"""Storage under the op log (counterpart of
``hyperspace_tpu/index/log_store.py``, local filesystem only).

Only ``put_if_absent`` must be atomic -- it decides every race between
concurrent actions. ``latestStable`` is a cache of the newest stable entry,
so a last-writer-wins overwrite suffices for it.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..util import file_utils


class LocalFsLogStore:
    """POSIX link-into-place create, fsync'd."""

    def put_if_absent(self, path: str, data: str) -> bool:
        return file_utils.atomic_create(path, data)

    def put_overwrite(self, path: str, data: str) -> None:
        file_utils.atomic_overwrite(path, data)

    def read(self, path: str) -> Optional[str]:
        if not os.path.exists(path):
            return None
        return file_utils.read_contents(path)

    def list_numeric_ids(self, dirpath: str) -> List[int]:
        if not os.path.isdir(dirpath):
            return []
        return [int(n) for n in os.listdir(dirpath) if n.isdigit()]

    def delete(self, path: str) -> bool:
        try:
            if os.path.exists(path):
                os.unlink(path)
            return True
        except OSError:
            return False
