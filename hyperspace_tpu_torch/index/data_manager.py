"""Physical index data layout: immutable versioned directories
(counterpart of ``hyperspace_tpu/index/data_manager.py``):

    <indexPath>/v__=<version>/<bucket files>.parquet
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

from ..util import file_utils
from .constants import IndexConstants


class IndexDataManager:
    def __init__(self, index_path: str):
        self._index_path = index_path
        self._prefix = IndexConstants.INDEX_VERSION_DIRECTORY_PREFIX + "="

    def get_latest_version_id(self) -> Optional[int]:
        versions = self.get_all_version_ids()
        return max(versions) if versions else None

    def get_all_version_ids(self) -> List[int]:
        pattern = re.compile(re.escape(self._prefix) + r"(\d+)$")
        out = []
        for name in file_utils.list_dir(self._index_path):
            m = pattern.match(name)
            if m and file_utils.is_dir(os.path.join(self._index_path, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def get_path(self, version: int) -> str:
        return os.path.join(self._index_path, f"{self._prefix}{version}")

    def delete(self, version: int) -> None:
        """Remove a version's files. A recreated index may write the same
        paths again, possibly within one mtime tick and at the same sizes,
        which a file signature cannot tell apart: the buffer pool forgets
        every read it holds."""
        from ..execution.buffer_pool import get_pool
        file_utils.delete_recursively(self.get_path(version))
        get_pool().clear()
