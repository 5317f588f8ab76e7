"""Storage under the op log (counterpart of
``hyperspace_tpu/index/log_store.py``).

Only ``put_if_absent`` must be atomic: it decides every race between
concurrent actions, and an object store gives it as a conditional PUT
(S3 ``If-None-Match: *``, GCS ``if-generation-match: 0``), so the log
protocol needs no rename. ``latestStable`` is a cache of the newest stable
entry, so a last-writer-wins overwrite suffices for it.

Paths without a scheme (or ``file://``) use the local filesystem; a
deployment backs another scheme by registering a factory::

    from hyperspace_tpu_torch.index import log_store
    log_store.register_scheme("s3", lambda path: MyS3LogStore(path))

``hsmem://`` (index/data_store.py) is registered built in.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

from ..exceptions import HyperspaceException
from ..util import file_utils


class LogStore:
    """The op-log storage contract."""

    def put_if_absent(self, path: str, data: str) -> bool:
        """Write ``data`` at ``path`` iff nothing is there; True on a win."""
        raise NotImplementedError

    def put_overwrite(self, path: str, data: str) -> None:
        """Last writer wins (the latestStable cache only)."""
        raise NotImplementedError

    def read(self, path: str) -> Optional[str]:
        """The contents, or None when absent."""
        raise NotImplementedError

    def list_numeric_ids(self, dirpath: str) -> List[int]:
        """The numeric entry names directly under ``dirpath``."""
        raise NotImplementedError

    def delete(self, path: str) -> bool:
        """Best-effort delete; True when gone (or already absent)."""
        raise NotImplementedError


class LocalFsLogStore(LogStore):
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


class InMemoryObjectStore(LogStore):
    """A conditional-put object store: a flat key space, LIST by prefix and
    compare-and-create under a lock, with no rename (S3/GCS semantics)."""

    def __init__(self):
        self._objects: Dict[str, str] = {}
        self._lock = threading.Lock()

    def put_if_absent(self, path: str, data: str) -> bool:
        with self._lock:
            if path in self._objects:
                return False
            self._objects[path] = data
            return True

    def put_overwrite(self, path: str, data: str) -> None:
        with self._lock:
            self._objects[path] = data

    def read(self, path: str) -> Optional[str]:
        with self._lock:
            return self._objects.get(path)

    def list_numeric_ids(self, dirpath: str) -> List[int]:
        prefix = dirpath.rstrip("/") + "/"
        with self._lock:
            tails = [k[len(prefix):] for k in self._objects if k.startswith(prefix)]
        return [int(t) for t in tails if "/" not in t and t.isdigit()]

    def delete(self, path: str) -> bool:
        with self._lock:
            self._objects.pop(path, None)
            return True

    def corrupt(self, path: str) -> None:
        """Truncate an object, as a crash mid-upload leaves it on a store
        without atomic multipart completion (a torn tail)."""
        with self._lock:
            if path in self._objects:
                self._objects[path] = self._objects[path][:10]


_SCHEME_FACTORIES: Dict[str, Callable[[str], LogStore]] = {}


def register_scheme(scheme: str, factory: Callable[[str], LogStore]) -> None:
    """Back ``scheme://`` index paths with the LogStore ``factory(path)``."""
    _SCHEME_FACTORIES[scheme.lower()] = factory


def strip_file_scheme(path: str) -> str:
    """A ``file://`` URI's filesystem path (os.* would otherwise make a
    literal './file:...' directory)."""
    if path.lower().startswith("file://"):
        return path[len("file://"):]
    return path


def store_for_path(index_path: str) -> LogStore:
    if "://" in index_path:
        scheme = index_path.split("://", 1)[0].lower()
        if scheme in ("file", ""):
            return LocalFsLogStore()
        factory = _SCHEME_FACTORIES.get(scheme)
        if factory is None:
            raise HyperspaceException(
                f"No LogStore registered for scheme {scheme!r}; register one with "
                "hyperspace_tpu_torch.index.log_store.register_scheme (the store needs "
                "only a conditional put; see the module docstring)")
        return factory(index_path)
    return LocalFsLogStore()


# The built-in hsmem:// scheme registers itself in data_store.
from . import data_store as _data_store  # noqa: E402,F401
