"""Index data files on an object store (counterpart of
``hyperspace_tpu/index/data_store.py``).

A scheme-qualified index path (``scheme://...``) routes every index data
write, read, listing, existence gate and recursive delete through the
``DataStore`` registered for its scheme; parquet IO passes the store's
``filesystem()`` to pyarrow as ``filesystem=``. Nothing needs rename: data
files are immutable puts under fresh ``v__=<n>/`` names, listings are
prefix lists and deletes prefix deletes. Paths without a scheme (or
``file://``) keep the local filesystem.

The built-in ``hsmem://`` scheme (fsspec's process-global memory
filesystem and a conditional-put log adapter over it) carries a whole
index, log and data, with no local file. fsspec is imported only when
that store is built, so the package imports without it.
"""

from __future__ import annotations

import os
import posixpath
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..exceptions import HyperspaceException


class DataStore:
    """The index data storage contract: immutable file puts and prefix
    lists. ``filesystem()`` is handed to pyarrow; the rest covers existence
    gates, leaf listings (index content) and vacuum's recursive delete."""

    def filesystem(self):
        raise NotImplementedError

    def normalize(self, path: str) -> str:
        """The path as ``filesystem()`` expects it (scheme stripped)."""
        raise NotImplementedError

    def is_dir(self, path: str) -> bool:
        raise NotImplementedError

    def list_dir(self, path: str) -> List[str]:
        """Names (not paths) directly under ``path``, sorted."""
        raise NotImplementedError

    def list_leaf_files(self, path: str) -> List[str]:
        """Every file under ``path``, scheme-qualified (the paths round-trip
        through log entries into reads), sorted, hidden names below
        ``path`` left out."""
        raise NotImplementedError

    def file_info(self, path: str) -> Tuple[str, int, int]:
        """(path, size, mtime ms): the signature triple."""
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        """A directory marker (a no-op on a flat object store)."""
        raise NotImplementedError

    def delete_recursively(self, path: str) -> None:
        raise NotImplementedError


def _hidden_below(root: str, path: str) -> bool:
    """Whether a segment of ``path`` below ``root`` starts with '.' or '_'
    (an ancestor such as '_data' in the root itself hides nothing)."""
    rel = path.strip("/")
    if rel.startswith(root):
        rel = rel[len(root):].lstrip("/")
    return any(s.startswith((".", "_")) for s in rel.split("/"))


class InMemoryDataStore(DataStore):
    """fsspec's memory filesystem behind ``hsmem://`` paths. It is
    process-global, so two users isolate by path root."""

    scheme = "hsmem"

    def __init__(self):
        import fsspec
        self._fs = fsspec.filesystem("memory")

    def filesystem(self):
        return self._fs

    def normalize(self, path: str) -> str:
        if path.startswith(self.scheme + "://"):
            return "/" + path[len(self.scheme) + 3:].lstrip("/")
        return path

    def _qualify(self, norm: str) -> str:
        return f"{self.scheme}://{norm.lstrip('/')}"

    def is_dir(self, path: str) -> bool:
        try:
            return self._fs.isdir(self.normalize(path))
        except FileNotFoundError:
            return False

    def list_dir(self, path: str) -> List[str]:
        p = self.normalize(path)
        if not self.is_dir(p):
            return []
        return sorted(posixpath.basename(e.rstrip("/")) for e in self._fs.ls(p, detail=False))

    def list_leaf_files(self, path: str) -> List[str]:
        p = self.normalize(path)
        if not self._fs.exists(p):
            return []
        root = p.strip("/")
        return sorted(self._qualify(f) for f in self._fs.find(p) if not _hidden_below(root, f))

    def file_info(self, path: str) -> Tuple[str, int, int]:
        info = self._fs.info(self.normalize(path))
        try:
            mtime_ms = int(float(info.get("created") or 0) * 1000)
        except (TypeError, ValueError):
            mtime_ms = 0
        return (path, int(info.get("size") or 0), mtime_ms)

    def makedirs(self, path: str) -> None:
        self._fs.makedirs(self.normalize(path), exist_ok=True)

    def delete_recursively(self, path: str) -> None:
        p = self.normalize(path)
        if self._fs.exists(p):
            self._fs.rm(p, recursive=True)


_SCHEME_FACTORIES: Dict[str, Callable[[], DataStore]] = {}
_STORE_CACHE: Dict[str, DataStore] = {}
_LOCK = threading.Lock()


def register_scheme(scheme: str, factory: Callable[[], DataStore]) -> None:
    """Back ``scheme://`` index data paths with the DataStore ``factory()``,
    built once, at the scheme's first use."""
    _SCHEME_FACTORIES[scheme.lower()] = factory


def scheme_of(path: str) -> Optional[str]:
    if "://" not in path:
        return None
    scheme = path.split("://", 1)[0].lower()
    return None if scheme in ("file", "") else scheme


def store_for_path(path: str) -> Optional[DataStore]:
    """The DataStore of a scheme-qualified path, or None for a local one."""
    scheme = scheme_of(path)
    if scheme is None:
        return None
    with _LOCK:
        store = _STORE_CACHE.get(scheme)
        if store is None:
            factory = _SCHEME_FACTORIES.get(scheme)
            if factory is None:
                raise HyperspaceException(
                    f"No DataStore registered for scheme {scheme!r}; register one with "
                    "hyperspace_tpu_torch.index.data_store.register_scheme (a "
                    "pyarrow-compatible filesystem and prefix listing; see the module "
                    "docstring)")
            store = _STORE_CACHE[scheme] = factory()
    return store


def fs_and_path(path: str):
    """(filesystem or None, normalized path) for a pyarrow IO call; a local
    path gives (None, path)."""
    store = store_for_path(path)
    if store is None:
        return None, path
    return store.filesystem(), store.normalize(path)


def file_stamp(path: str) -> Tuple[int, int]:
    """(size, mtime) of a file: os.stat's, the mtime in ns, for a local
    path; its store's, the mtime in ms, otherwise. OSError when it cannot
    be stat'ed."""
    store = store_for_path(path)
    if store is None:
        st = os.stat(path)
        return st.st_size, st.st_mtime_ns
    _, size, mtime_ms = store.file_info(path)
    return size, mtime_ms


def resolve_files(files) -> Tuple[object, List[str]]:
    """The many-path form of ``fs_and_path``: the files share the first
    one's store."""
    files = list(files)
    store = store_for_path(files[0]) if files else None
    if store is None:
        return None, files
    return store.filesystem(), [store.normalize(f) for f in files]


class _MemConditionalPutLogStore:
    """The op log over the same fsspec memory filesystem as the data, so an
    ``hsmem://`` tree carries the whole index. The lock stands in for a
    store's conditional PUT."""

    _lock = threading.Lock()  # one memory filesystem, one lock

    def __init__(self):
        import fsspec
        self._fs = fsspec.filesystem("memory")

    @staticmethod
    def _norm(path: str) -> str:
        prefix = InMemoryDataStore.scheme + "://"
        return "/" + path[len(prefix):].lstrip("/") if path.startswith(prefix) else path

    def put_if_absent(self, path: str, data: str) -> bool:
        p = self._norm(path)
        with self._lock:
            if self._fs.exists(p):
                return False
            with self._fs.open(p, "w") as f:
                f.write(data)
            return True

    def put_overwrite(self, path: str, data: str) -> None:
        with self._lock:
            with self._fs.open(self._norm(path), "w") as f:
                f.write(data)

    def read(self, path: str) -> Optional[str]:
        p = self._norm(path)
        with self._lock:
            if not self._fs.exists(p) or self._fs.isdir(p):
                return None
            with self._fs.open(p, "r") as f:
                return f.read()

    def list_numeric_ids(self, dirpath: str) -> List[int]:
        p = self._norm(dirpath)
        with self._lock:
            if not self._fs.exists(p):
                return []
            names = [posixpath.basename(e.rstrip("/")) for e in self._fs.ls(p, detail=False)]
        return [int(n) for n in names if n.isdigit()]

    def delete(self, path: str) -> bool:
        p = self._norm(path)
        with self._lock:
            if self._fs.exists(p):
                self._fs.rm(p)
            return True


def _register_builtin() -> None:
    from . import log_store
    register_scheme(InMemoryDataStore.scheme, InMemoryDataStore)
    log_store.register_scheme(InMemoryDataStore.scheme,
                              lambda path: _MemConditionalPutLogStore())


_register_builtin()
