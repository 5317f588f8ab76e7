"""Filesystem helpers (counterpart of ``hyperspace_tpu/util/file_utils.py``).

Writes that must be crash-consistent go through temp file + link/rename.
A scheme-qualified path's listings, stats, existence gates and deletes go
through the DataStore registered for its scheme (index/data_store.py).
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import List


def _write_temp(directory: str, contents: str) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{uuid.uuid4().hex}")
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(contents)
        f.flush()
        os.fsync(f.fileno())
    return tmp


def atomic_create(path: str, contents: str) -> bool:
    """Create ``path`` with ``contents`` iff it does not already exist;
    False when it does (optimistic concurrency for the op log)."""
    tmp = _write_temp(os.path.dirname(path), contents)
    try:
        # os.link fails with EEXIST if path exists: atomic create-if-absent.
        os.link(tmp, path)
        return True
    except FileExistsError:
        return False
    finally:
        os.unlink(tmp)


def atomic_overwrite(path: str, contents: str) -> None:
    """Atomically replace ``path`` with ``contents`` (for latestStable)."""
    os.replace(_write_temp(os.path.dirname(path), contents), path)


def read_contents(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def _data_store_for(path: str):
    """The DataStore of a scheme-qualified path, None for a local one
    (imported late: data_store sits above this module)."""
    if "://" not in path:
        return None
    from ..index import data_store
    return data_store.store_for_path(path)


def delete_recursively(path: str) -> None:
    store = _data_store_for(path)
    if store is not None:
        store.delete_recursively(path)
        return
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.unlink(path)


def list_leaf_files(path: str) -> List[str]:
    """Recursively list all regular files under ``path`` (sorted, full paths).
    Hidden files and dirs (leading '.' or '_') are excluded, like Spark's
    data-path filter."""
    store = _data_store_for(path)
    if store is not None:
        return store.list_leaf_files(path)
    out: List[str] = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if not _is_hidden(d))
        for f in sorted(files):
            if not _is_hidden(f):
                out.append(os.path.join(root, f))
    return out


def _is_hidden(name: str) -> bool:
    return name.startswith(".") or name.startswith("_")


def file_info_triple(path: str) -> tuple:
    """(full_path, size, mtime_ms) for a file, the signature triple."""
    store = _data_store_for(path)
    if store is not None:
        return store.file_info(path)
    st = os.stat(path)
    return (os.path.abspath(path), st.st_size, int(st.st_mtime * 1000))


def is_dir(path: str) -> bool:
    """Whether a directory (or a store's prefix) exists."""
    store = _data_store_for(path)
    return store.is_dir(path) if store is not None else os.path.isdir(path)


def list_dir(path: str) -> List[str]:
    """The names directly under ``path``, sorted; none when it is absent."""
    store = _data_store_for(path)
    if store is not None:
        return store.list_dir(path)
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def makedirs(path: str) -> None:
    """mkdir -p (a marker, or nothing, on a flat object store)."""
    store = _data_store_for(path)
    if store is not None:
        store.makedirs(path)
    else:
        os.makedirs(path, exist_ok=True)
