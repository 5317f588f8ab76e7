"""Local filesystem helpers (counterpart of ``hyperspace_tpu/util/file_utils.py``,
local filesystem only).

Writes that must be crash-consistent go through temp file + link/rename.
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


def delete_recursively(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.unlink(path)


def list_leaf_files(path: str) -> List[str]:
    """Recursively list all regular files under ``path`` (sorted, full paths).
    Hidden files and dirs (leading '.' or '_') are excluded, like Spark's
    data-path filter."""
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
    st = os.stat(path)
    return (os.path.abspath(path), st.st_size, int(st.st_mtime * 1000))
