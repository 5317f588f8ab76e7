"""Versioned operation log with optimistic concurrency (counterpart of
``hyperspace_tpu/index/log_manager.py``). Layout under an index's root:

    <indexPath>/_hyperspace_log/<id>         -- JSON log entry, immutable
    <indexPath>/_hyperspace_log/latestStable -- copy of the latest stable entry

``write_log`` refuses to overwrite an existing id (put-if-absent through
the log store), which is how concurrent actions detect conflicts. The
store is the one registered for the index path's scheme
(index/log_store.py), or the local filesystem.

The per-query lookups (the latest id, the latest stable entry) of a local
log are memoized process-wide by ``LogLookupCache``, keyed on the log
directory's change token; an object store has no such token, so its
lookups are not memoized.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from ..robustness import fault_names as _fn
from ..robustness import faults as _faults
from ..robustness import retry as _retry
from ..util import hashing, json_utils
from .constants import STABLE_STATES, IndexConstants, States
from .log_entry import IndexLogEntry
from .log_store import LocalFsLogStore, LogStore, store_for_path, strip_file_scheme


class LogLookupCache:
    """Process-wide memo of the op-log lookups every query makes, keyed on
    the log directory's identity token (mtime_ns, ctime_ns).

    Every protocol write creates or deletes a file in the log directory
    (an entry's put-if-absent, latestStable's temp file + replace), so the
    directory's mtime is a change token for writers in other processes;
    writers in this process also invalidate explicitly, against coarse
    filesystem timestamps. Entries are cached as their JSON text and
    parsed anew per hit: callers mutate the entries they get."""

    _MAX_DIRS = 256  # one slot per live index log
    # A directory whose mtime lies within this window of now may still
    # receive writes with the same stamp on a coarse filesystem, so its
    # token cannot detect them yet: such a value is served, not stored.
    _RACY_WINDOW_NS = 2_000_000_000

    def __init__(self):
        self._lock = threading.Lock()
        self._dirs = {}  # log path -> (token, {kind: value})
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    @staticmethod
    def _token(log_path: str):
        try:
            st = os.stat(log_path)
        except OSError:
            return ("missing",)
        return (st.st_mtime_ns, st.st_ctime_ns)

    @classmethod
    def _racy(cls, token) -> bool:
        if token == ("missing",):
            return False
        return time.time_ns() - token[0] < cls._RACY_WINDOW_NS

    def get(self, log_path: str, kind: str, compute):
        """The value of ``kind`` under ``log_path``. On a miss ``compute()``
        runs, and its value is stored under the token seen before it ran,
        unless the token moved meanwhile (a racing write never pins a
        stale value)."""
        token = self._token(log_path)
        with self._lock:
            cached = self._dirs.get(log_path)
            if cached is not None and cached[0] == token and kind in cached[1]:
                self.hits += 1
                return cached[1][kind]
            self.misses += 1
        value = compute()
        if self._racy(token):
            return value
        with self._lock:
            if self._token(log_path) != token:
                return value
            cached = self._dirs.get(log_path)
            if cached is None or cached[0] != token:
                if len(self._dirs) >= self._MAX_DIRS:
                    self._dirs.pop(next(iter(self._dirs)))
                cached = (token, {})
                self._dirs[log_path] = cached
            cached[1][kind] = value
        return value

    def invalidate(self, log_path: str) -> None:
        with self._lock:
            if self._dirs.pop(log_path, None) is not None:
                self.invalidations += 1

    def clear(self) -> None:
        with self._lock:
            self._dirs.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "invalidations": self.invalidations, "dirs": len(self._dirs)}


_LOOKUP_CACHE = LogLookupCache()


def get_lookup_cache() -> LogLookupCache:
    """The process-wide op-log lookup cache."""
    return _LOOKUP_CACHE


class IndexLogManager:
    def __init__(self, index_path: str, store: Optional[LogStore] = None):
        self._store = store or store_for_path(index_path)
        # Only a local log has the directory token the lookup cache checks.
        self._cacheable = isinstance(self._store, LocalFsLogStore)
        if self._cacheable:
            # A file:// URI becomes the path entry paths are joined under.
            index_path = strip_file_scheme(index_path)
        self._index_path = index_path
        self._log_path = os.path.join(index_path, IndexConstants.HYPERSPACE_LOG)
        self._latest_stable_path = os.path.join(
            self._log_path, IndexConstants.LATEST_STABLE_LOG_NAME)

    @property
    def index_path(self) -> str:
        return self._index_path

    def _path_from_id(self, log_id: int) -> str:
        return os.path.join(self._log_path, str(log_id))

    def _get_log_at(self, path: str) -> Optional[IndexLogEntry]:
        data = self._store.read(path)
        return None if data is None else IndexLogEntry.from_json(data)

    def get_log(self, log_id: int) -> Optional[IndexLogEntry]:
        return self._get_log_at(self._path_from_id(log_id))

    def _memo(self, kind: str, compute):
        if self._cacheable:
            return _LOOKUP_CACHE.get(self._log_path, kind, compute)
        return compute()

    def get_latest_id(self) -> Optional[int]:
        return self._memo("latest_id", self._compute_latest_id)

    def _compute_latest_id(self) -> Optional[int]:
        ids = self._store.list_numeric_ids(self._log_path)
        return max(ids) if ids else None

    def latest_entry_fingerprint(self) -> Optional[tuple]:
        """(latest id, md5 of that entry's bytes), or None for an empty log:
        the result cache's change detector (a full refresh restarts the
        log at the same ids, so the id alone cannot pin the state).
        Memoized per log directory token, like the other lookups."""
        return self._memo("fingerprint", self._compute_fingerprint)

    def _compute_fingerprint(self) -> Optional[tuple]:
        latest = self._compute_latest_id()
        if latest is None:
            return None
        data = self._store.read(self._path_from_id(latest))
        return (latest, hashing.md5_hex(data) if data is not None else "")

    def get_all_ids(self) -> List[int]:
        """Every existing entry id, newest first."""
        return sorted(self._store.list_numeric_ids(self._log_path), reverse=True)

    def get_latest_log(self) -> Optional[IndexLogEntry]:
        latest = self.get_latest_id()
        return self.get_log(latest) if latest is not None else None

    def _get_log_lenient(self, log_id: int) -> Optional[IndexLogEntry]:
        """``get_log`` that takes an unparseable (torn) entry for absent:
        for the recovery and compaction scans only; normal reads surface
        corruption."""
        try:
            return self.get_log(log_id)
        except (ValueError, KeyError, TypeError):
            return None

    def get_latest_stable_log(self) -> Optional[IndexLogEntry]:
        """Latest entry in a stable state; falls back to a backward scan past
        a broken tail, including an unparseable (torn) entry. Memoized as
        JSON text per log directory token and parsed per call."""
        text = self._memo("stable_json", lambda: (lambda e: None if e is None else e.to_json())(
            self._compute_latest_stable_log()))
        return None if text is None else IndexLogEntry.from_json(text)

    def _compute_latest_stable_log(self) -> Optional[IndexLogEntry]:
        try:
            log = self._get_log_at(self._latest_stable_path)
        except (ValueError, KeyError, TypeError):
            log = None
        if log is not None and log.state in STABLE_STATES:
            return log
        for log_id in self.get_all_ids():
            try:
                entry = self.get_log(log_id)
            except (ValueError, KeyError, TypeError):
                continue
            if entry is None:
                continue
            if entry.state in STABLE_STATES:
                return entry
            if entry.state in (States.CREATING, States.VACUUMING):
                # Logs before a CREATING/VACUUMING entry are unrelated.
                return None
        return None

    def create_latest_stable_log(self, log_id: int) -> bool:
        entry = self.get_log(log_id)
        if entry is None or entry.state not in STABLE_STATES:
            return False
        data = json_utils.to_json(entry.to_json_dict())

        def _put() -> None:
            # A kill here leaves the final entry committed and latestStable
            # stale: get_latest_stable_log's backward scan covers it.
            _faults.fault_point(_fn.LOG_STABLE)
            self._store.put_overwrite(self._latest_stable_path, data)

        _retry.call(_put, where="log.stable")
        _LOOKUP_CACHE.invalidate(self._log_path)
        return True

    def delete_latest_stable_log(self) -> bool:
        out = self._store.delete(self._latest_stable_path)
        _LOOKUP_CACHE.invalidate(self._log_path)
        return out

    def write_log(self, log_id: int, entry: IndexLogEntry) -> bool:
        """Write entry at ``log_id`` iff that id doesn't exist yet.
        Transient store errors retry (robustness/retry.py); an attempt that
        committed before erroring is found by its bytes, so a later "loss"
        to our own entry is a win. The lookup cache is invalidated even when
        another writer won: its entry is as new to this process as ours
        would have been."""
        entry.id = log_id
        path = self._path_from_id(log_id)
        data = json_utils.to_json(entry.to_json_dict())
        state = {"transient": False}

        def _put() -> bool:
            _faults.fault_point(_fn.LOG_WRITE)
            try:
                return self._store.put_if_absent(path, data)
            except _retry.TRANSIENT_TYPES:
                state["transient"] = True
                raise

        won = _retry.call(_put, where="log.write")
        if not won and state["transient"]:
            won = self._store.read(path) == data
        _LOOKUP_CACHE.invalidate(self._log_path)
        return won

    def delete_log(self, log_id: int) -> bool:
        """Remove one entry file: only compaction does this, after the
        checkpoint superseding it is committed, and recovery, for a torn
        tip."""
        out = self._store.delete(self._path_from_id(log_id))
        _LOOKUP_CACHE.invalidate(self._log_path)
        return out
