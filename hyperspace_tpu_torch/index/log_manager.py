"""Versioned operation log with optimistic concurrency (counterpart of
``hyperspace_tpu/index/log_manager.py``). Layout under an index's root:

    <indexPath>/_hyperspace_log/<id>         -- JSON log entry, immutable
    <indexPath>/_hyperspace_log/latestStable -- copy of the latest stable entry

``write_log`` refuses to overwrite an existing id (put-if-absent through
the log store), which is how concurrent actions detect conflicts.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..util import json_utils
from .constants import STABLE_STATES, IndexConstants, States
from .log_entry import IndexLogEntry
from .log_store import LocalFsLogStore


class IndexLogManager:
    def __init__(self, index_path: str):
        self._store = LocalFsLogStore()
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

    def get_latest_id(self) -> Optional[int]:
        ids = self._store.list_numeric_ids(self._log_path)
        return max(ids) if ids else None

    def get_all_ids(self) -> List[int]:
        """Every existing entry id, newest first."""
        return sorted(self._store.list_numeric_ids(self._log_path), reverse=True)

    def get_latest_log(self) -> Optional[IndexLogEntry]:
        latest = self.get_latest_id()
        return self.get_log(latest) if latest is not None else None

    def get_latest_stable_log(self) -> Optional[IndexLogEntry]:
        """Latest entry in a stable state; falls back to a backward scan past
        a broken tail, including an unparseable (torn) entry."""
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
        self._store.put_overwrite(self._latest_stable_path,
                                  json_utils.to_json(entry.to_json_dict()))
        return True

    def delete_latest_stable_log(self) -> bool:
        return self._store.delete(self._latest_stable_path)

    def write_log(self, log_id: int, entry: IndexLogEntry) -> bool:
        """Write entry at ``log_id`` iff that id doesn't exist yet."""
        entry.id = log_id
        return self._store.put_if_absent(self._path_from_id(log_id),
                                         json_utils.to_json(entry.to_json_dict()))
