"""Index manager: dispatch to actions with per-index log/data managers and
list indexes by scanning the system path (counterpart of
``hyperspace_tpu/index/manager.py``: create, delete, restore, vacuum,
cancel, refresh, optimize, listing, the statistics rows and the caching
manager the session holds).
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..exceptions import HyperspaceException
from ..util import file_utils
from .cache import CreationTimeBasedIndexCache
from .constants import IndexConstants, States
from .data_manager import IndexDataManager
from .log_entry import IndexLogEntry
from .log_manager import IndexLogManager
from .path_resolver import PathResolver


class IndexCollectionManager:
    def __init__(self, session):
        self.session = session
        self._path_resolver = PathResolver(session.hs_conf)

    def _index_path(self, name: str) -> str:
        return self._path_resolver.get_index_path(name)

    def _log_manager(self, name: str, must_exist: bool = True) -> IndexLogManager:
        path = self._index_path(name)
        if must_exist and not file_utils.is_dir(path):
            raise HyperspaceException(f"Index with name {name} could not be found.")
        return IndexLogManager(path)

    def _data_manager(self, name: str) -> IndexDataManager:
        return IndexDataManager(self._index_path(name))

    def log_manager_for(self, name: str) -> IndexLogManager:
        """An index's op-log manager (time-travel index selection reads
        older log versions through it)."""
        return self._log_manager(name)

    def create(self, df, index_config) -> None:
        from ..api import DataSkippingIndexConfig
        if isinstance(index_config, DataSkippingIndexConfig):
            from ..actions.create_skipping import CreateDataSkippingAction
            action_cls = CreateDataSkippingAction
        else:
            from ..actions.create import CreateAction
            action_cls = CreateAction
        name = index_config.index_name
        action_cls(self.session, df, index_config,
                   self._log_manager(name, must_exist=False),
                   self._data_manager(name)).run()

    def delete(self, index_name: str) -> None:
        from ..actions.lifecycle import DeleteAction
        DeleteAction(self.session, self._log_manager(index_name)).run()

    def restore(self, index_name: str) -> None:
        from ..actions.lifecycle import RestoreAction
        RestoreAction(self.session, self._log_manager(index_name)).run()

    def vacuum(self, index_name: str) -> None:
        from ..actions.lifecycle import VacuumAction
        VacuumAction(self.session, self._log_manager(index_name),
                     self._data_manager(index_name)).run()

    def cancel(self, index_name: str) -> None:
        from ..actions.lifecycle import CancelAction
        CancelAction(self.session, self._log_manager(index_name)).run()

    def refresh(self, index_name: str, mode: str = IndexConstants.REFRESH_MODE_FULL) -> None:
        if mode not in IndexConstants.REFRESH_MODES:
            raise HyperspaceException(
                f"Unsupported refresh mode: {mode}; "
                f"choose from {IndexConstants.REFRESH_MODES}")
        log_mgr = self._log_manager(index_name)
        latest = log_mgr.get_latest_stable_log()
        if latest is not None and latest.derivedDataset.kind == "DataSkippingIndex":
            from ..actions.create_skipping import (RefreshDataSkippingAction,
                                                   RefreshDataSkippingIncrementalAction)
            if mode == IndexConstants.REFRESH_MODE_QUICK:
                raise HyperspaceException(
                    "Quick refresh is not supported for data-skipping "
                    "indexes; use full or incremental.")
            cls = {IndexConstants.REFRESH_MODE_FULL: RefreshDataSkippingAction,
                   IndexConstants.REFRESH_MODE_INCREMENTAL:
                       RefreshDataSkippingIncrementalAction}[mode]
        else:
            from ..actions.refresh import (RefreshAction, RefreshIncrementalAction,
                                           RefreshQuickAction)
            cls = {IndexConstants.REFRESH_MODE_FULL: RefreshAction,
                   IndexConstants.REFRESH_MODE_INCREMENTAL: RefreshIncrementalAction,
                   IndexConstants.REFRESH_MODE_QUICK: RefreshQuickAction}[mode]
        cls(self.session, log_mgr, self._data_manager(index_name)).run()

    def optimize(self, index_name: str,
                 mode: str = IndexConstants.OPTIMIZE_MODE_QUICK) -> None:
        from ..actions.optimize import OptimizeAction
        if mode not in IndexConstants.OPTIMIZE_MODES:
            raise HyperspaceException(
                f"Unsupported optimize mode: {mode}; "
                f"choose from {IndexConstants.OPTIMIZE_MODES}")
        OptimizeAction(self.session, self._log_manager(index_name),
                       self._data_manager(index_name), mode).run()

    def _index_names(self) -> List[str]:
        system_path = self._path_resolver.system_path
        return [n for n in file_utils.list_dir(system_path)
                if file_utils.is_dir(os.path.join(system_path, n, IndexConstants.HYPERSPACE_LOG))]

    def latest_log_ids(self) -> tuple:
        """(index name, latest op-log id, entry-bytes md5) per index under
        the system path, by name: the result cache's index component
        (serving/fingerprint.py). It bypasses the TTL index cache, so
        another process's refresh changes cache keys at once."""
        out = []
        for name in self._index_names():
            fp = IndexLogManager(self._index_path(name)).latest_entry_fingerprint()
            if fp is not None:
                out.append((name, fp[0], fp[1]))
        return tuple(out)

    def get_indexes(self, states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        out = []
        for name in self._index_names():
            entry = IndexLogManager(self._index_path(name)).get_latest_log()
            if entry is not None and (states is None or entry.state in states):
                out.append(entry)
        return out

    def get_index(self, index_name: str) -> Optional[IndexLogEntry]:
        if index_name not in self._index_names():
            return None
        return self._log_manager(index_name).get_latest_log()

    def indexes(self):
        """One summary row per index that exists, as a pandas DataFrame."""
        import pandas as pd
        from .statistics import IndexStatistics
        counts = self.session._index_usage_counts
        rows = [IndexStatistics.from_entry(e, usage_count=counts.get(e.name, 0)).to_row()
                for e in self.get_indexes() if e.state != States.DOESNOTEXIST]
        return pd.DataFrame(rows, columns=IndexStatistics.SUMMARY_COLUMNS)


class CachingIndexCollectionManager(IndexCollectionManager):
    """The index list cached for ``hyperspace.index.cache.expiryDurationInSeconds``;
    every mutation through this manager clears it first."""

    def __init__(self, session):
        super().__init__(session)
        self._cache = CreationTimeBasedIndexCache(session.hs_conf.index_cache_expiry_seconds)

    def clear_cache(self) -> None:
        self._cache.clear()

    def get_indexes(self, states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        if states is None:
            return super().get_indexes(None)
        entries = self._cache.get()
        if entries is None:
            entries = super().get_indexes(None)
            self._cache.set(entries)
        return [e for e in entries if e.state in states]

    def create(self, df, index_config) -> None:
        self.clear_cache()
        super().create(df, index_config)

    def delete(self, index_name: str) -> None:
        self.clear_cache()
        super().delete(index_name)

    def restore(self, index_name: str) -> None:
        self.clear_cache()
        super().restore(index_name)

    def vacuum(self, index_name: str) -> None:
        self.clear_cache()
        super().vacuum(index_name)

    def refresh(self, index_name: str, mode: str = IndexConstants.REFRESH_MODE_FULL) -> None:
        self.clear_cache()
        super().refresh(index_name, mode)

    def optimize(self, index_name: str,
                 mode: str = IndexConstants.OPTIMIZE_MODE_QUICK) -> None:
        self.clear_cache()
        super().optimize(index_name, mode)

    def cancel(self, index_name: str) -> None:
        self.clear_cache()
        super().cancel(index_name)
