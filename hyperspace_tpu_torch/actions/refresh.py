"""Refresh actions: full rebuild, incremental append/delete, quick metadata
(counterpart of ``hyperspace_tpu/actions/refresh.py``).

The incremental path builds only the appended files, with the previous
entry's bucket count so the new files stay bucket-aligned with the old
ones; deletes rebuild from the old index rows masked on the lineage column
(a sorted membership test on the device). Quick refresh writes no data:
it records the appended and deleted files in the entry, and Hybrid Scan
applies them at query time.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException, NoChangesException
from ..execution.columnar import Table, read_parquet
from ..index.constants import IndexConstants, States
from ..index.log_entry import (Content, Directory, FileIdTracker, FileInfo,
                               IndexLogEntry, Update)
from ..ops import kernels
from ..plan.nodes import Scan
from ..telemetry import events as _ev
from .create import CreateActionBase


class ExistingIndexActionBase(CreateActionBase):
    """Base for actions over an existing index (refresh, optimize): they
    follow the previous stable entry's bucket count and lineage setting,
    and write the next data version."""

    def __init__(self, session, log_manager, data_manager):
        super().__init__(session, log_manager, data_manager)
        self._entry: Optional[IndexLogEntry] = None
        self._previous: Optional[IndexLogEntry] = None

    @property
    def previous_entry(self) -> IndexLogEntry:
        if self._previous is None:
            entry = self.log_manager.get_latest_stable_log()
            if entry is None:
                raise HyperspaceException("Could not read latest stable log")
            self._previous = entry
        return self._previous

    def _num_buckets(self) -> int:
        return self.previous_entry.num_buckets

    def _lineage_enabled(self) -> bool:
        return self.previous_entry.has_lineage_column()

    def _new_version(self) -> int:
        latest = self.data_manager.get_latest_version_id()
        return 0 if latest is None else latest + 1

    def _base_index_properties(self, relation) -> dict:
        """The previous entry's properties, then the standard ones."""
        props = dict(self.previous_entry.derivedDataset.properties)
        props.update(super()._base_index_properties(relation))
        return props

    @property
    def log_entry(self) -> IndexLogEntry:
        if self._entry is not None:
            return self._entry
        # begin() runs before op(): the previous entry is the placeholder.
        return self.previous_entry


def content_from_file_infos(infos: List[FileInfo]) -> Optional[Content]:
    """A Content over known FileInfos, stat-free (deleted files cannot be
    stat'ed)."""
    if not infos:
        return None
    return Content(Directory("/", files=sorted(infos, key=lambda f: f.name)))


class RefreshActionBase(ExistingIndexActionBase):
    """The previous entry, the relation listed anew, and the file diff."""

    transient_state = States.REFRESHING
    final_state = States.ACTIVE

    def __init__(self, session, log_manager, data_manager):
        super().__init__(session, log_manager, data_manager)
        self._relation = None
        self._diff: Optional[Tuple[List[FileInfo], List[FileInfo]]] = None

    @property
    def relation(self):
        if self._relation is None:
            rel = self.previous_entry.relation
            self._relation = self.session.source_provider_manager.build_relation(
                rel.rootPaths, rel.fileFormat, rel.options).refresh()
        return self._relation

    @property
    def indexed_columns(self) -> List[str]:
        return self.previous_entry.indexed_columns

    @property
    def included_columns(self) -> List[str]:
        return self.previous_entry.included_columns

    def _file_diff(self) -> Tuple[List[FileInfo], List[FileInfo]]:
        """(appended, deleted) against the files the previous entry recorded."""
        if self._diff is None:
            current = {FileInfo(p, size, mtime)
                       for p, size, mtime in self.relation.all_file_infos()}
            logged = self.previous_entry.source_file_info_set
            self._diff = (sorted(current - logged, key=lambda f: f.name),
                          sorted(logged - current, key=lambda f: f.name))
        return self._diff

    @property
    def appended_files(self) -> List[FileInfo]:
        return self._file_diff()[0]

    @property
    def deleted_files(self) -> List[FileInfo]:
        return self._file_diff()[1]

    def _seeded_tracker(self) -> FileIdTracker:
        """A tracker holding the previous source file ids: unchanged files
        keep their lineage ids, appended files number past them."""
        tracker = FileIdTracker()
        tracker.add_file_info(self.previous_entry.source_file_info_set)
        return tracker

    def validate(self) -> None:
        latest = self.log_manager.get_latest_log()
        if latest is None or latest.state != States.ACTIVE:
            raise HyperspaceException(
                f"Refresh is only supported in {States.ACTIVE} state; "
                f"found {latest.state if latest else 'no log'}")
        if not self.appended_files and not self.deleted_files:
            raise NoChangesException("Refresh aborted as no source data change found.")

    def _validate_deletes_have_lineage(self) -> None:
        if self.deleted_files and not self.previous_entry.has_lineage_column():
            raise HyperspaceException(
                "Index refresh (to handle deleted source data) is only "
                "supported on an index with lineage.")

    def _rebuilt_entry(self, tracker: FileIdTracker, index_content: Content,
                       version: int) -> IndexLogEntry:
        """A fresh entry over the relation as it is now."""
        prev = self.previous_entry
        return self._build_entry(
            prev.name, self.relation, Scan(self.relation), list(prev.indexed_columns),
            list(prev.included_columns), prev.schema, tracker, index_content
        ).with_log_version(version)


class RefreshAction(RefreshActionBase):
    """Full refresh: the whole index rebuilt in device memory from the
    current source at a new data version (as in the JAX package, whatever
    the device budget)."""

    def op(self) -> None:
        tracker = FileIdTracker()
        table = self._load_projected(self.relation, self.indexed_columns,
                                     self.included_columns, tracker)
        version = self._new_version()
        out_dir = self._write_index_files(table, self.indexed_columns, version)
        index_content = Content.from_directory(out_dir, tracker)
        self._entry = self._rebuilt_entry(tracker, index_content, version)

    def event(self, message: str) -> _ev.RefreshActionEvent:
        return _ev.RefreshActionEvent(message=message, index_name=self.previous_entry.name)


class RefreshIncrementalAction(RefreshActionBase):
    """Incremental refresh:

    - appends only: bucket-aligned index files over the appended source
      files alone, at a new version; the content is the old files and the
      new ones, so a bucket may hold several files (optimize merges them);
    - with deletes: the old index rows, less those whose lineage id is a
      deleted file's, with the appended rows, rebuilt whole at the new
      version (one sorted file per bucket).
    """

    def validate(self) -> None:
        super().validate()
        self._validate_deletes_have_lineage()

    def op(self) -> None:
        prev = self.previous_entry
        tracker = self._seeded_tracker()
        appended_paths = [f.name for f in self.appended_files]
        version = self._new_version()
        if self.deleted_files:
            old = read_parquet(sorted(prev.content.files), list(prev.schema.names),
                               self.session.device)
            deleted = torch.from_numpy(np.sort(np.asarray(
                [f.id for f in self.deleted_files], dtype=np.int64))).to(self.session.device)
            lineage = old.column(IndexConstants.DATA_FILE_NAME_ID).data.to(torch.int64)
            old = old.filter(~kernels.isin_sorted(lineage, deleted))
            parts = [old]
            if appended_paths:
                appended = self._load_projected(self.relation, self.indexed_columns,
                                                self.included_columns, tracker,
                                                files=appended_paths)
                parts.append(appended.select(old.names))
            table = Table.concat(parts) if len(parts) > 1 else parts[0]
            out_dir = self._write_index_files(table, self.indexed_columns, version)
            index_content = Content.from_directory(out_dir, tracker)
        else:
            appended = self._load_projected(self.relation, self.indexed_columns,
                                            self.included_columns, tracker,
                                            files=appended_paths)
            out_dir = self._write_index_files(appended, self.indexed_columns, version)
            index_content = prev.content.merge(Content.from_directory(out_dir, tracker))
        self._entry = self._rebuilt_entry(tracker, index_content, version)

    def event(self, message: str) -> _ev.RefreshIncrementalActionEvent:
        return _ev.RefreshIncrementalActionEvent(message=message,
                                                 index_name=self.previous_entry.name)


class RefreshQuickAction(RefreshActionBase):
    """Quick refresh: metadata only. The appended and deleted files go into
    the previous entry's source update; the index data is untouched and
    Hybrid Scan applies the change at query time."""

    def validate(self) -> None:
        super().validate()
        self._validate_deletes_have_lineage()

    def op(self) -> None:
        pass  # metadata only.

    @property
    def log_entry(self) -> IndexLogEntry:
        if self._entry is None:
            prev = self.previous_entry
            tracker = self._seeded_tracker()
            appended = [FileInfo(f.name, f.size, f.modifiedTime,
                                 tracker.add_file(f.name, f.size, f.modifiedTime))
                        for f in self.appended_files]
            # Deleted files keep their recorded ids.
            prev.relation.data.update = Update(
                appendedFiles=content_from_file_infos(appended),
                deletedFiles=content_from_file_infos(list(self.deleted_files)))
            self._entry = prev.with_log_version(prev.log_version)
        return self._entry

    def event(self, message: str) -> _ev.RefreshQuickActionEvent:
        return _ev.RefreshQuickActionEvent(message=message, index_name=self.previous_entry.name)
