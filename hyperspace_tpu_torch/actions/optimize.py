"""OptimizeAction: merge a bucket's index files into one (counterpart of
``hyperspace_tpu/actions/optimize.py``).

Candidates are the files below ``hyperspace.index.optimize.fileSizeThreshold``
(quick mode) or all files (full mode); a bucket with a single candidate is
left alone. Each other bucket's candidate rows are re-sorted by the
indexed columns on the device and written as one file at a new data
version; untouched files keep their place in the content. This restores
the one-sorted-file-per-bucket layout after incremental refreshes, and
with it the shuffle-free join and the group-by's skipped sort.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..exceptions import HyperspaceException, NoChangesException
from ..execution.columnar import read_parquet, write_parquet
from ..index.constants import IndexConstants, States
from ..index.log_entry import Content, FileIdTracker, FileInfo, IndexLogEntry
from ..ops import index_build, kernels
from ..telemetry import events as _ev
from ..util import file_utils
from .refresh import ExistingIndexActionBase


class OptimizeAction(ExistingIndexActionBase):
    transient_state = States.OPTIMIZING
    final_state = States.ACTIVE

    def __init__(self, session, log_manager, data_manager, mode: str):
        super().__init__(session, log_manager, data_manager)
        self.mode = mode
        self._partition: Optional[Tuple[Dict[int, List[FileInfo]], List[FileInfo]]] = None

    def _files_to_optimize(self) -> Tuple[Dict[int, List[FileInfo]], List[FileInfo]]:
        """(bucket -> files to merge, files left untouched)."""
        if self._partition is not None:
            return self._partition
        threshold = self.session.hs_conf.optimize_file_size_threshold()
        by_bucket: Dict[int, List[FileInfo]] = defaultdict(list)
        skipped: List[FileInfo] = []
        for info in sorted(self.previous_entry.content.file_infos, key=lambda f: f.name):
            bucket = index_build.bucket_id_from_file(info.name)
            small = self.mode == IndexConstants.OPTIMIZE_MODE_FULL or info.size < threshold
            if bucket is None or not small:
                skipped.append(info)
            else:
                by_bucket[bucket].append(info)
        compact = {}
        for bucket, files in by_bucket.items():
            if len(files) > 1:
                compact[bucket] = files
            else:
                skipped.extend(files)  # a single candidate has nothing to merge.
        self._partition = (compact, skipped)
        return self._partition

    def validate(self) -> None:
        latest = self.log_manager.get_latest_log()
        if latest is None or latest.state != States.ACTIVE:
            raise HyperspaceException(
                f"Optimize is only supported in {States.ACTIVE} state; "
                f"found {latest.state if latest else 'no log'}")
        if self.previous_entry.derivedDataset.kind != "CoveringIndex":
            raise HyperspaceException("Optimize is only supported on covering indexes.")
        compact, _ = self._files_to_optimize()
        if not compact:
            raise NoChangesException(
                "Optimize aborted as no optimizable index files smaller than "
                f"{self.session.hs_conf.optimize_file_size_threshold()} found.")

    def op(self) -> None:
        prev = self.previous_entry
        compact, skipped = self._files_to_optimize()
        version = self._new_version()
        out_dir = self.data_manager.get_path(version)
        file_utils.makedirs(out_dir)
        row_group_size = self.session.hs_conf.index_row_group_size()
        new_paths: List[str] = []
        for bucket in sorted(compact):
            table = read_parquet([f.name for f in compact[bucket]], list(prev.schema.names),
                                 self.session.device)
            # Restore the within-bucket order over the indexed columns.
            perm = kernels.lex_sort_indices(
                [table.column(c).data for c in prev.indexed_columns])
            out_path = os.path.join(out_dir, index_build.bucket_file_name(bucket))
            write_parquet(table.take(perm), out_path, row_group_size=row_group_size)
            new_paths.append(out_path)
        tracker = FileIdTracker()
        tracker.add_file_info(prev.source_file_info_set)
        index_content = Content.from_leaf_files([f.name for f in skipped] + new_paths, tracker)
        self._entry = IndexLogEntry.create(
            prev.name, prev.derivedDataset, index_content, prev.source,
            dict(prev.properties)).with_log_version(version)

    def event(self, message: str) -> _ev.OptimizeActionEvent:
        return _ev.OptimizeActionEvent(message=message, index_name=self.previous_entry.name)
