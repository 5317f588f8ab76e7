"""CreateAction: validate + build a covering index on the device
(counterpart of ``hyperspace_tpu/actions/create.py``).

``CreateActionBase`` is the machinery create shares with the refresh and
optimize actions: the projected read with the optional lineage column, the
in-memory build (over the whole mesh when it has more than one device),
the chunked build for a source above ``hyperspace.tpu.maxChunkRows`` rows,
and the log entry's assembly.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import pyarrow.parquet as pq
import torch

from ..exceptions import HyperspaceException
from ..execution.columnar import Column, Table, parquet_row_counts, write_parquet
from ..index.constants import IndexConstants, States
from ..index.data_manager import IndexDataManager
from ..index.log_entry import (Content, CoveringIndex, Directory, FileIdTracker,
                               Hdfs, IndexLogEntry, LogicalPlanFingerprint,
                               Relation, Signature, Source, SourcePlan)
from ..index.log_manager import IndexLogManager
from ..index.signatures import IndexSignatureProvider
from ..ops import index_build
from ..parallel import io as pio
from ..plan.nodes import Scan
from ..schema import INT64, Field, Schema
from ..sources.partitions import read_relation_files
from ..telemetry import events as _ev
from ..util import file_utils
from ..util.file_utils import file_info_triple
from ..util.resolver import resolve_all
from .action import Action


def write_bucket_files(table: Table, bounds, num_buckets: int, out_dir: str,
                       row_group_size: int, file_name=None) -> None:
    """One parquet file per non-empty bucket from bucket-contiguous rows;
    ``bounds[b]``..``bounds[b+1]`` delimit bucket b. ``file_name(b)``
    names bucket b's file (default ``index_build.bucket_file_name``). The
    table is fetched to the host at once (a no-op for a host table), then
    the files are written over threads, each by one."""
    name_for = file_name or index_build.bucket_file_name
    table = table.to_host()
    bounds = [int(x) for x in bounds]
    # Empty buckets produce no file.
    runs = [(b, bounds[b], bounds[b + 1]) for b in range(num_buckets)
            if bounds[b + 1] > bounds[b]]

    def write(run) -> None:
        b, lo, hi = run
        write_parquet(table.slice(lo, hi), os.path.join(out_dir, name_for(b)),
                      row_group_size=row_group_size)

    pio.run_all(write, runs)


def build_source(relation, plan, tracker: FileIdTracker) -> Source:
    """The entry's source description: the relation's files (ids from
    ``tracker``) and the plan's fingerprint."""
    source_content = Content.from_leaf_files(relation.all_files(), tracker)
    rel_meta = Relation(relation.root_paths, Hdfs(source_content),
                        relation.schema, relation.file_format, relation.options)
    provider = IndexSignatureProvider()
    fingerprint = LogicalPlanFingerprint(
        [Signature(provider.name(), provider.signature(plan))])
    return Source(SourcePlan([rel_meta], fingerprint))


def validate_source(session, plan) -> None:
    """An index is built over a plain scan of a supported relation."""
    if not isinstance(plan, Scan):
        raise HyperspaceException(
            "Only creating an index over a plain scan of a file-based "
            "relation is supported (no filters/joins under createIndex)")
    if not session.source_provider_manager.is_supported_relation(plan):
        raise HyperspaceException(f"Relation is not supported: {plan.relation.describe()}")


class CreateActionBase(Action):
    """What create and the full and incremental refreshes share."""

    def __init__(self, session, log_manager: IndexLogManager,
                 data_manager: IndexDataManager):
        super().__init__(session, log_manager)
        self.data_manager = data_manager

    def _num_buckets(self) -> int:
        return self.session.hs_conf.num_bucket_count()

    def _lineage_enabled(self) -> bool:
        return self.session.hs_conf.index_lineage_enabled()

    def _load_projected(self, relation, indexed: List[str], included: List[str],
                        tracker: FileIdTracker, files: Optional[List[str]] = None) -> Table:
        """The index columns of ``files`` (default: all the relation's) on
        the device, with the lineage column when enabled: each row's
        source-file id, numbered by ``tracker`` in file order."""
        files = list(files) if files is not None else relation.all_files()
        table = read_relation_files(relation, files, indexed + included, self.session.device)
        if self._lineage_enabled():
            if relation.data_file_format != "parquet":
                raise HyperspaceException("Lineage requires parquet sources in this version")
            ids = [tracker.add_file(*file_info_triple(f)) for f in files]
            lineage = np.repeat(np.asarray(ids, np.int64),
                                np.asarray(parquet_row_counts(files), np.int64))
            table = table.with_column(
                IndexConstants.DATA_FILE_NAME_ID,
                Column(INT64, torch.from_numpy(lineage).to(self.session.device)))
        return table

    def _write_index_files(self, table: Table, indexed: List[str], version: int) -> str:
        """Hash-partition + sort on the device, then one parquet file per
        bucket under the version's directory. With more than one device in
        the mesh the build runs over all of them (one bucket exchange,
        ``parallel/distributed_build.py``)."""
        num_buckets = self._num_buckets()
        out_dir = self.data_manager.get_path(version)
        file_utils.makedirs(out_dir)
        if self._use_mesh_build(table):
            self._write_index_files_distributed(table, indexed, num_buckets, out_dir)
            return out_dir
        sorted_table, bounds = index_build.build_sorted_buckets(table, indexed, num_buckets)
        # One wholesale fetch; the per-bucket writes then slice host memory.
        write_bucket_files(sorted_table.to_host(), bounds, num_buckets, out_dir,
                           self.session.hs_conf.index_row_group_size())
        return out_dir

    def _use_mesh_build(self, table: Table) -> bool:
        from ..parallel.mesh import mesh_devices
        from ..telemetry.logging import emit_distributed_fallback
        if not self.session.hs_conf.distributed_enabled():
            return False
        if len(mesh_devices(self.session)) <= 1:
            return False
        if table.num_rows == 0:
            emit_distributed_fallback(self.session, "index_build", "empty source table")
            return False
        # The query dispatch's cost gate (distributed.minStreamRows; 0
        # disables it).
        min_rows = self.session.hs_conf.distributed_min_stream_rows()
        if 0 < table.num_rows < min_rows:
            emit_distributed_fallback(
                self.session, "index_build",
                f"source {table.num_rows} rows below distributed.minStreamRows {min_rows}")
            return False
        return True

    def _write_index_files_distributed(self, table: Table, indexed: List[str],
                                       num_buckets: int, out_dir: str) -> None:
        """The mesh build: device ``i`` holds exactly the buckets of its
        range, each sorted, so each bucket's file is a slice of one
        device's rows (the single-device build's layout)."""
        from ..parallel.distributed_build import distributed_build_sorted_buckets
        from ..parallel.mesh import session_mesh

        tables, bids = distributed_build_sorted_buckets(
            table, indexed, num_buckets, session_mesh(self.session))
        row_group_size = self.session.hs_conf.index_row_group_size()
        for t, b in zip(tables, bids):
            bounds = torch.searchsorted(b.to(torch.int64), torch.arange(
                num_buckets + 1, device=b.device)).cpu().numpy()
            write_bucket_files(t, bounds, num_buckets, out_dir, row_group_size)

    def _build_chunked(self, relation, indexed: List[str], included: List[str],
                       tracker: FileIdTracker, version: int,
                       files: Optional[List[str]] = None) -> bool:
        """The chunked build when the source holds more rows than the
        device budget; False (nothing done) when the in-memory build
        should run instead, as it must for a source that is not parquet, a
        hive partition column or a struct leaf (no row groups or no
        physical column for the streaming reader)."""
        files = list(files) if files is not None else relation.all_files()
        if not files or relation.data_file_format != "parquet":
            return False
        physical = set(pq.read_schema(files[0]).names)
        if any(c not in physical for c in indexed + included):
            return False
        chunk_rows = self.session.hs_conf.max_chunk_rows()
        if sum(parquet_row_counts(files)) <= chunk_rows:
            return False
        lineage_ids = None
        if self._lineage_enabled():
            lineage_ids = [tracker.add_file(*file_info_triple(f)) for f in files]
        out_dir = self.data_manager.get_path(version)
        file_utils.makedirs(out_dir)
        index_build.build_sorted_buckets_chunked(
            files, indexed + included, indexed, self._num_buckets(), chunk_rows, out_dir,
            self.session.hs_conf.index_row_group_size(), self.session.device,
            lineage_ids=lineage_ids, lineage_col=IndexConstants.DATA_FILE_NAME_ID)
        return True

    def _base_index_properties(self, relation) -> dict:
        props = {}
        if self._lineage_enabled():
            props[IndexConstants.LINEAGE_PROPERTY] = "true"
        if relation.data_file_format == "parquet":
            props[IndexConstants.HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY] = "true"
        return props

    def _index_properties(self, relation) -> dict:
        """The standard properties, then the source's own (a delta table's
        version history), keyed by the log id this action commits at."""
        return relation.enrich_index_properties(self._base_index_properties(relation),
                                                self.end_id)

    def _build_entry(self, name: str, relation, plan, indexed: List[str],
                     included: List[str], index_schema: Schema, tracker: FileIdTracker,
                     index_content: Content) -> IndexLogEntry:
        derived = CoveringIndex(indexed, included, index_schema, self._num_buckets(),
                                self._index_properties(relation))
        return IndexLogEntry.create(name, derived, index_content,
                                    build_source(relation, plan, tracker), {})


class CreateAction(CreateActionBase):
    transient_state = States.CREATING
    final_state = States.ACTIVE

    def __init__(self, session, df, index_config, log_manager: IndexLogManager,
                 data_manager: IndexDataManager):
        super().__init__(session, log_manager, data_manager)
        self.df = df
        self.index_config = index_config
        self._entry: Optional[IndexLogEntry] = None
        self._resolved: Optional[tuple] = None

    def validate(self) -> None:
        validate_source(self.session, self.df.plan)
        self._resolve_columns()
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != States.DOESNOTEXIST:
            raise HyperspaceException(
                f"Another index with name {self.index_config.index_name} already exists")

    def _resolve_columns(self):
        if self._resolved is None:
            schema_names = self.df.plan.schema.names
            cs = self.session.hs_conf.case_sensitive()
            indexed = resolve_all(schema_names, self.index_config.indexed_columns,
                                  case_sensitive=cs)
            included = resolve_all(schema_names, self.index_config.included_columns,
                                   case_sensitive=cs)
            dup = set(indexed) & set(included)
            if dup:
                raise HyperspaceException(
                    f"Columns in both indexed and included: {sorted(dup)}")
            self._resolved = (indexed, included)
        return self._resolved

    def _index_schema(self, with_lineage: bool) -> Schema:
        indexed, included = self._resolve_columns()
        schema = Schema([self.df.plan.schema.field(c) for c in indexed + included])
        if with_lineage:
            schema = schema.append(Field(IndexConstants.DATA_FILE_NAME_ID, INT64, False))
        return schema

    def op(self) -> None:
        indexed, included = self._resolve_columns()
        relation = self.df.plan.relation
        tracker = FileIdTracker()
        if not self._build_chunked(relation, indexed, included, tracker, version=0):
            table = self._load_projected(relation, indexed, included, tracker)
            self._write_index_files(table, indexed, version=0)
        # The final entry records the index files just written.
        content = Content.from_directory(self.data_manager.get_path(0), tracker)
        self._entry = self._build_entry(
            self.index_config.index_name, relation, self.df.plan, indexed, included,
            self._index_schema(self._lineage_enabled()), tracker, content
        ).with_log_version(0)

    @property
    def log_entry(self) -> IndexLogEntry:
        if self._entry is not None:
            return self._entry
        # begin() runs before op(): write a placeholder entry.
        indexed, included = self._resolve_columns()
        return self._build_entry(
            self.index_config.index_name, self.df.plan.relation, self.df.plan, indexed,
            included, self._index_schema(False), FileIdTracker(),
            Content(root=Directory("/"))).with_log_version(0)

    def event(self, message: str) -> _ev.CreateActionEvent:
        return _ev.CreateActionEvent(message=message,
                                     index_name=self.index_config.index_name,
                                     index_config=self.index_config)
