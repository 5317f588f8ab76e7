"""CreateAction: validate + build a covering index on the device
(counterpart of ``hyperspace_tpu/actions/create.py``, in-memory build
only: no chunked build, no mesh build, no lineage column).

The JAX package streams a source above ``hyperspace.tpu.maxChunkRows``
rows through its chunked build (``build_sorted_buckets_chunked``). That
path is not ported yet, so such a source is refused with an error naming
it rather than built in memory.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..exceptions import HyperspaceException
from ..execution.columnar import (Table, parquet_row_counts, read_parquet,
                                  write_parquet)
from ..index.constants import IndexConstants, States
from ..index.data_manager import IndexDataManager
from ..index.log_entry import (Content, CoveringIndex, Directory, FileIdTracker,
                               Hdfs, IndexLogEntry, LogicalPlanFingerprint,
                               Relation, Signature, Source, SourcePlan)
from ..index.log_manager import IndexLogManager
from ..index.signatures import IndexSignatureProvider
from ..ops import index_build
from ..plan.nodes import Scan
from ..schema import Schema
from ..util.resolver import resolve_all
from .action import Action


def write_bucket_files(table: Table, bounds, num_buckets: int, out_dir: str,
                       row_group_size: int) -> None:
    """One parquet file per non-empty bucket from bucket-contiguous rows;
    ``bounds[b]``..``bounds[b+1]`` delimit bucket b."""
    for b in range(num_buckets):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        if hi <= lo:
            continue  # empty buckets produce no file.
        write_parquet(table.slice(lo, hi),
                      os.path.join(out_dir, index_build.bucket_file_name(b)),
                      row_group_size=row_group_size)


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


class CreateAction(Action):
    transient_state = States.CREATING
    final_state = States.ACTIVE

    def __init__(self, session, df, index_config, log_manager: IndexLogManager,
                 data_manager: IndexDataManager):
        super().__init__(session, log_manager)
        self.data_manager = data_manager
        self.df = df
        self.index_config = index_config
        self._entry: Optional[IndexLogEntry] = None
        self._resolved: Optional[tuple] = None

    def _num_buckets(self) -> int:
        return self.session.hs_conf.num_bucket_count()

    def validate(self) -> None:
        plan = self.df.plan
        validate_source(self.session, plan)
        self._resolve_columns()
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != States.DOESNOTEXIST:
            raise HyperspaceException(
                f"Another index with name {self.index_config.index_name} already exists")
        rows = sum(parquet_row_counts(plan.relation.all_files()))
        budget = self.session.hs_conf.max_chunk_rows()
        if rows > budget:
            raise HyperspaceException(
                f"Source has {rows} rows, above {IndexConstants.TPU_MAX_CHUNK_ROWS}"
                f"={budget}: the chunked build (build_sorted_buckets_chunked) is "
                "not ported to this package yet; raise the budget to build in "
                "device memory")

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

    def _write_index_files(self, relation, indexed: List[str],
                           included: List[str]) -> None:
        """Read the index columns, hash-partition + sort on the device,
        then write one parquet file per bucket."""
        table = read_parquet(relation.all_files(), indexed + included,
                             self.session.device)
        num_buckets = self._num_buckets()
        out_dir = self.data_manager.get_path(0)
        os.makedirs(out_dir, exist_ok=True)
        sorted_table, bounds = index_build.build_sorted_buckets(
            table, indexed, num_buckets)
        # One wholesale fetch; the per-bucket writes then slice host memory.
        write_bucket_files(sorted_table.to_host(), bounds, num_buckets, out_dir,
                           self.session.hs_conf.index_row_group_size())

    def _index_properties(self, relation) -> dict:
        props = {}
        if relation.file_format == "parquet":
            props[IndexConstants.HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY] = "true"
        return props

    def _build_entry(self, content: Content, tracker: FileIdTracker) -> IndexLogEntry:
        indexed, included = self._resolve_columns()
        relation = self.df.plan.relation
        index_schema = Schema([self.df.plan.schema.field(c) for c in indexed + included])
        derived = CoveringIndex(indexed, included, index_schema, self._num_buckets(),
                                self._index_properties(relation))
        entry = IndexLogEntry.create(self.index_config.index_name, derived, content,
                                     build_source(relation, self.df.plan, tracker), {})
        return entry.with_log_version(0)

    def op(self) -> None:
        indexed, included = self._resolve_columns()
        self._write_index_files(self.df.plan.relation, indexed, included)
        # The final entry records the index files just written.
        tracker = FileIdTracker()
        content = Content.from_directory(self.data_manager.get_path(0), tracker)
        self._entry = self._build_entry(content, tracker)

    @property
    def log_entry(self) -> IndexLogEntry:
        if self._entry is not None:
            return self._entry
        # begin() runs before op(): write a placeholder entry.
        return self._build_entry(Content(root=Directory("/")), FileIdTracker())
