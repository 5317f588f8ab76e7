"""Data-skipping index actions: create, full refresh and incremental
refresh of a per-file sketch table (counterpart of
``hyperspace_tpu/actions/create_skipping.py``). The sketch table holds
one row per source data file:

    _file (string, full path) | _file_id (int64)
    | minmax__<col>__min / minmax__<col>__max   (source column type)
    | bloom__<col>                              (binary packed bitset)
    | valuelist__<col>                          (list of source type)

stored as a single parquet file per index data version. Sketch values are
device reductions over each file's column (ops/sketches.py); the table
itself is tiny and is read host-side at plan time.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from ..exceptions import HyperspaceException
from ..execution.columnar import read_parquet
from ..index import data_store
from ..index.constants import States
from ..index.data_manager import IndexDataManager
from ..index.log_entry import (Content, DataSkippingIndex, Directory, FileIdTracker,
                               IndexLogEntry, Sketch)
from ..index.log_manager import IndexLogManager
from ..ops import sketches as sk
from ..parallel import io as pio
from ..plan.nodes import Scan
from ..schema import INT64, STRING, Field, Schema
from ..telemetry import events as _ev
from ..util import file_utils
from ..util.file_utils import file_info_triple
from ..util.resolver import resolve_all
from .action import Action
from .create import build_source, validate_source
from .refresh import RefreshActionBase

SKETCH_FILE_NAME = "sketches.parquet"
FILE_COL = "_file"
FILE_ID_COL = "_file_id"


def minmax_cols(column: str) -> tuple:
    return f"minmax__{column}__min", f"minmax__{column}__max"


def bloom_col(column: str) -> str:
    return f"bloom__{column}"


def valuelist_col(column: str) -> str:
    return f"valuelist__{column}"


def build_sketch_rows(relation, sketch_list: List[Sketch], files: List[str],
                      tracker: FileIdTracker, device) -> Dict[str, list]:
    """One sketch row per file; device reductions per (file, sketch). The
    reads run ahead on the reader pool (file k+1 decodes while file k's
    reductions run), and the loop takes the files in order, so the
    tracker's ids and the row order, and with them the table's bytes, are
    the JAX package's at any thread count."""
    needed = sorted({s.column for s in sketch_list})
    rows: Dict[str, list] = {FILE_COL: [], FILE_ID_COL: []}
    for s in sketch_list:
        if s.kind == "MinMax":
            lo, hi = minmax_cols(s.column)
            rows[lo] = []
            rows[hi] = []
        elif s.kind == "BloomFilter":
            rows[bloom_col(s.column)] = []
        elif s.kind == "ValueList":
            rows[valuelist_col(s.column)] = []
        else:
            raise HyperspaceException(f"Unknown sketch kind: {s.kind}")
    fmt = relation.data_file_format
    for path, table in pio.zip_prefetch(
            files, lambda f: read_parquet([f], needed, device, fmt=fmt), weight=os.path.getsize,
            label="sketch_build"):
        rows[FILE_COL].append(path)
        rows[FILE_ID_COL].append(tracker.add_file(*file_info_triple(path)))
        for s in sketch_list:
            col = table.column(s.column)
            if s.kind == "MinMax":
                lo, hi = minmax_cols(s.column)
                mn, mx = sk.minmax_values(col)
                rows[lo].append(mn)
                rows[hi].append(mx)
            elif s.kind == "ValueList":
                rows[valuelist_col(s.column)].append(
                    sk.value_list(col, int(s.properties["maxValues"])))
            else:
                rows[bloom_col(s.column)].append(sk.bloom_build(
                    col, int(s.properties["numBits"]),
                    int(s.properties["numHashes"])).tobytes())
    return rows


def sketch_arrow_schema(relation_schema: Schema, sketch_list: List[Sketch]) -> pa.Schema:
    fields = [pa.field(FILE_COL, pa.string()), pa.field(FILE_ID_COL, pa.int64())]
    for s in sketch_list:
        if s.kind in ("MinMax", "ValueList"):
            arrow_t = Schema([relation_schema.field(s.column)]).to_arrow().field(0).type
            if s.kind == "MinMax":
                lo, hi = minmax_cols(s.column)
                fields.append(pa.field(lo, arrow_t))
                fields.append(pa.field(hi, arrow_t))
            else:
                # A null list (over-cardinality file) means "no information".
                fields.append(pa.field(valuelist_col(s.column), pa.list_(arrow_t)))
        else:
            fields.append(pa.field(bloom_col(s.column), pa.binary()))
    return pa.schema(fields)


def sketch_table(rows: Dict[str, list], arrow_schema: pa.Schema) -> pa.Table:
    return pa.table({f.name: pa.array(rows[f.name], type=f.type) for f in arrow_schema},
                    schema=arrow_schema)


def write_sketch_table(rows: Dict[str, list], arrow_schema: pa.Schema,
                       out_dir: str) -> str:
    return _write_sketch_file(sketch_table(rows, arrow_schema), out_dir)


def _write_sketch_file(table: pa.Table, out_dir: str) -> str:
    file_utils.makedirs(out_dir)
    path = os.path.join(out_dir, SKETCH_FILE_NAME)
    fs, norm = data_store.fs_and_path(path)
    pq.write_table(table, norm, filesystem=fs)
    return path


def logical_sketch_schema(relation_schema: Schema, sketch_list: List[Sketch]) -> Schema:
    """The part of the sketch table describable in the logical type system
    (bloom binary columns are carried by sketch properties instead)."""
    fields = [Field(FILE_COL, STRING, False), Field(FILE_ID_COL, INT64, False)]
    for s in sketch_list:
        if s.kind == "MinMax":
            src = relation_schema.field(s.column)
            lo, hi = minmax_cols(s.column)
            fields.append(Field(lo, src.dtype, True))
            fields.append(Field(hi, src.dtype, True))
    return Schema(fields)


class CreateDataSkippingAction(Action):
    transient_state = States.CREATING
    final_state = States.ACTIVE

    def __init__(self, session, df, index_config, log_manager: IndexLogManager,
                 data_manager: IndexDataManager):
        super().__init__(session, log_manager)
        self.data_manager = data_manager
        self.df = df
        self.index_config = index_config
        self._entry: Optional[IndexLogEntry] = None
        self._sketches: Optional[List[Sketch]] = None

    def _resolved_sketches(self) -> List[Sketch]:
        if self._sketches is None:
            names = self.df.plan.schema.names
            cs = self.session.hs_conf.case_sensitive()
            self._sketches = [
                Sketch(spec.kind, resolve_all(names, [spec.column], case_sensitive=cs)[0],
                       spec.properties())
                for spec in self.index_config.sketches]
        return self._sketches

    def validate(self) -> None:
        validate_source(self.session, self.df.plan)
        self._resolved_sketches()
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != States.DOESNOTEXIST:
            raise HyperspaceException(
                f"Another index with name {self.index_config.index_name} already exists")

    def _build_entry(self, content: Content, tracker: FileIdTracker) -> IndexLogEntry:
        relation = self.df.plan.relation
        sketch_list = self._resolved_sketches()
        derived = DataSkippingIndex(
            sketches=sketch_list,
            schema=logical_sketch_schema(relation.schema, sketch_list))
        entry = IndexLogEntry.create(self.index_config.index_name, derived, content,
                                     build_source(relation, self.df.plan, tracker), {})
        return entry.with_log_version(0)

    def op(self) -> None:
        relation = self.df.plan.relation
        sketch_list = self._resolved_sketches()
        tracker = FileIdTracker()
        rows = build_sketch_rows(relation, sketch_list, relation.all_files(), tracker,
                                 self.session.device)
        out_dir = self.data_manager.get_path(0)
        write_sketch_table(rows, sketch_arrow_schema(relation.schema, sketch_list), out_dir)
        self._entry = self._build_entry(Content.from_directory(out_dir, tracker), tracker)

    @property
    def log_entry(self) -> IndexLogEntry:
        if self._entry is not None:
            return self._entry
        # begin() runs before op(): write a placeholder entry.
        return self._build_entry(Content(root=Directory("/")), FileIdTracker())

    def event(self, message: str) -> _ev.CreateActionEvent:
        return _ev.CreateActionEvent(message=message,
                                     index_name=self.index_config.index_name,
                                     index_config=self.index_config)


class RefreshDataSkippingAction(RefreshActionBase):
    """Full refresh: the whole sketch table rebuilt over the current file
    listing at a new data version."""

    def _commit(self, table: pa.Table, tracker: FileIdTracker) -> None:
        """Write the sketch table at a new data version; the entry over it."""
        prev = self.previous_entry
        version = self._new_version()
        out_dir = self.data_manager.get_path(version)
        _write_sketch_file(table, out_dir)
        source = build_source(self.relation, Scan(self.relation), tracker)
        self._entry = IndexLogEntry.create(
            prev.name, prev.derivedDataset, Content.from_directory(out_dir, tracker),
            source, {}).with_log_version(version)

    def op(self) -> None:
        tracker = FileIdTracker()
        sketch_list = self.previous_entry.derivedDataset.sketches
        rows = build_sketch_rows(self.relation, sketch_list, self.relation.all_files(),
                                 tracker, self.session.device)
        self._commit(sketch_table(rows, sketch_arrow_schema(self.relation.schema,
                                                            sketch_list)), tracker)

    def event(self, message: str) -> _ev.RefreshActionEvent:
        return _ev.RefreshActionEvent(message=message, index_name=self.previous_entry.name)


class RefreshDataSkippingIncrementalAction(RefreshDataSkippingAction):
    """Incremental refresh: the sketch rows of unchanged files kept, those
    of deleted files dropped, the appended files sketched. Rows are keyed
    by file, so deletes need no lineage."""

    def op(self) -> None:
        prev = self.previous_entry
        tracker = self._seeded_tracker()
        sketch_list = prev.derivedDataset.sketches
        # partitioning=None: the file lies under a "v__=<n>" directory,
        # which pyarrow would otherwise read as a column.
        fs, path = data_store.fs_and_path(_sketch_file(prev))
        old = pq.read_table(path, filesystem=fs, partitioning=None)
        deleted = {f.name for f in self.deleted_files}
        kept = old.filter(pa.array([name not in deleted
                                    for name in old.column(FILE_COL).to_pylist()]))
        arrow_schema = sketch_arrow_schema(self.relation.schema, sketch_list)
        new_rows = build_sketch_rows(self.relation, sketch_list,
                                     [f.name for f in self.appended_files], tracker,
                                     self.session.device)
        self._commit(pa.concat_tables([kept.cast(arrow_schema),
                                       sketch_table(new_rows, arrow_schema)]), tracker)

    def event(self, message: str) -> _ev.RefreshIncrementalActionEvent:
        return _ev.RefreshIncrementalActionEvent(message=message,
                                                 index_name=self.previous_entry.name)


def _sketch_file(entry: IndexLogEntry) -> str:
    files = [f for f in entry.content.files if os.path.basename(f) == SKETCH_FILE_NAME]
    if len(files) != 1:
        raise HyperspaceException(
            f"Data-skipping index {entry.name} must have exactly one sketch "
            f"table file; found {len(files)}")
    return files[0]
