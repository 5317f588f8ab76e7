"""Append/commit ingestion with load-time indexing (counterpart of
``hyperspace_tpu/streaming/ingest.py``).

- ``append(session, table, batch)`` writes the batch as a parquet file into
  the table's hidden staging directory (no scan sees a ``_``-prefixed
  name) and, while its rows are on the device, prebuilds one delta for each
  ACTIVE index over the table: bucket-routed, sorted part files for a
  covering index (``index_build.build_sorted_buckets``: the hash_bucket and
  bucket_histogram kernels), one sketch row for a data-skipping index
  (``sketches.minmax_values``: the masked_minmax kernel; value lists and
  Bloom bits).
- ``commit(session, table)`` publishes them through the op-log protocol:
  one per-table streaming log entry (put-if-absent decides races between
  committers) brackets the batch files' renames and each index's delta
  landing, itself a two-phase action on the index's own log. The indexes'
  entries then cover the new files, so queries serve from exact
  IndexScans with no refresh pass, and the result cache's log-version keys
  change with every commit.
- Group commit (``CommitCoordinator``, on by default): concurrent
  ``commit()`` callers coalesce into one publication wave, one table-log
  entry, one delta landing per index, one standing-query fire and one
  cluster broadcast (cluster/worker.py: the notice that fires standing
  queries on the fleet's other workers).

Crash safety (``recover()``): a commit that died before all its batch
files landed is undone (landed files deleted, the log cancelled, staging
swept); one that died after all of them landed is redone (the final entry
written). An index delta's wreck recovers through the ordinary index sweep.

Telemetry: ``ingest.append``, ``ingest.commit`` and ``ingest.wave`` spans
(a maintenance trace of their own when no query trace is active) and the
StreamingAppend, StreamingCommit, StreamingIndexDelta and StreamingWave
events; the commit queue is the ``streaming`` collector.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from typing import Dict, List, Optional

import pyarrow as pa
import pyarrow.parquet as pq
import torch

from ..actions.action import Action
from ..exceptions import HyperspaceException
from ..index.constants import STABLE_STATES, IndexConstants, States
from ..index import data_store
from ..index.data_manager import IndexDataManager
from ..index.log_entry import (Content, FileIdTracker, FileInfo, Hdfs, IndexLogEntry,
                               IngestedTable, LogicalPlanFingerprint, Relation, Signature,
                               Source, SourcePlan)
from ..index.log_manager import IndexLogManager, get_lookup_cache
from ..index.path_resolver import PathResolver
from ..robustness import fault_names as _fn
from ..robustness import faults as _faults
from ..schema import Schema
from ..telemetry import events as _ev
from ..telemetry import span_names as SN
from ..telemetry import trace as _trace
from ..util import file_utils, hashing
from .constants import StreamingConstants as SC


# ---------------------------------------------------------------------------
# Staged batches.
# ---------------------------------------------------------------------------

class _CoveringDelta:
    """Prebuilt bucket-aligned part files for one covering index, in the
    index's staging directory. ``layout`` pins the (num_buckets, indexed,
    included, lineage) the delta was routed with: a refresh or recreate
    between append and commit can change any of them."""

    __slots__ = ("index_name", "index_path", "staged_dir", "lineage_id", "layout")

    def __init__(self, index_name: str, index_path: str, staged_dir: str,
                 lineage_id: Optional[int], layout: tuple):
        self.index_name = index_name
        self.index_path = index_path
        self.staged_dir = staged_dir
        self.lineage_id = lineage_id
        self.layout = layout


def _covering_layout(entry: IndexLogEntry) -> tuple:
    return (entry.num_buckets, tuple(entry.indexed_columns),
            tuple(entry.included_columns), entry.has_lineage_column())


class _SketchDelta:
    """One precomputed sketch row (per batch file) for a skipping index; its
    file id is assigned at commit. ``layout`` pins the sketch set."""

    __slots__ = ("index_name", "index_path", "values", "layout")

    def __init__(self, index_name: str, index_path: str, values: Dict, layout: tuple):
        self.index_name = index_name
        self.index_path = index_path
        self.values = values  # sketch column -> value (FILE_COL included)
        self.layout = layout


def _sketch_layout(entry: IndexLogEntry) -> tuple:
    return tuple(sorted((s.kind, s.column, tuple(sorted(s.properties.items())))
                        for s in entry.derivedDataset.sketches))


class StagedBatch:
    __slots__ = ("batch_id", "table_path", "staged_path", "final_path", "rows", "nbytes",
                 "mtime_ms", "schema", "covering", "sketches")

    def __init__(self, batch_id: str, table_path: str, staged_path: str, final_path: str,
                 rows: int, nbytes: int, mtime_ms: int, schema: Schema):
        self.batch_id = batch_id
        self.table_path = table_path
        self.staged_path = staged_path
        self.final_path = final_path
        self.rows = rows
        self.nbytes = nbytes
        self.mtime_ms = mtime_ms
        self.schema = schema
        self.covering: List[_CoveringDelta] = []
        self.sketches: List[_SketchDelta] = []


class CommitQueue:
    """The process-wide staging state: staged batches per table, per-table
    append and commit locks, the schema memo and the tier's counters. Every
    mutation holds ``_lock``."""

    def __init__(self):
        self._lock = threading.Lock()
        # Blocking appends park here; every mutation that frees budget
        # (land, abandon, drop_table) notifies.
        self._space = threading.Condition(self._lock)
        self._staged: Dict[str, List[StagedBatch]] = {}
        # Batches an in-flight commit popped still count toward the lineage
        # base of concurrent appends until they land or requeue.
        self._inflight: Dict[str, List[StagedBatch]] = {}
        self._table_locks: Dict[str, threading.Lock] = {}
        self._commit_locks: Dict[str, threading.Lock] = {}
        self._schemas: Dict[str, object] = {}
        self._stats = {
            "appends": 0, "commits": 0, "batches_committed": 0,
            "rows_staged": 0, "rows_committed": 0,
            "covering_deltas": 0, "sketch_deltas": 0,
            "commit_conflicts": 0, "subscription_fires": 0,
        }

    def table_lock(self, table: str) -> threading.Lock:
        with self._lock:
            return self._table_locks.setdefault(table, threading.Lock())

    def commit_lock(self, table: str) -> threading.Lock:
        with self._lock:
            return self._commit_locks.setdefault(table, threading.Lock())

    def push(self, batch: StagedBatch, max_staged: int, block: bool = False,
             timeout_s: Optional[float] = None) -> None:
        """Stage one batch: raise on a full table (``staged + in-flight >=
        max_staged``), or with ``block=True`` wait for a commit to free
        budget, up to ``timeout_s``."""
        with self._lock:
            if block:
                self._await_space(batch.table_path, max_staged, timeout_s)
            staged = self._staged.setdefault(batch.table_path, [])
            pending = len(staged) + len(self._inflight.get(batch.table_path, []))
            if pending >= max_staged:
                raise HyperspaceException(
                    f"{batch.table_path}: {pending} staged/in-flight batches reach "
                    "hyperspace.tpu.streaming.maxStagedBatches; commit() before "
                    "appending more")
            staged.append(batch)
            self._stats["appends"] += 1
            self._stats["rows_staged"] += batch.rows
            self._stats["covering_deltas"] += len(batch.covering)
            self._stats["sketch_deltas"] += len(batch.sketches)

    def wait_for_space(self, table: str, max_staged: int,
                       timeout_s: Optional[float] = None) -> None:
        with self._lock:
            self._await_space(table, max_staged, timeout_s)

    def _await_space(self, table: str, max_staged: int, timeout_s: Optional[float]) -> None:
        # The caller holds _lock; the wait releases it.
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while len(self._staged.get(table, [])) + len(self._inflight.get(table, [])) >= max_staged:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise HyperspaceException(
                    f"{table}: blocked append timed out after {timeout_s:.1f}s waiting for "
                    "staged-batch budget (hyperspace.tpu.streaming.maxStagedBatches; is "
                    "anything committing?)")
            self._space.wait(remaining)

    def pop_wave(self, table: str, limit: Optional[int] = None):
        """Move up to ``limit`` staged batches (all when None) into the
        in-flight set, in order. Returns ``(batches, truncated)``."""
        with self._lock:
            staged = self._staged.get(table, [])
            if limit is None or limit >= len(staged):
                batches = self._staged.pop(table, [])
                truncated = False
            else:
                batches = staged[:limit]
                self._staged[table] = staged[limit:]
                truncated = True
            if batches:
                self._inflight.setdefault(table, []).extend(batches)
            return batches, truncated

    def pop_all(self, table: str) -> List[StagedBatch]:
        batches, _ = self.pop_wave(table)
        return batches

    def _drop_inflight(self, table: str, batches: List[StagedBatch]) -> None:
        flight = self._inflight.get(table, [])
        for b in batches:
            if b in flight:
                flight.remove(b)

    def land(self, table: str, batches: List[StagedBatch]) -> None:
        with self._lock:
            self._drop_inflight(table, batches)
            self._stats["commits"] += 1
            self._stats["batches_committed"] += len(batches)
            self._stats["rows_committed"] += sum(b.rows for b in batches)
            self._space.notify_all()

    def requeue(self, table: str, batches: List[StagedBatch]) -> None:
        """Put the batches of a commit that never started back at the front
        of the queue, in order."""
        with self._lock:
            self._drop_inflight(table, batches)
            self._staged[table] = batches + self._staged.get(table, [])
            self._stats["commit_conflicts"] += 1

    def abandon(self, table: str, batches: List[StagedBatch]) -> None:
        """Forget the batches of a commit that failed after its op started:
        only recover() resolves that wreck, and their staged files stay on
        disk for its sweep."""
        with self._lock:
            self._drop_inflight(table, batches)
            self._space.notify_all()

    def drop_table(self, table: str) -> List[StagedBatch]:
        """Forget a table's staged state (recovery swept its staging)."""
        with self._lock:
            dropped = self._staged.pop(table, [])
            dropped += self._inflight.pop(table, [])
            self._schemas.pop(table, None)
            self._space.notify_all()
            return dropped

    def has_staged(self, table: str) -> bool:
        with self._lock:
            return bool(self._staged.get(table))

    def table_schema(self, table: str, loader):
        """The memoized table schema; ``loader()`` runs once per table."""
        with self._lock:
            sch = self._schemas.get(table)
        if sch is not None:
            return sch
        sch = loader()
        if sch is not None:
            with self._lock:
                sch = self._schemas.setdefault(table, sch)
        return sch

    def has_pending(self, table: str) -> bool:
        with self._lock:
            return bool(self._staged.get(table) or self._inflight.get(table))

    def forget_schema_if_unused(self, table: str) -> None:
        """Drop the schema memo when no staged or in-flight batch backs it
        (a discarded bootstrap batch must not pin a still-empty table's
        schema)."""
        with self._lock:
            if not self._staged.get(table) and not self._inflight.get(table):
                self._schemas.pop(table, None)

    def staged_delta_count(self, table: str, index_name: str) -> int:
        """How many staged or in-flight batches carry a delta for
        ``index_name``: the lineage-id offset of the next append."""
        with self._lock:
            return sum(1 for b in self._staged.get(table, []) + self._inflight.get(table, [])
                       if any(d.index_name == index_name for d in b.covering))

    def staged_count(self, table: str) -> int:
        with self._lock:
            return len(self._staged.get(table, [])) + len(self._inflight.get(table, []))

    def note(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["tables_staged"] = sum(1 for v in self._staged.values() if v)
            out["batches_staged"] = sum(len(v) for v in self._staged.values())
        out["oplog_cache"] = get_lookup_cache().stats()
        out["group_commit"] = get_coordinator().stats()
        return out


_QUEUE: Optional[CommitQueue] = None
_QUEUE_LOCK = threading.Lock()


def get_queue() -> CommitQueue:
    """The process-wide commit queue; first use registers the
    ``streaming`` collector in the metrics registry."""
    global _QUEUE
    with _QUEUE_LOCK:
        if _QUEUE is None:
            _QUEUE = CommitQueue()
            from ..telemetry import metric_names as MN
            from ..telemetry.metrics import get_registry
            get_registry().register_collector(MN.COLLECTOR_STREAMING, _QUEUE.stats)
        return _QUEUE


# ---------------------------------------------------------------------------
# Group commit.
# ---------------------------------------------------------------------------

class _WaveState:
    """One table's group-commit ledger (guarded by CommitCoordinator._cv).
    ``push_seq`` counts pushes, ``pop_mark`` is the count the in-flight wave
    popped at, ``done_seq`` the count landed waves published through."""

    __slots__ = ("push_seq", "pop_mark", "done_seq", "leader", "generation", "riders",
                 "outcomes")

    def __init__(self):
        self.push_seq = 0
        self.pop_mark = 0
        self.done_seq = 0
        self.leader = False
        self.generation = 0
        self.riders = 0
        self.outcomes: Dict[int, tuple] = {}


class CommitCoordinator:
    """Per-table group commit. One caller leads a wave: it pops the queue
    (sub-waves of at most ``groupCommit.maxWave`` batches) and runs the
    op-log protocol; every caller whose batches the wave covers waits on the
    ledger and returns the wave's outcome. A failed wave raises in the
    leader and every rider."""

    def __init__(self):
        self._cv = threading.Condition()
        self._tables: Dict[str, _WaveState] = {}
        self._stats = {"commit_calls": 0, "waves": 0, "sub_waves": 0, "led": 0, "joined": 0,
                       "wave_batches": 0}

    def note_push(self, table: str) -> None:
        with self._cv:
            self._tables.setdefault(table, _WaveState()).push_seq += 1

    def forget(self, table: str) -> None:
        """Drop a table's ledger (recovery swept its staged state); waiting
        committers return an empty outcome."""
        with self._cv:
            self._tables.pop(table, None)
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return dict(self._stats)

    def commit_grouped(self, session, table_path: str) -> dict:
        """Return once every batch staged for ``table_path`` before this
        call is published (or the wave carrying it failed)."""
        with self._cv:
            self._stats["commit_calls"] += 1
            st = self._tables.setdefault(table_path, _WaveState())
            target = st.push_seq
            while True:
                if st.leader:
                    if st.pop_mark < target:
                        # The in-flight wave popped before our batches
                        # staged: wait it out, then lead or ride the next.
                        self._cv.wait()
                        continue
                    gen = st.generation
                    st.riders += 1
                    self._stats["joined"] += 1
                    while st.generation == gen and self._tables.get(table_path) is st:
                        self._cv.wait()
                    res, err = st.outcomes.get(gen, (None, None))
                    if err is not None:
                        raise err
                    if res is None:
                        return _empty_commit_summary()  # the ledger was forgotten
                    out = dict(res)
                    out["files"] = list(res["files"])
                    out["indexes_updated"] = list(res["indexes_updated"])
                    out["indexes_skipped"] = list(res["indexes_skipped"])
                    out["joined_wave"] = True
                    return out
                if st.done_seq >= target and not get_queue().has_staged(table_path):
                    return _empty_commit_summary()
                st.leader = True
                st.riders = 0
                self._stats["led"] += 1
                break
        return self._lead(session, st, table_path)

    def _lead(self, session, st: _WaveState, table_path: str) -> dict:
        # Any outcome must finalize the generation, or riders wait forever.
        t0 = time.perf_counter()
        agg: Optional[dict] = None
        error: Optional[BaseException] = None
        sub_waves = 0
        try:
            window_s = session.hs_conf.streaming_group_commit_window_ms() / 1000.0
            max_wave = session.hs_conf.streaming_group_commit_max_wave()
            if window_s > 0:
                time.sleep(window_s)  # let appends and committers join
            with _trace.maintenance_trace(session, "ingest"), \
                    _trace.span(SN.INGEST_WAVE) as sp:
                while True:
                    with self._cv:
                        st.pop_mark = st.push_seq
                        self._cv.notify_all()
                    res, truncated = _commit_once(session, table_path, limit=max_wave)
                    sub_waves += 1
                    agg = res if agg is None else _merge_commit_summary(agg, res)
                    if not truncated:
                        break
                if agg["committed_batches"]:
                    agg["subscriptions_fired"] = _fire_subscriptions(
                        session, table_path, batches=agg["committed_batches"])
                agg["sub_waves"] = sub_waves
                agg["seconds"] = time.perf_counter() - t0
                if sp is not None:
                    sp.attrs["batches"] = agg["committed_batches"]
                    sp.attrs["sub_waves"] = sub_waves
                    sp.attrs["joined"] = st.riders
            return agg
        except BaseException as e:
            error = e
            raise
        finally:
            with self._cv:
                gen = st.generation
                st.generation = gen + 1
                st.leader = False
                riders = st.riders
                st.outcomes[gen] = (agg if error is None else None, error)
                for old in [g for g in st.outcomes if g < gen - 3]:
                    del st.outcomes[old]
                if error is None:
                    st.done_seq = max(st.done_seq, st.pop_mark)
                    self._stats["waves"] += 1
                    self._stats["sub_waves"] += sub_waves
                    self._stats["wave_batches"] += agg["committed_batches"] if agg else 0
                self._cv.notify_all()
            if error is None and agg is not None and agg["committed_batches"]:
                _emit_wave(session, table_path, agg, riders, sub_waves)


def _emit_wave(session, table_path: str, agg: dict, riders: int, sub_waves: int) -> None:
    from ..telemetry.events import StreamingWaveEvent
    from ..telemetry.logging import log_event
    log_event(session, StreamingWaveEvent(
        message=f"wave of {agg['committed_batches']} batches ({riders} committers rode it)",
        table=table_path, batches=agg["committed_batches"], rows=agg["rows"], joined=riders,
        sub_waves=sub_waves, seconds=agg["seconds"]))


def _emit_append(session, staged: StagedBatch, seconds: float) -> None:
    from ..telemetry.events import StreamingAppendEvent
    from ..telemetry.logging import log_event
    log_event(session, StreamingAppendEvent(
        message=(f"staged {staged.rows} rows ({len(staged.covering)} covering, "
                 f"{len(staged.sketches)} sketch deltas)"),
        table=staged.table_path, rows=staged.rows, nbytes=staged.nbytes,
        covering_deltas=len(staged.covering), sketch_deltas=len(staged.sketches),
        seconds=seconds))


def _empty_commit_summary() -> dict:
    return {"committed_batches": 0, "rows": 0, "files": [], "indexes_updated": [],
            "indexes_skipped": [], "subscriptions_fired": 0, "seconds": 0.0}


def _merge_commit_summary(agg: dict, res: dict) -> dict:
    agg["committed_batches"] += res["committed_batches"]
    agg["rows"] += res["rows"]
    agg["files"].extend(res["files"])
    for key in ("indexes_updated", "indexes_skipped"):
        for name in res[key]:
            if name not in agg[key]:
                agg[key].append(name)
    agg["seconds"] += res["seconds"]
    return agg


_COORD: Optional[CommitCoordinator] = None
_COORD_LOCK = threading.Lock()


def get_coordinator() -> CommitCoordinator:
    """The process-wide group-commit coordinator."""
    global _COORD
    with _COORD_LOCK:
        if _COORD is None:
            _COORD = CommitCoordinator()
        return _COORD


# ---------------------------------------------------------------------------
# Table plumbing.
# ---------------------------------------------------------------------------

def table_key(table_path: str) -> str:
    """Directory-safe identity of a table path (its streaming log's
    directory under <systemPath>/_streaming/)."""
    table_path = os.path.abspath(table_path)
    return os.path.basename(table_path.rstrip(os.sep)) + "-" + hashing.md5_hex(table_path)[:10]


def table_log_dir(session, table_path: str) -> str:
    return os.path.join(session.hs_conf.system_path(), SC.STREAMING_DIR, table_key(table_path))


def _staged_marker_dir(session) -> str:
    return os.path.join(session.hs_conf.system_path(), SC.STREAMING_DIR, "_staged")


def _note_staged_table(session, table_path: str) -> None:
    """Record where a table with staged batches lives, so recovery finds
    its staging even before its first commit."""
    marker = os.path.join(_staged_marker_dir(session), table_key(table_path))
    if not os.path.exists(marker):
        os.makedirs(_staged_marker_dir(session), exist_ok=True)
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            f.write(table_path)
        os.replace(tmp, marker)


def _to_arrow(batch) -> pa.Table:
    """A pyarrow Table from a Table, RecordBatch, pandas DataFrame or dict
    of columns."""
    if isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, pa.RecordBatch):
        return pa.Table.from_batches([batch])
    if isinstance(batch, dict):
        return pa.table(batch)
    try:
        import pandas as pd
        if isinstance(batch, pd.DataFrame):
            return pa.Table.from_pandas(batch, preserve_index=False)
    except ImportError:
        pass
    raise HyperspaceException(
        f"append() cannot convert {type(batch).__name__} to a record batch (pass a pyarrow "
        "Table/RecordBatch, pandas DataFrame, or dict of columns)")


def _indexes_for_table(session, table_path: str) -> List[IndexLogEntry]:
    """ACTIVE indexes whose one source relation is this parquet directory."""
    out = []
    for entry in session.index_collection_manager.get_indexes([States.ACTIVE]):
        try:
            rel = entry.relation
        except (AssertionError, AttributeError, IndexError, HyperspaceException):
            continue
        if rel.fileFormat == "parquet" and \
                [os.path.abspath(p) for p in rel.rootPaths] == [table_path]:
            out.append(entry)
    return out


def _prev_source_max_id(entry: IndexLogEntry) -> int:
    return max((f.id for f in entry.source_file_info_set), default=-1)


def _staging_dir(base: str) -> str:
    path = os.path.join(base, SC.STAGING_DIR)
    os.makedirs(path, exist_ok=True)
    return path


def _require_enabled(session) -> None:
    if not session.hs_conf.streaming_enabled():
        raise HyperspaceException(
            "hyperspace.tpu.streaming.enabled is false; enable it to use the append/commit "
            "ingestion tier")


# ---------------------------------------------------------------------------
# append().
# ---------------------------------------------------------------------------

def append(session, table_path: str, batch, block: bool = False) -> dict:
    """Stage one record batch for ``table_path`` and prebuild its index
    deltas on the session's device. Nothing is visible to queries until
    ``commit()``. A full staging budget raises, or with ``block=True``
    waits up to ``backpressure.timeoutMs``."""
    _require_enabled(session)
    table_path = os.path.abspath(table_path)
    queue = get_queue()
    timeout_s = session.hs_conf.streaming_backpressure_timeout_ms() / 1000.0
    with queue.table_lock(table_path), _faults.scope_for(session.hs_conf), \
            _trace.maintenance_trace(session, "ingest"), \
            _trace.span(SN.INGEST_APPEND) as sp:
        t0 = time.perf_counter()
        # Backpressure first: a refused append pays neither the parquet
        # write nor the delta builds.
        max_staged = session.hs_conf.streaming_max_staged_batches()
        if block:
            queue.wait_for_space(table_path, max_staged, timeout_s)
        elif queue.staged_count(table_path) >= max_staged:
            raise HyperspaceException(
                f"{table_path}: staged batches reach hyperspace.tpu.streaming.maxStagedBatches;"
                " commit() before appending more")
        at = _to_arrow(batch)
        if at.num_rows == 0:
            raise HyperspaceException("append() got an empty batch")
        os.makedirs(table_path, exist_ok=True)
        _check_schema(queue, table_path, at)
        batch_id = uuid.uuid4().hex[:12]
        staging = _staging_dir(table_path)
        _note_staged_table(session, table_path)
        name = f"{SC.INGEST_FILE_PREFIX}{batch_id}.parquet"
        staged_path = os.path.join(staging, name)
        final_path = os.path.join(table_path, name)
        staged = None
        try:
            _faults.fault_point(_fn.INGEST_STAGE)
            pq.write_table(at, staged_path)
            _, nbytes, mtime_ms = file_utils.file_info_triple(staged_path)
            staged = StagedBatch(batch_id, table_path, staged_path, final_path, at.num_rows,
                                 nbytes, mtime_ms, Schema.from_arrow(at.schema))
            if session.hs_conf.streaming_load_time_indexing():
                # As in an action: the sketch reductions read the session's
                # length classes, the reads its io conf.
                from .. import shapes
                from ..parallel import io as pio
                with shapes.use_conf(session.hs_conf), pio.use_session(session):
                    _prebuild_deltas(session, queue, staged, at)
            queue.push(staged, max_staged, block=block, timeout_s=timeout_s if block else None)
            get_coordinator().note_push(table_path)
        except BaseException:
            # A failed append leaks no staging file and pins no schema its
            # own discarded batch bootstrapped on an empty table.
            if staged is not None:
                _discard_staged(staged)
            else:
                try:
                    os.unlink(staged_path)
                except OSError:
                    pass
            if not queue.has_pending(table_path) and \
                    not any(f.endswith(".parquet")
                            for f in file_utils.list_leaf_files(table_path)):
                queue.forget_schema_if_unused(table_path)
            raise
        seconds = time.perf_counter() - t0
        if sp is not None:
            sp.attrs["rows"] = staged.rows
            sp.attrs["covering_deltas"] = len(staged.covering)
            sp.attrs["sketch_deltas"] = len(staged.sketches)
        _emit_append(session, staged, seconds)
        return {"batch_id": batch_id, "rows": staged.rows,
                "staged_batches": queue.staged_count(table_path),
                "covering_deltas": len(staged.covering),
                "sketch_deltas": len(staged.sketches)}


def _check_schema(queue: CommitQueue, table_path: str, at: pa.Table) -> None:
    """A batch must carry the table's columns and types, memoized per table
    so no append walks the directory."""

    def load():
        existing = [f for f in file_utils.list_leaf_files(table_path) if f.endswith(".parquet")]
        return pq.read_schema(existing[0]) if existing else at.schema

    have = queue.table_schema(table_path, load)
    names = set(have.names)
    got = set(at.schema.names)
    if got != names:
        raise HyperspaceException(
            f"append() schema mismatch for {table_path}: table has {sorted(names)}, batch has "
            f"{sorted(got)}")
    forked = [(n, str(have.field(n).type), str(at.schema.field(n).type))
              for n in sorted(names) if have.field(n).type != at.schema.field(n).type]
    if forked:
        raise HyperspaceException(
            f"append() schema mismatch for {table_path}: column type fork {forked} (table type "
            "vs batch type)")


def _discard_staged(staged: StagedBatch) -> None:
    try:
        os.unlink(staged.staged_path)
    except OSError:
        pass
    for delta in staged.covering:
        shutil.rmtree(delta.staged_dir, ignore_errors=True)


def _prebuild_deltas(session, queue: CommitQueue, staged: StagedBatch, at: pa.Table) -> None:
    """While the batch is in memory, bucket-route it for every covering
    index and sketch it for every skipping index over this table, on the
    session's device. An index whose columns the batch lacks is skipped
    (Hybrid Scan covers its files)."""
    from ..execution.columnar import Table as ExecTable
    entries = _indexes_for_table(session, staged.table_path)
    if not entries:
        return
    resolver = PathResolver(session.hs_conf)
    exec_table = ExecTable.from_arrow(at, session.device)
    for entry in entries:
        index_path = resolver.get_index_path(entry.name)
        kind = getattr(entry.derivedDataset, "kind", "")
        if kind == "CoveringIndex":
            delta = _prebuild_covering(session, queue, staged, exec_table, entry, index_path)
            if delta is not None:
                staged.covering.append(delta)
        elif kind == "DataSkippingIndex":
            delta = _prebuild_sketch(staged, exec_table, entry, index_path)
            if delta is not None:
                staged.sketches.append(delta)


def _prebuild_covering(session, queue: CommitQueue, staged: StagedBatch, exec_table,
                       entry: IndexLogEntry, index_path: str) -> Optional[_CoveringDelta]:
    from ..actions import create
    from ..execution.columnar import Column
    from ..ops import index_build
    from ..schema import INT64
    cols = list(entry.indexed_columns) + list(entry.included_columns)
    if any(c not in exec_table.names for c in cols):
        return None
    table = exec_table.select(cols)
    lineage_id = None
    if entry.has_lineage_column():
        # The commit's seeded tracker numbers batch files prev_max+1, +2,
        # ... in batch order; staged and in-flight batches ahead of this
        # one hold the earlier ids (appends are serialized per table).
        lineage_id = _prev_source_max_id(entry) + 1 + \
            queue.staged_delta_count(staged.table_path, entry.name)
        table = table.with_column(
            IndexConstants.DATA_FILE_NAME_ID,
            Column(INT64, torch.full((table.num_rows,), lineage_id, dtype=torch.int64,
                                     device=exec_table.device)))
    sorted_table, bounds = index_build.build_sorted_buckets(
        table, list(entry.indexed_columns), entry.num_buckets)
    staged_dir = os.path.join(_staging_dir(index_path), staged.batch_id)
    os.makedirs(staged_dir, exist_ok=True)
    suffix = staged.batch_id[:8]

    def name_for(bucket: int) -> str:
        return index_build.bucket_file_name(bucket).replace(".parquet", f"-{suffix}.parquet")

    try:
        create.write_bucket_files(sorted_table, bounds, entry.num_buckets, staged_dir,
                                  session.hs_conf.index_row_group_size(), file_name=name_for)
    except BaseException:
        # The delta never reaches staged.covering: remove it here.
        shutil.rmtree(staged_dir, ignore_errors=True)
        raise
    return _CoveringDelta(entry.name, index_path, staged_dir, lineage_id,
                          _covering_layout(entry))


def _prebuild_sketch(staged: StagedBatch, exec_table, entry: IndexLogEntry,
                     index_path: str) -> Optional[_SketchDelta]:
    from ..actions import create_skipping as cs
    from ..ops import sketches as sk
    sketch_list = entry.derivedDataset.sketches
    if any(s.column not in exec_table.names for s in sketch_list):
        return None
    values: Dict = {cs.FILE_COL: staged.final_path}
    for s in sketch_list:
        col = exec_table.column(s.column)
        if s.kind == "MinMax":
            lo, hi = cs.minmax_cols(s.column)
            values[lo], values[hi] = sk.minmax_values(col)
        elif s.kind == "ValueList":
            values[cs.valuelist_col(s.column)] = sk.value_list(col, int(s.properties["maxValues"]))
        elif s.kind == "BloomFilter":
            values[cs.bloom_col(s.column)] = sk.bloom_build(
                col, int(s.properties["numBits"]), int(s.properties["numHashes"])).tobytes()
        else:
            return None  # an unknown sketch kind: Hybrid Scan covers the file
    return _SketchDelta(entry.name, index_path, values, _sketch_layout(entry))


# ---------------------------------------------------------------------------
# commit(): the op-log protocol around publication and delta landing.
# ---------------------------------------------------------------------------

def _pinned_source(table_path: str, prev: IndexLogEntry, batch_infos: List[FileInfo]) -> Source:
    """The source over exactly the previous entry's files plus this
    commit's batch files (a foreign file landing meanwhile stays a Hybrid
    Scan append). Its fingerprint is the standard provider's over a relation
    pinned to that set, so a fresh query whose listing matches applies the
    index with a plain exact IndexScan."""
    from ..index.signatures import IndexSignatureProvider
    from ..plan.nodes import Scan
    from ..sources.default import DefaultFileBasedRelation
    prev_infos = sorted(prev.source_file_info_set, key=lambda f: f.name)
    paths = sorted([f.name for f in prev_infos] + [f.name for f in batch_infos])
    relation = DefaultFileBasedRelation.pinned([table_path], "parquet", {}, paths,
                                               prev.relation.dataSchema)
    content = _content_over(prev_infos + list(batch_infos))
    rel_meta = Relation(rootPaths=[table_path], data=Hdfs(content),
                        dataSchema=relation.schema, fileFormat="parquet", options={})
    provider = IndexSignatureProvider()
    fingerprint = LogicalPlanFingerprint(
        [Signature(provider.name(), provider.signature(Scan(relation)))])
    return Source(SourcePlan([rel_meta], fingerprint))


def _content_over(infos: List[FileInfo]) -> Content:
    from ..actions.refresh import content_from_file_infos
    content = content_from_file_infos(list(infos))
    if content is None:
        raise HyperspaceException("cannot build content over zero files")
    return content


def _rewrite_lineage(staged_dir: str, fid: int, row_group_size: int) -> None:
    """Repair a drifted lineage prediction: rewrite each staged bucket
    file's constant ``_data_file_id`` column to the committed id, at the
    index's row-group size."""
    col_name = IndexConstants.DATA_FILE_NAME_ID
    for fname in sorted(os.listdir(staged_dir)):
        path = os.path.join(staged_dir, fname)
        table = pq.read_table(path, partitioning=None)
        if col_name not in table.schema.names:
            continue
        idx = table.schema.get_field_index(col_name)
        fixed = pa.array([fid] * table.num_rows, type=table.schema.field(idx).type)
        pq.write_table(table.set_column(idx, col_name, fixed), path,
                       row_group_size=row_group_size)


def _carry_props(prev: IndexLogEntry) -> Dict[str, str]:
    """Entry properties a delta carries forward: the compaction generation,
    so entries after a compaction keep it in their bytes."""
    gen = prev.properties.get(SC.COMPACTION_GENERATION_PROPERTY)
    return {SC.COMPACTION_GENERATION_PROPERTY: gen} if gen is not None else {}


class _LandDeltasBase(Action):
    """The per-index delta landings of one commit: each re-anchors on the
    index's latest ACTIVE entry and runs the two-phase protocol on the
    index's own log, so a crash here recovers through the index sweep."""

    transient_state = States.REFRESHING
    final_state = States.ACTIVE

    def __init__(self, session, log_manager: IndexLogManager, data_manager: IndexDataManager,
                 table_path: str, pairs: List[tuple]):
        super().__init__(session, log_manager)
        self.data_manager = data_manager
        self.table_path = table_path
        self.pairs = pairs  # [(StagedBatch, delta)] in batch order
        self.index_name = pairs[0][1].index_name
        self._prev: Optional[IndexLogEntry] = None
        self._entry: Optional[IndexLogEntry] = None

    @property
    def prev_entry(self) -> IndexLogEntry:
        if self._prev is None:
            entry = self.log_manager.get_latest_stable_log()
            if entry is None or entry.state != States.ACTIVE:
                raise HyperspaceException(
                    f"cannot land a streaming delta on {self.index_name}: index is not ACTIVE "
                    "(deleted or mutated between append and commit)")
            self._prev = entry
        return self._prev

    def validate(self) -> None:
        """The index must still be ACTIVE with the layout the deltas were
        built for, and a refresh that raced in and already indexed a batch
        file must not get its rows twice. Raising here (before begin writes
        anything) sends the index to indexes_skipped."""
        prev = self.prev_entry
        want = self._entry_layout(prev)
        for _batch, delta in self.pairs:
            if delta.layout != want:
                raise HyperspaceException(
                    f"{self.index_name}: index layout changed between append and commit "
                    f"({delta.layout} -> {want}); skipping the staged delta")
        covered = {f.name for f in prev.source_file_info_set}
        fresh = [(b, d) for (b, d) in self.pairs if b.final_path not in covered]
        for b, d in self.pairs:
            if b.final_path in covered and getattr(d, "staged_dir", None):
                shutil.rmtree(d.staged_dir, ignore_errors=True)
        if not fresh:
            raise HyperspaceException(
                f"{self.index_name}: a concurrent refresh already covers every batch of this "
                "commit; nothing to land")
        self.pairs = fresh

    @staticmethod
    def _entry_layout(prev: IndexLogEntry) -> tuple:
        raise NotImplementedError

    @property
    def log_entry(self) -> IndexLogEntry:
        if self._entry is not None:
            return self._entry
        return self.prev_entry  # begin()'s placeholder, as a refresh's

    def _new_version_dir(self):
        latest = self.data_manager.get_latest_version_id()
        version = 0 if latest is None else latest + 1
        out_dir = self.data_manager.get_path(version)
        file_utils.makedirs(out_dir)
        return version, out_dir

    def event(self, message: str) -> _ev.StreamingIndexDeltaEvent:
        return _ev.StreamingIndexDeltaEvent(message=message, index_name=self.index_name)


class _LandCoveringDeltas(_LandDeltasBase):
    """Move one covering index's prebuilt part files for every batch of a
    commit into a new immutable data version, and commit an entry whose
    content is the old files plus the delta files (an append-only
    incremental refresh, minus the build)."""

    _entry_layout = staticmethod(_covering_layout)

    def op(self) -> None:
        prev = self.prev_entry
        version, out_dir = self._new_version_dir()
        # Commit-time file ids: the append-time lineage prediction is a fast
        # path, and a drifted delta is repaired in place.
        tracker = FileIdTracker()
        tracker.add_file_info(prev.source_file_info_set)
        batch_infos = []
        for batch, delta in self.pairs:
            full, size, mtime = file_utils.file_info_triple(batch.final_path)
            fid = tracker.add_file(full, size, mtime)
            if delta.lineage_id is not None and fid != delta.lineage_id:
                _rewrite_lineage(delta.staged_dir, fid,
                                 self.session.hs_conf.index_row_group_size())
            batch_infos.append(FileInfo(full, size, mtime, fid))
        for _batch, delta in self.pairs:
            for fname in sorted(os.listdir(delta.staged_dir)):
                os.replace(os.path.join(delta.staged_dir, fname), os.path.join(out_dir, fname))
            try:
                os.rmdir(delta.staged_dir)
            except OSError:
                pass
        index_content = prev.content.merge(Content.from_directory(out_dir, tracker))
        source = _pinned_source(self.table_path, prev, batch_infos)
        entry = IndexLogEntry.create(prev.name, prev.derivedDataset, index_content, source,
                                     _carry_props(prev))
        self._entry = entry.with_log_version(version)


class _LandSketchDeltas(_LandDeltasBase):
    """A new sketch-table version: the kept rows plus one row per batch
    file (the incremental skipping refresh, with the device reductions
    already paid at append)."""

    _entry_layout = staticmethod(_sketch_layout)

    def op(self) -> None:
        from ..actions import create_skipping as cs
        prev = self.prev_entry
        # partitioning=None: v__=<n> must not read as a hive column.
        fs, old_path = data_store.fs_and_path(cs._sketch_file(prev))
        old = pq.read_table(old_path, filesystem=fs, partitioning=None)
        tracker = FileIdTracker()
        tracker.add_file_info(prev.source_file_info_set)
        batch_infos = []
        rows: Dict[str, list] = {f.name: [] for f in old.schema}
        for batch, delta in self.pairs:
            full, size, mtime = file_utils.file_info_triple(batch.final_path)
            fid = tracker.add_file(full, size, mtime)
            batch_infos.append(FileInfo(full, size, mtime, fid))
            values = dict(delta.values)
            values[cs.FILE_ID_COL] = fid
            for f in old.schema:
                rows[f.name].append(values.get(f.name))
        appended = pa.table({f.name: pa.array(rows[f.name], type=f.type) for f in old.schema},
                            schema=old.schema)
        merged = pa.concat_tables([old, appended])
        version, out_dir = self._new_version_dir()
        fs, merged_path = data_store.fs_and_path(os.path.join(out_dir, cs.SKETCH_FILE_NAME))
        pq.write_table(merged, merged_path, filesystem=fs)
        index_content = Content.from_directory(out_dir, tracker)
        source = _pinned_source(self.table_path, prev, batch_infos)
        entry = IndexLogEntry.create(prev.name, prev.derivedDataset, index_content, source,
                                     _carry_props(prev))
        self._entry = entry.with_log_version(version)


class _StreamingCommitAction(Action):
    """One atomic commit of a table's popped batches on the table's
    streaming log: begin writes a transient entry listing the files about
    to publish, op renames them into the table and lands the per-index
    deltas, end commits the ACTIVE entry."""

    transient_state = States.REFRESHING
    final_state = States.ACTIVE

    def __init__(self, session, log_manager: IndexLogManager, table_path: str,
                 batches: List[StagedBatch]):
        super().__init__(session, log_manager)
        self.table_path = table_path
        self.batches = batches
        self.op_started = False
        self.indexes_updated: List[str] = []
        self.indexes_skipped: List[str] = []

    def validate(self) -> None:
        latest_id = self.log_manager.get_latest_id()
        if latest_id is None:
            return
        # A torn tip is a wreck to recover, not a parse error forever.
        latest = self.log_manager._get_log_lenient(latest_id)
        if latest is None or latest.state not in STABLE_STATES:
            raise HyperspaceException(
                f"streaming log for {self.table_path} is mid-commit or wrecked; run "
                "Hyperspace.recover() first")

    def _stable(self) -> Optional[IndexLogEntry]:
        entry = self.log_manager.get_latest_stable_log()
        if entry is not None and entry.state != States.ACTIVE:
            return None  # DOESNOTEXIST after a cancelled first commit
        return entry

    @property
    def log_entry(self) -> IndexLogEntry:
        prev = self._stable()
        infos = [FileInfo(b.final_path, b.nbytes, b.mtime_ms) for b in self.batches]
        new_content = _content_over(infos)
        if prev is not None and prev.content is not None and prev.content.files:
            content = prev.content.merge(new_content)
        else:
            content = new_content
        props = _carry_props(prev) if prev is not None else {}
        derived = IngestedTable(schema=self.batches[0].schema)
        rel = Relation(rootPaths=[self.table_path], data=Hdfs(content),
                       dataSchema=self.batches[0].schema, fileFormat="parquet", options={})
        fingerprint = LogicalPlanFingerprint(
            [Signature("streaming.ingest", table_key(self.table_path))])
        return IndexLogEntry.create(table_key(self.table_path), derived, content,
                                    Source(SourcePlan([rel], fingerprint)), props)

    def op(self) -> None:
        self.op_started = True
        _faults.fault_point(_fn.INGEST_PUBLISH)
        for b in self.batches:
            os.replace(b.staged_path, b.final_path)
        resolver = PathResolver(self.session.hs_conf)
        cov: Dict[str, List[tuple]] = {}
        sk: Dict[str, List[tuple]] = {}
        for b in self.batches:
            for d in b.covering:
                cov.setdefault(d.index_name, []).append((b, d))
            for d in b.sketches:
                sk.setdefault(d.index_name, []).append((b, d))
        for deltas, land in ((cov, _LandCoveringDeltas), (sk, _LandSketchDeltas)):
            for name in sorted(deltas):
                path = resolver.get_index_path(name)
                self._land(name, land(self.session, IndexLogManager(path),
                                      IndexDataManager(path), self.table_path, deltas[name]))

    def _land(self, name: str, action: Action) -> None:
        """One index's landing never fails the commit: the batch files are
        published, and an index that lost its delta does not cover them
        (Hybrid Scan does, until the next commit or refresh). Kills and
        cancellation still propagate."""
        try:
            action.run()
        except Exception:
            self.indexes_skipped.append(name)
        else:
            self.indexes_updated.append(name)

    def event(self, message: str) -> _ev.StreamingCommitEvent:
        return _ev.StreamingCommitEvent(
            message=message, table=self.table_path, batches=len(self.batches),
            files=len(self.batches), rows=sum(b.rows for b in self.batches),
            indexes_updated=list(self.indexes_updated))


def commit(session, table_path: str) -> dict:
    """Publish every staged batch for ``table_path`` atomically. Returns a
    summary dict. A commit that lost the put-if-absent race re-queues its
    batches and raises. With ``groupCommit.enabled`` (the default)
    concurrent callers coalesce into one wave, and riders' summaries carry
    ``joined_wave``; off, every call publishes its own batches."""
    _require_enabled(session)
    table_path = os.path.abspath(table_path)
    if session.hs_conf.streaming_group_commit_enabled():
        return get_coordinator().commit_grouped(session, table_path)
    res, _ = _commit_once(session, table_path)
    if res["committed_batches"]:
        res["subscriptions_fired"] = _fire_subscriptions(session, table_path,
                                                         batches=res["committed_batches"])
    return res


def _commit_once(session, table_path: str, limit: Optional[int] = None):
    """One publication: pop up to ``limit`` staged batches and land them as
    one table-log entry plus one delta landing per index. Fires no
    subscription. Returns ``(summary, truncated)``."""
    queue = get_queue()
    with queue.commit_lock(table_path):
        batches, truncated = queue.pop_wave(table_path, limit)
        if not batches:
            return _empty_commit_summary(), False
        t0 = time.perf_counter()
        log_mgr = IndexLogManager(table_log_dir(session, table_path))
        action = _StreamingCommitAction(session, log_mgr, table_path, batches)
        try:
            with _trace.maintenance_trace(session, "ingest"), \
                    _trace.span(SN.INGEST_COMMIT) as sp:
                action.run()
                if sp is not None:
                    sp.attrs["batches"] = len(batches)
                    sp.attrs["indexes"] = len(action.indexes_updated)
        except BaseException:
            if not action.op_started:
                queue.requeue(table_path, batches)  # nothing landed: retryable
            else:
                queue.abandon(table_path, batches)  # a wreck for recover()
            raise
        queue.land(table_path, batches)
        session.index_collection_manager.clear_cache()
        seconds = time.perf_counter() - t0
    return ({"committed_batches": len(batches), "rows": sum(b.rows for b in batches),
             "files": [b.final_path for b in batches],
             "indexes_updated": list(action.indexes_updated),
             "indexes_skipped": list(action.indexes_skipped),
             "subscriptions_fired": 0, "seconds": seconds}, truncated)


def _fire_subscriptions(session, table_path: str, batches: int = 0) -> int:
    """Fire this process's standing queries over the table, then send the
    commit notice to the cluster's live peers (cluster/worker.py), so they
    fire on every worker. A peer's failure costs it one fire, never the
    durable commit; a disabled cluster costs one conf read."""
    from ..serving import frontend as fe
    fired = 0
    for front in fe.all_frontends():
        try:
            fired += front.notify_commit(session, table_path)
        except Exception:
            # The commit is durable; a fire's errors land on its
            # subscriptions.
            continue
    if fired:
        get_queue().note(subscription_fires=fired)
    if session.hs_conf.cluster_enabled():
        from ..cluster import worker as _cluster
        _cluster.broadcast_commit(session, table_path, batches=batches)
    return fired


# ---------------------------------------------------------------------------
# Crash recovery (driven by robustness/recovery.recover_indexes).
# ---------------------------------------------------------------------------

def recover_streaming(session, summary: Dict) -> None:
    """Sweep the per-table streaming logs: undo commits that died with
    batch files partly published, redo those that died after all of them
    landed, and clear staging leftovers everywhere. Runs under recover()'s
    operator contract: no live writer."""
    s = summary.setdefault("streaming", {"tables": [], "rolled_back": {}, "completed": [],
                                         "torn_entries": 0, "staging_swept": 0})
    root = os.path.join(session.hs_conf.system_path(), SC.STREAMING_DIR)
    if os.path.isdir(root):
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if not os.path.isdir(os.path.join(path, IndexConstants.HYPERSPACE_LOG)):
                continue
            s["tables"].append(name)
            try:
                _recover_table_log(session, path, name, s)
            except Exception as e:
                summary.setdefault("errors", {})[f"streaming:{name}"] = \
                    f"{type(e).__name__}: {e}"
    # Tables that staged batches but never reached a first commit.
    marker_dir = _staged_marker_dir(session)
    if os.path.isdir(marker_dir):
        for name in sorted(os.listdir(marker_dir)):
            marker = os.path.join(marker_dir, name)
            try:
                with open(marker) as f:
                    table_path = f.read().strip()
            except OSError:
                continue
            if table_path:
                stage = os.path.join(table_path, SC.STAGING_DIR)
                if os.path.isdir(stage):
                    s["staging_swept"] += _sweep_staging(stage)
                get_queue().drop_table(os.path.abspath(table_path))
                get_coordinator().forget(os.path.abspath(table_path))
            try:
                os.unlink(marker)
            except OSError:
                pass
    # Index-side staging: prebuilt deltas of batches that will never commit.
    sys_root = session.hs_conf.system_path()
    if os.path.isdir(sys_root):
        for name in sorted(os.listdir(sys_root)):
            if name == SC.STREAMING_DIR:
                continue
            stage = os.path.join(sys_root, name, SC.STAGING_DIR)
            if os.path.isdir(stage):
                s["staging_swept"] += _sweep_staging(stage)


def _recover_table_log(session, path: str, name: str, s: Dict) -> None:
    mgr = IndexLogManager(path)
    latest_id = mgr.get_latest_id()
    if latest_id is None:
        return
    latest = mgr._get_log_lenient(latest_id)
    stable = mgr.get_latest_stable_log()
    stable_files = set(stable.content.files) \
        if stable is not None and stable.content is not None else set()
    if latest is None:
        # A torn tip (the begin or the end write): delete it and examine
        # the new tip in this same pass, so a torn end redoes at once.
        mgr.delete_log(latest_id)
        s["torn_entries"] += 1
        _recover_table_log(session, path, name, s)
        return
    if latest.state not in STABLE_STATES:
        torn = [f for f in (latest.content.files if latest.content is not None else [])
                if f not in stable_files
                and os.path.basename(f).startswith(SC.INGEST_FILE_PREFIX)]
        landed = [f for f in torn if os.path.isfile(f)]
        if torn and len(landed) == len(torn):
            # Redo: publication finished before the crash.
            entry = IndexLogEntry.from_json(latest.to_json())
            entry.state = States.ACTIVE
            mgr.delete_latest_stable_log()
            if mgr.write_log(latest_id + 1, entry):
                mgr.create_latest_stable_log(latest_id + 1)
            s["completed"].append(name)
        else:
            # Undo: roll the batch back out of the table.
            for f in landed:
                try:
                    os.unlink(f)
                except OSError:
                    pass
            from ..actions.lifecycle import CancelAction
            CancelAction(session, mgr, IndexDataManager(path)).run()
            s["rolled_back"][name] = len(landed)
    table_path = None
    for e in (latest, stable):
        if e is None:
            continue
        try:
            table_path = os.path.abspath(e.relation.rootPaths[0])
            break
        except (AssertionError, AttributeError, IndexError, HyperspaceException):
            continue
    if table_path is not None:
        stage = os.path.join(table_path, SC.STAGING_DIR)
        if os.path.isdir(stage):
            s["staging_swept"] += _sweep_staging(stage)
        get_queue().drop_table(table_path)
        get_coordinator().forget(table_path)


def _sweep_staging(path: str) -> int:
    n = sum(len(files) for _root, _dirs, files in os.walk(path))
    shutil.rmtree(path, ignore_errors=True)
    return n
