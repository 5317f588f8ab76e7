"""Eager columnar plan executor (counterpart of
``hyperspace_tpu/execution/executor.py``: Scan, IndexScan, Filter,
Project, Join (inner, left, right, full, semi, anti and cross),
Aggregate (COUNT DISTINCT included), Window, Sort, Limit, Union and
BucketUnion).

Executes a logical plan bottom-up over device-resident tables. A Filter
directly over a scan pushes its prunable conjuncts into the parquet read;
over an IndexScan with the bucket spec exposed, equality predicates on the
indexed columns also prune whole bucket files before any IO. A filtered
scan or index scan over more rows than the device budget
(``hyperspace.tpu.maxChunkRows``) streams its files in chunks and keeps
only each chunk's survivors.

Under Hybrid Scan an IndexScan drops the rows whose lineage id is a
deleted source file's and merges in the rows of appended source files:
sorted alone by (bucket, key) and merged into the index's bucket order, so
a join on that key keeps its shuffle-free path.

An IndexScan whose buckets are one file each yields a table in bucket
order (``Table.bucket_order``). A join whose side is in bucket order on
its one join key probes that side without sorting it (the shuffle-free
merge join), and a group-by whose keys are the bucket keys skips its sort
(or, with more keys, sorts only the runs of equal keys). The host syncs
are the JAX package's: one for a filter's survivor count, one for a join's
output length (and one for the fast path's key-width check), one for a
group count.

Where the mesh tier declines a plan, a Filter, Project or Join chain root,
and an Aggregate over such a chain, runs as one fused region
(execution/fusion.py) unless ``hyperspace.tpu.execution.fusion.enabled``
is false; what the region does not absorb runs stage by stage here.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import pyarrow.parquet as pq
import torch

from .. import shapes
from ..exceptions import HyperspaceException
from ..ops import kernels
from ..index.constants import IndexConstants
from ..ops.index_build import bucket_id_from_file, bucket_ids_for
from ..parallel import io as pio
from ..plan import expr as E
from ..plan.nodes import (Aggregate, BucketUnion, Filter, IndexScan, Join, Limit,
                          LogicalPlan, Project, Scan, Sort, Union, Window)
from ..schema import BOOL, DATE, FLOAT64, INT32, INT64, STRING
from ..serving import batcher
from ..serving import context as qctx
from ..serving.fingerprint import _node_detail
from ..sources.partitions import read_relation_files
from ..telemetry import span_names as SN
from ..telemetry import trace as _trace
from . import fusion, index_cache
from .buffer_pool import file_signature
from .columnar import (DEVICE_DTYPE, Column, Table, dictionaries_equal, empty_table,
                       iter_dataset_chunks, literal_to_device, parquet_row_counts,
                       read_parquet, translate_codes)
from .evaluator import arith_bank_key, eval_expr, eval_predicate_mask, predicate_bank_key
from .pushdown import pruned_index_read_filter, pushable_filter


def execute(plan: LogicalPlan, session) -> Table:
    from ..ops import cuda_kernels
    builds0 = cuda_kernels.BUILD_STATS["builds"]
    seconds0 = cuda_kernels.BUILD_STATS["build_seconds"]
    # Every read under this execution takes the session's io and buffer
    # pool conf, and the mesh's shard boundaries its length classes.
    with shapes.use_conf(session.hs_conf), pio.use_session(session):
        # A {Filter, Project, Join}* chain root (under optional Sort/Limit)
        # runs SPMD over the mesh, its rows gathered per device
        # (execution/spmd.py); Aggregate roots dispatch in _execute_node.
        from . import spmd
        result = _spmd_with_fault_fallback(
            lambda: spmd.try_execute_plan(plan, session, _spmd_executor(session)), session)
        if result is None:
            result = _execute(plan, None, session)
    _emit_compile_event(session, cuda_kernels.BUILD_STATS["builds"] - builds0,
                        cuda_kernels.BUILD_STATS["build_seconds"] - seconds0)
    return result


def _emit_compile_event(session, count: int, seconds: float) -> None:
    """The kernel libraries this execution built with nvcc (a process-wide
    tally, so a concurrent first query's builds can land here) as a
    KernelCompileEvent; nothing when none was built."""
    if count <= 0:
        return
    from ..ops import cuda_kernels
    from ..telemetry.events import KernelCompileEvent
    from ..telemetry.logging import get_logger
    get_logger(session.hs_conf.event_logger_class()).log_event(KernelCompileEvent(
        message=f"{count} kernel library build(s) during plan execution",
        count=count, seconds=round(seconds, 4), total=cuda_kernels.BUILD_STATS["builds"]))


def _spmd_executor(session):
    """The single-device executor the SPMD path materializes join sides
    with."""
    return lambda plan, needed: _execute(plan, needed, session)


def _spmd_with_fault_fallback(run, session) -> Optional[Table]:
    """The SPMD -> single-device degradation ladder: a fault of the SPMD
    dispatch degrades to the single-device run of the same stage (the
    same answer), observable as a DistributedFallbackEvent whose reason
    starts with "fault:". A structural mismatch already returns None in
    ``try_execute_*``. A deadline error is a cancellation and a re-plan
    request a control transfer: both pass through. With
    ``robustness.degrade.enabled=false`` the fault raises."""
    from ..exceptions import QueryDeadlineError
    try:
        return run()
    except QueryDeadlineError:
        raise
    except Exception as e:
        from ..adaptive.feedback import ReplanRequested
        if isinstance(e, ReplanRequested):
            raise
        if session is None or not session.hs_conf.robustness_degrade_enabled():
            raise
        from ..robustness import faults as _faults
        from ..telemetry.logging import emit_distributed_fallback
        _faults.note(degraded_spmd=1)
        emit_distributed_fallback(session, "spmd_query", f"fault: {type(e).__name__}: {e}")
        return None


def _execute(plan: LogicalPlan, needed: Optional[Set[str]], session) -> Table:
    """One plan node, under one ``exec.stage`` span (attributes ``node``
    and ``rows``) while a trace is active, so the span tree mirrors the
    plan tree; ``idle()`` makes it a plain call while tracing is off. The
    span ends when the host returns: it waits for no kernel. Every stage
    boundary, on entry and on exit, is a cancellation point for the
    query's deadline (serving/context.py)."""
    qctx.check_deadline("exec.stage")
    if isinstance(plan, (Filter, Project, Join)):
        # Whole-plan fusion (execution/fusion.py): a chain root opening a
        # fusible region runs as one region, with no exec.stage span (and
        # no Table) for its interior nodes. Aggregate roots try it in
        # _execute_node, after the SPMD dispatch; chain roots reach here
        # only once execute()'s spmd.try_execute_plan declined.
        fused = fusion.try_execute(plan, needed, session)
        if fused is not None:
            qctx.check_deadline("exec.stage")
            return fused
    if _trace.idle():
        table = _execute_node(plan, needed, session)
        qctx.check_deadline("exec.stage")
        return table
    with _trace.span(SN.EXEC_STAGE, node=plan.node_name) as sp:
        table = _execute_node(plan, needed, session)
        if sp is not None:
            # A tensor's length: no device sync.
            sp.attrs["rows"] = int(table.num_rows)
        qctx.check_deadline("exec.stage")
        return table


def _shared_scan_key(plan: Scan, needed: Optional[Set[str]], device):
    """A literal sweep's scan-sharing key: the relation in full (format,
    paths, options), the columns read and the device."""
    return (_node_detail(plan), tuple(sorted(needed)) if needed is not None else None,
            str(device))


def _execute_node(plan: LogicalPlan, needed: Optional[Set[str]], session) -> Table:
    if isinstance(plan, Scan):
        sweep = batcher.active_sweep()
        if sweep is not None:
            # A literal sweep's members read the same sources: the first
            # member's table serves the rest.
            return sweep.shared_scan(_shared_scan_key(plan, needed, session.device),
                                     lambda: _execute_scan(plan, needed, session.device))
        return _execute_scan(plan, needed, session.device)
    if isinstance(plan, IndexScan):
        return _execute_index_scan(plan, needed, session.device)
    if isinstance(plan, Filter):
        child_needed = None if needed is None else \
            needed | set(plan.condition.references)
        child = plan.child
        sweep = batcher.active_sweep()
        if sweep is not None and isinstance(child, Scan):
            # Under a sweep, row-group pushdown would prune different row
            # groups for each member's literals; the unpruned read, shared
            # by the batch, gives the same answer (each member's own mask,
            # the kernels' on a card, is applied below). A source past the
            # chunk budget keeps the per-member streamed path.
            chunked = _chunked_filtered_scan(child, child_needed, plan.condition, None,
                                             session.hs_conf.max_chunk_rows(), session.device)
            if chunked is not None:
                return chunked
            table = sweep.shared_scan(
                _shared_scan_key(child, child_needed, session.device),
                lambda: _execute_scan(child, child_needed, session.device))
        elif isinstance(child, (Scan, IndexScan)):
            # Push row-group-prunable conjuncts into the parquet read. A
            # source's struct leaves are no physical columns, so dotted
            # names are pushed only into index files, which store them flat.
            pa_filter = pushable_filter(plan.condition, child.schema,
                                        allow_nested=isinstance(child, IndexScan))
            chunk_rows = session.hs_conf.max_chunk_rows()
            if isinstance(child, Scan):
                chunked = _chunked_filtered_scan(child, child_needed, plan.condition,
                                                 pa_filter, chunk_rows, session.device)
                if chunked is not None:
                    return chunked
                table = _execute_scan(child, child_needed, session.device, pa_filter)
            else:
                buckets = _equality_bucket_subset(child, plan.condition)
                chunked = _chunked_filtered_index_scan(
                    child, child_needed, plan.condition, pa_filter, buckets, chunk_rows,
                    session.device)
                if chunked is not None:
                    return chunked
                pruned = pa_filter is not None and pruned_index_read_filter(
                    child.index_entry, plan.condition, child.schema) is not None
                table = _execute_index_scan(child, child_needed, session.device,
                                            pa_filter, bucket_subset=buckets,
                                            prefer_pruned_read=pruned)
        else:
            table = _execute(child, child_needed, session)
        return _filter_table(table, plan.condition)
    if isinstance(plan, Project):
        child_needed = set()
        for e in plan.exprs:
            child_needed.update(e.references)
        table = _execute(plan.child, child_needed, session)
        out = Table({e.name: _eval_expr_banked(table, e) for e in plan.exprs})
        # Pass-through columns, renamed or not, keep the bucket order.
        order = table.bucket_order
        if order:
            renamed: Dict[str, str] = {}
            for e in plan.exprs:
                inner = e.child if isinstance(e, E.Alias) else e
                if isinstance(inner, E.Col):
                    renamed.setdefault(inner.column, e.name)
            if all(k in renamed for k in order[1]):
                out = Table(out.columns, (order[0], tuple(renamed[k] for k in order[1])))
        return out
    if isinstance(plan, Join):
        table = _execute_join(plan, needed, session)
        _record_join_actual(plan, table, session)
        return table
    if isinstance(plan, Aggregate):
        # Eligible aggregation subtrees run SPMD over the mesh; any
        # mismatch, and through the ladder any dispatch fault, falls back.
        from . import spmd
        result = _spmd_with_fault_fallback(
            lambda: spmd.try_execute_aggregate(plan, session, _spmd_executor(session)),
            session)
        if result is not None:
            return result
        fused = fusion.try_execute(plan, needed, session)
        if fused is not None:
            return fused
        child_needed = set(plan.group_cols)
        for a in plan.aggs:
            child_needed.update(a.references)
        return _execute_aggregate(plan, _execute(plan.child, child_needed, session))
    if isinstance(plan, Sort):
        child_needed = None if needed is None else needed | {c for c, _ in plan.orders}
        return _execute_sort(plan, _execute(plan.child, child_needed, session))
    if isinstance(plan, Window):
        out_names = {name for name, _ in plan.wexprs}
        child_needed = None if needed is None else \
            (needed - out_names) | {r for _, w in plan.wexprs for r in w.references}
        return _execute_window(plan, _execute(plan.child, child_needed, session))
    if isinstance(plan, Limit):
        return _execute_limit(plan, _execute(plan.child, needed, session))
    if isinstance(plan, (Union, BucketUnion)):
        # Align on the union's pruned output: a child whose own filter
        # read extra columns holds more than the others.
        out_names = [n for n in plan.schema.names if needed is None or n in needed]
        child_needed = needed
        if not out_names:
            # count(*): no column is referenced; every child keeps one.
            out_names = plan.schema.names[:1]
            child_needed = None if needed is None else needed | set(out_names)
        return Table.concat([_execute(c, child_needed, session).select(out_names)
                             for c in plan.children])
    raise HyperspaceException(f"Cannot execute plan node {plan.node_name}")


def _record_join_actual(plan: Join, table: Table, session) -> None:
    """Every executed inner join's output rows, kept on the session by
    ``join_actual_key`` whatever the reorder flag: explain's "Join order:"
    section pairs them with the reorderer's estimates, and with the
    adaptive loop on they feed the correction store (keyed by both sides,
    so corrections never cross table pairs).

    This is also the mid-query re-plan trigger (adaptive/feedback.py): the
    executor owns the join boundaries, so after the write-back the
    adaptive tier may raise ReplanRequested here, which
    Session._execute_uncaptured catches to plan again. The executor has no
    path that turns an error into a fallback, so nothing stands between
    the raise and that catch."""
    if plan.join_type != "inner" or plan.condition is None:
        return
    key = qctx.join_actual_key(plan.condition, plan.left, plan.right)
    qctx.record_join_actual(session, key, table.num_rows)
    if session.hs_conf.adaptive_replan_enabled():
        from ..adaptive import feedback as _feedback
        _feedback.maybe_replan(session, key, table.num_rows)


# False inside a fused region's body, whose stages the JAX package traces
# into the region's one program (no stage of their own in the bank).
_BANK_STAGES: contextvars.ContextVar = contextvars.ContextVar("hst_torch_bank_stages",
                                                              default=True)


def _banked(banked, fn):
    """``fn`` after the program bank's lookup of its stage (``banked``:
    (stage key, shape-class vector), or None: unbanked). The bank counts
    the program the JAX package compiles for this stage; the stage itself
    is the eager function, called as it stands (nothing compiled to
    reuse)."""
    if banked is not None and _BANK_STAGES.get():
        from ..serving.program_bank import get_bank
        get_bank().lookup(banked[0], banked[1], lambda: fn)
    return fn


def _filter_table(table: Table, condition) -> Table:
    mask_fn = _banked(predicate_bank_key(table, condition), eval_predicate_mask)
    return table.filter(mask_fn(table, condition))


def _eval_expr_banked(table: Table, e: E.Expr) -> Column:
    return _banked(arith_bank_key(table, e), eval_expr)(table, e)


def _read_columns(schema_names: List[str], needed: Optional[Set[str]]) -> List[str]:
    """Columns to read, always explicit: index files live under "v__=<n>"
    directories, and pyarrow's reader would infer a phantom "v__" column
    from the path if asked for all columns."""
    if needed is None:
        return list(schema_names)
    return [n for n in schema_names if n in needed] or [schema_names[0]]


def _execute_scan(plan: Scan, needed: Optional[Set[str]], device,
                  pa_filter=None) -> Table:
    relation = plan.relation
    cols = _read_columns(relation.schema.names, needed)
    files = relation.all_files()
    if not files:
        return empty_table(relation.schema.select(cols), device)
    return read_relation_files(relation, files, cols, device, filters=pa_filter, pool=True)


# The chunked scans' device footprint: tests hold max_device_rows to the
# chunk budget. Concurrent queries update it under the lock.
CHUNK_SCAN_STATS = {"max_device_rows": 0, "chunks": 0}
_CHUNK_STATS_LOCK = threading.Lock()


def _note_chunk_scan(rows: int) -> None:
    with _CHUNK_STATS_LOCK:
        CHUNK_SCAN_STATS["max_device_rows"] = max(CHUNK_SCAN_STATS["max_device_rows"], rows)
        CHUNK_SCAN_STATS["chunks"] += 1


def _chunked_filtered_scan(plan: Scan, needed: Optional[Set[str]], condition, pa_filter,
                           chunk_rows: int, device) -> Optional[Table]:
    """Filter over a scan of more rows than the device budget: the files
    stream in chunks (row groups the pushed filter excludes are never
    decoded), each chunk is masked on the device and only its survivors
    are kept. None when the source fits the budget (the in-memory read is
    cheaper), the source is not parquet (the other formats have no row
    groups to stream; they are read whole, however many rows they hold),
    or a needed column is not a physical one: a hive partition column or
    a struct leaf, which the in-memory reader attaches or flattens."""
    relation = plan.relation
    files = relation.all_files()
    if not files or relation.data_file_format != "parquet":
        return None
    cols = _read_columns(relation.schema.names, needed)
    if any(c not in set(pq.read_schema(files[0]).names) for c in cols):
        return None
    if sum(parquet_row_counts(files)) <= chunk_rows:
        return None
    parts: List[Table] = []
    for chunk in iter_dataset_chunks(files, cols, chunk_rows, device, pa_filter):
        _note_chunk_scan(chunk.num_rows)
        parts.append(chunk.filter(eval_predicate_mask(chunk, condition)))
    if not parts:
        return empty_table(relation.schema.select(cols), device)
    return Table.concat(parts)


def _index_scan_layout(plan: IndexScan, needed: Optional[Set[str]],
                       bucket_subset: Optional[Set[int]]):
    """(index files in bucket order, explicit read columns, whether every
    bucket is one file) for an index scan. After an incremental refresh a
    bucket's rows can span several version directories; bucket-grouped
    order is what the bucket-aware operators expect. The lineage column
    is read when deleted files' rows must be dropped."""
    entry = plan.index_entry
    keyed = sorted(((bucket_id_from_file(f), f) for f in entry.content.files),
                   key=lambda t: (t[0] is None, t[0] or 0, t[1]))
    single_file_buckets = all(b is not None for b, _ in keyed) \
        and len({b for b, _ in keyed}) == len(keyed)
    if bucket_subset is not None:
        keyed = [(b, f) for b, f in keyed if b in bucket_subset]
    cols = _read_columns(plan.schema.names if needed is None else entry.schema.names,
                         needed)
    if plan.deleted_file_ids and IndexConstants.DATA_FILE_NAME_ID not in cols:
        cols = cols + [IndexConstants.DATA_FILE_NAME_ID]
    return [f for _, f in keyed], cols, single_file_buckets


def _with_bucket_order(entry, table: Table, single_file_buckets: bool) -> Table:
    """Files in bucket order, rows sorted by the indexed columns within
    each: the covering index's layout, kept by a row subsequence."""
    if single_file_buckets and all(c in table.names for c in entry.indexed_columns):
        return Table(table.columns, (entry.num_buckets, tuple(entry.indexed_columns)))
    return table


def _deleted_ids(plan: IndexScan, device) -> Optional[torch.Tensor]:
    if not plan.deleted_file_ids:
        return None
    return torch.from_numpy(np.sort(np.asarray(plan.deleted_file_ids, dtype=np.int64))).to(
        device)


def _not_deleted(table: Table, deleted: torch.Tensor) -> torch.Tensor:
    lineage = table.column(IndexConstants.DATA_FILE_NAME_ID).data.to(torch.int64)
    return ~kernels.isin_sorted(lineage, deleted)


def _with_unknown_lineage(appended: Table, device) -> Table:
    """Appended source rows have no index lineage: they get the unknown id."""
    return appended.with_column(IndexConstants.DATA_FILE_NAME_ID, Column(
        INT64, torch.full((appended.num_rows,), IndexConstants.UNKNOWN_FILE_ID,
                          dtype=torch.int64, device=device)))


def _drop_unwanted_lineage(plan: IndexScan, table: Table,
                           needed: Optional[Set[str]]) -> Table:
    wanted = needed if needed is not None else set(plan.schema.names)
    lineage = IndexConstants.DATA_FILE_NAME_ID
    if lineage in table.names and lineage not in wanted:
        return table.select([n for n in table.names if n != lineage])
    return table


def _chunked_filtered_index_scan(plan: IndexScan, needed: Optional[Set[str]], condition,
                                 pa_filter, bucket_subset: Optional[Set[int]],
                                 chunk_rows: int, device) -> Optional[Table]:
    """Filter over an index scan of more rows (index and appended files
    together) than the device budget: the bucket-ordered index files
    stream in chunks, each masked by the predicate and the deleted-row
    mask; the appended files stream under the same budget and their
    survivors merge into the bucket order. None when everything fits the
    budget."""
    entry = plan.index_entry
    index_files, cols, single_file_buckets = _index_scan_layout(plan, needed, bucket_subset)
    if not index_files:
        return None
    if plan.appended_files and plan.source_relation.data_file_format != "parquet":
        return None  # appended files without footers: the in-memory path
    if sum(parquet_row_counts(index_files + list(plan.appended_files))) <= chunk_rows:
        return None
    lineage = IndexConstants.DATA_FILE_NAME_ID
    deleted = _deleted_ids(plan, device)
    parts: List[Table] = []
    for chunk in iter_dataset_chunks(index_files, cols, chunk_rows, device, pa_filter):
        _note_chunk_scan(chunk.num_rows)
        mask = eval_predicate_mask(chunk, condition)
        if deleted is not None:
            mask = mask & _not_deleted(chunk, deleted)
        parts.append(chunk.filter(mask))
    app_parts: List[Table] = []
    if plan.appended_files:
        app_cols = [c for c in cols if c != lineage]
        for chunk in _appended_chunks(plan, app_cols, chunk_rows, device):
            _note_chunk_scan(chunk.num_rows)
            appended = chunk.filter(eval_predicate_mask(chunk, condition))
            if lineage in cols:
                appended = _with_unknown_lineage(appended, device)
            app_parts.append(appended.select(cols))
    parts = [p for p in parts if p.num_rows > 0]
    app_parts = [p for p in app_parts if p.num_rows > 0]
    if not parts and not app_parts:
        return empty_table(entry.schema.select([c for c in cols if c != lineage]), device)
    table = Table.concat(parts) if parts else empty_table(entry.schema.select(cols), device)
    # Chunks stream the files in bucket order; survivors keep it.
    table = _with_bucket_order(entry, table, single_file_buckets)
    if app_parts:
        app_table = Table.concat(app_parts)
        merged = _merge_appended_preserving_order(entry, table, app_table)
        if merged is not None:
            table = merged
        else:
            table = Table.concat([table, app_table]) if table.num_rows else app_table
    return _drop_unwanted_lineage(plan, table, needed)


def _appended_chunks(plan: IndexScan, cols: List[str], chunk_rows: int, device):
    """The appended source files' ``cols`` in tables of at most
    ``chunk_rows`` rows on ``device``. Files whose columns are all physical
    stream row group by row group; otherwise (a partition column or a
    struct leaf) each file is read on the host through the relation's
    reader and sliced to the budget before it moves to the device."""
    files = list(plan.appended_files)
    if all(set(cols) <= set(pq.read_schema(f).names) for f in files):
        yield from iter_dataset_chunks(files, cols, chunk_rows, device)
        return
    for f in files:
        table = read_relation_files(plan.source_relation, [f], cols, torch.device("cpu"))
        for lo in range(0, table.num_rows, chunk_rows):
            part = table.slice(lo, min(lo + chunk_rows, table.num_rows))
            yield Table({n: c.to(device) for n, c in part.columns.items()})


def _equality_bucket_subset(plan: IndexScan, condition) -> Optional[Set[int]]:
    """Bucket pruning: equality predicates on every indexed column pin the
    buckets a matching row can live in (the reference's useBucketSpec
    behavior), through the host mirror of the device hash."""
    if not plan.use_bucket_spec:
        return None
    entry = plan.index_entry
    # The bucket id combines the hashes of ALL indexed columns, so pruning
    # needs an equality constraint on every one.
    per_column_hashes = []
    for name in entry.indexed_columns:
        if name not in entry.schema:
            return None
        dtype = entry.schema.field(name).dtype
        values = None
        for conjunct in E.split_conjunctive_predicates(condition):
            vals = _equality_values(conjunct, name)
            if vals is not None:
                values = vals if values is None else (values & vals)
        if values is None or len(values) > 16:
            return None
        hashes = []
        for v in values:
            if dtype == STRING:
                hashes.append(kernels.hash32_value_host(str(v), dtype))
            else:
                hashes.append(kernels.hash32_value_host(
                    literal_to_device(v, dtype, None), dtype))
        per_column_hashes.append(hashes)

    combos = [None]
    for hashes in per_column_hashes:
        combos = [kernels.hash_combine_host(c, h) if c is not None else h
                  for c in combos for h in hashes]
        if len(combos) > 256:
            return None
    return {c % entry.num_buckets for c in combos}


def _equality_values(conjunct, column: str):
    if isinstance(conjunct, E.EqualTo):
        left, right = conjunct.left, conjunct.right
        if isinstance(left, E.Lit) and isinstance(right, E.Col):
            left, right = right, left
        if isinstance(left, E.Col) and left.column == column \
                and isinstance(right, E.Lit):
            return {right.value}
    if isinstance(conjunct, E.In) and isinstance(conjunct.value, E.Col) \
            and conjunct.value.column == column:
        if all(isinstance(o, E.Lit) for o in conjunct.options):
            return {o.value for o in conjunct.options}
    return None


def _execute_index_scan(plan: IndexScan, needed: Optional[Set[str]], device,
                        pa_filter=None, bucket_subset: Optional[Set[int]] = None,
                        prefer_pruned_read: bool = False) -> Table:
    """The index files' rows in bucket order, the deleted files' rows
    dropped and the appended files' rows merged in. The index files come
    from the device-resident index-table cache, read whole (the Filter
    above masks them on the device), unless the filter constrains the
    leading indexed column (``prefer_pruned_read``): then a read pruned by
    the row-group statistics of the sorted column costs less."""
    entry = plan.index_entry
    index_files, cols, single_file_buckets = _index_scan_layout(plan, needed, bucket_subset)
    if not index_files and bucket_subset is not None and not plan.appended_files:
        return empty_table(entry.schema.select(
            [c for c in cols if c != IndexConstants.DATA_FILE_NAME_ID]), device)
    if not index_files:
        table = empty_table(entry.schema.select(cols), device)
    elif index_cache.enabled() and not (prefer_pruned_read and pa_filter is not None):
        cache = index_cache.get_cache()
        key = (entry.id, entry.name, file_signature(index_files), tuple(cols), str(device))
        table = cache.get(key)
        _emit_index_cache_probe(entry.name, hit=table is not None)
        if table is None:
            table = read_parquet(index_files, cols, device)
            cache.put(key, table)
    else:
        table = read_parquet(index_files, cols, device, filters=pa_filter, pool=True)
    table = _with_bucket_order(entry, table, single_file_buckets)
    deleted = _deleted_ids(plan, device)
    if deleted is not None:
        table = table.filter(_not_deleted(table, deleted))
    if plan.appended_files:
        appended = read_relation_files(
            plan.source_relation, plan.appended_files,
            [c for c in cols if c != IndexConstants.DATA_FILE_NAME_ID], device)
        if IndexConstants.DATA_FILE_NAME_ID in cols:
            appended = _with_unknown_lineage(appended, device)
        merged = _merge_appended_preserving_order(entry, table, appended)
        if merged is not None:
            table = merged
        else:
            table = Table.concat([table, appended.select(table.names)])
    return _drop_unwanted_lineage(plan, table, needed)


def _emit_index_cache_probe(index_name: str, hit: bool) -> None:
    """One IndexCacheHitEvent or IndexCacheMissEvent per index-table cache
    probe, through the executing session's logger."""
    session = pio.active_session()
    if session is None:
        return
    from ..telemetry.events import IndexCacheHitEvent, IndexCacheMissEvent
    from ..telemetry.logging import log_event
    cls = IndexCacheHitEvent if hit else IndexCacheMissEvent
    log_event(session, cls(message=f"index table cache {'hit' if hit else 'miss'}",
                           index_name=index_name))


# How often the shuffle-free paths were taken (tests and chip_smoke.py
# hold them): appended rows merged without losing the bucket order, and
# joins that probed a bucket-ordered side without sorting it.
HYBRID_MERGE_COUNT = 0
FAST_JOIN_COUNT = 0


def _merge_appended_preserving_order(entry, table: Table,
                                     appended: Table) -> Optional[Table]:
    """Hybrid Scan without losing the merge join: the appended rows are
    bucketed on the device (the hash+bucket kernel), sorted alone by
    (bucket, key) and merged into the (bucket, key)-sorted index rows, so
    ``bucket_order`` survives and a join on the key still skips its sort.

    The merge is two searchsorted passes over packed (bucket << 32 |
    biased key) int64 keys, index rows first on ties, then one scatter of
    row positions. None (the caller concatenates, dropping the order)
    unless the index rows are in bucket order on one int32, int64 or date
    key whose values all lie in (-2**31, 2**31), where the packing is
    exact. The JAX package tests the largest |key|, which wraps for the
    int64 minimum; one host sync either way."""
    global HYBRID_MERGE_COUNT
    if table.bucket_order is None or len(entry.indexed_columns) != 1:
        return None
    key = entry.indexed_columns[0]
    if key not in table.names or key not in appended.names:
        return None
    icol = table.column(key)
    if icol.dtype not in (INT32, INT64, DATE):
        return None
    if table.num_rows == 0 or appended.num_rows == 0:
        return None
    appended = appended.select(table.names)
    num_buckets = table.bucket_order[0]
    wide = [c.data for c in (icol, appended.column(key)) if c.data.dtype == torch.int64]
    if wide:
        outside = torch.stack([((a <= -2 ** 31) | (a >= 2 ** 31)).any() for a in wide])
        if bool(outside.any()):  # HOST SYNC (single scalar).
            return None

    def composite(t: Table) -> torch.Tensor:
        bids = bucket_ids_for(t, [key], num_buckets)
        return kernels.pack2_int32(bids, t.column(key).data.to(torch.int32))

    # Sort only the appended rows; the index rows are sorted already.
    comp_a = composite(appended)
    perm_a = kernels.lex_sort_indices([comp_a])
    appended = appended.take(perm_a)
    comp_a = comp_a[perm_a]
    comp_i = composite(table)
    n_i, n_a = table.num_rows, appended.num_rows
    dev = comp_i.device
    pos_i = torch.arange(n_i, device=dev) + torch.searchsorted(comp_a, comp_i, side="left")
    pos_a = torch.arange(n_a, device=dev) + torch.searchsorted(comp_i, comp_a, side="right")
    union = Table.concat([table, appended])  # unifies string dictionaries.
    gather = torch.empty(n_i + n_a, dtype=torch.int64, device=dev)
    gather[torch.cat([pos_i, pos_a])] = torch.arange(n_i + n_a, device=dev)
    HYBRID_MERGE_COUNT += 1
    return Table(union.take(gather).columns, (num_buckets, (key,)))


# ---------------------------------------------------------------------------
# Join.
# ---------------------------------------------------------------------------

def _string_join_keys(lc: Column, rc: Column):
    if dictionaries_equal(lc.dictionary, rc.dictionary):
        return lc.data, rc.data
    return lc.data, translate_codes(lc.dictionary, rc)


def _comparable_concat(lc: Column, rc: Column) -> torch.Tensor:
    """Left ++ right key values in one comparable space."""
    if (lc.dtype == STRING) != (rc.dtype == STRING):
        raise HyperspaceException("Join key type mismatch")
    if lc.dtype == STRING:
        return torch.cat(_string_join_keys(lc, rc))
    ldata, rdata = lc.data, rc.data
    if ldata.is_floating_point() != rdata.is_floating_point():
        raise HyperspaceException(f"Join key type mismatch: {lc.dtype} vs {rc.dtype}")
    wide = torch.float64 if ldata.is_floating_point() else torch.int64
    return torch.cat([ldata.to(wide), rdata.to(wide)])


def _join_key_arrays(left: Table, right: Table, pairs: List[Tuple[str, str]]):
    """Device key arrays for the join, in a shared comparable space: one
    key as it is, two int32/date keys packed into one int64, any other
    tuple dense-ranked over both sides."""
    if len(pairs) == 1:
        lc, rc = left.column(pairs[0][0]), right.column(pairs[0][1])
        if lc.dtype == STRING or rc.dtype == STRING:
            if lc.dtype != rc.dtype:
                raise HyperspaceException("Join key type mismatch")
            return _string_join_keys(lc, rc)
        return lc.data, rc.data
    cols = [(left.column(a), right.column(b)) for a, b in pairs]
    if len(pairs) == 2 and all(c.dtype in (INT32, DATE) for pair in cols for c in pair):
        return (kernels.pack2_int32(cols[0][0].data, cols[1][0].data),
                kernels.pack2_int32(cols[0][1].data, cols[1][1].data))
    ranks = kernels.dense_rank([_comparable_concat(lc, rc) for lc, rc in cols])
    return ranks[:left.num_rows], ranks[left.num_rows:]


def _keys_validity(table: Table, names: Sequence[str]) -> Optional[torch.Tensor]:
    v = None
    for n in names:
        cv = table.column(n).validity
        if cv is not None:
            v = cv if v is None else (v & cv)
    return v


def _bucketed_merge_keys(left: Table, right: Table, pairs, lkeys, rkeys):
    """When one side is in bucket order on its one join key (a covering
    index), (bucket, key) composite probe keys that let the merge join run
    without sorting that side: (left keys, right keys, swapped), or None.
    The key must be an integer or a date that fits in 32 bits."""
    if len(pairs) != 1:
        return None
    lname, rname = pairs[0]
    lcol, rcol = left.column(lname), right.column(rname)
    if lcol.dtype not in (INT32, INT64, DATE) or rcol.dtype != lcol.dtype:
        return None

    def ordered_on(table: Table, name: str) -> bool:
        return table.bucket_order is not None and table.bucket_order[1] == (name,)

    if ordered_on(right, rname):
        swapped, num_buckets = False, right.bucket_order[0]
    elif ordered_on(left, lname):
        swapped, num_buckets = True, left.bucket_order[0]
    else:
        return None
    lcomp, l_fits = kernels.bucket_composite_keys(lkeys, lcol.dtype, num_buckets)
    rcomp, r_fits = kernels.bucket_composite_keys(rkeys, rcol.dtype, num_buckets)
    fits = [f for f in (l_fits, r_fits) if f is not None]
    if fits and not bool(torch.stack(fits).all()):  # HOST SYNC (single scalar).
        return None
    return lcomp, rcomp, swapped


def _execute_join(plan: Join, needed: Optional[Set[str]], session) -> Table:
    if plan.join_type == "cross":
        return _execute_cross_join(plan, needed, session)
    pairs = E.extract_equi_join_keys(plan.condition)
    if pairs is None:
        raise HyperspaceException(
            f"Only conjunctive equi-joins are supported; got {plan.condition!r}")
    left_names = set(plan.left.schema.names)
    right_names = set(plan.right.schema.names)
    norm: List[Tuple[str, str]] = []
    for a, b in pairs:
        if a in left_names and b in right_names:
            norm.append((a, b))
        elif b in left_names and a in right_names:
            norm.append((b, a))
        else:
            raise HyperspaceException(
                f"Join keys ({a}, {b}) do not split across the two sides")
    lneed = None if needed is None else \
        {n for n in needed if n in left_names} | {p[0] for p in norm}
    rneed = None if needed is None else \
        {n for n in needed if n in right_names} | {p[1] for p in norm}
    left = _execute(plan.left, lneed, session)
    right = _execute(plan.right, rneed, session)
    how = plan.join_type
    if how in ("semi", "anti"):
        return _execute_semi_anti_join(left, right, norm, how)
    if how == "right":
        # A right join is a left join with the sides swapped: the output
        # is assembled by name against the plan's schema.
        left, right = right, left
        norm = [(r, l) for l, r in norm]
        how = "left"
    if how in ("left", "full"):
        return _execute_outer_join(plan, left, right, norm, how)
    left, right, lkeys, rkeys = _probe_keys(left, right, norm)
    li, ri = kernels.merge_join_indices(lkeys, rkeys)
    del lkeys, rkeys
    return _gather_join_output(plan, left, right, li, ri)


def _execute_cross_join(plan: Join, needed: Optional[Set[str]], session) -> Table:
    """Every left row with every right row, left-major. The SQL front end
    emits it for single-row sides (comma-joined global aggregates); a guard
    bounds the general case."""
    left_names = set(plan.left.schema.names)
    lneed = None if needed is None else {n for n in needed if n in left_names}
    rneed = None if needed is None else {n for n in needed if n not in left_names}
    left = _execute(plan.left, lneed, session)
    right = _execute(plan.right, rneed, session)
    n, m = left.num_rows, right.num_rows
    if n * m > 50_000_000:
        raise HyperspaceException(f"Cross join too large: {n} x {m} rows")
    dev = left.device
    li = torch.repeat_interleave(torch.arange(n, device=dev), m)
    ri = torch.arange(m, device=dev).repeat(n)
    out = {}
    for name in plan.schema.names:
        if needed is not None and name not in needed:
            continue
        if name in left.columns:
            out[name] = left.column(name).take(li)
        elif name in right.columns:
            out[name] = right.column(name).take(ri)
    if not out:
        # count(*) over a cross join: one column carries the row count.
        if left.columns:
            k = next(iter(left.columns))
            out[k] = left.columns[k].take(li)
        else:
            k = next(iter(right.columns))
            out[k] = right.columns[k].take(ri)
    return Table(out)


def _execute_semi_anti_join(left: Table, right: Table, norm, how: str) -> Table:
    """The left rows with (semi) or without (anti) a key match on the
    right, in their order (a bucket order survives): membership by one
    sort and a searchsorted. A null left key matches nothing (anti keeps
    the row); null right keys are dropped first."""
    lkeys, rkeys = _join_key_arrays(left, right, norm)
    lvalid = _keys_validity(left, [p[0] for p in norm])
    rvalid = _keys_validity(right, [p[1] for p in norm])
    if rvalid is not None:
        rkeys = rkeys[rvalid]
    lkeys, rkeys = kernels.same_dtype(lkeys, rkeys)
    found = kernels.isin_sorted(lkeys, torch.sort(rkeys).values)
    if lvalid is not None:
        found = found & lvalid
    return left.filter(found if how == "semi" else ~found)


def _null_filled_like(table: Table, n: int) -> Dict[str, Column]:
    """``n`` rows of every column of ``table``, all null (outer-join padding)."""
    out = {}
    for name, c in table.columns.items():
        dev = c.data.device
        out[name] = Column(c.dtype, torch.zeros((n,) + tuple(c.data.shape[1:]),
                                                dtype=c.data.dtype, device=dev),
                           torch.zeros(n, dtype=torch.bool, device=dev), c.dictionary)
    return out


def _execute_outer_join(plan: Join, left: Table, right: Table, norm, how: str) -> Table:
    """LEFT (or FULL) outer equi-join: the inner matches, then the left
    rows with none, the right side null-filled, then (full) the right rows
    no left row matched, the left side null-filled. A null key matches
    nothing. The bucket order does not survive."""
    lkeys_all, rkeys_all = _join_key_arrays(left, right, norm)
    lvalid = _keys_validity(left, [p[0] for p in norm])
    rvalid = _keys_validity(right, [p[1] for p in norm])
    l_idx = kernels.filter_indices(lvalid) if lvalid is not None else None
    r_idx = kernels.filter_indices(rvalid) if rvalid is not None else None
    lkeys = lkeys_all[l_idx] if l_idx is not None else lkeys_all
    rkeys = rkeys_all[r_idx] if r_idx is not None else rkeys_all
    order = kernels.lex_sort_indices([rkeys])
    li, ri, counts = kernels.merge_join_indices(lkeys, rkeys[order], return_counts=True)
    # Back from the valid subsets to row positions.
    li_orig = l_idx[li] if l_idx is not None else li
    r_pos = r_idx[order] if r_idx is not None else order
    ri_orig = r_pos[ri]
    unmatched_l = kernels.filter_indices(counts == 0)
    if l_idx is not None:
        unmatched_l = torch.cat([l_idx[unmatched_l], kernels.filter_indices(~lvalid)])
    blocks = [{**left.take(li_orig).columns, **right.take(ri_orig).columns}]
    n_um_l = int(unmatched_l.shape[0])
    if n_um_l:
        blocks.append({**left.take(unmatched_l).columns, **_null_filled_like(right, n_um_l)})
    if how == "full":
        # Right rows no left row matched (null-key rows among them).
        hit = torch.zeros(right.num_rows, dtype=torch.bool, device=ri_orig.device)
        hit[ri_orig] = True
        unmatched_r = kernels.filter_indices(~hit)
        n_um_r = int(unmatched_r.shape[0])
        if n_um_r:
            blocks.append({**_null_filled_like(left, n_um_r),
                           **right.take(unmatched_r).columns})
    names = [n for n in plan.schema.names if n in blocks[0]]
    return Table.concat([Table({n: b[n] for n in names}) for b in blocks])


def _probe_keys(left: Table, right: Table, norm: List[Tuple[str, str]]):
    """(probe side, build side sorted by its keys, probe keys, sorted build
    keys). Rows with a null key are dropped (they match nothing); a side
    in bucket order on its key is probed by (bucket, key) composites
    without a sort, the other side becoming the probe side."""
    global FAST_JOIN_COUNT
    lkeys, rkeys = _join_key_arrays(left, right, norm)
    lvalid = _keys_validity(left, [p[0] for p in norm])
    if lvalid is not None:
        idx = kernels.filter_indices(lvalid)
        left, lkeys = left.take(idx), lkeys[idx]
    rvalid = _keys_validity(right, [p[1] for p in norm])
    if rvalid is not None:
        idx = kernels.filter_indices(rvalid)
        right, rkeys = right.take(idx), rkeys[idx]
    fast = _bucketed_merge_keys(left, right, norm, lkeys, rkeys)
    if fast is not None:
        FAST_JOIN_COUNT += 1
        lcomp, rcomp, swapped = fast
        if swapped:
            return right, left, rcomp, lcomp
        return left, right, lcomp, rcomp
    order = kernels.lex_sort_indices([rkeys])
    return left, right.take(order), lkeys, rkeys[order]


def _gather_join_output(plan: Join, left: Table, right: Table, li: torch.Tensor,
                        ri: torch.Tensor) -> Table:
    taken_left, taken_right = left.take(li), right.take(ri)
    out = {}
    for n in plan.schema.names:
        # The sides were column-pruned; emit only what they produced.
        if n in taken_left.columns:
            out[n] = taken_left.columns[n]
        elif n in taken_right.columns:
            out[n] = taken_right.columns[n]
    # The output follows the probe (left) side's row order, so its bucket
    # order survives for a group-by on those keys downstream.
    order_out = left.bucket_order
    if order_out is not None and not all(k in out for k in order_out[1]):
        order_out = None
    return Table(out, order_out)


# ---------------------------------------------------------------------------
# Aggregate and Sort.
# ---------------------------------------------------------------------------

def _null_aware_keys(c: Column) -> List[torch.Tensor]:
    """Sort keys for one column with null as its own value, before every
    real one: (validity flag, null-masked data) when nullable."""
    if c.validity is None:
        return [c.data]
    return [c.validity.to(torch.int32),
            torch.where(c.validity, c.data, torch.zeros((), dtype=c.data.dtype,
                                                        device=c.data.device))]


def _group_sort_keys(cols: Sequence[Column]) -> List[torch.Tensor]:
    return [k for c in cols for k in _null_aware_keys(c)]


def _unwrap_agg(agg: E.Expr) -> E.AggExpr:
    while isinstance(agg, E.Alias):
        agg = agg.child
    if not isinstance(agg, E.AggExpr):
        raise HyperspaceException(f"Aggregate list requires agg functions; got {agg!r}")
    return agg


def _agg_child_column(agg: E.AggExpr, table: Table) -> Column:
    child = _eval_expr_banked(table, agg.child)
    if child.dtype == STRING and not isinstance(agg, (E.Min, E.Max)):
        raise HyperspaceException("sum/avg over string column")
    return child


def _sum_dtype(values: torch.Tensor) -> str:
    return FLOAT64 if values.is_floating_point() else INT64


def _count_distinct(child: Column, gids: torch.Tensor, num_groups: int) -> Column:
    """COUNT(DISTINCT value) per group: rows sorted by (group, value), the
    first row of each pair flagged, the flags summed per group. Null values
    are parked in a segment past the real groups; NaN counts as one value."""
    n = child.data.shape[0]
    dev = child.data.device
    if n == 0:
        return Column(INT64, torch.zeros(num_groups, dtype=torch.int64, device=dev))
    data = child.data.to(torch.int32) if child.dtype == BOOL else child.data
    gid_key = gids if child.validity is None else \
        torch.where(child.validity, gids, torch.full_like(gids, num_groups))
    perm = kernels.lex_sort_indices([gid_key, data])
    sg, sv = gid_key[perm], data[perm]
    first = kernels.change_mask([sg, sv])
    first[0] = True
    if sv.is_floating_point():
        # NaN != NaN would count each NaN; the sort puts a group's NaNs
        # side by side, so a NaN after a NaN is no new value.
        nan_pair = torch.zeros(n, dtype=torch.bool, device=dev)
        nan_pair[1:] = torch.isnan(sv[1:]) & torch.isnan(sv[:-1]) & (sg[1:] == sg[:-1])
        first = first & ~nan_pair
    counts = kernels.segment_sum(first.to(torch.int64), sg, num_groups + 1)[:num_groups]
    return Column(INT64, counts)


def _eval_agg(agg_expr: E.Expr, table: Table, gids: torch.Tensor, num_groups: int) -> Column:
    agg = _unwrap_agg(agg_expr)
    if isinstance(agg, E.CountDistinct):
        return _count_distinct(eval_expr(table, agg.child), gids, num_groups)
    if isinstance(agg, E.Count):
        validity = None if agg.child is None else eval_expr(table, agg.child).validity
        return Column(INT64, kernels.segment_count(gids, num_groups, validity))
    child = _agg_child_column(agg, table)
    if isinstance(agg, (E.Sum, E.Avg)):
        value, counts = kernels.segment_agg(child.data, child.validity, gids, num_groups,
                                            "mean" if isinstance(agg, E.Avg) else "sum")
        # SQL: a group with no valid values aggregates to NULL.
        validity = None if child.validity is None else counts > 0
        return Column(FLOAT64 if isinstance(agg, E.Avg) else _sum_dtype(value),
                      value, validity)
    if isinstance(agg, (E.Min, E.Max)):
        value, counts = kernels.segment_agg(child.data, child.validity, gids, num_groups,
                                            "min" if isinstance(agg, E.Min) else "max",
                                            widen=False)
        validity = None if child.validity is None else counts > 0
        return Column(child.dtype, value, validity, child.dictionary)
    raise HyperspaceException(f"Unknown aggregate {agg!r}")


def _execute_aggregate(plan: Aggregate, table: Table) -> Table:
    if not plan.group_cols:
        return _execute_global_aggregate(plan, table)
    key_cols = [table.column(g) for g in plan.group_cols]
    order = table.bucket_order
    keys_non_null = all(c.validity is None for c in key_cols)
    if order is not None and set(order[1]) == set(plan.group_cols) and keys_non_null:
        # Rows sorted by (bucket, keys): equal key tuples are contiguous
        # (a tuple lives in one bucket), so no sort is needed. Nullable
        # keys fall through: their fill values would meet real zeros.
        sorted_table, sorted_keys = table, [c.data for c in key_cols]
    elif order is not None and set(order[1]) < set(plan.group_cols) and keys_non_null \
            and not any(isinstance(_unwrap_agg(a), E.CountDistinct) for a in plan.aggs):
        # (Distinct counts of runs do not combine: the full sort handles them.)
        # The bucket keys are a strict subset of the group keys (Q3: the
        # join output in l_orderkey order, grouped by three keys): equal
        # tuples come in runs, so only the runs are sorted.
        return _execute_aggregate_two_phase(plan, table, key_cols)
    else:
        perm = kernels.lex_sort_indices(_group_sort_keys(key_cols))
        sorted_table = table.take(perm)
        sorted_keys = _group_sort_keys([sorted_table.column(g) for g in plan.group_cols])
    gids, num_groups = kernels.group_ids_from_sorted(sorted_keys)
    if num_groups == 0:
        return empty_table(plan.schema, table.device)
    arrays, spec = [], []
    for g in plan.group_cols:
        c = sorted_table.column(g)
        arrays.append(c.data)
        spec.append((g, "d"))
        if c.validity is not None:
            arrays.append(c.validity)
            spec.append((g, "v"))
    heads = dict(zip(spec, kernels.segment_heads(gids, arrays, num_groups)))
    out = {}
    for g in plan.group_cols:
        c = sorted_table.column(g)
        out[g] = Column(c.dtype, heads[(g, "d")], heads.get((g, "v")), c.dictionary)
    for agg in plan.aggs:
        out[agg.name] = _eval_agg(agg, sorted_table, gids, num_groups)
    return Table(out)


def _execute_global_aggregate(plan: Aggregate, table: Table) -> Table:
    """One output row: every input row in group 0."""
    gids = torch.zeros(table.num_rows, dtype=torch.int64, device=table.device)
    return Table({a.name: _eval_agg(a, table, gids, 1) for a in plan.aggs})


def _execute_aggregate_two_phase(plan: Aggregate, table: Table,
                                 key_cols: List[Column]) -> Table:
    """Phase 1 reduces each run of consecutive equal key tuples to
    partials without a sort; phase 2 sorts only the runs and combines the
    partials of equal tuples in that order. Output is key-sorted, as the
    full-sort path's is."""
    run_keys = [c.data for c in key_cols]
    rids, num_runs = kernels.group_ids_from_sorted(run_keys)
    if num_runs == 0:
        return empty_table(plan.schema, table.device)
    run_vals = kernels.segment_heads(rids, run_keys, num_runs)
    order2 = kernels.lex_sort_indices(run_vals)
    sorted_vals = [v[order2] for v in run_vals]
    gids2, num_groups = kernels.group_ids_from_sorted(sorted_vals)

    def combine(run_partial: torch.Tensor, op: str) -> torch.Tensor:
        return kernels.gather_segment(run_partial, order2, gids2, num_groups, op)

    out = {}
    for g, gv in zip(plan.group_cols, kernels.segment_heads(gids2, sorted_vals, num_groups)):
        src = table.column(g)
        out[g] = Column(src.dtype, gv, None, src.dictionary)
    for agg_expr in plan.aggs:
        agg = _unwrap_agg(agg_expr)
        if isinstance(agg, E.Count):
            validity = None if agg.child is None else eval_expr(table, agg.child).validity
            out[agg_expr.name] = Column(
                INT64, combine(kernels.segment_count(rids, num_runs, validity), "sum"))
            continue
        child = _agg_child_column(agg, table)
        validity = child.validity
        out_validity = None
        if isinstance(agg, (E.Sum, E.Avg)):
            run_sums, run_valid = kernels.segment_agg(child.data, validity, rids,
                                                      num_runs, "sum")
            total_valid = None
            if run_valid is not None:
                total_valid = combine(run_valid, "sum")
                out_validity = total_valid > 0
            sums = combine(run_sums, "sum")
            if isinstance(agg, E.Sum):
                out[agg_expr.name] = Column(_sum_dtype(sums), sums, out_validity)
                continue
            if total_valid is None:
                total_valid = combine(kernels.segment_count(rids, num_runs), "sum")
            out[agg_expr.name] = Column(
                FLOAT64, sums.to(torch.float64) / total_valid.clamp(min=1).to(torch.float64),
                out_validity)
        elif isinstance(agg, (E.Min, E.Max)):
            op = "min" if isinstance(agg, E.Min) else "max"
            run_m, run_valid = kernels.segment_agg(child.data, validity, rids, num_runs, op,
                                                   widen=False)
            if run_valid is not None:
                out_validity = combine(run_valid, "sum") > 0
            out[agg_expr.name] = Column(child.dtype, combine(run_m, op), out_validity,
                                        child.dictionary)
        else:
            raise HyperspaceException(f"Unknown aggregate {agg!r}")
    return Table(out)


def _execute_sort(plan: Sort, table: Table) -> Table:
    """Stable; nulls first ascending and last descending (Spark's
    default), by sorting the null-aware keys in the requested direction."""
    keys, ascending = [], []
    for name, asc in plan.orders:
        for k in _null_aware_keys(table.column(name)):
            keys.append(k)
            ascending.append(asc)
    return table.take(kernels.lex_sort_indices(keys, ascending))


def _execute_limit(plan: Limit, table: Table) -> Table:
    return table.slice(0, min(plan.n, table.num_rows))


# ---------------------------------------------------------------------------
# Window.
# ---------------------------------------------------------------------------

def _dict_for(table: Table, name: str):
    c = table.columns.get(name)
    return c.dictionary if c is not None and c.dtype == STRING else None


def _execute_window(plan: Window, table: Table) -> Table:
    """Analytic functions as a sort and segmented scans, in the child's
    row order: values are computed in partition-sorted order and scattered
    back through the sort permutation. Window expressions with one
    (partition, order) spec share one sort."""
    n = table.num_rows
    out = dict(table.columns)
    dev = table.device
    if n == 0:
        for name, w in plan.wexprs:
            f = plan.schema.field(name)
            dic = _dict_for(table, w.arg.column) if (
                w.arg is not None and f.dtype == STRING) else None
            out[name] = Column(f.dtype, torch.zeros(0, dtype=DEVICE_DTYPE[f.dtype], device=dev),
                               None, dic)
        return Table(out, table.bucket_order)
    iota = torch.arange(n, device=dev)
    specs: Dict[Tuple, List] = {}
    for name, w in plan.wexprs:
        key = (tuple(p.column for p in w.partition),
               tuple((o.column, asc) for o, asc in w.orders))
        specs.setdefault(key, []).append((name, w))
    for (pcols, oitems), group in specs.items():
        keys, asc_flags = [], []
        for p in pcols:
            for k in _null_aware_keys(table.column(p)):
                keys.append(k)
                asc_flags.append(True)
        for oc, a in oitems:
            for k in _null_aware_keys(table.column(oc)):
                keys.append(k)
                asc_flags.append(a)
        order = kernels.lex_sort_indices(keys, asc_flags) if keys else iota
        if pcols:
            pkeys_sorted = _group_sort_keys([table.column(p).take(order) for p in pcols])
            pids, n_part = kernels.group_ids_from_sorted(pkeys_sorted)
        else:
            pkeys_sorted = []
            pids, n_part = torch.zeros(n, dtype=torch.int64, device=dev), 1
        part_start = torch.ones(n, dtype=torch.bool, device=dev)
        part_start[1:] = pids[1:] != pids[:-1]
        part_first = kernels.segment_first_index(pids, n_part)
        pos = iota - part_first[pids]
        peer_gid = peer_first = peer_last = None
        if oitems:
            okeys_sorted = _group_sort_keys([table.column(oc).take(order) for oc, _ in oitems])
            peer_gid, n_peer = kernels.group_ids_from_sorted(pkeys_sorted + okeys_sorted)
            peer_first = kernels.segment_first_index(peer_gid, n_peer)
            peer_last = kernels.segment_last_index(peer_gid, n_peer)
        for name, w in group:
            dtype = plan.schema.field(name).dtype
            validity_s = None
            dic = None
            if w.fn == "row_number":
                vals = (pos + 1).to(torch.int64)
            elif w.fn == "rank":
                vals = (peer_first[peer_gid] - part_first[pids] + 1).to(torch.int64)
            elif w.fn == "dense_rank":
                vals = (peer_gid - peer_gid[part_first[pids]] + 1).to(torch.int64)
            else:
                arg = None if w.arg is None else table.column(w.arg.column).take(order)
                vals, validity_s = _window_agg(w, arg, pids, n_part, part_start, peer_gid,
                                               peer_last)
                if dtype == STRING:
                    dic = arg.dictionary
            data = torch.empty(n, dtype=vals.dtype, device=dev)
            data[order] = vals
            validity = None
            if validity_s is not None:
                validity = torch.empty(n, dtype=torch.bool, device=dev)
                validity[order] = validity_s
            out[name] = Column(dtype, data, validity, dic)
    return Table(out, table.bucket_order)


def _window_agg(w: E.WindowExpr, arg: Optional[Column], pids: torch.Tensor, n_part: int,
                part_start: torch.Tensor, peer_gid, peer_last):
    """One windowed aggregate in partition-sorted order: (values, validity
    or None). Frames: 'partition', the whole partition; 'rows', running;
    'range', running with order-key peers sharing their last row's value
    (SQL's default with ORDER BY). Running sums add in the JAX package's
    associative-scan order (kernels.segmented_scan)."""
    fn, frame = w.fn, w.frame
    n = pids.shape[0]
    dev = pids.device
    if frame == "range" and peer_gid is None:
        frame = "partition"  # no ORDER BY: every row is a peer
    if fn == "count":
        data = torch.ones(n, dtype=torch.int64, device=dev) \
            if arg is None or arg.validity is None else arg.validity.to(torch.int64)
    elif fn in ("sum", "avg"):
        if arg.dtype == STRING:
            raise HyperspaceException(f"{fn} over string column")
        data = arg.data.to(torch.float64 if arg.data.is_floating_point() else torch.int64)
        if arg.validity is not None:
            data = torch.where(arg.validity, data, torch.zeros((), dtype=data.dtype, device=dev))
        if fn == "avg":
            data = data.to(torch.float64)
    else:  # min / max: invalid rows past every real value
        data = arg.data
        if arg.validity is not None:
            data = torch.where(arg.validity, data, torch.full(
                (), kernels._sentinel(data.dtype, fn == "min"), dtype=data.dtype, device=dev))
    valid = None if arg is None or arg.validity is None else arg.validity.to(torch.int64)

    def framed(values: torch.Tensor, op, seg_op: str) -> torch.Tensor:
        if frame == "partition":
            seg = {"sum": kernels.segment_sum, "min": kernels.segment_min,
                   "max": kernels.segment_max}[seg_op](values, pids, n_part)
            return seg[pids]
        running = kernels.segmented_scan(values, part_start, op)
        if frame == "range":
            running = running[peer_last[peer_gid]]
        return running

    if fn == "count":
        return framed(data, torch.add, "sum"), None
    if fn in ("min", "max"):
        vals = framed(data, torch.minimum if fn == "min" else torch.maximum, fn)
        if valid is None:
            return vals, None
        return vals, framed(valid, torch.add, "sum") > 0
    total = framed(data, torch.add, "sum")
    if fn == "avg":
        cnt = framed(valid if valid is not None else torch.ones(n, dtype=torch.int64,
                                                                 device=dev),
                     torch.add, "sum")
        return total / cnt.clamp(min=1), (cnt > 0) if valid is not None else None
    if valid is None:
        return total, None
    return total, framed(valid, torch.add, "sum") > 0
