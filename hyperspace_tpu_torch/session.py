"""Session + DataFrame API (counterpart of ``hyperspace_tpu/session.py``).

The session holds the conf, the device, the source-provider manager, the
temp views and the hyperspace switch; ``enable_hyperspace()`` turns the
index rewrite on for every later query. ``sql(text)`` lowers a SELECT over
the temp views onto the same DataFrame API (``sql.py``). DataFrames are
thin wrappers over the logical plan IR; ``to_arrow()`` runs normalization
(filter pushdown, column pruning) → (hyperspace rewrite if enabled) → the
executor.

The session holds one caching index manager, which the rules and the
``Hyperspace`` facade share, and a tally of how often each index was
applied by a real (not a diagnostic) rewrite pass.

``execute(plan, context=None)`` runs under a per-query context
(serving/context.py). With ``advisor.capture.enabled`` it records the
query in the session's workload log (advisor/workload.py); with
``adaptive.replan.enabled`` it runs a query once more when a join boundary
asks for a re-plan (adaptive/feedback.py). With
``serving.result_cache.enabled`` it consults the result cache first
(``Session.result_cache``, rebuilt whenever its budgets change), and
``sql`` memoizes lowered plans by (text, temp-view version, case mode).

Each execution opens a span-tree trace (telemetry/trace.py) while
``telemetry.trace.enabled`` is on (the default), with the
``plan.normalize`` and ``rewrite.index_rules`` spans of the optimizer
under its ``query`` root; the retained one is ``_last_trace``
(``Hyperspace.last_trace()``). Every execution feeds the SLO monitor
(telemetry/slo.py). ``telemetry.profiler.{enabled,dir}`` capture one query
with torch.profiler; ``hyperspace.tpu.trace.dir`` captures every
execution.

The device defaults to ``"cuda"``. A session asked for CUDA on a machine
without it raises; it never carries on quietly on the CPU. Pass
``device="cpu"`` to run the plain torch versions of the kernels.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union as TUnion

import torch

from .config import CacheWithTransform, Conf, HyperspaceConf
from .exceptions import HyperspaceException
from .index.constants import IndexConstants
from .plan import expr as E
from .plan.nodes import (Aggregate, Filter, Join, Limit, LogicalPlan, Project, Scan, Sort,
                         Union, Window)
from .schema import Schema
from .sources.default import DefaultFileBasedSourceBuilder
from .sources.delta import VERSION_AS_OF_OPTION, DeltaLakeSourceBuilder
from .sources.iceberg import SNAPSHOT_ID_OPTION, IcebergSourceBuilder
from .sources.interfaces import FileBasedSourceProviderManager
from .telemetry import span_names as SN
from .telemetry import trace as _trace


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HyperspaceException(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the plain torch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise HyperspaceException(f"Unsupported device {dev}")
    return dev


class Session:
    def __init__(self, conf: Optional[Dict[str, str]] = None,
                 system_path: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.conf = Conf(conf)
        if system_path is not None:
            self.conf.set(IndexConstants.INDEX_SYSTEM_PATH, system_path)
        self.hs_conf = HyperspaceConf(self.conf)
        self._hyperspace_enabled = False
        # The JAX package's default order of builders.
        self.source_provider_manager = FileBasedSourceProviderManager(
            [DefaultFileBasedSourceBuilder(), DeltaLakeSourceBuilder(), IcebergSourceBuilder()])
        self._index_collection_manager = None
        # index name -> times a real rewrite pass applied it
        # (rules/rule_utils.log_index_usage increments under the lock).
        self._index_usage_counts: Dict[str, int] = {}
        self._usage_counts_lock = threading.Lock()
        # The advisor's workload log (advisor/workload.py), made here so the
        # serving workers' concurrent captures share one; and, per thread,
        # the reason collector of the last real rewrite pass, whose applied
        # names a capture records.
        from .advisor.workload import WorkloadLog
        self._workload_log = WorkloadLog()
        self._reason_tls = threading.local()
        # Temp views by lower-cased name (view names are case-insensitive);
        # every registration bumps the version the SQL plan memo keys on.
        self._temp_views: Dict[str, LogicalPlan] = {}
        self._views_lock = threading.Lock()
        self._temp_views_version = 0
        # The result cache follows its conf string (switch and budgets):
        # rebuilt, and so emptied, when that changes.
        self._result_cache_holder = CacheWithTransform(
            self.hs_conf.result_cache_conf_string, self._build_result_cache)
        self._sql_plan_cache: "OrderedDict[Tuple, LogicalPlan]" = OrderedDict()
        self._sql_plan_stats = {"hits": 0, "misses": 0}
        self._sql_plan_lock = threading.Lock()
        # The cost-based optimizer's state: the statistics provider
        # (optimizer/stats.provider_for attaches it on first use), the
        # chain records of the last join-reorder pass, and the output rows
        # of recent inner joins by join_actual_key (bounded LRU, written
        # by the executor under the lock); explain and the adaptive
        # feedback loop read the last two.
        self._stats_provider = None
        self._last_join_order: Optional[list] = None
        self._join_actuals: "OrderedDict[str, int]" = OrderedDict()
        self._join_actuals_lock = threading.Lock()
        # The span tree of the most recent retained trace (telemetry/trace.py);
        # Hyperspace.last_trace() and explain's "Trace:" section read it.
        self._last_trace = None
        # Opt-in artifact preload: the lake's kernel libraries, hottest
        # first, within the preload budgets, so this process's first query
        # runs no nvcc. An unreadable store directory leaves the session up
        # (a later miss builds).
        if self.hs_conf.artifacts_preload_enabled():
            from .artifacts.manager import preload as _artifact_preload
            try:
                _artifact_preload(self)
            except OSError:
                pass

    @property
    def _last_reason_collector(self):
        """The calling thread's last real rewrite pass's reason collector."""
        return getattr(self._reason_tls, "collector", None)

    @_last_reason_collector.setter
    def _last_reason_collector(self, ctx) -> None:
        self._reason_tls.collector = ctx

    @property
    def index_collection_manager(self):
        """The session's caching index manager, built on first use."""
        if self._index_collection_manager is None:
            from .index.manager import CachingIndexCollectionManager
            self._index_collection_manager = CachingIndexCollectionManager(self)
        return self._index_collection_manager

    def _build_result_cache(self, raw: str):
        from .serving.result_cache import build_result_cache
        return build_result_cache(self)

    @property
    def result_cache(self):
        """The result cache (serving/result_cache.py), or None while
        ``serving.result_cache.enabled`` is false."""
        return self._result_cache_holder.load()

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    def create_temp_view(self, name: str, df: "DataFrame", replace: bool = False) -> None:
        key = name.lower()
        with self._views_lock:
            if key in self._temp_views and not replace:
                raise HyperspaceException(f"Temp view already exists: {name}")
            self._temp_views[key] = df.plan
            self._temp_views_version += 1

    def table(self, name: str) -> "DataFrame":
        """A DataFrame over a temp view. It shares the view's plan, so the
        index rewrites apply as on the DataFrame the view was made from."""
        with self._views_lock:
            plan = self._temp_views.get(name.lower())
        if plan is None:
            raise HyperspaceException(f"No such temp view: {name}")
        return DataFrame(self, plan)

    def drop_temp_view(self, name: str) -> bool:
        with self._views_lock:
            dropped = self._temp_views.pop(name.lower(), None) is not None
            if dropped:
                self._temp_views_version += 1
            return dropped

    def create_dataframe(self, plan: LogicalPlan) -> "DataFrame":
        return DataFrame(self, plan)

    def sql(self, text: str) -> "DataFrame":
        """One SQL SELECT over the temp views, lowered onto the DataFrame
        API (the grammar of ``sql.py``, the JAX package's).

        While the result cache is enabled, the lowered plan is memoized by
        (text, temp-view version, case mode), up to ``planCacheSize``
        texts: lowering is pure given those."""
        from .sql import sql as _sql
        size = self.hs_conf.result_cache_plan_cache_size() \
            if self.result_cache is not None else 0
        if size <= 0:
            return _sql(self, text)
        key = (text, self._temp_views_version, self.hs_conf.case_sensitive())
        with self._sql_plan_lock:
            plan = self._sql_plan_cache.get(key)
            if plan is not None:
                self._sql_plan_cache.move_to_end(key)
                self._sql_plan_stats["hits"] += 1
                return DataFrame(self, plan)
            self._sql_plan_stats["misses"] += 1
        df = _sql(self, text)
        with self._sql_plan_lock:
            self._sql_plan_cache[key] = df.plan
            while len(self._sql_plan_cache) > size:
                self._sql_plan_cache.popitem(last=False)
        return df

    def enable_hyperspace(self) -> "Session":
        self._hyperspace_enabled = True
        return self

    def disable_hyperspace(self) -> "Session":
        self._hyperspace_enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self._hyperspace_enabled

    def optimize(self, plan: LogicalPlan, diagnostic: bool = False,
                 _pre_normalized: bool = False) -> LogicalPlan:
        """Filter pushdown below projections and inner joins, column
        pruning (the join rule's coverage check sees each side's true
        column set only after it), join reordering if
        ``optimizer.joinReorder.enabled``, the hyperspace rewrite batch if
        enabled, then partition pruning. Partition pruning is always on,
        and runs after the index rules: it narrows a Scan's files, and the
        rules fingerprint the relation's full listing.

        ``diagnostic``: a pass whose plan is inspected, not executed
        (explain); its rewrite runs with a silent reason collector and
        counts no index usage. ``_pre_normalized``: the caller already ran
        the pushdown and pruning (serving.fingerprint.normalize)."""
        from .rules.column_pruning import prune_columns
        from .rules.pushdown import push_filters
        from .sources.partitions import prune_partitions
        if not _pre_normalized:
            with _trace.span(SN.PLAN_NORMALIZE):
                plan = prune_columns(push_filters(plan))
        # Join reordering wants the pushed filters (selectivity) and runs
        # before the index rules, which then match the reordered tree. The
        # result cache's key pins the flag through the conf hash.
        if self.hs_conf.join_reorder_enabled():
            from .optimizer.join_order import reorder_joins
            plan = reorder_joins(self, plan, diagnostic=diagnostic)
        if self._hyperspace_enabled:
            from .rules.apply_hyperspace import apply_hyperspace
            from .rules.index_filters import ReasonCollector
            ctx = ReasonCollector(enabled=False, silent=True) if diagnostic else None
            plan = apply_hyperspace(self, plan, ctx)
        return prune_partitions(plan)

    def execute(self, plan: LogicalPlan, context=None):
        """Execute a plan under a :class:`~.serving.context.QueryContext`:
        the one given (the serving frontend's), else one made for this
        call. The context pins the result cache and the advisor's capture
        decision, carries the query's io counters, its deadline and its
        trace. The trace root and the one-shot profiler capture bracket the
        whole execution, and the session's ``robustness.faults.*`` conf arms
        its fault points for exactly this execution; the SLO monitor records
        every query's latency and outcome."""
        from .robustness import faults as _faults
        from .serving.context import QueryContext
        ctx = context if context is not None else QueryContext.for_session(self)
        with ctx.activate(), _faults.scope_for(self.hs_conf), _trace.maybe_profile(self), \
                _trace.query_trace(self, ctx):
            t0 = time.perf_counter()
            error = suppress = False
            try:
                if not ctx.capture:
                    return self._execute_uncaptured(plan, ctx)
                # Workload capture (advisor/workload.py) times whatever
                # path runs. The collector is cleared first, so the applied
                # names are this execution's (a result-cache hit runs no
                # rewrite and records none).
                self._last_reason_collector = None
                table = self._execute_uncaptured(plan, ctx)
                from .advisor.workload import capture_execution
                capture_execution(self, plan, time.perf_counter() - t0)
                return table
            except BaseException as exc:
                error = True
                # A failed query is tail-keep-worthy by definition.
                _trace.keep_active("error")
                # A sweep member the frontend reruns alone records its
                # outcome from the rerun; a cancellation is never rerun.
                from .exceptions import QueryDeadlineError
                suppress = ctx.slo_suppress_error and not isinstance(exc, QueryDeadlineError)
                raise
            finally:
                if not suppress:
                    from .telemetry import slo as _slo
                    _slo.observe_query(self, (time.perf_counter() - t0) * 1000.0,
                                       error=error, degraded=ctx.degraded)

    def _execute_uncaptured(self, plan: LogicalPlan, ctx):
        """One execution; with ``adaptive.replan.enabled``, a second one
        when a join boundary asks for a re-plan (adaptive/feedback.py). The
        observation is in the correction store by then, so the second plan
        uses it; that attempt runs to its end (one re-plan a query)."""
        if not self.hs_conf.adaptive_replan_enabled():
            return self._execute_once(plan, ctx)
        from .adaptive import feedback as _feedback
        try:
            return self._execute_once(plan, ctx)
        except _feedback.ReplanRequested as rr:
            _feedback.emit_replan_event(self, rr)
            with _feedback.suppress_replans():
                return self._execute_once(plan, ctx)

    def _execute_once(self, plan: LogicalPlan, ctx):
        cache = ctx.result_cache
        if cache is not None:
            # A hit skips the rewrite and the execution; a miss executes and
            # applies the admission floors. The frontend's context may carry
            # its cross-session cache: the keys pin the plan, the sources,
            # the index versions and this session's conf.
            from .serving.result_cache import execute_with_cache
            return execute_with_cache(self, cache, plan)
        return self._run_optimized(self.optimize(plan))

    def _run_optimized(self, optimized: LogicalPlan):
        from .execution.executor import execute
        trace_dir = self.hs_conf.trace_dir()
        if trace_dir:
            with _trace.profile_into(trace_dir, "execution"):
                return execute(optimized, self)
        return execute(optimized, self)


class DataFrameReader:
    """``session.read``: parquet, csv, json (newline-delimited), orc, text
    (one string column "value" per line) and avro files, delta and iceberg
    tables (lake/), or ``format(fmt).load(...)``. ``option`` values travel
    with the relation."""

    def __init__(self, session: Session):
        self._session = session
        self._options: Dict[str, str] = {}

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = str(value)
        return self

    def parquet(self, *paths: str) -> "DataFrame":
        return self.format("parquet").load(*paths)

    def csv(self, *paths: str) -> "DataFrame":
        return self.format("csv").load(*paths)

    def json(self, *paths: str) -> "DataFrame":
        return self.format("json").load(*paths)

    def orc(self, *paths: str) -> "DataFrame":
        return self.format("orc").load(*paths)

    def text(self, *paths: str) -> "DataFrame":
        return self.format("text").load(*paths)

    def avro(self, *paths: str) -> "DataFrame":
        return self.format("avro").load(*paths)

    def delta(self, path: str, version_as_of: Optional[int] = None) -> "DataFrame":
        """A commit-log table (lake/delta.py), at ``version_as_of`` if given."""
        reader = self.format("delta")
        if version_as_of is not None:
            reader._options[VERSION_AS_OF_OPTION] = str(version_as_of)
        return reader.load(path)

    def iceberg(self, path: str, snapshot_id: Optional[int] = None) -> "DataFrame":
        """A snapshot/manifest table (lake/iceberg.py), at ``snapshot_id`` if
        given."""
        reader = self.format("iceberg")
        if snapshot_id is not None:
            reader._options[SNAPSHOT_ID_OPTION] = str(snapshot_id)
        return reader.load(path)

    def format(self, fmt: str) -> "_FormattedReader":
        return _FormattedReader(self._session, fmt, dict(self._options))


class _FormattedReader:
    def __init__(self, session: Session, fmt: str, options: Dict[str, str]):
        self._session = session
        self._fmt = fmt
        self._options = options

    def load(self, *paths: str) -> "DataFrame":
        relation = self._session.source_provider_manager.build_relation(
            list(paths), self._fmt, self._options)
        return DataFrame(self._session, Scan(relation))


class DataFrame:
    def __init__(self, session: Session, plan: LogicalPlan):
        self.session = session
        self.plan = plan

    @property
    def schema(self) -> Schema:
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return self.plan.schema.names

    # Column names resolve case-insensitively against the schema
    # (`hyperspace.caseSensitive=true` restores exact matching).
    # Unresolvable names pass through unchanged so the plan constructors
    # raise with the user's spelling.
    def _spelling(self, name: str, names: Optional[List[str]] = None) -> str:
        from .util.resolver import resolve
        avail = names if names is not None else self.plan.schema.names
        r = resolve(avail, name, self.session.hs_conf.case_sensitive())
        return r if r is not None else name

    def _resolve_expr(self, e: E.Expr, names: Optional[List[str]] = None) -> E.Expr:
        return E.rename_columns(e, lambda n: self._spelling(n, names))

    def filter(self, condition: E.Expr) -> "DataFrame":
        return DataFrame(self.session, Filter(self._resolve_expr(condition), self.plan))

    def select(self, *exprs: TUnion[str, E.Expr]) -> "DataFrame":
        flat: List[TUnion[str, E.Expr]] = []
        for e in exprs:
            flat.extend(e if isinstance(e, (list, tuple)) else [e])
        flat = [self._spelling(e) if isinstance(e, str) else self._resolve_expr(e)
                for e in flat]
        return DataFrame(self.session, Project(flat, self.plan))

    def join(self, other: "DataFrame", on: E.Expr, how: str = "inner") -> "DataFrame":
        both = list(self.plan.schema.names) + list(other.plan.schema.names)
        return DataFrame(self.session,
                         Join(self.plan, other.plan, self._resolve_expr(on, both), how))

    def cross_join(self, other: "DataFrame") -> "DataFrame":
        """The Cartesian product (the SQL front end emits it for single-row
        sides)."""
        return DataFrame(self.session, Join(self.plan, other.plan, None, "cross"))

    def group_by(self, *cols: str) -> "GroupedData":
        return GroupedData(self, [self._spelling(c) for c in cols])

    def agg(self, *aggs: E.Expr) -> "DataFrame":
        """A global aggregate: one row."""
        return DataFrame(self.session,
                         Aggregate([], [self._resolve_expr(a) for a in aggs], self.plan))

    def sort(self, *orders: TUnion[str, Tuple[str, bool]]) -> "DataFrame":
        """Sort by columns, each a name (ascending) or (name, ascending)."""
        normalized: List[Tuple[str, bool]] = []
        for o in orders:
            name, asc = (o, True) if isinstance(o, str) else o
            normalized.append((self._spelling(name), asc))
        return DataFrame(self.session, Sort(normalized, self.plan))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, Limit(n, self.plan))

    def execute(self):
        """Run the (possibly rewritten) plan; returns the device Table."""
        return self.session.execute(self.plan)

    def optimized_plan(self) -> LogicalPlan:
        return self.session.optimize(self.plan)

    def explain(self) -> str:
        """The plan's tree and, with hyperspace enabled, the rewritten one
        (a diagnostic pass: it counts no index usage)."""
        text = self.plan.tree_string()
        if self.session.is_hyperspace_enabled():
            text += "\n\n== Optimized (hyperspace) ==\n" + \
                self.session.optimize(self.plan, diagnostic=True).tree_string()
        return text

    def to_arrow(self):
        return self.execute().to_arrow()

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def collect(self) -> List[tuple]:
        return [tuple(d.values()) for d in self.to_arrow().to_pylist()]

    def count(self) -> int:
        return self.execute().num_rows

    def with_column(self, name: str, expr: E.Expr) -> "DataFrame":
        """Add or replace a column. The column to replace matches
        case-insensitively; the output keeps the caller's spelling."""
        resolved = self._spelling(name)
        expr = self._resolve_expr(expr)
        exprs = [E.Col(n) if n != resolved else expr.alias(name)
                 for n in self.plan.schema.names]
        if resolved not in self.plan.schema.names:
            exprs.append(expr.alias(name))
        return DataFrame(self.session, Project(exprs, self.plan))

    def with_window(self, name: str, wexpr: E.Expr) -> "DataFrame":
        """Append an analytic column built with ``plan.expr.window(...)``."""
        if not isinstance(wexpr, E.WindowExpr):
            raise HyperspaceException(f"with_window expects a WindowExpr; got {wexpr!r}")
        return DataFrame(self.session, Window([(name, self._resolve_expr(wexpr))], self.plan))

    def drop(self, *names: str) -> "DataFrame":
        dropped = {self._spelling(n) for n in names}
        keep = [n for n in self.plan.schema.names if n not in dropped]
        if not keep:
            raise HyperspaceException("drop() would remove every column")
        return DataFrame(self.session, Project(keep, self.plan))

    def distinct(self) -> "DataFrame":
        """Distinct rows: a group-by on every column, so the index rewrites
        apply to it."""
        cols = list(self.plan.schema.names)
        # A count alias that no group column shares.
        cnt = "__distinct_cnt"
        while cnt in cols:
            cnt += "_"
        agg = Aggregate(cols, [E.Count(None).alias(cnt)], self.plan)
        return DataFrame(self.session, Project(cols, agg))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL: the same column names and types, in order."""
        if self.plan.schema.names != other.plan.schema.names:
            raise HyperspaceException(
                f"union() column mismatch: {self.plan.schema.names} vs "
                f"{other.plan.schema.names}")
        mismatched = [(f.name, f.dtype, other.plan.schema.field(f.name).dtype)
                      for f in self.plan.schema.fields
                      if f.dtype != other.plan.schema.field(f.name).dtype]
        if mismatched:
            raise HyperspaceException(f"union() dtype mismatch: {mismatched}")
        return DataFrame(self.session, Union([self.plan, other.plan]))


    where = filter

    @property
    def write(self) -> "DataFrameWriter":
        """Write the query's result to files."""
        return DataFrameWriter(self)


class DataFrameWriter:
    """The query's result to parquet, csv, json or avro files. ``mode``:
    "error" (the default: refuse a non-empty directory), "overwrite" or
    "append" (one more part file).

    ``bucket_by(n, cols...)`` (parquet only) writes one file per bucket,
    rows sorted by the bucketing columns within each, through the index
    build's hash, histogram and sort on the device; the bucket id stays in
    the file name, and ``_bucket_spec.json`` records the layout, which an
    append must match. ``partition_by(cols...)`` (parquet only) writes
    hive ``col=value/`` directories.

    Every format writes in this order: ``_check`` refuses a bad destination
    before the query runs, the result is materialized, and only then is
    the directory emptied (overwrite) and created, so a query may be
    written back over its own source."""

    BUCKET_SPEC_FILE = "_bucket_spec.json"  # readers list format suffixes only

    def __init__(self, df: DataFrame):
        self._df = df
        self._mode = "error"
        self._bucket: Optional[Tuple[int, List[str]]] = None
        self._partition: Optional[List[str]] = None

    def mode(self, mode: str) -> "DataFrameWriter":
        if mode not in ("error", "overwrite", "append"):
            raise HyperspaceException(f"Unknown write mode: {mode}")
        self._mode = mode
        return self

    def bucket_by(self, num_buckets: int, *cols: str) -> "DataFrameWriter":
        if num_buckets <= 0:
            raise HyperspaceException(
                f"bucket_by needs a positive bucket count, got {num_buckets}")
        if not cols:
            raise HyperspaceException("bucket_by needs at least one bucketing column")
        cols = tuple(self._df._spelling(c) for c in cols)
        missing = [c for c in cols if c not in self._df.plan.schema]
        if missing:
            raise HyperspaceException(
                f"bucket_by columns not in the result: {missing}; "
                f"available: {self._df.plan.schema.names}")
        if self._partition is not None:
            raise HyperspaceException("bucket_by and partition_by cannot be combined")
        self._bucket = (num_buckets, list(cols))
        return self

    bucketBy = bucket_by

    def partition_by(self, *cols: str) -> "DataFrameWriter":
        if not cols:
            raise HyperspaceException("partition_by needs at least one partition column")
        names = self._df.plan.schema.names
        cols = tuple(self._df._spelling(c) for c in cols)
        missing = [c for c in cols if c not in names]
        if missing:
            raise HyperspaceException(
                f"partition_by columns not in the result: {missing}; available: {names}")
        if len(set(cols)) != len(cols):
            raise HyperspaceException(f"partition_by columns repeat: {list(cols)}")
        if len(set(cols)) == len(names):
            raise HyperspaceException("partition_by cannot consume every output column")
        if self._bucket is not None:
            raise HyperspaceException("bucket_by and partition_by cannot be combined")
        self._partition = list(cols)
        return self

    partitionBy = partition_by

    def _check(self, path: str) -> None:
        if os.path.isfile(path):
            raise HyperspaceException(f"Path is a file, not a dir: {path}")
        if self._mode == "error" and os.path.isdir(path) and os.listdir(path):
            raise HyperspaceException(
                f"Path not empty: {path} (use mode('overwrite') or mode('append'))")

    def _prepare_dir(self, path: str) -> str:
        if self._mode == "overwrite" and os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        return path

    def _finalize(self, path: str) -> str:
        self._prepare_dir(path)
        return os.path.join(path, f"part-{uuid.uuid4().hex[:12]}")

    def _reject_layout(self, fmt: str) -> None:
        if self._bucket is not None:
            raise HyperspaceException(
                f"bucket_by is only supported for parquet output, not {fmt}")
        if self._partition is not None:
            raise HyperspaceException(
                f"partition_by is only supported for parquet output, not {fmt}")

    def _guard_bucketed_dir(self, path: str) -> None:
        """A write without the bucket spec must not append to a bucketed
        dataset."""
        if self._mode == "append" and \
                os.path.isfile(os.path.join(path, self.BUCKET_SPEC_FILE)):
            raise HyperspaceException(
                f"{path} holds a bucketed dataset; appending non-bucketed rows "
                "would break its layout. Use bucket_by(<same spec>) or "
                "mode('overwrite').")

    def parquet(self, path: str) -> None:
        from .execution.columnar import write_parquet
        self._check(path)
        if self._bucket is not None:
            self._bucketed_parquet(path)
            return
        self._guard_bucketed_dir(path)
        if self._partition is not None:
            self._partitioned_parquet(path)
            return
        table = self._df.execute().to_host()
        write_parquet(table, self._finalize(path) + ".parquet")

    def _partitioned_parquet(self, path: str) -> None:
        import pyarrow as pa
        import pyarrow.dataset as pa_ds
        import pyarrow.parquet as pq

        at = self._df.to_arrow()
        self._prepare_dir(path)
        if at.num_rows == 0:
            # write_dataset writes nothing for no rows; one 0-row file
            # keeps the directory readable.
            if not any(f.endswith(".parquet") for f in os.listdir(path)):
                pq.write_table(at, os.path.join(path, f"part-{uuid.uuid4().hex[:12]}.parquet"))
            return
        part_schema = pa.schema([at.schema.field(c) for c in self._partition])
        pa_ds.write_dataset(
            at, path, format="parquet",
            partitioning=pa_ds.partitioning(part_schema, flavor="hive"),
            basename_template=f"part-{uuid.uuid4().hex[:12]}-{{i}}.parquet",
            existing_data_behavior="overwrite_or_ignore")

    def _bucketed_parquet(self, path: str) -> None:
        from .actions.create import write_bucket_files
        from .execution.columnar import write_parquet
        from .ops import index_build

        num_buckets, cols = self._bucket
        spec = {"numBuckets": num_buckets, "columns": cols}
        spec_path = os.path.join(path, self.BUCKET_SPEC_FILE)
        if self._mode == "append" and os.path.isdir(path) and os.listdir(path):
            # Rows must land in files whose names promise their bucket.
            try:
                with open(spec_path) as f:
                    existing = json.load(f)
            except OSError:
                raise HyperspaceException(
                    f"Cannot bucket-append to {path}: it was not written "
                    "with bucket_by (no bucket spec found).") from None
            if existing != spec:
                raise HyperspaceException(
                    f"bucket_by({num_buckets}, {cols}) does not match the "
                    f"existing layout of {path}: "
                    f"bucket_by({existing['numBuckets']}, {existing['columns']}).")
        table = self._df.execute()
        sorted_table, bounds = index_build.build_sorted_buckets(table, cols, num_buckets)
        host = sorted_table.to_host()
        self._prepare_dir(path)
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        # A per-write suffix keeps appended files apart; the bucket id stays
        # the name's part-<id> prefix.
        suffix = uuid.uuid4().hex[:8]

        def name_for(bucket: int) -> str:
            return index_build.bucket_file_name(bucket).replace(".parquet",
                                                                f"-{suffix}.parquet")

        if host.num_rows == 0 and not any(f.endswith(".parquet") for f in os.listdir(path)):
            write_parquet(host, os.path.join(path, name_for(0)))  # keeps the schema
            return
        write_bucket_files(host, bounds, num_buckets, path, None, file_name=name_for)

    def csv(self, path: str) -> None:
        import pyarrow.csv as pa_csv
        self._check(path)
        self._reject_layout("csv")
        at = self._df.to_arrow()
        pa_csv.write_csv(at, self._finalize(path) + ".csv")

    def json(self, path: str) -> None:
        """Newline-delimited records, dates in ISO form (pandas'
        ``to_json``)."""
        self._check(path)
        self._reject_layout("json")
        df = self._df.to_pandas()
        df.to_json(self._finalize(path) + ".json", orient="records", lines=True,
                   date_format="iso")

    def avro(self, path: str) -> None:
        from .util.avro import write_avro
        self._check(path)
        self._reject_layout("avro")
        at = self._df.to_arrow()
        write_avro(at, self._finalize(path) + ".avro")


class GroupedData:
    def __init__(self, df: DataFrame, group_cols: List[str]):
        self._df = df
        self._group_cols = group_cols

    def agg(self, *aggs: E.Expr) -> DataFrame:
        return DataFrame(self._df.session,
                         Aggregate(self._group_cols,
                                   [self._df._resolve_expr(a) for a in aggs],
                                   self._df.plan))

    def count(self) -> DataFrame:
        return self.agg(E.Count(None))
