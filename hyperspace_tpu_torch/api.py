"""User API facade (counterpart of ``hyperspace_tpu/api.py``: covering and
data-skipping indexes; create, delete, restore, vacuum, refresh, optimize
and cancel; the introspection calls indexes, index, explain and why_not;
the streaming tier's append, commit, compact, recover and continuous
sources; the telemetry surfaces metrics, metrics_delta, metrics_text,
serve_metrics, health, dump_flight_recorder, explain_analyze and
last_trace; the advisor's recommend, what_if, build_recommendation and
workload; the adaptive tier's adaptive_builder and adaptive_stats). The
JAX package's fleet_metrics (cluster tier) and spmd_stats (mesh tier) wait
with their tiers."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .exceptions import HyperspaceException
from .index.constants import IndexConstants


@dataclass(frozen=True)
class IndexConfig:
    """Covering-index specification."""

    index_name: str
    indexed_columns: List[str]
    included_columns: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.index_name:
            raise HyperspaceException("Index name cannot be empty")
        if not self.indexed_columns:
            raise HyperspaceException("Indexed columns cannot be empty")
        lowered = [c.lower() for c in
                   list(self.indexed_columns) + list(self.included_columns)]
        if len(set(lowered)) != len(lowered):
            raise HyperspaceException(
                "Duplicate columns across indexed/included lists")


@dataclass(frozen=True)
class SketchSpec:
    """One data-skipping sketch over one column (ops/sketches.py)."""

    kind: str
    column: str

    def properties(self) -> dict:
        return {}


@dataclass(frozen=True)
class MinMaxSketch(SketchSpec):
    kind: str = field(default="MinMax", init=False)

    def __init__(self, column: str):
        object.__setattr__(self, "column", column)
        object.__setattr__(self, "kind", "MinMax")


@dataclass(frozen=True)
class BloomFilterSketch(SketchSpec):
    """Bloom membership sketch; sized from (expected_items, fpp)."""

    kind: str = field(default="BloomFilter", init=False)
    fpp: float = 0.01
    expected_items: int = 100_000

    def __init__(self, column: str, fpp: float = 0.01,
                 expected_items: int = 100_000):
        object.__setattr__(self, "column", column)
        object.__setattr__(self, "kind", "BloomFilter")
        object.__setattr__(self, "fpp", fpp)
        object.__setattr__(self, "expected_items", expected_items)

    def properties(self) -> dict:
        from .ops.sketches import bloom_parameters
        num_bits, num_hashes = bloom_parameters(self.expected_items, self.fpp)
        return {"numBits": str(num_bits), "numHashes": str(num_hashes),
                "fpp": str(self.fpp),
                "expectedItems": str(self.expected_items)}


@dataclass(frozen=True)
class ValueListSketch(SketchSpec):
    """Exact distinct-values sketch for low-cardinality columns: equality
    and IN predicates prune a file unless the literal is IN its stored
    value list (no false positives, unlike Bloom). Files whose cardinality
    exceeds ``max_values`` store no list and are always kept."""

    kind: str = field(default="ValueList", init=False)
    max_values: int = 256

    def __init__(self, column: str, max_values: int = 256):
        object.__setattr__(self, "column", column)
        object.__setattr__(self, "kind", "ValueList")
        object.__setattr__(self, "max_values", int(max_values))

    def properties(self) -> dict:
        return {"maxValues": str(self.max_values)}


@dataclass(frozen=True)
class DataSkippingIndexConfig:
    """Data-skipping index specification: per-source-file sketches."""

    index_name: str
    sketches: List[SketchSpec]

    def __post_init__(self):
        if not self.index_name:
            raise HyperspaceException("Index name cannot be empty")
        if not self.sketches:
            raise HyperspaceException("At least one sketch is required")
        seen = set()
        for s in self.sketches:
            key = (s.kind, s.column.lower())
            if key in seen:
                raise HyperspaceException(
                    f"Duplicate sketch {s.kind} on column {s.column}")
            seen.add(key)


class Hyperspace:
    def __init__(self, session):
        self.session = session
        self.index_manager = session.index_collection_manager

    def create_index(self, df, index_config) -> None:
        """Build an index: an ``IndexConfig`` (covering) or a
        ``DataSkippingIndexConfig`` (per-file sketches)."""
        self.index_manager.create(df, index_config)

    def delete_index(self, index_name: str) -> None:
        self.index_manager.delete(index_name)

    def restore_index(self, index_name: str) -> None:
        self.index_manager.restore(index_name)

    def vacuum_index(self, index_name: str) -> None:
        self.index_manager.vacuum(index_name)

    def refresh_index(self, index_name: str,
                      mode: str = IndexConstants.REFRESH_MODE_FULL) -> None:
        """Bring an index up to its source: ``full`` rebuilds it,
        ``incremental`` indexes the appended files (and, with lineage, drops
        the rows of deleted ones), ``quick`` only records the change for
        Hybrid Scan."""
        self.index_manager.refresh(index_name, mode)

    def optimize_index(self, index_name: str,
                       mode: str = IndexConstants.OPTIMIZE_MODE_QUICK) -> None:
        """Merge each bucket's small files (``quick``) or all its files
        (``full``) into one sorted file."""
        self.index_manager.optimize(index_name, mode)

    def cancel(self, index_name: str) -> None:
        """Roll an index stuck in a transient state back to its last stable
        entry."""
        self.index_manager.cancel(index_name)

    def recover(self, index_names=None) -> dict:
        """Crash recovery sweep (robustness/recovery.py): roll every index
        whose latest op-log entry is transient back to its last stable
        state, vacuum data versions no committed entry references, and undo
        or redo the streaming tier's torn commits. A healthy lake is a
        no-op. Operator action: run it only while no other process mutates
        the lake. Returns {scanned, cancelled, vacuumed, errors, streaming,
        artifacts}; ``artifacts`` is the artifact store's vacuum summary
        (``{"enabled": False}`` while the store is off)."""
        from .robustness.recovery import recover_indexes
        summary = recover_indexes(self.session, names=index_names)
        self.index_manager.clear_cache()
        summary["artifacts"] = self._artifact_vacuum()
        return summary

    # The streaming tier (streaming/).

    def append(self, table_path: str, batch, block: bool = False) -> dict:
        """Stage one record batch (pyarrow Table or RecordBatch, pandas
        DataFrame, or dict of columns) for the parquet table directory
        ``table_path``, out of every scan's sight, and prebuild each ACTIVE
        index's delta on the device. ``block=True`` waits on a full staging
        budget (up to ``backpressure.timeoutMs``) instead of raising.
        Returns a summary dict."""
        from .streaming.ingest import append as _append
        return _append(self.session, table_path, batch, block=block)

    def commit(self, table_path: str) -> dict:
        """Publish every staged batch for ``table_path`` atomically through
        the op-log protocol, landing the prebuilt index deltas in the same
        commit; standing queries over the table fire. Returns a summary
        dict."""
        from .streaming.ingest import commit as _commit
        return _commit(self.session, table_path)

    def compact(self, names=None) -> dict:
        """Fold each op log's superseded entries into one checkpoint entry
        and vacuum unreferenced index data versions
        (streaming/compaction.py). Operator action, as ``recover``: run it
        in a quiet window. Returns a summary dict; ``artifacts`` is the
        artifact store's vacuum summary, as in ``recover``."""
        from .streaming.compaction import compact as _compact
        summary = _compact(self.session, names)
        summary["artifacts"] = self._artifact_vacuum()
        return summary

    def _artifact_vacuum(self) -> dict:
        """recover()'s and compact()'s sweep of the artifact store: crashed
        publication temps, blobs of another runtime, corrupt blobs, orphaned
        usage tallies, the byte budget."""
        from .artifacts.manager import vacuum as _artifact_vacuum
        return _artifact_vacuum(self.session)

    # The artifact store (artifacts/).

    def warmup(self) -> dict:
        """Load the lake's kernel libraries from the artifact store into
        this process, hottest first (by the persisted usage tallies),
        within the ``artifacts.preload.maxMs`` / ``maxBytes`` budgets, so
        the first query launches without an nvcc build. The explicit
        counterpart of the opt-in preload at Session creation
        (``artifacts.preload.enabled``). Returns {enabled, loaded, skipped,
        bytes, ms, budget_hit}."""
        from .artifacts.manager import preload as _preload
        return _preload(self.session)

    def artifact_stats(self) -> dict:
        """The artifact store's counters (hits, misses, corruptions,
        persists, evictions, resident blobs and bytes) merged with the
        manager's warm-cache and preload numbers; ``{"enabled": False}``
        while the store is off. The same dict backs the ``artifacts``
        metrics collector."""
        from .artifacts.manager import manager_for
        mgr = manager_for(self.session)
        if mgr is None:
            return {"enabled": False}
        out = {"enabled": True}
        out.update(mgr.stats())
        return out

    def tail_directory(self, watch_dir: str, table_path: str, name=None):
        """Start a continuous source tailing ``watch_dir`` for new
        ``*.parquet`` drops into ``table_path``. Returns the running source;
        ``.stop()`` drains and halts it."""
        from .streaming.sources import tail_directory as _tail
        return _tail(self.session, watch_dir, table_path, name=name)

    def tail_log(self, log_path: str, table_path: str, name=None):
        """Start a continuous source tailing the JSONL log at ``log_path``
        into ``table_path``. Returns the running source."""
        from .streaming.sources import tail_log as _tail
        return _tail(self.session, log_path, table_path, name=name)

    def streaming_stats(self) -> dict:
        """The commit queue's counters, the group-commit ledger's and the
        op-log lookup cache's."""
        from .streaming.ingest import get_queue
        return get_queue().stats()

    def indexes(self):
        """One summary row per index (pandas DataFrame)."""
        return self.index_manager.indexes()

    def index(self, index_name: str):
        """The extended statistics row of one index (pandas DataFrame)."""
        import pandas as pd
        from .index.statistics import IndexStatistics
        entry = self.index_manager.get_index(index_name)
        if entry is None:
            raise HyperspaceException(f"Index with name {index_name} could not be found.")
        usage = self.session._index_usage_counts.get(index_name, 0)
        return pd.DataFrame([IndexStatistics.from_entry(
            entry, usage_count=usage).to_extended_row()])

    def explain(self, df, verbose: bool = False, redirect_func=None,
                mode: str = "plaintext") -> str:
        """The plan with and without indexes, changed subtrees highlighted,
        rendered per ``mode`` ("plaintext", "console" or "html"); also
        handed to ``redirect_func`` when given."""
        from .plananalysis.explain import explain_string
        text = explain_string(self.session, df.plan, verbose=verbose, mode=mode)
        if redirect_func is not None:
            redirect_func(text)
        return text

    def io_stats(self) -> dict:
        """The process-wide reader-pool counters (parallel/io.py): pooled
        fan-outs, file tasks, byte estimates, in-worker read seconds,
        consumer wait seconds, prefetch streams and items, pool width.
        Read through the metrics registry's ``io`` collector."""
        from .parallel import io as pio
        from .telemetry import metric_names as MN
        from .telemetry.metrics import get_registry
        out = get_registry().collect(MN.COLLECTOR_IO)
        return out if out is not None else pio.pool_stats()

    def spmd_stats(self) -> dict:
        """The mesh tier: whether distribution is on, the mesh the next
        dispatch would span and its platform, the dispatch tallies (queries,
        sorts, builds), mesh programs compiled (0: eager torch compiles
        none), the last dispatch's collectives and capacity attempts, and
        whether a multi-file leaf shards on file boundaries (always)."""
        from .execution import spmd
        from .parallel import distributed_build
        from .parallel.mesh import mesh_devices
        devices = mesh_devices(self.session)
        return {
            "enabled": self.session.hs_conf.distributed_enabled(),
            "mesh_devices": len(devices),
            "platform": devices[0].type,
            "query_dispatches": spmd.DISPATCH_COUNT,
            "sort_dispatches": spmd.SORT_DISPATCH_COUNT,
            "build_dispatches": distributed_build.DISPATCH_COUNT,
            "mesh_programs_compiled": 0,  # eager torch compiles no program
            "last_collectives": spmd.last_collectives(),
            "last_cap_attempts": spmd.LAST_CAP_ATTEMPTS,
            "file_aligned_scan": True,
        }

    def buffer_pool_stats(self) -> dict:
        """The buffer pool's counters (execution/buffer_pool.py): hits per
        tier, misses, admissions, host->device ``transfers`` (0 new ones on
        a fully warm repeat), demotions and evictions,
        ``decode_bytes_saved``, residency against the budgets, and the
        probes per namespace. Read through the metrics registry's
        ``buffer_pool`` collector."""
        from .execution import buffer_pool
        from .telemetry import metric_names as MN
        from .telemetry.metrics import get_registry
        out = get_registry().collect(MN.COLLECTOR_BUFFER_POOL)
        return out if out is not None else buffer_pool.pool_stats()

    # The telemetry tier (telemetry/).

    def metrics(self) -> dict:
        """One snapshot over every subsystem (telemetry/metrics.py): the
        process registry's counters and gauges, the live histograms
        (``query.latency_ms``, ``serving.latency_ms``: rolling
        p50/p95/p99 and QPS) and every named collector (``io``,
        ``robustness``, ``streaming``, ``serving``, ``buffer_pool``,
        ``program_bank``, ``flight_recorder``), plus this session's
        ``result_cache``."""
        from .execution import buffer_pool
        from .parallel import io as pio
        from .serving.program_bank import get_bank
        from .telemetry import metric_names as MN
        from .telemetry.metrics import get_registry
        snap = get_registry().snapshot()
        cols = snap["collectors"]
        cols.setdefault(MN.COLLECTOR_IO, pio.pool_stats())
        cols.setdefault(MN.COLLECTOR_PROGRAM_BANK, get_bank().stats())
        cols.setdefault(MN.COLLECTOR_BUFFER_POOL, buffer_pool.pool_stats())
        cols["result_cache"] = self.result_cache_stats()
        if MN.COLLECTOR_SERVING not in cols:
            cols[MN.COLLECTOR_SERVING] = self.serving_stats()
        return snap

    def metrics_delta(self, before: dict, after: Optional[dict] = None) -> dict:
        """The numeric leaves that changed between two ``metrics()``
        snapshots, as one flat ``{dotted.path: delta}`` dict; ``after``
        defaults to a snapshot now."""
        from .telemetry.exposition import delta
        return delta(before, after if after is not None else self.metrics())

    def metrics_text(self) -> str:
        """The whole ``metrics()`` surface as OpenMetrics text exposition
        (telemetry/exposition.py). With a live cluster node every sample
        carries a ``worker="<id>"`` label; single-process text is the
        unlabelled format (``maybe_node`` never starts a node)."""
        from .cluster.worker import maybe_node
        from .telemetry.exposition import render_text
        node = maybe_node()
        return render_text(self.metrics(), worker=node.worker_id if node else "")

    def fleet_metrics(self) -> dict:
        """Every live cluster worker's metrics snapshot, keyed by worker
        id, and an ``aggregate`` dict summing the numeric leaves over the
        fleet: this process's own surface, the peers' over the cluster
        transport (a peer that does not answer is skipped; staleness drops
        it from the roster). With the cluster disabled: this process, as
        ``local``."""
        from .cluster import transport
        from .cluster.worker import get_node
        from .telemetry.exposition import flatten
        workers: dict = {}
        node = get_node(self.session)
        if node is None:
            workers["local"] = self.metrics()
        else:
            workers[node.worker_id] = self.metrics()
            timeout_s = self.session.hs_conf.cluster_forward_timeout_ms() / 1000.0
            for peer in node.membership.peers():
                try:
                    response = transport.send_request(peer.host, peer.port, {"op": "metrics"},
                                                      timeout_s=timeout_s, session=self.session)
                except OSError:
                    continue  # a dead peer: staleness routes around it
                if response.get("ok"):
                    workers[peer.worker_id] = response["metrics"]
        aggregate: dict = {}
        for snap in workers.values():
            for key, value in flatten(snap).items():
                aggregate[key] = aggregate.get(key, 0.0) + value
        return {"workers": workers, "aggregate": aggregate}

    def serve_metrics(self, port: Optional[int] = None) -> int:
        """Start the opt-in scrape endpoint (``GET
        127.0.0.1:<port>/metrics`` serves ``metrics_text()``).
        ``port=None`` reads ``hyperspace.tpu.telemetry.export.httpPort``
        (raising while it is 0, the default); an explicit ``port=0`` binds
        an ephemeral port. Returns the bound port."""
        from .telemetry.exposition import start_http_exporter
        return start_http_exporter(self.session, port)

    def stop_serving_metrics(self) -> None:
        from .telemetry.exposition import stop_http_exporter
        stop_http_exporter()

    def health(self) -> dict:
        """This session's SLO objectives (``hyperspace.tpu.telemetry.slo.*``)
        evaluated now over the sliding window of completed queries:
        ``healthy`` and, per objective, observed, threshold and breached.
        A healthy→breached transition emits SloBreachEvent; with
        ``hyperspace.tpu.adaptive.enabled`` the verdicts drive
        the serving frontend's shed and degrade admission
        (adaptive/admission.py)."""
        from .telemetry.slo import health
        return health(self.session)

    def adaptive_builder(self):
        """The process-default budgeted builder (adaptive/builder.py):
        ``run_once()`` for one maintenance pass, ``start()``/``stop()`` for
        its daemon loop. A pass acts only in a serving idle window and only
        while ``hyperspace.tpu.adaptive.builder.enabled`` holds."""
        from .adaptive.builder import get_builder
        return get_builder(self)

    def adaptive_stats(self) -> dict:
        """The adaptive control plane's counters: the correction store's,
        the admission controller's and the builder's ledger."""
        from .adaptive.admission import get_controller
        from .adaptive.builder import get_ledger
        from .adaptive.feedback import get_store
        return {"feedback": get_store().stats(), "admission": get_controller().stats(),
                "builder": get_ledger().stats()}

    def dump_flight_recorder(self, path: Optional[str] = None) -> str:
        """The flight recorder's rings (retained traces, recent events,
        anomalies, metrics snapshots) as one Perfetto / chrome://tracing
        JSON document (telemetry/flight_recorder.py); written to ``path``
        when given, returned either way."""
        import json
        from .telemetry.flight_recorder import get_recorder
        text = json.dumps(get_recorder().dump(), default=str)
        if path:
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
        return text

    def explain_analyze(self, df) -> str:
        """Execute the query with its trace forced on and return one report:
        the span timeline (wall and self times; host times, see
        telemetry/trace.py), estimated against actual join rows, and the
        query's io, cache and robustness tallies
        (plananalysis/analyze.py)."""
        from .plananalysis.analyze import explain_analyze_string
        return explain_analyze_string(self.session, df.plan)

    def last_trace(self):
        """The span tree (:class:`~.telemetry.trace.Trace`) of this
        session's most recent retained trace, or None. Export with
        ``.to_chrome_json()``; render with
        ``telemetry.trace.render_timeline``."""
        return self.session._last_trace

    def result_cache_stats(self) -> dict:
        """The result cache's counters per tier (None while it is off), the
        SQL plan memo's, and the device index-table cache's."""
        from .execution import index_cache
        cache = self.session.result_cache
        out = {"result_cache": cache.stats() if cache is not None else None,
               "sql_plan_cache": dict(self.session._sql_plan_stats)}
        if index_cache.enabled():
            ic = index_cache.get_cache()
            out["index_table_cache"] = {"hits": ic.hits, "misses": ic.misses,
                                        "resident_bytes": ic.nbytes}
        else:
            out["index_table_cache"] = None
        return out

    def clear_result_cache(self) -> None:
        """Drop every cached result and the SQL plan memo. Never needed for
        right answers (stale keys are never reached), but frees the memory
        at once."""
        cache = self.session.result_cache
        if cache is not None:
            cache.clear()
        with self.session._sql_plan_lock:
            self.session._sql_plan_cache.clear()

    def serving_frontend(self):
        """The process-default serving frontend (serving/frontend.py),
        built on first use with this session governing it. Requires
        ``hyperspace.tpu.serving.enabled=true``."""
        from .serving.frontend import get_frontend
        return get_frontend(self.session)

    def serving_stats(self) -> dict:
        """The process-default frontend's admission and batching counters,
        its cross-session result cache and the process-wide program bank
        (``{"frontend": None, "program_bank": ...}`` before any frontend
        exists)."""
        from .serving import frontend as fe
        from .serving.program_bank import get_bank
        front = fe._DEFAULT
        if front is None:
            return {"frontend": None, "program_bank": get_bank().stats()}
        out = front.stats()
        out["frontend"] = True
        return out

    def why_not(self, df, index_name: Optional[str] = None) -> str:
        """Why each index was, or was not, applied to this query's plan."""
        from .rules.apply_hyperspace import apply_hyperspace
        from .rules.column_pruning import prune_columns
        from .rules.index_filters import ReasonCollector
        # Silent: a diagnostic pass counts no index usage.
        ctx = ReasonCollector(enabled=True, silent=True)
        apply_hyperspace(self.session, prune_columns(df.plan), ctx)
        return ctx.format(index_name)

    # The advisor: workload capture, what-if, recommendation (advisor/).

    def recommend(self, top_k: int = 5):
        """Cost-ranked index recommendations from the captured workload
        (``hyperspace.tpu.advisor.capture.enabled``). Pure planning: builds
        nothing and leaves the index log store's bytes as they were.
        Returns an AdvisorReport (``.recommendations``, ``.explain()``)."""
        from .advisor.recommend import recommend
        return recommend(self.session, top_k=top_k)

    def what_if(self, df, configs):
        """Would building ``configs`` (IndexConfig / DataSkippingIndexConfig)
        rewrite this query? Metadata-only hypothetical entries go through
        the rules' ``candidates_for`` hook and the index selection runs
        again; nothing is built or written. Returns a WhatIfOutcome
        (``.rewritten``, ``.predicted_speedup``, ``.explain()``)."""
        from .advisor.whatif import what_if
        return what_if(self.session, df.plan, configs)

    def build_recommendation(self, recommendation) -> None:
        """Build one recommendation's configs through the normal create
        path (this one DOES build index data)."""
        from .advisor.recommend import build_recommendation
        build_recommendation(self, recommendation)

    def workload(self):
        """The captured workload log as a pandas DataFrame (empty until
        ``hyperspace.tpu.advisor.capture.enabled`` is set)."""
        import pandas as pd
        from .advisor.workload import log_for
        return pd.DataFrame(log_for(self.session).to_rows(), columns=[
            "fingerprint", "tables", "latency_s", "appliedIndexes", "rulesFired"])
