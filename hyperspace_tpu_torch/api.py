"""User API facade (counterpart of ``hyperspace_tpu/api.py``: covering and
data-skipping indexes; create, delete, restore, vacuum, refresh, optimize
and cancel; the introspection calls indexes, index, explain and why_not;
the streaming tier's append, commit, compact, recover and continuous
sources)."""

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
        artifacts}; ``artifacts`` is ``{"enabled": False}`` (the artifact
        store is not ported)."""
        from .robustness.recovery import recover_indexes
        summary = recover_indexes(self.session, names=index_names)
        self.index_manager.clear_cache()
        summary["artifacts"] = {"enabled": False}
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
        in a quiet window. Returns a summary dict; ``artifacts`` is
        ``{"enabled": False}``."""
        from .streaming.compaction import compact as _compact
        summary = _compact(self.session, names)
        summary["artifacts"] = {"enabled": False}
        return summary

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
        consumer wait seconds, prefetch streams and items, pool width."""
        from .parallel import io as pio
        return pio.pool_stats()

    def buffer_pool_stats(self) -> dict:
        """The buffer pool's counters (execution/buffer_pool.py): hits per
        tier, misses, admissions, host->device ``transfers`` (0 new ones on
        a fully warm repeat), demotions and evictions,
        ``decode_bytes_saved``, residency against the budgets, and the
        probes per namespace."""
        from .execution import buffer_pool
        return buffer_pool.pool_stats()

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
        """The process-default frontend's admission and batching counters
        and its cross-session result cache (``{"frontend": None}`` before
        any frontend exists)."""
        from .serving import frontend as fe
        front = fe._DEFAULT
        if front is None:
            return {"frontend": None}
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
