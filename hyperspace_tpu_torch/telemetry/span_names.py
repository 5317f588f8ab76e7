"""Frozen registry of trace span names (counterpart of
``hyperspace_tpu/telemetry/span_names.py``, trimmed to the spans this
package opens).

Every ``trace.span(...)`` / ``trace.add_span(...)`` site in the package
names its span with one of these constants, and every name registered
here is observed by a test (``tests/test_torch_tracing.py`` holds both).
Variable detail (node kinds, hit/miss, byte counts) rides in span
attributes, never in the name. The names equal the JAX package's, so
dashboards and explain's "Trace:" section read the same strings.

The reference's ``spmd.compile`` is left out: eager torch compiles no
mesh program.
"""

from __future__ import annotations

# The per-query root span, opened by Session.execute (one per
# QueryContext; literal-sweep members nest under SERVING_SWEEP).
QUERY = "query"

# Plan normalization (push_filters + prune_columns) in Session.optimize.
PLAN_NORMALIZE = "plan.normalize"

# Cost-based join reordering (optimizer/join_order.reorder_joins).
JOIN_REORDER = "optimize.join_reorder"

# The hyperspace index-rewrite batch (rules/apply_hyperspace).
INDEX_REWRITE = "rewrite.index_rules"

# Result-cache key computation + probe (serving/result_cache).
CACHE_LOOKUP = "serving.cache_lookup"

# Program-bank lookup (serving/program_bank; attrs carry hit/miss) and
# the wrapper construction on a bank miss.
BANK_LOOKUP = "bank.lookup"
BANK_COMPILE = "bank.compile"

# One span per executed plan node (execution/executor._execute).
EXEC_STAGE = "exec.stage"

# One fused region (execution/fusion.py; attributes ``fused_nodes``,
# ``root`` and ``rows``): its interior nodes record no exec.stage span.
EXEC_FUSED = "exec.fused"

# Pooled multi-file read fan-out / prefetch stream (parallel/io.py),
# recorded on the consumer side of the per-query io attribution.
IO_READ = "io.read"
IO_PREFETCH = "io.prefetch"

# The shared literal-sweep batch span (serving/frontend._run_batch);
# member queries' QUERY spans are its children.
SERVING_SWEEP = "serving.sweep"

# Streaming ingestion tier (streaming/): one INGEST_APPEND per staged
# batch, one INGEST_COMMIT per published commit, one INGEST_COMPACT per
# compacted log, one INGEST_WAVE per group-commit wave, one INGEST_SOURCE
# per productive continuous-source poll.
INGEST_APPEND = "ingest.append"
INGEST_COMMIT = "ingest.commit"
INGEST_COMPACT = "ingest.compact"
INGEST_WAVE = "ingest.wave"
INGEST_SOURCE = "ingest.source"

# One SPMD mesh dispatch (execution/spmd._run/_run_stream; attributes
# ``mode``, ``rows``, ``cap_attempts``).
SPMD_DISPATCH = "spmd.dispatch"

# Serving cluster (cluster/): one CLUSTER_FORWARD per routed submission
# (attributes ``owner`` and ``ok``), one CLUSTER_BROADCAST per commit
# notice to the live peers, one CLUSTER_GATHER per host allgather.
CLUSTER_FORWARD = "cluster.forward"
CLUSTER_BROADCAST = "cluster.broadcast"
CLUSTER_GATHER = "cluster.gather"

# Artifact store (artifacts/): one ARTIFACT_LOAD per lake probe (attrs
# carry hit/reason/nbytes), one ARTIFACT_EXPORT per publication of a built
# kernel library, one ARTIFACT_WARMUP per preload pass (attrs carry the
# loaded count and bytes).
ARTIFACT_LOAD = "artifact.load"
ARTIFACT_EXPORT = "artifact.export"
ARTIFACT_WARMUP = "artifact.warmup"

SPAN_NAMES = frozenset({
    QUERY, PLAN_NORMALIZE, JOIN_REORDER, INDEX_REWRITE, CACHE_LOOKUP,
    EXEC_STAGE, EXEC_FUSED, IO_READ, IO_PREFETCH, SPMD_DISPATCH, SERVING_SWEEP,
    INGEST_APPEND, INGEST_COMMIT, INGEST_COMPACT, INGEST_WAVE, INGEST_SOURCE,
    CLUSTER_FORWARD, CLUSTER_BROADCAST, CLUSTER_GATHER,
    BANK_LOOKUP, BANK_COMPILE, ARTIFACT_LOAD, ARTIFACT_EXPORT, ARTIFACT_WARMUP,
})
