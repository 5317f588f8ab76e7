"""Frozen registry of metric instrument and collector names (counterpart
of ``hyperspace_tpu/telemetry/metric_names.py``, trimmed to what this
package records).

Every push-side instrument (``counter_add`` / ``gauge_set`` /
``histogram``) and every ``register_collector`` site names its metric with
one of these constants. The OpenMetrics exposition
(telemetry/exposition.py), ``Hyperspace.metrics_delta()`` and scrapers key
on these strings, which equal the JAX package's.

The reference's ``serving.sweep_invocations`` counter (the stacked
literal-sweep mask) is left out on purpose.
"""

from __future__ import annotations

# -- push-side counters -----------------------------------------------------

# Retention outcome of each completed root trace (telemetry/trace.py):
# the head coin said keep / the tail-keep override rescued it / it was
# recorded provisionally and discarded at completion.
TRACE_SAMPLED = "trace.sampled"
TRACE_TAIL_KEPT = "trace.tail_kept"
TRACE_DISCARDED = "trace.discarded"

# Anomalies the flight recorder captured (telemetry/flight_recorder.py).
FLIGHT_ANOMALIES = "flight_recorder.anomalies"

# SLO objective transitions into breach (telemetry/slo.py).
SLO_BREACHES = "slo.breaches"

# -- live histograms --------------------------------------------------------

# Per-completed-query latency through the serving frontend
# (serving/frontend.py; window: constants.LATENCY_WINDOW_S).
SERVING_LATENCY_MS = "serving.latency_ms"

# Per-query latency of every Session.execute (telemetry/slo.py feeds it):
# the SLO monitors' p99 source and the adaptive tail-keep baseline.
QUERY_LATENCY_MS = "query.latency_ms"

# -- pull-side collectors ---------------------------------------------------

COLLECTOR_IO = "io"
COLLECTOR_SERVING = "serving"
COLLECTOR_ROBUSTNESS = "robustness"
COLLECTOR_STREAMING = "streaming"
COLLECTOR_FLIGHT_RECORDER = "flight_recorder"
COLLECTOR_BUFFER_POOL = "buffer_pool"
COLLECTOR_CLUSTER = "cluster"
COLLECTOR_FUSION = "fusion"
COLLECTOR_PROGRAM_BANK = "program_bank"
COLLECTOR_ARTIFACTS = "artifacts"

METRIC_NAMES = frozenset({
    TRACE_SAMPLED, TRACE_TAIL_KEPT, TRACE_DISCARDED, FLIGHT_ANOMALIES,
    SLO_BREACHES, SERVING_LATENCY_MS, QUERY_LATENCY_MS, COLLECTOR_IO,
    COLLECTOR_SERVING, COLLECTOR_ROBUSTNESS, COLLECTOR_STREAMING,
    COLLECTOR_FLIGHT_RECORDER, COLLECTOR_BUFFER_POOL, COLLECTOR_CLUSTER,
    COLLECTOR_FUSION, COLLECTOR_PROGRAM_BANK, COLLECTOR_ARTIFACTS,
})
