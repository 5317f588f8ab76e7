"""Telemetry config keys and defaults (``hyperspace.tpu.telemetry.*``;
counterpart of ``hyperspace_tpu/telemetry/constants.py``, the same keys
and defaults, for the knobs an operator sets). They govern the tracing,
SLO, exposition and profiler layers of this package, and are read
through config.py's accessors only. The caps and windows below are fixed
module constants: nothing sets them per session.
"""

from __future__ import annotations


class TelemetryConstants:
    # Per-query span-tree tracing (telemetry/trace.py). On by default;
    # the sampleRate knob below bounds retention; `false` restores the
    # hard no-op fast path (byte-identical results).
    TRACE_ENABLED = "hyperspace.tpu.telemetry.trace.enabled"
    TRACE_ENABLED_DEFAULT = "true"

    # Head-sampled trace RETENTION (telemetry/trace.py): the coin is
    # flipped once per query at Session.execute; a coin-negative query
    # still records into a provisional trace (so the tail-keep override
    # can rescue exactly the unlucky ones — deadline breaches, retries,
    # degradations, anomalies, live-latency outliers) but the trace is
    # DISCARDED at completion unless kept. 1.0 (default) retains every
    # trace; serving deployments drop to ~0.1; 0 retains only tail-kept
    # traces.
    TRACE_SAMPLE_RATE = "hyperspace.tpu.telemetry.trace.sampleRate"
    TRACE_SAMPLE_RATE_DEFAULT = "1.0"

    # SLO monitors (telemetry/slo.py): named objectives evaluated over a
    # sliding window of completed queries — p99 latency (ms) and error
    # rate (each 0 = objective disarmed). Breaches emit SloBreachEvent
    # and flip Hyperspace.health(); nothing acts on a breach here (the
    # admission controller waits with adaptive/).
    SLO_P99_MS = "hyperspace.tpu.telemetry.slo.p99Ms"
    SLO_P99_MS_DEFAULT = "0"
    SLO_ERROR_RATE = "hyperspace.tpu.telemetry.slo.errorRate"
    SLO_ERROR_RATE_DEFAULT = "0"
    SLO_MIN_COUNT = "hyperspace.tpu.telemetry.slo.minCount"
    SLO_MIN_COUNT_DEFAULT = "5"

    # OpenMetrics HTTP exposition (telemetry/exposition.py): a localhost
    # scrape endpoint serving Hyperspace.metrics_text(). 0 (default) =
    # off; a port (or 0 passed explicitly to serve_metrics for an
    # ephemeral bind) starts the listener on 127.0.0.1 only.
    EXPORT_HTTP_PORT = "hyperspace.tpu.telemetry.export.httpPort"
    EXPORT_HTTP_PORT_DEFAULT = "0"

    # Opt-in torch.profiler capture bracketing ONE query (the first
    # executed after arming): the CPU and CUDA timeline lands under `dir`
    # as a chrome trace (chrome://tracing, Perfetto). One-shot per
    # process (re-arm via telemetry.trace.reset_profiler, tests only) so
    # a serving loop cannot accumulate unbounded captures.
    PROFILER_ENABLED = "hyperspace.tpu.telemetry.profiler.enabled"
    PROFILER_ENABLED_DEFAULT = "false"
    PROFILER_DIR = "hyperspace.tpu.telemetry.profiler.dir"
    PROFILER_DIR_DEFAULT = ""


# Span cap per trace: past it new spans are dropped (counted on
# Trace.dropped) instead of growing without bound, so a pathological plan
# or a huge literal sweep cannot balloon host memory.
TRACE_MAX_SPANS = 4096

# Retained traces the flight recorder's ring holds (telemetry/
# flight_recorder.py; its event, anomaly and snapshot rings are fixed too).
FLIGHT_MAX_TRACES = 32

# Sliding window (seconds) of the SLO objectives (telemetry/slo.py) and
# of the live latency histograms (query.latency_ms, serving.latency_ms:
# p50/p95/p99 and QPS over samples this recent).
SLO_WINDOW_S = 60.0
LATENCY_WINDOW_S = 60.0
