"""Robustness layer (counterpart of ``hyperspace_tpu/robustness/``): the
fault-point registry and crash recovery.

- ``faults``   -- named fault points at the op-log and ingestion
  boundaries, armed via ``hyperspace.tpu.robustness.faults.*`` conf, a
  no-op while disarmed;
- ``retry``    -- bounded backoff retry of the op-log writes on transient
  errors;
- ``recovery`` -- crash recovery for a lake another process died in
  (transient-state rollback, orphaned data-version vacuum, the streaming
  tier's undo/redo).

Its counters are the ``robustness`` collector of the metrics registry
(telemetry/metrics.py); a retried sequence emits a RetryEvent, and an
incident marks the query's trace tail-keep. Not ported here: the retry of
pooled reads, and the degradation ladders' fault points (io, scan,
serving, result cache, buffer pool, artifacts, cluster), which wait for
the rest of the robustness tier.
"""

from .faults import (FaultRegistry, FaultSpec, InjectedFaultError,  # noqa: F401
                     TransientInjectedFaultError, fault_point)
