"""Robustness layer (counterpart of ``hyperspace_tpu/robustness/``): fault
injection, deadlines, retry, degradation, crash recovery.

- ``faults``   -- named fault points at every risky boundary of the ported
  tiers, armed via ``hyperspace.tpu.robustness.faults.*`` conf or a
  registry's ``scope``, a no-op while disarmed; ``degrade_enabled``, the
  switch of every degradation ladder; the process counters;
- ``retry``    -- bounded backoff retry on transient errors at the pooled
  reads, the op-log writes and the cluster transport;
- deadlines    -- per-query cooperative cancellation
  (``serving/context.check_deadline`` at stage, io and queue boundaries);
- ``recovery`` -- crash recovery for a lake another process died in
  (transient-state rollback, orphaned data-version vacuum, the streaming
  tier's undo/redo).

The ladders live at their fault sites (result-cache device copy and spill
read-back, buffer-pool load, frontend sweep member and worker release).
Its counters are the ``robustness`` collector of the metrics registry
(telemetry/metrics.py); a retried sequence emits a RetryEvent, and an
incident marks the query's trace tail-keep.
"""

from .faults import (FaultRegistry, FaultSpec, InjectedFaultError,  # noqa: F401
                     TransientInjectedFaultError, fault_point)
