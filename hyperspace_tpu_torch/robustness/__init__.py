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

Not ported here: the retry of pooled reads, and the degradation ladders'
fault points (io, scan, serving, result cache,
buffer pool, artifacts, cluster), which wait for the telemetry and
robustness tiers.
"""

from .faults import (FaultRegistry, FaultSpec, InjectedFaultError,  # noqa: F401
                     TransientInjectedFaultError, fault_point)
