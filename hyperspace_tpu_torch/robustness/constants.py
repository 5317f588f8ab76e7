"""Robustness conf keys (counterpart of
``hyperspace_tpu/robustness/constants.py``: fault injection)."""

from __future__ import annotations


class RobustnessConstants:
    # One key per fault point: ``hyperspace.tpu.robustness.faults.<point>``
    # with <point> from fault_names.py. The value is a spec string
    # ``kind[:opt=val[,opt=val...]]``:
    #   kinds  error (InjectedFaultError, or exc=<builtin name>),
    #          transient (TransientInjectedFaultError),
    #          latency (sleep ms, then go on),
    #          kill (SIGKILL the process: a kill -9 at that position)
    #   opts   p=<0..1>, nth=<n> (only the nth hit), times=<k> (at most k
    #          firings), ms=<n> (latency), exc=<name> (for kind=error)
    # Unset, every fault point is a no-op.
    FAULTS_PREFIX = "hyperspace.tpu.robustness.faults"

