"""Robustness conf keys (counterpart of
``hyperspace_tpu/robustness/constants.py``)."""

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

    # A query's cooperative deadline in milliseconds (0: none), for every
    # Session.execute of the session; ServingFrontend.submit's
    # ``deadline_ms=`` overrides it per submission. Past it the next stage
    # or io boundary raises QueryDeadlineError.
    DEADLINE_MS = "hyperspace.tpu.robustness.deadlineMs"
    DEADLINE_MS_DEFAULT = "0"

    # Retry of transient faults (pooled reads, op-log writes): up to
    # maxAttempts attempts, backing off from baseMs. 1 disables retry.
    RETRY_MAX_ATTEMPTS = "hyperspace.tpu.robustness.retry.maxAttempts"
    RETRY_MAX_ATTEMPTS_DEFAULT = "3"
    RETRY_BASE_MS = "hyperspace.tpu.robustness.retry.baseMs"
    RETRY_BASE_MS_DEFAULT = "10"

    # The switch of every degradation ladder (result-cache device copy ->
    # host tier, buffer-pool load -> miss and re-read, sweep member ->
    # run alone, dying worker -> members released). Off, the failures
    # raise as they are.
    DEGRADE_ENABLED = "hyperspace.tpu.robustness.degrade.enabled"
    DEGRADE_ENABLED_DEFAULT = "true"
