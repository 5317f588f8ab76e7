"""Bounded retry with exponential backoff and jitter for transient faults
(counterpart of ``hyperspace_tpu/robustness/retry.py``), around the
boundaries where a transient error is plausible and a repeat is safe: the
pooled reader tasks (parallel/io.py: reads are idempotent, and the ordered
gather gives the same bytes whichever attempt produced them), the op-log
store writes (index/log_manager.py: put-if-absent decides every race) and
the cluster transport (cluster/transport.py).

Transient means OSError or TimeoutError (not a missing file or a
permission error) or an injected TransientInjectedFaultError; anything
else raises on the first attempt. A sequence that exhausts its attempts
raises its first error. The policy is
``hyperspace.tpu.robustness.retry.{maxAttempts,baseMs}`` of the governing
session; delays are ``baseMs * 2^(attempt-1)`` jittered in [0.5x, 1.5x). A
query past its deadline never sleeps here: the deadline is checked before
each backoff. A sequence that retried (recovered or exhausted) emits one
RetryEvent through the governing session's logger.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from . import faults as _faults

TRANSIENT_TYPES = (OSError, TimeoutError, _faults.TransientInjectedFaultError)

NON_TRANSIENT_TYPES = (FileNotFoundError, NotADirectoryError, IsADirectoryError,
                       PermissionError)


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    base_ms: float = 10.0


DEFAULT_POLICY = RetryPolicy()


def policy_from_conf(hs_conf) -> RetryPolicy:
    return RetryPolicy(max_attempts=hs_conf.robustness_retry_max_attempts(),
                       base_ms=hs_conf.robustness_retry_base_ms())


def active_policy() -> RetryPolicy:
    """The governing session's policy: the active query context's, else the
    io session scope's (actions run under it), else the defaults."""
    from ..parallel import io as pio
    from ..serving.context import active_context
    ctx = active_context()
    session = ctx.session if ctx is not None else pio.active_session()
    return policy_from_conf(session.hs_conf) if session is not None else DEFAULT_POLICY


def call(fn: Callable, *, where: str = "", policy: Optional[RetryPolicy] = None,
         session=None):
    """``fn()`` with up to ``policy.max_attempts`` attempts, absorbing
    transient errors between them. ``where`` names the boundary in the
    RetryEvent and in a deadline cancellation."""
    p = policy if policy is not None else active_policy()
    first_err: Optional[BaseException] = None
    for attempt in range(1, p.max_attempts + 1):
        try:
            result = fn()
        except TRANSIENT_TYPES as e:
            if isinstance(e, NON_TRANSIENT_TYPES):
                raise
            if first_err is None:
                first_err = e
            if attempt >= p.max_attempts:
                _faults.note(retries=attempt - 1, retry_failures=1)
                _emit(session, where, attempt, False, first_err)
                raise first_err
            from ..serving.context import check_deadline
            check_deadline(where)
            delay_s = (p.base_ms / 1000.0) * (2 ** (attempt - 1))
            if delay_s > 0:
                time.sleep(delay_s * (0.5 + random.random()))
            continue
        if attempt > 1:
            _faults.note(retries=attempt - 1)
            _emit(session, where, attempt, True, first_err)
        return result


def _emit(session, where: str, attempts: int, succeeded: bool,
          first_err: Optional[BaseException]) -> None:
    """One RetryEvent per retried sequence, through the governing session's
    logger: the explicit one, else the io scope's (actions run under it),
    else the active query's."""
    if session is None:
        from ..parallel import io as pio
        session = pio.active_session()
    if session is None:
        from ..serving.context import active_context
        ctx = active_context()
        session = ctx.session if ctx is not None else None
    if session is None:
        return
    from ..telemetry.events import RetryEvent
    from ..telemetry.logging import log_event
    log_event(session, RetryEvent(
        message=(f"retry at {where!r}: {attempts} attempt(s), "
                 + ("recovered" if succeeded else "exhausted")),
        where=where, attempts=attempts, succeeded=succeeded,
        error=(f"{type(first_err).__name__}: {first_err}" if first_err is not None else "")))
