"""Bounded retry with exponential backoff and jitter for transient faults
(counterpart of ``hyperspace_tpu/robustness/retry.py``), around the
op-log store writes (index/log_manager.py): put-if-absent decides every
race, so putting again after an OSError keeps the protocol's semantics.

Transient means OSError or TimeoutError (not a missing file or a
permission error) or an injected TransientInjectedFaultError; anything
else raises on the first attempt. A sequence that exhausts its attempts
raises its first error. Up to MAX_ATTEMPTS attempts, with delays of
``BASE_MS * 2^(attempt-1)`` jittered in [0.5x, 1.5x): the JAX package's
defaults, which nothing here tunes. A sequence that retried (recovered or
exhausted) emits one RetryEvent through the governing session's logger.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from . import faults as _faults

TRANSIENT_TYPES = (OSError, TimeoutError, _faults.TransientInjectedFaultError)

NON_TRANSIENT_TYPES = (FileNotFoundError, NotADirectoryError, IsADirectoryError,
                       PermissionError)

MAX_ATTEMPTS = 3
BASE_MS = 10.0


def call(fn: Callable, *, where: str = "", session=None):
    """``fn()`` with up to MAX_ATTEMPTS attempts, absorbing transient
    errors between them. ``where`` names the boundary in the RetryEvent."""
    first_err: Optional[BaseException] = None
    for attempt in range(1, MAX_ATTEMPTS + 1):
        try:
            result = fn()
        except TRANSIENT_TYPES as e:
            if isinstance(e, NON_TRANSIENT_TYPES):
                raise
            if first_err is None:
                first_err = e
            if attempt >= MAX_ATTEMPTS:
                _faults.note(retries=attempt - 1, retry_failures=1)
                _emit(session, where, attempt, False, first_err)
                raise first_err
            delay_s = (BASE_MS / 1000.0) * (2 ** (attempt - 1))
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
