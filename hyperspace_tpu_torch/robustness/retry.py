"""Bounded retry with exponential backoff and jitter for transient faults
(counterpart of ``hyperspace_tpu/robustness/retry.py``), around the
op-log store writes (index/log_manager.py): put-if-absent decides every
race, so putting again after an OSError keeps the protocol's semantics.

Transient means OSError or TimeoutError (not a missing file or a
permission error) or an injected TransientInjectedFaultError; anything
else raises on the first attempt. A sequence that exhausts its attempts
raises its first error. Up to MAX_ATTEMPTS attempts, with delays of
``BASE_MS * 2^(attempt-1)`` jittered in [0.5x, 1.5x): the JAX package's
defaults, which nothing here tunes. The JAX package's RetryEvent is not
ported (with the telemetry tier).
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


def call(fn: Callable):
    """``fn()`` with up to MAX_ATTEMPTS attempts, absorbing transient
    errors between them."""
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
                raise first_err
            delay_s = (BASE_MS / 1000.0) * (2 ** (attempt - 1))
            time.sleep(delay_s * (0.5 + random.random()))
            continue
        if attempt > 1:
            _faults.note(retries=attempt - 1)
        return result
