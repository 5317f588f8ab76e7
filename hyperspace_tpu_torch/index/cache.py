"""TTL cache for index metadata (counterpart of ``hyperspace_tpu/index/cache.py``)."""

from __future__ import annotations

import time
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class CreationTimeBasedIndexCache(Generic[T]):
    """One entry that expires ``expiry_seconds_fn()`` seconds after it was
    cached (a callable, so the expiry follows the live conf)."""

    def __init__(self, expiry_seconds_fn):
        self._expiry_seconds_fn = expiry_seconds_fn
        self._entry: Optional[T] = None
        self._cached_at: float = 0.0

    def get(self) -> Optional[T]:
        if self._entry is None:
            return None
        if time.time() - self._cached_at > self._expiry_seconds_fn():
            self.clear()
            return None
        return self._entry

    def set(self, entry: T) -> None:
        self._entry = entry
        self._cached_at = time.time()

    def clear(self) -> None:
        self._entry = None
        self._cached_at = 0.0
