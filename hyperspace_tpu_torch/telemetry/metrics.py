"""Process-wide metrics registry: one surface over every subsystem
(counterpart of ``hyperspace_tpu/telemetry/metrics.py``).

- **counters / gauges**: push-side scalars any module may bump
  (``counter_add`` / ``gauge_set``), snapshot together;
- **histograms**: sliding-window value records with p50/p95/p99 and rate
  (``query.latency_ms`` per executed query, ``serving.latency_ms`` per
  query through the serving frontend);
- **collectors**: named pull callbacks the existing stats surfaces
  register (``io`` → parallel/io.pool_stats, ``robustness`` →
  robustness/faults.stats, ``streaming`` → the commit queue's stats,
  ``serving`` → the default frontend's stats, ``buffer_pool`` →
  execution/buffer_pool.pool_stats, ``flight_recorder``); a snapshot
  invokes them all, and ``Hyperspace.io_stats()`` /
  ``buffer_pool_stats()`` read through here.

Cache-shaped collectors spell their counters ``hits`` / ``misses`` /
``evictions``. Push-side instrument names come from the frozen
telemetry/metric_names.py registry.

Histograms window their samples over ``LATENCY_WINDOW_S``
(telemetry/constants.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .constants import LATENCY_WINDOW_S

_MAX_SAMPLES = 32768


def percentile(ordered: List[float], frac: float) -> float:
    """Upper-index percentile over an ASCENDING-sorted list (the one
    convention every surface shares: the live histograms, the SLO
    monitors, bench's _pct)."""
    return ordered[min(int(len(ordered) * frac), len(ordered) - 1)]


class SlidingHistogram:
    """Timestamped samples over a sliding window; percentiles and rate
    are computed at snapshot time over the samples still inside it.

    The sample buffer is bounded (``max_samples``, ~546 QPS sustained
    at the default 60 s window before it saturates). When load exceeds
    that, the OLDEST in-window samples drop — the snapshot then flags
    ``truncated`` and computes the rate over the time span the retained
    samples actually cover (so QPS stays honest under exactly the load
    the histogram exists to measure); percentiles are over the retained
    (most recent) samples."""

    def __init__(self, window_s: float = LATENCY_WINDOW_S,
                 max_samples: int = _MAX_SAMPLES):
        self.window_s = max(float(window_s), 0.001)
        self.max_samples = max(int(max_samples), 16)
        self._lock = threading.Lock()
        self._samples: "deque[tuple]" = deque()
        self.total_count = 0
        self._cap_dropped = 0  # in-window samples lost to max_samples

    def record(self, value: float, now: Optional[float] = None) -> None:
        t = now if now is not None else time.monotonic()
        with self._lock:
            self._samples.append((t, float(value)))
            self.total_count += 1
            while len(self._samples) > self.max_samples:
                old_t, _ = self._samples.popleft()
                if old_t >= t - self.window_s:
                    self._cap_dropped += 1

    _pct = staticmethod(percentile)

    def snapshot(self, now: Optional[float] = None) -> dict:
        t = now if now is not None else time.monotonic()
        with self._lock:
            while self._samples and self._samples[0][0] < t - self.window_s:
                self._samples.popleft()
            # Truncation is CURRENT only while the buffer is still full:
            # once the window slides past the drop region the retained
            # samples cover the whole window again.
            truncated = self._cap_dropped > 0 \
                and len(self._samples) >= self.max_samples
            if not truncated:
                self._cap_dropped = 0
            span = (t - self._samples[0][0]) if self._samples else 0.0
            values = sorted(v for _, v in self._samples)
        effective = max(span, 1e-6) if truncated else self.window_s
        out = {
            "count": len(values),
            "total_count": self.total_count,
            "window_s": self.window_s,
            "qps": round(len(values) / effective, 4),
        }
        if truncated:
            out["truncated"] = True
        if values:
            out.update({
                "p50": self._pct(values, 0.50),
                "p95": self._pct(values, 0.95),
                "p99": self._pct(values, 0.99),
                "mean": sum(values) / len(values),
                "max": values[-1],
            })
        return out


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, SlidingHistogram] = {}
        self._collectors: Dict[str, Callable[[], dict]] = {}

    # -- push-side instruments ----------------------------------------

    def counter_add(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def histogram(self, name: str) -> SlidingHistogram:
        """The named histogram, created on first use."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = SlidingHistogram()
            return h

    # -- pull-side collectors ------------------------------------------

    def register_collector(self, name: str,
                           fn: Callable[[], dict]) -> None:
        """Register (or replace) the named stats source; its dict is
        embedded verbatim under ``collectors[name]`` in snapshots."""
        with self._lock:
            self._collectors[name] = fn

    def collect(self, name: str) -> Optional[dict]:
        with self._lock:
            fn = self._collectors.get(name)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            # A broken stats source must not take the whole surface down.
            return {"error": "collector failed"}

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            names = list(self._collectors)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {n: h.snapshot() for n, h in hists.items()},
            "collectors": {n: self.collect(n) for n in names},
        }


_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """THE process registry (every subsystem and every session share
    it)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY
