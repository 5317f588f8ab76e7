"""SLO monitors: named objectives over sliding windows of completed
queries (counterpart of ``hyperspace_tpu/telemetry/slo.py``).

Two objectives, each armed by its own ``hyperspace.tpu.telemetry.slo.*``
conf key (0 = disarmed): **p99 latency** (ms) and **error rate** (failed /
completed). Every ``Session.execute``, frontend or not, feeds
:func:`observe_query` with (latency, error flag, the QueryContext's
degraded flag, counted in the verdict) and the live ``query.latency_ms``
histogram; the monitor evaluates the armed objectives over
``SLO_WINDOW_S`` (rate-limited on the feed path, always on demand via
``Hyperspace.health()``).

Breaches are EDGE-TRIGGERED per objective: the healthy→breached
transition emits one :class:`~.events.SloBreachEvent`, bumps the
``slo.breaches`` counter and lands a flight-recorder anomaly; the
recovery transition re-arms silently. ``Hyperspace.health()`` returns the
verdict dict. Nothing here acts on a breach: the admission controller
that sheds or degrades waits with adaptive/.

The monitor also owns the cached live p99 the trace sampler's adaptive
tail-keep threshold reads (:func:`adaptive_slow_threshold_ms`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from . import metric_names as MN
from .constants import SLO_WINDOW_S
from .metrics import get_registry, percentile

_MAX_SAMPLES = 32768
# Samples older than this are gone for every consumer; windows larger
# than the horizon evaluate over what the horizon retains.
_RETENTION_S = 3600.0
_EVAL_INTERVAL_S = 5.0
_P99_CACHE_S = 5.0
# Adaptive tail-keep: 2x the live p99 once the window holds this many
# samples (below it the estimate is noise and no threshold applies).
_ADAPTIVE_FACTOR = 2.0
_ADAPTIVE_MIN_SAMPLES = 64

OBJECTIVE_P99 = "p99_latency_ms"
OBJECTIVE_ERROR_RATE = "error_rate"


class SloMonitor:
    """Sliding-window query outcomes + edge-triggered breach state."""

    def __init__(self, max_samples: int = _MAX_SAMPLES):
        self._lock = threading.Lock()
        # (monotonic_t, latency_ms, error, degraded)
        self._samples: deque = deque(maxlen=max(int(max_samples), 16))
        self._breached = {}          # objective name -> bool
        self._last_eval_s = 0.0
        self._p99_cache: Optional[float] = None
        self._p99_cache_t = 0.0
        self.total = 0
        self.error_total = 0
        self.degraded_total = 0

    def record(self, latency_ms: float, error: bool, degraded: bool,
               now: Optional[float] = None) -> None:
        t = now if now is not None else time.monotonic()
        with self._lock:
            self._samples.append((t, float(latency_ms), bool(error),
                                  bool(degraded)))
            self.total += 1
            if error:
                self.error_total += 1
            if degraded:
                self.degraded_total += 1

    def _window(self, window_s: float, now: float):
        """Samples inside ``window_s``, trimmed to the retention
        horizon."""
        with self._lock:
            while self._samples and \
                    self._samples[0][0] < now - _RETENTION_S:
                self._samples.popleft()
            cut = now - window_s
            return [s for s in self._samples if s[0] >= cut]

    def due(self, now: Optional[float] = None) -> bool:
        t = now if now is not None else time.monotonic()
        with self._lock:
            if t - self._last_eval_s < _EVAL_INTERVAL_S:
                return False
            self._last_eval_s = t
            return True

    # ------------------------------------------------------------------
    # Evaluation.
    # ------------------------------------------------------------------

    def evaluate(self, session, now: Optional[float] = None,
                 emit: bool = True) -> dict:
        """Evaluate the governing session's armed objectives over its
        window; emit SloBreachEvent per healthy→breached transition.
        Returns the health verdict dict."""
        t = now if now is not None else time.monotonic()
        conf = session.hs_conf
        window_s = SLO_WINDOW_S
        min_count = conf.telemetry_slo_min_count()
        samples = self._window(window_s, t)
        n = len(samples)
        lat = sorted(s[1] for s in samples)
        errors = sum(1 for s in samples if s[2])
        degraded = sum(1 for s in samples if s[3])
        p99 = percentile(lat, 0.99) if lat else None
        objectives = {}
        armed = (
            (OBJECTIVE_P99, conf.telemetry_slo_p99_ms(), p99),
            (OBJECTIVE_ERROR_RATE, conf.telemetry_slo_error_rate(),
             (errors / n) if n else None),
        )
        healthy = True
        for name, threshold, observed in armed:
            is_armed = threshold > 0
            breached = bool(
                is_armed and n >= min_count and observed is not None
                and observed > threshold)
            objectives[name] = {
                "armed": is_armed,
                "threshold": threshold if is_armed else None,
                "observed": observed,
                "breached": breached,
            }
            if breached:
                healthy = False
            # Edge state is per (objective, threshold) and updates only
            # for ARMED evaluations: the monitor is a process singleton
            # while thresholds are per-session conf, so neither a
            # disarmed session nor a session with a DIFFERENT armed
            # threshold can reset another session's breach edge and
            # turn one continuous incident into a stream of "new"
            # breaches.
            if is_armed:
                edge = (name, float(threshold))
                with self._lock:
                    was = self._breached.get(edge, False)
                    if len(self._breached) > 256 and edge not in \
                            self._breached:
                        # A threshold-scanning caller must not grow the
                        # edge table without bound.
                        self._breached.clear()
                    self._breached[edge] = breached
                if breached and not was:
                    get_registry().counter_add(MN.SLO_BREACHES)
                    if emit:
                        _emit_breach(session, name, threshold, observed,
                                     window_s, n)
        return {
            "healthy": healthy,
            "window_s": window_s,
            "count": n,
            "errors": errors,
            "degraded": degraded,
            "objectives": objectives,
        }

    def live_p99_ms(self, now: Optional[float] = None) -> Optional[float]:
        """Cached p99 of the LIVE ``query.latency_ms`` histogram (its
        sliding window, not this monitor's hour-long retention — a
        cold-start spike must age out of the adaptive threshold the way
        the docs promise), cheap enough for the per-query tail-keep
        check."""
        t = now if now is not None else time.monotonic()
        with self._lock:
            if self._p99_cache_t and t - self._p99_cache_t < _P99_CACHE_S:
                return self._p99_cache
            self._p99_cache_t = t
        snap = get_registry().histogram(MN.QUERY_LATENCY_MS).snapshot()
        p99 = snap.get("p99") \
            if snap.get("count", 0) >= _ADAPTIVE_MIN_SAMPLES else None
        with self._lock:
            self._p99_cache = p99
        return p99


def _emit_breach(session, objective: str, threshold: float,
                 observed, window_s: float, count: int) -> None:
    try:
        from .events import SloBreachEvent
        from .logging import log_event
        log_event(session, SloBreachEvent(
                message=(f"SLO breach: {objective} observed "
                         f"{observed:.4g} > objective {threshold:g} "
                         f"over {window_s:g}s ({count} queries)"),
                objective=objective, threshold=threshold,
                observed=float(observed), window_s=window_s,
                count=count))
    except Exception:
        pass  # observability must never fail a query


_MONITOR: Optional[SloMonitor] = None
_MONITOR_LOCK = threading.Lock()


def get_monitor() -> SloMonitor:
    """THE process SLO monitor (shared like the metrics registry)."""
    global _MONITOR
    if _MONITOR is None:
        with _MONITOR_LOCK:
            if _MONITOR is None:
                _MONITOR = SloMonitor()
    return _MONITOR


def observe_query(session, latency_ms: float, error: bool = False,
                  degraded: bool = False) -> None:
    """The per-query feed (Session.execute's finally): the live
    query-latency histogram plus the SLO window, with a rate-limited
    evaluation so breaches surface without anyone polling health()."""
    try:
        get_registry().histogram(MN.QUERY_LATENCY_MS).record(latency_ms)
        mon = get_monitor()
        mon.record(latency_ms, error, degraded)
        if mon.due():
            mon.evaluate(session)
    except Exception:
        pass  # observability must never fail a query


def health(session) -> dict:
    """Evaluate now and return the verdict (Hyperspace.health)."""
    return get_monitor().evaluate(session)


def adaptive_slow_threshold_ms() -> Optional[float]:
    """The tail-keep latency threshold: 2x the live query-latency p99,
    None until the window is populated enough to mean anything."""
    p99 = get_monitor().live_p99_ms()
    if p99 is None:
        return None
    return p99 * _ADAPTIVE_FACTOR
