"""Anomaly flight recorder: bounded process-wide rings of recent
observability, dumpable as one Perfetto bundle (counterpart of
``hyperspace_tpu/telemetry/flight_recorder.py``).

It keeps small, hard-bounded rings of (a) recently retained span-tree
traces (telemetry/trace.py hands every kept trace in via
``finish_root``), (b) recent telemetry events (every ``HyperspaceEvent``
construction lands here: events are built at their emit sites), (c)
anomalies, and (d) periodic metrics snapshots. ``dump()`` fuses them into
one Chrome-trace-event / Perfetto JSON document: span "X" events on a
wall-clock timeline plus instant ("i") markers for events and anomalies,
with the metrics snapshots in ``otherData``.

**Anomaly triggers** double as the tail-keep signal for trace sampling:
``note_anomaly`` marks the ACTIVE trace keep-worthy
(:func:`~.trace.keep_active`), appends to the anomaly ring, bumps the
``flight_recorder.anomalies`` counter and forces a metrics snapshot
(rate-limited). The classifier in :func:`note_event` recognizes
QueryCancelledEvent (deadline breach), RetryEvent exhaustion (any
RetryEvent marks keep; only exhaustion is an anomaly), spill-corrupt
cache misses and SloBreachEvent; robustness/recovery.py reports
crash-recovery sweeps explicitly.

Ring sizes are constants (``FLIGHT_MAX_TRACES`` in telemetry/constants.py
and the event, anomaly and snapshot caps here): O(ring) memory by
construction.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

from . import metric_names as MN
from .constants import FLIGHT_MAX_TRACES
from .metrics import get_registry

_MAX_EVENTS = 512
_MAX_ANOMALIES = 128
_MAX_SNAPSHOTS = 8
# Anomalies force a metrics snapshot at most this often; healthy-path
# snapshots ride trace retention at the longer periodic interval.
_ANOMALY_SNAPSHOT_S = 1.0
_PERIODIC_SNAPSHOT_S = 30.0


class FlightRecorder:
    def __init__(self, max_traces: int = FLIGHT_MAX_TRACES):
        self._lock = threading.Lock()
        self._traces: deque = deque(maxlen=max(int(max_traces), 1))
        self._events: deque = deque(maxlen=_MAX_EVENTS)
        self._anomalies: deque = deque(maxlen=_MAX_ANOMALIES)
        self._snapshots: deque = deque(maxlen=_MAX_SNAPSHOTS)
        self._last_snapshot_s = 0.0
        # Cumulative totals (ring depths alone hide churn).
        self.trace_count = 0
        self.event_count = 0
        self.anomaly_count = 0

    # ------------------------------------------------------------------
    # Feeds.
    # ------------------------------------------------------------------

    def note_trace(self, tr) -> None:
        """One retained trace (called by trace.finish_root)."""
        with self._lock:
            self._traces.append(tr)
            self.trace_count += 1
        self._maybe_snapshot(_PERIODIC_SNAPSHOT_S)

    def note_event(self, name: str, message: str, trace_id: str,
                   span_id: str) -> None:
        with self._lock:
            self._events.append({
                "name": name, "message": message,
                "trace_id": trace_id, "span_id": span_id,
                "wall_ms": int(time.time() * 1000),
            })
            self.event_count += 1

    def note_anomaly(self, kind: str, detail: str = "",
                     trace_id: str = "") -> None:
        with self._lock:
            self._anomalies.append({
                "kind": kind, "detail": detail, "trace_id": trace_id,
                "wall_ms": int(time.time() * 1000),
            })
            self.anomaly_count += 1
        get_registry().counter_add(MN.FLIGHT_ANOMALIES)
        self._maybe_snapshot(_ANOMALY_SNAPSHOT_S)

    def _maybe_snapshot(self, min_interval_s: float) -> None:
        now = time.monotonic()
        with self._lock:
            if now - self._last_snapshot_s < min_interval_s:
                return
            self._last_snapshot_s = now
        # Snapshot OUTSIDE the ring lock: collectors take their own
        # locks (io pool, frontends).
        snap = get_registry().snapshot()
        with self._lock:
            self._snapshots.append({
                "wall_ms": int(time.time() * 1000), "metrics": snap})

    # ------------------------------------------------------------------
    # Surfaces.
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """The ``flight_recorder`` collector payload."""
        with self._lock:
            return {
                "traces": len(self._traces),
                "events": len(self._events),
                "anomalies": len(self._anomalies),
                "snapshots": len(self._snapshots),
                "trace_total": self.trace_count,
                "event_total": self.event_count,
                "anomaly_total": self.anomaly_count,
            }

    def traces(self) -> list:
        with self._lock:
            return list(self._traces)

    def anomalies(self) -> list:
        with self._lock:
            return list(self._anomalies)

    def dump(self) -> dict:
        """One Perfetto/chrome://tracing-loadable document over every
        ring: retained traces' spans as complete ("X") events on a
        shared wall-clock timeline (each stamped with its trace_id),
        events/anomalies as instant ("i") markers, metrics snapshots +
        the anomaly log in ``otherData``."""
        pid = os.getpid()
        with self._lock:
            traces = list(self._traces)
            events = list(self._events)
            anomalies = list(self._anomalies)
            snapshots = list(self._snapshots)
        anchor_ms = min(
            [tr.created_wall_ms for tr in traces]
            + [e["wall_ms"] for e in events]
            + [a["wall_ms"] for a in anomalies]
            + [int(time.time() * 1000)])
        trace_events = []
        for tr in traces:
            base_us = (tr.created_wall_ms - anchor_ms) * 1000.0
            trace_events.extend(
                tr.span_events(base_us=base_us, with_trace_id=True))
        for e in events:
            trace_events.append({
                "name": e["name"], "cat": "hyperspace.event", "ph": "i",
                "ts": round((e["wall_ms"] - anchor_ms) * 1000.0, 3),
                "pid": pid, "tid": 0, "s": "p",
                "args": {"message": e["message"],
                         "trace_id": e["trace_id"],
                         "span_id": e["span_id"]},
            })
        for a in anomalies:
            trace_events.append({
                "name": f"anomaly:{a['kind']}", "cat": "hyperspace.anomaly",
                "ph": "i",
                "ts": round((a["wall_ms"] - anchor_ms) * 1000.0, 3),
                "pid": pid, "tid": 0, "s": "p",
                "args": {"detail": a["detail"],
                         "trace_id": a["trace_id"]},
            })
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "anchor_wall_ms": anchor_ms,
                "trace_ids": [tr.trace_id for tr in traces],
                "anomalies": anomalies,
                "metric_snapshots": snapshots,
                "stats": self.stats(),
            },
        }


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
    """THE process flight recorder (shared like the metrics registry)."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def _recorder_stats() -> dict:
    return get_recorder().stats()


get_registry().register_collector(MN.COLLECTOR_FLIGHT_RECORDER,
                                  _recorder_stats)


def note_anomaly(kind: str, detail: str = "") -> None:
    """Record one anomaly AND mark the active trace tail-keep — the one
    shared entry point every anomaly site funnels through."""
    from . import trace as _trace
    _trace.keep_active(kind)
    tid, _sid = _trace.active_ids()
    get_recorder().note_anomaly(kind, detail, trace_id=tid)


def note_event(event) -> None:
    """Event-construction hook (HyperspaceEvent.__post_init__): ring the
    event, then classify the anomaly/tail-keep signals."""
    name = type(event).__name__
    get_recorder().note_event(
        name, getattr(event, "message", ""),
        getattr(event, "trace_id", ""), getattr(event, "span_id", ""))
    if name == "RetryEvent":
        # Any retried sequence makes the query tail-keep-worthy; only
        # exhaustion is an anomaly.
        from . import trace as _trace
        _trace.keep_active("retry")
        if not getattr(event, "succeeded", True):
            note_anomaly("retry.exhausted", getattr(event, "message", ""))
    elif name == "QueryCancelledEvent":
        note_anomaly("query.cancelled", getattr(event, "message", ""))
    elif name == "ResultCacheMissEvent":
        if getattr(event, "reason", "") == "spill-corrupt":
            note_anomaly("spill.corrupt", getattr(event, "message", ""))
    elif name == "SloBreachEvent":
        note_anomaly("slo.breach", getattr(event, "message", ""))
