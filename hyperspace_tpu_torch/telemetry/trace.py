"""Per-query span-tree tracing (counterpart of
``hyperspace_tpu/telemetry/trace.py``).

The third telemetry pillar (beside typed events and the metrics
registry): one :class:`Trace` per query execution, holding a tree of
:class:`Span` records — trace_id + span_id + parent links, wall-clock
anchor + ``perf_counter`` timestamps, and structured attributes — so a
single query's time can be attributed across optimize → rewrite → cache
lookup → per-stage execution → I/O. Events emitted during a traced
execution are stamped with the active (trace_id, span_id).

Span times are HOST times: CUDA runs asynchronously, so a span that only
launches a kernel ends when the launch returns, and the device time lands
in whichever later span synchronizes (usually the result's copy to
arrow). No span synchronizes the device. The one-shot profiler capture
(:func:`maybe_profile`) gives device time.

Propagation is a contextvar, not a thread-local: the serving frontend
snapshots ``contextvars.copy_context()`` per submission and the prefetch
producer runs under a copied context, so the active span follows the
query across worker threads like the per-query io attribution it rides
next to. Reader-pool workers do NOT inherit the context: their work is
recorded on the consumer side (``add_span``), where parallel/io.py
credits the per-query io counters.

Tracing off is a hard no-op fast path: ``span(...)`` returns a shared
no-op context manager after one contextvar read, and ``Session.execute``
opens no trace at all while ``hyperspace.tpu.telemetry.trace.enabled``
is false (conf via config.py only). The flag defaults on, with
head-sampled RETENTION: the per-query coin (``telemetry.trace.sampleRate``)
is flipped at ``Session.execute``; a coin-negative query still records
into a provisional trace, so the tail-keep override (:func:`keep_active`:
retries, robustness incidents, errors, flight-recorder anomalies, the
live-latency threshold) can rescue exactly the unlucky queries, but the
trace is discarded at completion unless kept (:func:`finish_root`). Span
names come from the frozen registry in span_names.py.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from . import metric_names as MN
from . import span_names
from .constants import TRACE_MAX_SPANS

# The (Trace, Span) pair of the in-flight traced execution, if any.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "hst_torch_active_trace", default=None)


class Span:
    """One timed region. ``end_perf`` is None while open; attributes are
    a plain dict the owner may amend until the trace is exported."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "tid",
                 "start_perf", "end_perf", "attrs")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, attrs: dict):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.tid = threading.get_ident()
        self.start_perf = time.perf_counter()
        self.end_perf: Optional[float] = None
        self.attrs = attrs

    def finish(self) -> None:
        if self.end_perf is None:
            self.end_perf = time.perf_counter()

    @property
    def duration_s(self) -> float:
        end = self.end_perf if self.end_perf is not None \
            else time.perf_counter()
        return max(end - self.start_perf, 0.0)

    def __repr__(self) -> str:  # diagnostic only
        return (f"Span({self.name}, id={self.span_id}, "
                f"parent={self.parent_id}, {self.duration_s * 1000:.2f}ms)")


class Trace:
    """The span tree of one query (or one literal-sweep batch). Spans
    append under a lock — members of a sweep and prefetch producers can
    write from several threads — in completion-independent creation
    order; parent links carry the tree."""

    def __init__(self, max_spans: int = TRACE_MAX_SPANS, label: str = "",
                 sampled: bool = True):
        self.trace_id = uuid.uuid4().hex[:16]
        self.label = label
        self.max_spans = max(int(max_spans), 1)
        self.created_wall_ms = int(time.time() * 1000)
        self._anchor_perf = time.perf_counter()
        self._lock = threading.Lock()
        self.spans: List[Span] = []
        self.dropped = 0
        self._ids = 0
        # Retention state (the head-sampling layer): ``sampled`` is the
        # coin flipped at creation; ``keep_reasons`` collects tail-keep
        # marks (deadline breach, retry, degradation, anomaly, slow);
        # ``retained`` flips once finish_root decides to keep it.
        self.sampled = bool(sampled)
        self.keep_reasons: List[str] = []
        self.retained = False

    def new_span(self, name: str, parent_id: Optional[str],
                 attrs: Optional[dict] = None) -> Optional[Span]:
        """Open a span; None once the trace is at ``TRACE_MAX_SPANS`` (the
        would-be span's children then attach to its parent — the tree
        stays connected, the cap stays hard)."""
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return None
            self._ids += 1
            span = Span(self.trace_id, format(self._ids, "x"),
                        parent_id, name, dict(attrs) if attrs else {})
            self.spans.append(span)
            return span

    @property
    def root(self) -> Optional[Span]:
        for s in self.spans:
            if s.parent_id is None:
                return s
        return None

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def duration_s(self) -> float:
        root = self.root
        return root.duration_s if root is not None else 0.0

    # ------------------------------------------------------------------
    # Export: Chrome trace-event JSON (chrome://tracing, Perfetto).
    # ------------------------------------------------------------------

    def span_events(self, base_us: float = 0.0,
                    with_trace_id: bool = False) -> List[dict]:
        """Complete ("X") trace events for every span, ts/dur in
        microseconds offset by ``base_us``; span/parent ids ride in
        ``args`` so the tree survives the flat format (and, for
        multi-trace bundles like the flight-recorder dump, the
        trace_id)."""
        pid = os.getpid()
        events = []
        for s in list(self.spans):
            args: Dict[str, object] = {"span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            if with_trace_id:
                args["trace_id"] = self.trace_id
            args.update(s.attrs)
            events.append({
                "name": s.name,
                "cat": "hyperspace",
                "ph": "X",
                "ts": round(base_us
                            + (s.start_perf - self._anchor_perf) * 1e6, 3),
                "dur": round(s.duration_s * 1e6, 3),
                "pid": pid,
                "tid": s.tid,
                "args": args,
            })
        return events

    def to_chrome_json(self) -> str:
        """One-trace Chrome trace-event JSON (chrome://tracing,
        Perfetto)."""
        events = self.span_events()
        return json.dumps({
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id,
                          "label": self.label,
                          "start_wall_ms": self.created_wall_ms,
                          "dropped_spans": self.dropped},
        }, default=str)


# ---------------------------------------------------------------------------
# Ambient-span API (the only span-opening surface outside this module).
# ---------------------------------------------------------------------------

class _NoopSpan:
    """Shared do-nothing context manager: the tracing-off fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


NOOP = _NoopSpan()


class _SpanScope:
    __slots__ = ("_name", "_attrs", "_pair", "_token", "span")

    def __init__(self, name: str, attrs: dict):
        self._name = name
        self._attrs = attrs
        self.span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Optional[Span]:
        pair = _ACTIVE.get()
        if pair is None:
            return None
        tr, parent = pair
        span = tr.new_span(self._name,
                           parent.span_id if parent is not None else None,
                           self._attrs)
        if span is None:  # trace at maxSpans
            return None
        self.span = span
        self._token = _ACTIVE.set((tr, span))
        return span

    def __exit__(self, et, ev, tb):
        if self.span is not None:
            if et is not None:
                self.span.attrs["error"] = type(et).__name__
            self.span.finish()
            _ACTIVE.reset(self._token)
        return False


def span(name: str, **attrs):
    """Context manager timing one region under the active trace. Returns
    the shared no-op scope when no trace is active (one contextvar read —
    the instrumented hot paths pay effectively nothing while tracing is
    off); yields the open :class:`Span` (or None at the span cap)."""
    if _ACTIVE.get() is None:
        return NOOP
    return _SpanScope(name, attrs)


def add_span(name: str, start_perf: Optional[float] = None,
             **attrs) -> Optional[Span]:
    """Record an already-elapsed region as a completed child of the
    active span — the consumer-side recording shape for work that ran on
    non-context threads (the reader pool, the prefetch producer), rided
    by parallel/io.py exactly where it credits the per-query io
    counters."""
    pair = _ACTIVE.get()
    if pair is None:
        return None
    tr, parent = pair
    span = tr.new_span(name,
                       parent.span_id if parent is not None else None,
                       attrs)
    if span is None:
        return None
    if start_perf is not None:
        span.start_perf = float(start_perf)
    span.finish()
    return span


def active() -> Optional[Tuple[Trace, Span]]:
    return _ACTIVE.get()


def idle() -> bool:
    """True when no trace is active on this context — the guard the
    hottest call sites use to skip even attribute-dict construction."""
    return _ACTIVE.get() is None


def keep_active(reason: str = "") -> None:
    """Mark the ACTIVE trace tail-keep: it survives a negative sample
    coin at completion. Called by the anomaly sites (deadline
    cancellation, retry, degradation ladders, flight-recorder anomalies)
    — a no-op outside a traced execution."""
    pair = _ACTIVE.get()
    if pair is None:
        return
    tr = pair[0]
    with tr._lock:
        if reason not in tr.keep_reasons:
            tr.keep_reasons.append(reason or "anomaly")


def sample_coin(session) -> bool:
    """One retention coin flip per root trace (``sampleRate`` conf)."""
    rate = session.hs_conf.telemetry_trace_sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return random.random() < rate


def finish_root(session, tr: Trace) -> None:
    """Retention decision for one completed root-owned trace: keep it
    (``session._last_trace`` + the flight-recorder ring) when the head
    coin said yes, a tail-keep mark landed, or the query breached the
    live-latency threshold; discard it otherwise. Counted on the
    ``trace.sampled`` / ``trace.tail_kept`` / ``trace.discarded``
    process counters."""
    if tr.retained:
        return
    keep = tr.sampled
    kind = MN.TRACE_SAMPLED
    if not keep and tr.keep_reasons:
        keep, kind = True, MN.TRACE_TAIL_KEPT
    if not keep:
        from . import slo as _slo
        thr = _slo.adaptive_slow_threshold_ms()
        if thr is not None and tr.duration_s() * 1000.0 > thr:
            keep, kind = True, MN.TRACE_TAIL_KEPT
            tr.keep_reasons.append("slow")
    if keep:
        tr.retained = True
        session._last_trace = tr
        from . import flight_recorder as _fr
        _fr.get_recorder().note_trace(tr)
    from .metrics import get_registry
    get_registry().counter_add(MN.TRACE_DISCARDED if not keep else kind)


def active_ids() -> Tuple[str, str]:
    """(trace_id, span_id) of the active span, ("", "") when idle — the
    stamp HyperspaceEvent picks up at construction/emission time."""
    pair = _ACTIVE.get()
    if pair is None:
        return "", ""
    tr, span = pair
    return tr.trace_id, span.span_id if span is not None else ""


@contextlib.contextmanager
def maintenance_trace(session, label: str = ""):
    """Root trace for a non-query operation (streaming append/commit/
    compact): when ``telemetry.trace.enabled`` is set and no trace is
    already active, opens a fresh Trace so the operation's spans
    (``ingest.*``) record, landing on ``session._last_trace`` like a
    query trace. Ambient-trace and tracing-off paths are no-ops — the
    operation's spans then nest under the caller's trace or vanish."""
    if _ACTIVE.get() is not None or session is None or \
            not session.hs_conf.telemetry_trace_enabled():
        yield None
        return
    tr = Trace(label=label, sampled=sample_coin(session))
    token = _ACTIVE.set((tr, None))
    try:
        yield tr
    finally:
        _ACTIVE.reset(token)
        finish_root(session, tr)


@contextlib.contextmanager
def query_trace(session, ctx=None):
    """The root scope ``Session.execute`` opens around one query.

    Resolution order:
    - ``ctx.trace_parent`` set (a literal-sweep member handed a shared
      sweep trace by the frontend): open this query's QUERY span as a
      child in THAT trace;
    - a trace already active on this context (nested execution): open a
      child QUERY span in it;
    - ``telemetry.trace.enabled`` on the session: open a fresh Trace
      with a root QUERY span;
    - otherwise: hard no-op.

    The finished trace lands on ``session._last_trace`` (and on
    ``ctx.trace``) for Hyperspace.last_trace() / explain's "Trace:"
    section."""
    parent = getattr(ctx, "trace_parent", None) if ctx is not None else None
    ambient = _ACTIVE.get()
    forced = bool(getattr(ctx, "trace_force", False)) \
        if ctx is not None else False
    if parent is None and ambient is None and not forced:
        if session is None or \
                not session.hs_conf.telemetry_trace_enabled():
            yield None
            return
    attrs = {}
    if ctx is not None:
        attrs["query_id"] = ctx.query_id
        if ctx.client:
            attrs["client"] = ctx.client
    fresh = False
    if parent is not None:
        tr, parent_span = parent
        parent_id = parent_span.span_id if parent_span is not None else None
    elif ambient is not None:
        tr, parent_span = ambient
        parent_id = parent_span.span_id if parent_span is not None else None
    else:
        # ``trace_force`` (explain_analyze) pins the coin: the caller
        # asked for THIS query's trace, sampling must not drop it.
        tr = Trace(label=ctx.client if ctx is not None else "",
                   sampled=forced or sample_coin(session))
        parent_id = None
        fresh = True
    root = tr.new_span(span_names.QUERY, parent_id, attrs)
    if ctx is not None:
        ctx.trace = tr
    token = _ACTIVE.set((tr, root)) if root is not None else None
    try:
        yield root
    finally:
        if root is not None:
            root.finish()
            _ACTIVE.reset(token)
        if session is not None:
            if fresh:
                finish_root(session, tr)
            elif tr.sampled or tr.keep_reasons:
                # Shared sweep / nested traces: the owner (the serving
                # frontend / the outer query) runs the full retention;
                # members only surface an already-keep-worthy trace.
                session._last_trace = tr


# ---------------------------------------------------------------------------
# Opt-in torch.profiler capture (one query per arm).
# ---------------------------------------------------------------------------

_PROFILER_LOCK = threading.Lock()
_PROFILER_DONE = False


@contextlib.contextmanager
def profile_into(out_dir: str, label: str = "query"):
    """Bracket the block with ``torch.profiler`` (CPU, and CUDA where the
    card is present) and export its chrome trace as a new file under
    ``out_dir``; yields the file's path (written when the block exits)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"hst_{label}_{os.getpid()}_{uuid.uuid4().hex[:8]}.pt.trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def maybe_profile(session):
    """Bracket ONE query with :func:`profile_into` when
    ``hyperspace.tpu.telemetry.profiler.{enabled,dir}`` arm it. One-shot
    per process: the first execution after arming captures, later ones
    run untouched (a serving loop must not accumulate captures)."""
    global _PROFILER_DONE
    if session is None or \
            not session.hs_conf.telemetry_profiler_enabled():
        yield False
        return
    out_dir = session.hs_conf.telemetry_profiler_dir()
    if not out_dir:
        yield False
        return
    with _PROFILER_LOCK:
        if _PROFILER_DONE:
            yield False
            return
        _PROFILER_DONE = True
    with profile_into(out_dir):
        yield True


def reset_profiler() -> None:
    """Re-arm the one-shot profiler capture (tests)."""
    global _PROFILER_DONE
    _PROFILER_DONE = False


# ---------------------------------------------------------------------------
# Rendering (explain's "Trace:" section).
# ---------------------------------------------------------------------------

_RENDER_ATTRS = ("node", "hit", "tier", "mode", "files", "rows",
                 "size", "members")
_MAX_RENDER_LINES = 48


def render_timeline(trace: Trace) -> List[str]:
    """Indented span tree with per-span wall duration and self-time
    (duration minus direct children — where the time actually went)."""
    children: Dict[Optional[str], List[Span]] = {}
    for s in trace.spans:
        children.setdefault(s.parent_id, []).append(s)
    lines: List[str] = []
    total = 0

    def walk(span: Span, depth: int) -> None:
        nonlocal total
        total += 1
        if len(lines) >= _MAX_RENDER_LINES:
            return
        kids = children.get(span.span_id, [])
        dur = span.duration_s
        self_s = max(dur - sum(k.duration_s for k in kids), 0.0)
        detail = " ".join(
            f"{k}={span.attrs[k]}" for k in _RENDER_ATTRS
            if k in span.attrs)
        pad = "  " * depth
        lines.append(
            f"{pad}{span.name:<24} {dur * 1000:9.2f} ms "
            f"(self {self_s * 1000:.2f} ms)"
            + (f"  [{detail}]" if detail else ""))
        for k in kids:
            walk(k, depth + 1)

    for root in children.get(None, []):
        walk(root, 0)
    hidden = len(trace.spans) - min(len(trace.spans), _MAX_RENDER_LINES)
    if hidden > 0:
        lines.append(f"... {hidden} more span(s) not shown")
    if trace.dropped:
        lines.append(f"({trace.dropped} span(s) dropped at the "
                     f"{trace.max_spans}-span cap)")
    return lines
