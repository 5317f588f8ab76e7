"""The explicit per-query execution context (counterpart of
``hyperspace_tpu/serving/context.py``).

``Session.execute`` builds one :class:`QueryContext` per call, or takes the
one the serving frontend hands it, and activates it on a contextvar for
the execution. The layers below read the active context instead of
session attributes:

- ``result_cache``: resolved once when the context is made (the frontend's
  cross-session cache for a query that came through it, else the
  session's own), so a conf change mid-query cannot swap it;
- ``io``: the query's read counters. ``parallel/io.py`` and the buffer pool
  credit the active context beside their process-wide counters;
- ``deadline_s``: a cooperative deadline (the submit's ``deadline_ms``,
  else ``robustness.deadlineMs``), checked by :func:`check_deadline` at the
  executor's stage boundaries, the io waits and the retry backoffs; expiry
  raises QueryDeadlineError and emits one QueryCancelledEvent;
- ``trace``: the span tree this query's spans landed in
  (telemetry/trace.py), ``trace_parent`` the shared sweep span a literal
  sweep hands its members, ``trace_force`` (explain_analyze) a trace kept
  whatever the sampling conf; ``degraded`` and ``slo_suppress_error``
  feed the SLO monitor (telemetry/slo.py).

:func:`record_join_actual` keeps an executed inner join's output rows on
its session, keyed by :func:`join_actual_key`, which explain and the
adaptive feedback loop pair with the join reorderer's estimates.

A contextvar, not a thread-local: the prefetch producers and the frontend's
workers run in copied contexts, so attribution follows the query across
threads.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from typing import Optional

_QUERY_IDS = itertools.count(1)

_CONTEXT: contextvars.ContextVar = contextvars.ContextVar("hst_torch_query_context",
                                                          default=None)

_IO_COUNTER_KEYS = ("read_tasks", "read_bytes", "read_seconds", "wait_seconds",
                    "prefetch_items", "pool_hits", "pool_misses", "pool_bytes_saved")


class QueryContext:
    """Everything one query execution needs, made explicit."""

    def __init__(self, session, result_cache=None, client: str = "",
                 query_id: Optional[int] = None, deadline_s: Optional[float] = None,
                 capture: bool = False):
        self.session = session
        # The advisor's capture decision, pinned when the context is made.
        self.capture = bool(capture)
        self.query_id = query_id if query_id is not None else next(_QUERY_IDS)
        self.client = client
        self.created_s = time.perf_counter()
        self.result_cache = result_cache
        # An absolute perf_counter stamp, or None.
        self.deadline_s = deadline_s
        self._cancel_emitted = False
        self.trace = None
        self.trace_parent = None
        self.trace_force = False
        # A robustness degradation ladder fired during this query (the SLO
        # degrade-rate objective reads it).
        self.degraded = False
        # A sweep member's attempt whose failure the frontend reruns alone:
        # the rerun's outcome is the one the SLO window records.
        self.slo_suppress_error = False
        self._io_lock = threading.Lock()
        self._io = {k: 0.0 if k.endswith("seconds") else 0 for k in _IO_COUNTER_KEYS}

    @classmethod
    def for_session(cls, session, shared_cache=None, client: str = "",
                    deadline_s: Optional[float] = None,
                    query_id: Optional[int] = None) -> "QueryContext":
        """The context ``Session.execute`` builds when none is handed in.
        ``shared_cache`` (the frontend's cross-session cache) takes
        precedence over the session's own; an explicit ``deadline_s`` (the
        frontend's submit-time deadline) over the session's
        ``robustness.deadlineMs``; ``query_id`` is the frontend's,
        allocated at submit time."""
        cache = shared_cache if shared_cache is not None else session.result_cache
        if deadline_s is None:
            ms = session.hs_conf.robustness_deadline_ms()
            if ms > 0:
                deadline_s = time.perf_counter() + ms / 1000.0
        return cls(session, result_cache=cache, client=client, deadline_s=deadline_s,
                   query_id=query_id, capture=session.hs_conf.advisor_capture_enabled())

    @contextlib.contextmanager
    def activate(self):
        token = _CONTEXT.set(self)
        try:
            yield self
        finally:
            _CONTEXT.reset(token)

    def note_io(self, **deltas) -> None:
        with self._io_lock:
            for k, v in deltas.items():
                if k in self._io:
                    self._io[k] += v

    def io_stats(self) -> dict:
        with self._io_lock:
            return dict(self._io)


_JOIN_ACTUALS_MAX = 256


def _leaf_identity(leaf) -> str:
    """A leaf's identity that the optimizer's rewrites keep: the reorderer
    keys its estimates before index substitution and partition pruning,
    the executor its actuals after. A Scan's partition base survives
    ``with_files``; an IndexScan's entry records its source Scan's root
    paths. Both reduce to the source directory of the original Scan."""
    rel = getattr(leaf, "relation", None)
    if rel is not None:  # Scan
        base = getattr(rel, "partition_base_path", None)
        if base:
            return str(base)
        paths = getattr(rel, "root_paths", None) or []
        return str(paths[0]) if paths else leaf.node_name
    entry = getattr(leaf, "index_entry", None)
    if entry is not None:  # IndexScan
        paths = entry.relation.rootPaths
        return str(paths[0]) if paths else f"index:{entry.name}"
    return leaf.node_name


def join_side_signature(plan) -> str:
    """One join input's signature: its leaves' identities, sorted."""
    return "+".join(sorted(_leaf_identity(leaf) for leaf in plan.collect_leaves()))


def join_actual_key(condition, left, right) -> str:
    """The key that pairs an inner join's estimate with its actual rows:
    the condition's repr and both sides' signatures, so two table pairs
    that share a condition's text never collide."""
    return (f"{condition!r} @ {join_side_signature(left)} >< "
            f"{join_side_signature(right)}")


def record_join_actual(session, key: str, rows: int) -> None:
    """An executed inner join's output rows onto the session's bounded,
    locked LRU store; with ``adaptive.enabled``, into the
    process's correction store too (adaptive/feedback.py)."""
    with session._join_actuals_lock:
        actuals = session._join_actuals
        actuals[key] = int(rows)
        actuals.move_to_end(key)
        while len(actuals) > _JOIN_ACTUALS_MAX:
            actuals.popitem(last=False)
    try:
        if session.hs_conf.adaptive_enabled():
            from ..adaptive import feedback as _feedback
            _feedback.get_store().observe(session, key, int(rows))
    except Exception:
        pass  # feedback accounting never fails a query


def next_query_id() -> int:
    """One process-wide query id (the frontend takes it at submit time)."""
    return next(_QUERY_IDS)


def active_context() -> Optional[QueryContext]:
    """The context of the execution in flight, if any."""
    return _CONTEXT.get()


def deadline_remaining_s() -> Optional[float]:
    """Seconds to the active query's deadline (negative once past), or None
    without a context or a deadline."""
    ctx = _CONTEXT.get()
    if ctx is None or ctx.deadline_s is None:
        return None
    return ctx.deadline_s - time.perf_counter()


def check_deadline(where: str = "") -> None:
    """A cancellation point: raises QueryDeadlineError once the active
    query's deadline has passed, else does nothing."""
    ctx = _CONTEXT.get()
    if ctx is None or ctx.deadline_s is None or time.perf_counter() < ctx.deadline_s:
        return
    with ctx._io_lock:
        first = not ctx._cancel_emitted
        ctx._cancel_emitted = True
    if first:
        from ..telemetry import trace as _trace
        pair = _trace.active()
        if pair is not None and pair[1] is not None:
            # Flag the span the cancellation struck.
            pair[1].attrs["deadline_exceeded"] = True
            pair[1].attrs["cancelled_at"] = where
    deadline_cancel(ctx.session, ctx.query_id, where,
                    (time.perf_counter() - ctx.created_s) * 1000.0, emit=first)


def deadline_cancel(session, query_id: int, where: str, elapsed_ms: float,
                    emit: bool = True) -> None:
    """Raise the typed deadline error (shared by the mid-query check and
    the frontend's check before a queued query starts). The first
    cancellation of a query counts ``deadline_cancellations`` and emits
    one QueryCancelledEvent (``emit=False`` on a re-trip)."""
    from ..exceptions import QueryDeadlineError
    if emit:
        from ..robustness import faults as _faults
        _faults.note(deadline_cancellations=1)
        if session is not None:
            from ..telemetry.events import QueryCancelledEvent
            from ..telemetry.logging import log_event
            log_event(session, QueryCancelledEvent(
                message=(f"query {query_id} cancelled at {where or 'boundary'}: "
                         f"deadline expired after {elapsed_ms:.1f} ms"),
                query_id=query_id, where=where, elapsed_ms=round(elapsed_ms, 3)))
    raise QueryDeadlineError(
        f"query {query_id} exceeded its deadline ({elapsed_ms:.1f} ms elapsed; "
        f"cancelled at {where or 'stage boundary'})")
