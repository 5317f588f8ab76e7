"""Feedback-corrected cardinality estimates and mid-query re-planning
(counterpart of ``hyperspace_tpu/adaptive/feedback.py``).

The join reorderer (optimizer/join_order.py) leaves per-step ``est_rows``
records keyed by ``join_actual_key`` on ``session._last_join_order``, and
the executor writes every executed inner join's actual rows under the
same keys (serving/context.record_join_actual). This module closes the
loop:

- :class:`CorrectionStore`, one per process: an EXACT tier keyed by the
  whole join key (condition and both side signatures) holding an EMA of
  the observed rows, and a COARSE tier keyed by the unordered pair of side
  signatures holding a clamped EMA of the actual/estimate ratio. The
  first reuses a join's observed rows; the second carries a learned
  mis-estimate over to other orders over the same pair of tables.
- ``observe()``, called from record_join_actual while
  ``adaptive.enabled`` is on: pairs the actual with the recorded
  estimate, where the reorderer left one, and updates both tiers.
- ``maybe_replan()``, called by the executor right after that write-back:
  when the actual differs from the estimate past
  ``REPLAN_ERROR_THRESHOLD`` and a later join of the same chain
  remains, it raises :class:`ReplanRequested`.
  ``Session._execute_uncaptured`` catches it and runs the query once more,
  planned with the correction ``observe`` just stored. One re-plan a query
  (a contextvar guard); a literal sweep's members never re-plan.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from ..exceptions import HyperspaceException
from .constants import FEEDBACK_ALPHA, FEEDBACK_MAX_ENTRIES, REPLAN_ERROR_THRESHOLD

# Clamp on the coarse tier's ratio: one wild observation cannot move a
# pair's future estimates by more than this factor.
_RATIO_CLAMP = 64.0

_SUPPRESS: contextvars.ContextVar = contextvars.ContextVar(
    "hst_torch_adaptive_replan_suppress", default=False)


class ReplanRequested(HyperspaceException):
    """A control transfer, not a failure: a join boundary observed rows far
    enough from the estimate that planning again beats finishing the
    current plan. Raised only while ``adaptive.replan.enabled`` is on and
    always caught by Session._execute_uncaptured (a HyperspaceException,
    so an escape still meets the serving tier's typed-error contract)."""

    def __init__(self, key: str, est_rows: float, actual_rows: int):
        super().__init__(f"re-plan requested: join {key!r} estimated ~{est_rows:.0f} "
                         f"rows, observed {actual_rows}")
        self.key = key
        self.est_rows = float(est_rows)
        self.actual_rows = int(actual_rows)


def parse_key(key: str) -> Optional[Tuple[str, str, str]]:
    """(condition repr, left signature, right signature) of one join key;
    None for a key of another form."""
    try:
        head, right_sig = key.rsplit(" >< ", 1)
        cond, left_sig = head.rsplit(" @ ", 1)
    except ValueError:
        return None
    return cond, left_sig, right_sig


def pair_key(left_sig: str, right_sig: str) -> str:
    """The two inputs joined either way round have the same true rows."""
    a, b = sorted((left_sig, right_sig))
    return f"{a} || {b}"


class CorrectionStore:
    """The process-wide feedback store. Every read and write holds
    ``_lock``: serving workers write it and any thread may optimize."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: "OrderedDict[str, float]" = OrderedDict()    # key -> EMA rows
        self._ratios: "OrderedDict[str, float]" = OrderedDict()  # pair -> EMA ratio
        self._observed = 0
        self._paired = 0
        self._replans = 0

    def observe(self, session, key: str, rows: int) -> None:
        parsed = parse_key(key)
        if parsed is None:
            return
        _, left_sig, right_sig = parsed
        est = lookup_estimate(session, key)
        with self._lock:
            self._observed += 1
            prev = self._rows.get(key)
            self._rows[key] = float(rows) if prev is None \
                else (1.0 - FEEDBACK_ALPHA) * prev + FEEDBACK_ALPHA * float(rows)
            self._rows.move_to_end(key)
            while len(self._rows) > FEEDBACK_MAX_ENTRIES:
                self._rows.popitem(last=False)
            if est is not None and est > 0:
                self._paired += 1
                pk = pair_key(left_sig, right_sig)
                ratio = max(float(rows), 1.0) / max(est, 1.0)
                ratio = min(max(ratio, 1.0 / _RATIO_CLAMP), _RATIO_CLAMP)
                prev_r = self._ratios.get(pk)
                self._ratios[pk] = ratio if prev_r is None \
                    else (1.0 - FEEDBACK_ALPHA) * prev_r + FEEDBACK_ALPHA * ratio
                self._ratios.move_to_end(pk)
                while len(self._ratios) > FEEDBACK_MAX_ENTRIES:
                    self._ratios.popitem(last=False)

    def note_replan(self) -> None:
        with self._lock:
            self._replans += 1

    def exact_rows(self, key: str) -> Optional[float]:
        with self._lock:
            v = self._rows.get(key)
        return None if v is None else max(1.0, v)

    def pair_ratio(self, left_sig: str, right_sig: str) -> Optional[float]:
        with self._lock:
            return self._ratios.get(pair_key(left_sig, right_sig))

    def corrected_rows(self, left_sig: str, right_sig: str, est: float) -> float:
        """The coarse tier's correction of one enumeration step: the
        estimate scaled by the pair's learned ratio (the exact tier applies
        when the reorderer rebuilds the chosen order)."""
        ratio = self.pair_ratio(left_sig, right_sig)
        if ratio is None:
            return est
        return max(1.0, est * ratio)

    def stats(self) -> dict:
        with self._lock:
            return {"exact_entries": len(self._rows), "ratio_entries": len(self._ratios),
                    "observed": self._observed, "paired": self._paired,
                    "replans": self._replans}

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._ratios.clear()
            self._observed = self._paired = self._replans = 0


_STORE: Optional[CorrectionStore] = None
_STORE_LOCK = threading.Lock()


def get_store() -> CorrectionStore:
    """The process's store."""
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = CorrectionStore()
    return _STORE


def lookup_estimate(session, key: str) -> Optional[float]:
    """The reorderer's estimate for one executed join, if its last pass
    left one (a chain kept in its text order records no steps)."""
    for r in session._last_join_order or []:
        for s in r.get("steps") or []:
            if s.get("key") == key:
                return float(s["est_rows"])
    return None


@contextlib.contextmanager
def suppress_replans():
    """maybe_replan does nothing inside (the re-executed attempt)."""
    token = _SUPPRESS.set(True)
    try:
        yield
    finally:
        _SUPPRESS.reset(token)


def maybe_replan(session, key: str, actual_rows: int) -> None:
    """The join-boundary trigger (after the write-back, which already fed
    the store): raise ReplanRequested when the actual differs from the
    recorded estimate past the threshold and a later join of the chain
    remains."""
    if _SUPPRESS.get():
        return
    from ..serving import batcher
    if batcher.active_sweep() is not None:
        # A sweep's members share scans: one member's abort would strand
        # the others.
        return
    est = None
    is_last = True
    for r in session._last_join_order or []:
        steps = r.get("steps") or []
        for i, s in enumerate(steps):
            if s.get("key") == key:
                est = float(s["est_rows"])
                is_last = i == len(steps) - 1
    if est is None or est <= 0 or is_last:
        # Nothing to differ from, or no later join a better order helps.
        return
    actual = max(float(actual_rows), 1.0)
    if max(actual / est, est / actual) <= REPLAN_ERROR_THRESHOLD:
        return
    get_store().note_replan()
    raise ReplanRequested(key, est, actual_rows)


def emit_replan_event(session, rr: ReplanRequested) -> None:
    try:
        from ..telemetry.events import ReplanEvent
        from ..telemetry.logging import log_event
        log_event(session, ReplanEvent(
            message=(f"mid-query re-plan: estimated ~{rr.est_rows:.0f} rows, "
                     f"observed {rr.actual_rows}"),
            key=rr.key, est_rows=round(rr.est_rows, 3), actual_rows=rr.actual_rows,
            threshold=REPLAN_ERROR_THRESHOLD))
    except Exception:
        pass  # an event never fails a query
