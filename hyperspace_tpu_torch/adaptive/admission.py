"""SLO admission: breach -> shed or degrade, recovery on health
(counterpart of ``hyperspace_tpu/adaptive/admission.py``).

The serving frontend asks the :class:`AdmissionController` at submit time.
While any armed objective of the SLO monitor (telemetry/slo.py) is
breached, the controller answers ``adaptive.admission.mode``:

- ``shed``: the submit raises ServingRejectedError, as a full queue does;
- ``degrade``: the query is admitted; if its plan is an eligible
  aggregation, the worker runs it over a fixed sampled prefix of each
  scan's files and the result states its error bound
  (``Table.approx_error_bound``). Other plans run exact.

The controller evaluates the monitor at most once a second (the verdict
is kept between), and the first healthy verdict returns to exact answers
with an AdaptiveActionEvent("admission.recover").
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import List, Optional, Tuple

from ..plan import expr as E
from ..plan.nodes import Aggregate, Limit, LogicalPlan, Project, Scan, Sort
from .constants import ADMISSION_SAMPLE_FRACTION

# Seconds between evaluations of the SLO monitor.
_REFRESH_S = 1.0


class AdmissionController:
    """The process's admission verdict, fed by the SLO monitor; all state
    behind ``_lock`` (client threads submit concurrently)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._overloaded = False
        self._last_refresh = 0.0
        self._stats = {"breaches": 0, "recoveries": 0, "sheds": 0, "degrades": 0,
                       "ingest_pauses": 0}

    def refresh(self, session, force: bool = False) -> bool:
        """Evaluate the SLO monitor (at most once a second unless ``force``)
        and return whether it is overloaded."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < _REFRESH_S:
                return self._overloaded
            self._last_refresh = now
        from ..telemetry.slo import get_monitor
        verdict = get_monitor().evaluate(session, now=now)
        breached = any(o.get("breached") for o in (verdict.get("objectives") or {}).values())
        action = None
        with self._lock:
            was = self._overloaded
            self._overloaded = bool(breached)
            if breached and not was:
                self._stats["breaches"] += 1
                action = "admission.engage"
            elif was and not breached:
                self._stats["recoveries"] += 1
                action = "admission.recover"
        if action is not None:
            from . import emit_action
            mode = session.hs_conf.adaptive_admission_mode()
            emit_action(session, action, subject=mode,
                        detail=(f"SLO breach: new submissions will {mode}"
                                if action.endswith("engage")
                                else "health() clear: exact answers resume"))
        return bool(breached)

    def decide(self, session, force_refresh: bool = False) -> str:
        """'admit' | 'shed' | 'degrade' for one submission."""
        if not session.hs_conf.adaptive_enabled():
            return "admit"
        if not self.refresh(session, force=force_refresh):
            return "admit"
        mode = session.hs_conf.adaptive_admission_mode()
        with self._lock:
            self._stats["sheds" if mode == "shed" else "degrades"] += 1
        return mode

    def should_pause_ingest(self, session) -> bool:
        """A continuous source's backpressure (streaming/sources.py): while
        an armed objective is breached, tailers pull no new input, so
        serving drains first. Counts ``ingest_pauses``; never pauses with
        admission off."""
        if not session.hs_conf.adaptive_enabled():
            return False
        if not self.refresh(session):
            return False
        with self._lock:
            self._stats["ingest_pauses"] += 1
        return True

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["overloaded"] = self._overloaded
        return out

    def reset(self) -> None:
        with self._lock:
            self._overloaded = False
            self._last_refresh = 0.0
            for k in self._stats:
                self._stats[k] = 0


_CONTROLLER: Optional[AdmissionController] = None
_CONTROLLER_LOCK = threading.Lock()


def get_controller() -> AdmissionController:
    """The process's controller."""
    global _CONTROLLER
    if _CONTROLLER is None:
        with _CONTROLLER_LOCK:
            if _CONTROLLER is None:
                _CONTROLLER = AdmissionController()
    return _CONTROLLER


# The approximate tier: sampled scans, scaled aggregates, a stated bound.

_SCALED = (E.Count, E.Sum)
_UNSCALED = (E.Min, E.Max, E.Avg)


def _agg_kind(a) -> Optional[type]:
    inner = a.child if isinstance(a, E.Alias) else a
    for kind in _SCALED + _UNSCALED:
        if type(inner) is kind:
            return kind
    return None


def _sample_relation(rel, fraction: float):
    """(sampled relation, kept bytes, total bytes, kept files), or None when
    the relation has nothing to drop. The kept prefix of the sorted listing
    is fixed: a plan degrades to the same answer every time."""
    try:
        files = sorted(rel.all_files())
    except Exception:
        return None
    if len(files) < 2:
        return None
    keep_n = max(1, int(math.ceil(len(files) * fraction)))
    if keep_n >= len(files):
        return None

    def _size(f: str) -> int:
        try:
            return os.path.getsize(f)
        except OSError:
            return 0

    total = sum(_size(f) for f in files)
    kept_files = files[:keep_n]
    kept = sum(_size(f) for f in kept_files)
    if total <= 0 or kept <= 0:
        return None
    return rel.with_files(kept_files), kept, total, keep_n


def approximate_plan(session, plan: LogicalPlan) -> Optional[Tuple[LogicalPlan, dict]]:
    """The degraded rewrite and its stated error bound, or None when
    ``plan`` is not an eligible aggregation (such a query runs exact even
    under breach). Eligible: Sort/Limit/column-Project wrappers over ONE
    Aggregate of Count/Sum/Min/Max/Avg whose subtree scans a source of
    several files. Each scan keeps a prefix of its sorted files; Count and
    Sum are scaled by the inverse kept-byte share (Avg needs no scaling,
    Min and Max stay as read)."""
    wrappers: List[LogicalPlan] = []
    node = plan
    while isinstance(node, (Sort, Limit)) or (
            isinstance(node, Project) and all(isinstance(e, E.Col) for e in node.exprs)):
        wrappers.append(node)
        node = node.children[0]
    if not isinstance(node, Aggregate):
        return None
    kinds = [_agg_kind(a) for a in node.aggs]
    if not kinds or any(k is None for k in kinds):
        return None

    scale = 1.0
    kept_files_total = 0
    sampled = 0

    def _swap(n: LogicalPlan) -> LogicalPlan:
        nonlocal scale, kept_files_total, sampled
        if not isinstance(n, Scan):
            return n
        rel = getattr(n, "relation", None)
        if rel is None:
            return n
        hit = _sample_relation(rel, ADMISSION_SAMPLE_FRACTION)
        if hit is None:
            return n
        new_rel, kept, total, keep_n = hit
        scale *= total / kept
        kept_files_total += keep_n
        sampled += 1
        return Scan(new_rel)

    approx_child = node.child.transform_up(_swap)
    if sampled == 0:
        return None  # nothing to sample: run exact
    agg = Aggregate(node.group_cols, node.aggs, approx_child)
    exprs: List[E.Expr] = [E.Col(g) for g in node.group_cols]
    for a, kind in zip(node.aggs, kinds):
        if kind in _SCALED and scale != 1.0:
            exprs.append(E.Alias(E.Multiply(E.Col(a.name), E.Lit(scale)), a.name))
        else:
            exprs.append(E.Col(a.name))
    out: LogicalPlan = Project(exprs, agg)
    for w in reversed(wrappers):
        out = w.with_children([out])

    effective = 1.0 / scale
    bound = {
        "kind": "relative",
        "confidence": 0.95,
        "sample_fraction": round(effective, 4),
        # A CLT-flavored heuristic over the kept file count, honest for sums
        # and counts over files of about one size, and stated as such.
        "bound": round(min(1.0, 2.0 * math.sqrt(max(0.0, 1.0 - effective)
                                                / max(1, kept_files_total))), 4),
        "scaled": [a.name for a, k in zip(node.aggs, kinds) if k in _SCALED],
    }
    return out, bound
