"""Selectivity and cardinality estimates over the statistics layer
(counterpart of ``hyperspace_tpu/optimizer/cardinality.py``; the same
estimators in the same Python float arithmetic, so the same join orders).

Textbook estimators (System R lineage), fed by optimizer/stats.py:

  * range conjuncts  → covered fraction of the column's [min, max] span;
  * equality         → 1 / NDV (uniformity assumption);
  * IN lists         → |list| / NDV, capped at 1;
  * IS [NOT] NULL    → the footer-exact null fraction;
  * equi-joins       → containment of keys: |L| x |R| / max(NDV_l, NDV_r).

Sketch refutation (Bloom membership / MinMax, via
StatsProvider.sketch_row_fraction) caps equality/IN selectivity from
above: rows in files every sketch refutes cannot match. Unknown shapes
estimate 1.0 — conservative for join ordering (an unknown predicate
never makes a table look artificially small).
"""

from __future__ import annotations

import datetime
from typing import Optional

from ..plan import expr as E
from .stats import TableStats, numeric_span_fraction

# Selectivity floor: keeps products non-zero so downstream ratios and
# q-errors stay finite even when an estimator reports "nothing survives".
MIN_SELECTIVITY = 1e-4

# Fixed fallbacks for shapes the statistics cannot see through
# (the classic System R defaults, biased conservative).
EQUALITY_FALLBACK = 0.1
RANGE_FALLBACK = 1.0 / 3.0
LIKE_SELECTIVITY = 0.2

_RANGE_OPS = (E.LessThan, E.LessThanOrEqual,
              E.GreaterThan, E.GreaterThanOrEqual)


def _clamp(s: float) -> float:
    return max(MIN_SELECTIVITY, min(1.0, s))


def _coerce_literal(value, cs):
    """Date columns accept ISO strings in the expression language."""
    if isinstance(value, str) and isinstance(cs.minimum, datetime.date):
        try:
            return datetime.date.fromisoformat(value)
        except ValueError:
            return value
    return value


def _col_lit(e) -> Optional[tuple]:
    """(column, op-name, literal) for Col <op> Lit in either order."""
    if not isinstance(e, _RANGE_OPS + (E.EqualTo,)):
        return None
    left, right = e.left, e.right
    op = type(e).__name__
    if isinstance(left, E.Lit) and isinstance(right, E.Col):
        left, right = right, left
        op = {"EqualTo": "EqualTo", "LessThan": "GreaterThan",
              "LessThanOrEqual": "GreaterThanOrEqual",
              "GreaterThan": "LessThan",
              "GreaterThanOrEqual": "LessThanOrEqual"}[op]
    if isinstance(left, E.Col) and isinstance(right, E.Lit):
        return left.column, op, right.value
    return None


def conjunct_selectivity(stats: Optional[TableStats], e: E.Expr) -> float:
    """Estimated selectivity of one predicate node (not clamped —
    callers clamp the final product)."""
    if isinstance(e, E.And):
        return conjunct_selectivity(stats, e.left) * \
            conjunct_selectivity(stats, e.right)
    if isinstance(e, E.Or):
        sl = conjunct_selectivity(stats, e.left)
        sr = conjunct_selectivity(stats, e.right)
        return min(1.0, sl + sr - sl * sr)
    if isinstance(e, E.Not):
        child = conjunct_selectivity(stats, e.child)
        # An opaque child estimates 1.0; its negation is equally opaque —
        # returning 1 - 1.0 = 0 would make the table look artificially
        # tiny, the exact failure the conservative default exists to
        # prevent.
        return 1.0 if child >= 1.0 else 1.0 - child
    if isinstance(e, E.IsNull) and isinstance(e.child, E.Col):
        if stats is None:
            return 0.5
        nf = stats.null_fraction(e.child.column)
        return (1.0 - nf) if e.negated else nf
    if isinstance(e, E.Like):
        return (1.0 - LIKE_SELECTIVITY) if e.negated else LIKE_SELECTIVITY
    if isinstance(e, E.In) and isinstance(e.value, E.Col) \
            and all(isinstance(o, E.Lit) for o in e.options):
        ndv = stats.ndv(e.value.column) if stats is not None else None
        if ndv is None:
            return min(1.0, len(e.options) * EQUALITY_FALLBACK)
        return min(1.0, len(set(o.value for o in e.options)) / ndv)
    cl = _col_lit(e)
    if cl is None:
        return 1.0  # opaque shape: assume it keeps everything
    column, op, value = cl
    cs = stats.column(column) if stats is not None else None
    if op == "EqualTo":
        ndv = stats.ndv(column) if stats is not None else None
        if ndv is None:
            return EQUALITY_FALLBACK
        sel = 1.0 / ndv
        if cs is not None and cs.has_minmax:
            v = _coerce_literal(value, cs)
            try:
                if v < cs.minimum or v > cs.maximum:
                    return 0.0
            except TypeError:
                pass
        return sel
    if cs is None:
        return RANGE_FALLBACK
    v = _coerce_literal(value, cs)
    if op in ("LessThan", "LessThanOrEqual"):
        frac = numeric_span_fraction(cs, None, v)
    else:
        frac = numeric_span_fraction(cs, v, None)
    if frac is None:
        return RANGE_FALLBACK
    return frac * (1.0 - (stats.null_fraction(column)
                          if stats is not None else 0.0))


def filter_selectivity(stats: Optional[TableStats], condition: E.Expr,
                       sketch_cap: Optional[float] = None) -> float:
    """Estimated fraction of rows ``condition`` keeps, in
    [MIN_SELECTIVITY, 1]. ``sketch_cap`` (rows in sketch-unrefuted
    files / total rows) caps the estimate from above."""
    sel = 1.0
    for conjunct in E.split_conjunctive_predicates(condition):
        sel *= conjunct_selectivity(stats, conjunct)
    if sketch_cap is not None:
        sel = min(sel, sketch_cap)
    return _clamp(sel)


def equi_join_rows(left_rows: float, right_rows: float,
                   pair_ndvs) -> float:
    """Multi-key equi-join output estimate: the cross product divided,
    per key pair, by max(NDV_l, NDV_r) — containment of keys with
    independence across pairs. ``pair_ndvs`` is a sequence of
    (left_ndv, right_ndv); a missing NDV falls back to the side's row
    count (keys assumed distinct — the foreign-key-to-primary-key
    common case). THE estimator the reorderer's step/base-item
    calculations use."""
    out = left_rows * right_rows
    for lndv, rndv in pair_ndvs:
        out /= max(1.0,
                   lndv if lndv is not None else left_rows,
                   rndv if rndv is not None else right_rows)
    return out


def join_output_rows(left_rows: float, right_rows: float,
                     left_ndv: Optional[float],
                     right_ndv: Optional[float]) -> float:
    """Single-key convenience form of :func:`equi_join_rows`."""
    return equi_join_rows(left_rows, right_rows,
                          [(left_ndv, right_ndv)])
