"""Cost-based join reordering over inner-equi-join chains (counterpart of
``hyperspace_tpu/optimizer/join_order.py``).

The SQL front end lowers a comma-joined FROM list (and chained DataFrame
``.join`` calls) in text order; on a star schema the first join often
makes the largest intermediate there is. This pass runs inside
``Session.optimize`` after filter pushdown and column pruning and before
the index rules, so the rules match the reordered tree as they would the
original.

  * Only chains of INNER joins whose conditions are conjunctions of
    column=column equalities are reordered; other joins are barriers,
    and their subtrees are rewritten on their own.
  * The new chain is left-deep, in the order of least estimated
    intermediate rows: exhaustive left-deep DP up to
    ``JOIN_REORDER_DP_THRESHOLD`` tables (optimizer/constants.py), greedy
    above.
  * A trailing Project restores the original column order, so results
    equal the reorder-off plan's up to row order.
  * A chain with any member whose rows cannot be estimated (no parquet
    footers, an unknown operator) keeps its original order.

Estimates come from optimizer/stats.py and optimizer/cardinality.py. Each
chain leaves a record on ``session._last_join_order``, which explain's
"Join order:" section reads. The pass runs under the
``optimize.join_reorder`` span; a pass that is not diagnostic and changed
an order emits one JoinReorderEvent per reordered chain and one
CardinalityEstimateEvent per step. While ``adaptive.enabled`` is on, each
step's estimate is corrected by what execution taught the adaptive tier
(``_Corrector``, adaptive/feedback.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..exceptions import HyperspaceException
from ..plan import expr as E
from ..plan.nodes import (Aggregate, Filter, Join, Limit, LogicalPlan,
                          Project, Scan, Sort, Union, Window)
from . import cardinality
from .constants import JOIN_REORDER_DP_THRESHOLD
from .stats import provider_for


def _is_chain_join(node: LogicalPlan) -> bool:
    return (isinstance(node, Join) and node.join_type == "inner"
            and node.condition is not None
            and E.extract_equi_join_keys(node.condition) is not None)


def _is_passthrough_project(node: LogicalPlan) -> bool:
    """A pure column-pruning Project directly above a chain join (the
    shape prune_columns interposes between joins): safe to flatten
    through — no renames, no computed columns. The dropped pruning is
    recovered by the trailing Project the rebuild adds (and the
    executor's needed-set propagation never materializes the extras)."""
    return (isinstance(node, Project)
            and all(isinstance(e, E.Col) for e in node.exprs)
            and _is_chain_join(node.child))


def _flatten(node: LogicalPlan, items: List[LogicalPlan],
             conjuncts: List[E.Expr]) -> None:
    if _is_chain_join(node):
        _flatten(node.left, items, conjuncts)
        _flatten(node.right, items, conjuncts)
        conjuncts.extend(E.split_conjunctive_predicates(node.condition))
    elif _is_passthrough_project(node):
        _flatten(node.child, items, conjuncts)
    else:
        items.append(node)


def _item_label(node: LogicalPlan, idx: int) -> str:
    for leaf in node.collect_leaves():
        relation = getattr(leaf, "relation", None)
        if relation is not None and relation.root_paths:
            return os.path.basename(
                relation.root_paths[0].rstrip("/")) or f"item#{idx}"
    return f"{node.node_name.lower()}#{idx}"


# ---------------------------------------------------------------------------
# Per-item cardinality estimation.
# ---------------------------------------------------------------------------

@dataclass
class _Est:
    rows: float
    ndv: Dict[str, Optional[float]] = field(default_factory=dict)


def _estimate_item(session, node: LogicalPlan,
                   needed: frozenset) -> Optional[_Est]:
    """Estimated output rows of ``node`` plus NDV for the ``needed``
    columns, or None when no estimate is possible."""
    provider = provider_for(session)
    if isinstance(node, Scan):
        ts = provider.table_stats(node.relation)
        if ts is None:
            return None
        ndv = {c: ts.ndv(c) for c in needed if c in node.schema}
        return _Est(float(max(ts.row_count, 1)), ndv)
    if isinstance(node, Filter):
        child = _estimate_item(session, node.child, needed)
        if child is None:
            return None
        ts = None
        cap = None
        if isinstance(node.child, Scan):
            ts = provider.table_stats(node.child.relation)
            cap = provider.sketch_row_fraction(node.child.relation,
                                               node.condition)
        sel = cardinality.filter_selectivity(ts, node.condition, cap)
        rows = max(1.0, child.rows * sel)
        return _Est(rows, _cap_ndv(child.ndv, rows))
    if isinstance(node, Project):
        renames = {}
        for e in node.exprs:
            inner = e.child if isinstance(e, E.Alias) else e
            if isinstance(inner, E.Col):
                renames[e.name] = inner.column
        child_needed = frozenset(renames.get(c, c) for c in needed)
        child = _estimate_item(session, node.child, child_needed)
        if child is None:
            return None
        ndv = {c: child.ndv.get(renames.get(c, c)) for c in needed}
        return _Est(child.rows, ndv)
    if isinstance(node, Aggregate):
        groups = frozenset(node.group_cols)
        child = _estimate_item(session, node.child, needed | groups)
        if child is None:
            return None
        if not node.group_cols:
            return _Est(1.0, {c: 1.0 for c in needed})
        rows = 1.0
        for g in node.group_cols:
            nd = child.ndv.get(g)
            rows *= nd if nd is not None else child.rows ** 0.5
        rows = max(1.0, min(rows, child.rows))
        ndv = {c: child.ndv.get(c) for c in needed}
        return _Est(rows, _cap_ndv(ndv, rows))
    if isinstance(node, Limit):
        child = _estimate_item(session, node.child, needed)
        if child is None:
            return None
        rows = max(1.0, min(float(node.n), child.rows))
        return _Est(rows, _cap_ndv(child.ndv, rows))
    if isinstance(node, (Sort, Window)):
        return _estimate_item(session, node.children[0], needed)
    if isinstance(node, Union):
        rows = 0.0
        ndv: Dict[str, Optional[float]] = {c: None for c in needed}
        for c in node.children:
            child = _estimate_item(session, c, needed)
            if child is None:
                return None
            rows += child.rows
        return _Est(max(1.0, rows), ndv)
    if isinstance(node, Join):
        return _estimate_join(session, node, needed)
    return None


def _estimate_join(session, node: Join,
                   needed: frozenset) -> Optional[_Est]:
    keys = E.extract_equi_join_keys(node.condition) \
        if node.condition is not None else []
    key_cols = frozenset(c for pair in (keys or []) for c in pair)
    left = _estimate_item(session, node.left, needed | key_cols)
    right = _estimate_item(session, node.right, needed | key_cols)
    if left is None or right is None:
        return None
    if node.join_type in ("semi", "anti"):
        rows = max(1.0, left.rows * 0.5)
        return _Est(rows, _cap_ndv(left.ndv, rows))
    if node.join_type == "cross":
        rows = left.rows * right.rows
        return _Est(rows, _cap_ndv({**left.ndv, **right.ndv}, rows))
    rows = cardinality.equi_join_rows(
        left.rows, right.rows,
        [(left.ndv.get(a, right.ndv.get(a)),
          right.ndv.get(b, left.ndv.get(b))) for a, b in (keys or [])])
    if node.join_type in ("left", "full"):
        rows = max(rows, left.rows)
    if node.join_type in ("right", "full"):
        rows = max(rows, right.rows)
    rows = max(1.0, rows)
    return _Est(rows, _cap_ndv({**left.ndv, **right.ndv}, rows))


def _cap_ndv(ndv: Dict[str, Optional[float]],
             rows: float) -> Dict[str, Optional[float]]:
    return {c: (None if v is None else max(1.0, min(v, rows)))
            for c, v in ndv.items()}


# ---------------------------------------------------------------------------
# Order enumeration.
# ---------------------------------------------------------------------------

class _Corrector:
    """The adaptive feedback hook (adaptive/feedback.py): scales each
    enumeration step's estimate by its table pair's learned actual/estimate
    ratio, and takes the observed rows of a rebuilt join that ran before.
    Made only while ``adaptive.enabled`` is on; without it the reorderer
    takes ``_NO_CORRECTION`` and the cost model is the uncorrected one.
    Side signatures use the leaf identities the executor keys actuals by
    (serving/context.join_actual_key), so keys made here, before index
    substitution and partition pruning, pair with those of execution."""

    def __init__(self, session, items: List[LogicalPlan]):
        from ..adaptive.feedback import get_store
        from ..serving.context import _leaf_identity
        self._store = get_store()
        self._ids: List[List[str]] = [
            [_leaf_identity(leaf) for leaf in it.collect_leaves()] for it in items]
        self._sig_cache: Dict[frozenset, str] = {}

    def _sig(self, idxs) -> str:
        key = frozenset(idxs)
        s = self._sig_cache.get(key)
        if s is None:
            parts: List[str] = []
            for i in key:
                parts.extend(self._ids[i])
            s = self._sig_cache[key] = "+".join(sorted(parts))
        return s

    def adjust(self, joined, t: int, est: float) -> float:
        return self._store.corrected_rows(self._sig(joined), self._sig([t]), est)

    def exact(self, key: str) -> Optional[float]:
        return self._store.exact_rows(key)


class _NoCorrection:
    """The corrector while adaptive feedback is off: estimates unchanged."""

    def adjust(self, joined, t: int, est: float) -> float:
        return est

    def exact(self, key: str) -> Optional[float]:
        return None


_NO_CORRECTION = _NoCorrection()


def _step(rows: float, ndv: Dict[str, Optional[float]], item: _Est,
          conds: List[Tuple[str, str]]) -> Tuple[float, Dict]:
    """One left-deep join step: current intermediate x ``item`` over the
    equality pairs in ``conds``. Returns (output rows, merged ndvs)."""
    resolved = [(ndv.get(a, item.ndv.get(a)),
                 item.ndv.get(b, ndv.get(b)), a, b) for a, b in conds]
    out = max(1.0, cardinality.equi_join_rows(
        rows, item.rows, [(l, r) for l, r, _, _ in resolved]))
    merged = dict(ndv)
    merged.update(item.ndv)
    for l, r, a, b in resolved:
        merged[a] = merged[b] = min(l if l is not None else rows,
                                    r if r is not None else item.rows)
    return out, _cap_ndv(merged, out)


def _edge_conds(edges, joined: frozenset, t: int) -> List[Tuple[str, str]]:
    out = []
    for a, b, la, lb in edges:
        if a in joined and b == t:
            out.append((la, lb))
        elif b in joined and a == t:
            out.append((lb, la))
    return out


def _enumerate_greedy(ests: List[_Est], edges,
                      corr=_NO_CORRECTION) -> List[int]:
    n = len(ests)
    best_pair = None
    for i in range(n):
        for j in range(i + 1, n):
            conds = _edge_conds(edges, frozenset([i]), j)
            if not conds:
                continue
            rows, _ = _step(ests[i].rows, ests[i].ndv, ests[j], conds)
            rows = corr.adjust([i], j, rows)
            if best_pair is None or rows < best_pair[0]:
                best_pair = (rows, i, j)
    if best_pair is None:
        return list(range(n))
    _, i, j = best_pair
    order = [i, j]
    joined = frozenset(order)
    rows, ndv = _step(ests[i].rows, ests[i].ndv, ests[j],
                      _edge_conds(edges, frozenset([i]), j))
    rows = corr.adjust([i], j, rows)
    while len(order) < n:
        best = None
        for t in range(n):
            if t in joined:
                continue
            conds = _edge_conds(edges, joined, t)
            if not conds:
                continue
            out, nd = _step(rows, ndv, ests[t], conds)
            out = corr.adjust(joined, t, out)
            if best is None or out < best[0]:
                best = (out, t, nd)
        if best is None:
            # Disconnected remainder (cannot happen for a chain that came
            # from a valid join tree): keep the original order.
            return list(range(n))
        rows, ndv = best[0], best[2]
        order.append(best[1])
        joined = joined | {best[1]}
    return order


def _enumerate_dp(ests: List[_Est], edges,
                  corr=_NO_CORRECTION) -> List[int]:
    """Exhaustive left-deep search over connected subsets (Selinger-style
    DP): state per subset keeps the cheapest cumulative intermediate-row
    total. Falls back to greedy on any gap (disconnected subsets)."""
    n = len(ests)
    # subset (frozenset) -> (cost, rows, ndv, order)
    states: Dict[frozenset, Tuple[float, float, Dict, List[int]]] = {}
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            conds = _edge_conds(edges, frozenset([i]), j)
            if not conds:
                continue
            rows, ndv = _step(ests[i].rows, ests[i].ndv, ests[j], conds)
            rows = corr.adjust([i], j, rows)
            key = frozenset((i, j))
            if key not in states or rows < states[key][0]:
                states[key] = (rows, rows, ndv, [i, j])
    for _size in range(2, n):
        additions: Dict[frozenset, Tuple] = {}
        for subset, (cost, rows, ndv, order) in states.items():
            if len(subset) != _size:
                continue
            for t in range(n):
                if t in subset:
                    continue
                conds = _edge_conds(edges, subset, t)
                if not conds:
                    continue
                out, nd = _step(rows, ndv, ests[t], conds)
                out = corr.adjust(subset, t, out)
                key = subset | {t}
                cand = (cost + out, out, nd, order + [t])
                prev = additions.get(key) or states.get(key)
                if prev is None or cand[0] < prev[0]:
                    additions[key] = cand
        states.update(additions)
    full = states.get(frozenset(range(n)))
    if full is None:
        return _enumerate_greedy(ests, edges, corr)
    return full[3]


# ---------------------------------------------------------------------------
# The rewrite.
# ---------------------------------------------------------------------------

def reorder_joins(session, plan: LogicalPlan, diagnostic: bool = False) -> LogicalPlan:
    """Rewrite every eligible inner-equi-join chain of ``plan`` to its
    cheapest estimated linear order. Leaves a list of chain records on
    ``session._last_join_order`` (explain reads it back); a pass that is
    not ``diagnostic`` (explain's) and changed an order emits its events."""
    from ..telemetry import span_names as SN
    from ..telemetry import trace as _trace
    records: List[dict] = []
    with _trace.span(SN.JOIN_REORDER) as sp:
        out = _rewrite(session, plan, records)
        if sp is not None:
            sp.attrs["chains"] = len(records)
            sp.attrs["reordered"] = sum(1 for r in records if r["reordered"])
    session._last_join_order = records
    if not diagnostic and any(r["reordered"] for r in records):
        _emit_events(session, records)
    return out


def _emit_events(session, records: List[dict]) -> None:
    from ..telemetry.events import CardinalityEstimateEvent, JoinReorderEvent
    from ..telemetry.logging import get_logger
    logger = get_logger(session.hs_conf.event_logger_class())
    for r in records:
        if not r["reordered"]:
            continue
        logger.log_event(JoinReorderEvent(
            message="Join chain reordered.", tables=list(r["labels"]),
            order=list(r["order"]), estimated_rows=[s["est_rows"] for s in r["steps"]]))
        for s in r["steps"]:
            logger.log_event(CardinalityEstimateEvent(
                message="Equi-join output estimate.", subject=s["key"],
                estimated_rows=s["est_rows"]))


def _rewrite(session, node: LogicalPlan, records: List[dict]) -> LogicalPlan:
    if _is_chain_join(node):
        items: List[LogicalPlan] = []
        conjuncts: List[E.Expr] = []
        _flatten(node, items, conjuncts)
        new_items = [_rewrite(session, it, records) for it in items]
        mapping = {id(old): new for old, new in zip(items, new_items)}
        if len(new_items) < 3:
            # A 2-table chain has one linear order; nothing to choose.
            return _rebuild_same(node, mapping)
        return _reorder_chain(session, node, new_items, conjuncts,
                              mapping, records)
    new_children = [_rewrite(session, c, records) for c in node.children]
    if all(a is b for a, b in zip(new_children, node.children)):
        return node
    return node.with_children(new_children)


def _rebuild_same(node: LogicalPlan, mapping: Dict[int, LogicalPlan]
                  ) -> LogicalPlan:
    """The original chain structure (interposed pruning Projects
    included) with (possibly rewritten) items substituted back in."""
    if _is_chain_join(node):
        left = _rebuild_same(node.left, mapping)
        right = _rebuild_same(node.right, mapping)
        if left is node.left and right is node.right:
            return node
        return Join(left, right, node.condition, "inner")
    if _is_passthrough_project(node):
        child = _rebuild_same(node.child, mapping)
        if child is node.child:
            return node
        return Project(node.exprs, child)
    return mapping[id(node)]


def _reorder_chain(session, node: Join, items: List[LogicalPlan],
                   conjuncts: List[E.Expr],
                   mapping: Dict[int, LogicalPlan],
                   records: List[dict]) -> LogicalPlan:
    labels = [_item_label(it, i) for i, it in enumerate(items)]
    record = {"labels": labels, "order": labels, "reordered": False,
              "base": [], "steps": []}
    records.append(record)

    owner: Dict[str, int] = {}
    for i, it in enumerate(items):
        for name in it.schema.names:
            if name in owner:
                record["note"] = "ambiguous columns"
                return _rebuild_same(node, mapping)
            owner[name] = i

    # Edges: (item_a, item_b, col_a, col_b) per equality conjunct, plus
    # the original Expr so the rebuilt conditions reuse the user's
    # spelling/orientation.
    edges: List[Tuple[int, int, str, str]] = []
    exprs: Dict[Tuple[int, int, str, str], E.Expr] = {}
    for c in conjuncts:
        la, lb = c.left.column, c.right.column
        a, b = owner.get(la), owner.get(lb)
        if a is None or b is None or a == b:
            record["note"] = "non-cross-table equality"
            return _rebuild_same(node, mapping)
        edges.append((a, b, la, lb))
        exprs[(a, b, la, lb)] = c

    needed = frozenset(la for _, _, la, _ in edges) | \
        frozenset(lb for _, _, _, lb in edges)
    ests: List[Optional[_Est]] = [
        _estimate_item(session, it, needed) for it in items]
    if any(e is None for e in ests):
        record["note"] = "no statistics for at least one table"
        return _rebuild_same(node, mapping)
    record["base"] = [
        {"label": labels[i], "est_rows": ests[i].rows}
        for i in range(len(items))]

    corr = _Corrector(session, items) if session.hs_conf.adaptive_enabled() \
        else _NO_CORRECTION
    if len(items) <= JOIN_REORDER_DP_THRESHOLD:
        order = _enumerate_dp(ests, edges, corr)
    else:
        order = _enumerate_greedy(ests, edges, corr)
    if order == list(range(len(items))):
        record["note"] = "original order already cheapest"
        return _rebuild_same(node, mapping)

    # Rebuild left-deep in the chosen order; each step conjoins every
    # original equality conjunct both of whose sides are now present.
    # Any constructor rejection (e.g. an ambiguity an interposed pruning
    # Project used to resolve) falls back to the original order.
    # Step keys are the join_actual_key strings the executor records
    # actuals under for the Join nodes built here, so explain and the
    # adaptive loops pair each estimate with its actual and never across
    # table pairs.
    from ..serving.context import join_actual_key
    joined = frozenset([order[0]])
    cur = items[order[0]]
    rows, ndv = ests[order[0]].rows, ests[order[0]].ndv
    steps: List[dict] = []
    try:
        for t in order[1:]:
            conds = [exprs[e] for e in edges
                     if (e[0] in joined and e[1] == t)
                     or (e[1] in joined and e[0] == t)]
            if not conds:
                record["note"] = "chosen order lost connectivity"
                return _rebuild_same(node, mapping)
            rows, ndv = _step(rows, ndv, ests[t],
                              _edge_conds(edges, joined, t))
            condition = E.conjoin(conds)
            key = join_actual_key(condition, cur, items[t])
            rows = corr.adjust(joined, t, rows)
            exact = corr.exact(key)
            if exact is not None:
                rows = exact
            cur = Join(cur, items[t], condition, "inner",
                       reorder_note=f"reordered, est~{rows:.0f} rows")
            steps.append({"right": labels[t], "key": key,
                          "est_rows": rows})
            joined = joined | {t}

        original_names = list(node.schema.names)
        if list(cur.schema.names) != original_names:
            cur = Project(original_names, cur)
    except HyperspaceException:
        record["note"] = "rebuild rejected; original order kept"
        record["steps"] = []
        return _rebuild_same(node, mapping)
    record["order"] = [labels[i] for i in order]
    record["reordered"] = True
    record["steps"] = steps
    return cur
