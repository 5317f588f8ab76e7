"""Filter pushdown through Project (counterpart of
``hyperspace_tpu/rules/pushdown.py``, without the join case).

The index rules match ``Scan → Filter (→ Project)`` shapes, so a query
written ``select(...).filter(...)`` -- a Filter above a Project -- is
normalized first: the projection's expressions are substituted into the
predicate and the filter re-parented below the projection,

    Filter(cond, Project(exprs, child))
      → Project(exprs, Filter(subst(cond), child))

recursively, so a filter sinks through any number of projections.
Adjacent filters merge into one node.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..exceptions import HyperspaceException
from ..plan import expr as E
from ..plan.nodes import Filter, LogicalPlan, Project


def _substitute(e: E.Expr, mapping: Dict[str, E.Expr]) -> Optional[E.Expr]:
    """``e`` with every Col reference replaced by the projection expression
    that produces it, or None when an expression kind can't be rebuilt."""

    def rec(node: E.Expr) -> E.Expr:
        if isinstance(node, E.Col):
            return mapping.get(node.column, node)
        return E.map_children(node, rec)

    try:
        return rec(e)
    except HyperspaceException:
        return None


def push_filters(plan: LogicalPlan) -> LogicalPlan:
    children = plan.children
    if children:
        plan = plan.with_children([push_filters(c) for c in children])
    if isinstance(plan, Filter) and isinstance(plan.child, Project):
        proj = plan.child
        cond = _substitute(plan.condition, {ex.name: ex for ex in proj.exprs})
        if cond is not None:
            return Project(proj.exprs, push_filters(Filter(cond, proj.child)))
    if isinstance(plan, Filter) and isinstance(plan.child, Filter):
        inner = plan.child
        return push_filters(Filter(plan.condition & inner.condition, inner.child))
    return plan
