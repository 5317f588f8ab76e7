"""Filter pushdown through Project and inner Join (counterpart of
``hyperspace_tpu/rules/pushdown.py``; no filter moves below another join
type, as in the JAX package).

The index rules match ``Scan → Filter (→ Project)`` shapes, so a query
written ``select(...).filter(...)`` -- a Filter above a Project -- is
normalized first: the projection's expressions are substituted into the
predicate and the filter re-parented below the projection,

    Filter(cond, Project(exprs, child))
      → Project(exprs, Filter(subst(cond), child))

recursively, so a filter sinks through any number of projections. The
conjuncts of a filter above an inner join move to the side whose columns
they reference, so a WHERE written above a join prunes each input before
it and the per-side index rules see it. Only inner joins: below an outer
join a conjunct on the null-producing side would drop the rows the join
pads instead of the padded rows, and the JAX package pushes nothing below
semi, anti, outer or cross joins either (plan trees stay equal). Adjacent
filters merge into one node.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..exceptions import HyperspaceException
from ..plan import expr as E
from ..plan.nodes import Filter, Join, LogicalPlan, Project


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
        mapping = {ex.name: ex.child if isinstance(ex, E.Alias) else ex
                   for ex in proj.exprs}
        cond = None if any(isinstance(ex, E.AggExpr) for ex in mapping.values()) \
            else _substitute(plan.condition, mapping)
        if cond is not None:
            return Project(proj.exprs, push_filters(Filter(cond, proj.child)))
    if isinstance(plan, Filter) and isinstance(plan.child, Join) \
            and plan.child.join_type == "inner":
        join = plan.child
        l_names = set(join.left.schema.names)
        r_names = set(join.right.schema.names)
        to_left: List[E.Expr] = []
        to_right: List[E.Expr] = []
        stay: List[E.Expr] = []
        for conj in E.split_conjunctive_predicates(plan.condition):
            refs = set(conj.references)
            if refs and refs <= l_names:
                to_left.append(conj)
            elif refs and refs <= r_names:
                to_right.append(conj)
            else:
                stay.append(conj)
        if to_left or to_right:
            left = push_filters(Filter(E.conjoin(to_left), join.left)) \
                if to_left else join.left
            right = push_filters(Filter(E.conjoin(to_right), join.right)) \
                if to_right else join.right
            out: LogicalPlan = Join(left, right, join.condition, join.join_type)
            return Filter(E.conjoin(stay), out) if stay else out
    if isinstance(plan, Filter) and isinstance(plan.child, Filter):
        inner = plan.child
        return push_filters(Filter(plan.condition & inner.condition, inner.child))
    return plan
