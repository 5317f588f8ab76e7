"""Column pruning: narrow each subtree to the columns its ancestors need
(counterpart of ``hyperspace_tpu/rules/column_pruning.py``).

The join rule's coverage check reads the columns a join side references.
Without this pass a side is a bare Scan exposing every source column, and
no covering index covers it. Projects are inserted at the top of join
inputs and below aggregates, so the rules see the true column sets. A
Union or BucketUnion passes the columns required of it to every child; a Window's
subtree is left as it is, as in the JAX package (the executor still reads
only the columns the window and its ancestors use).
"""

from __future__ import annotations

from typing import Optional, Set

from ..plan.nodes import (Aggregate, BucketUnion, Filter, IndexScan, Join, Limit,
                          LogicalPlan, Project, Scan, Sort, Union)


def prune_columns(plan: LogicalPlan, required: Optional[Set[str]] = None) -> LogicalPlan:
    if required is None:
        required = set(plan.schema.names)
    if isinstance(plan, (Scan, IndexScan)):
        return plan
    if isinstance(plan, Project):
        child_req: Set[str] = set()
        for e in plan.exprs:
            child_req.update(e.references)
        return Project(plan.exprs, prune_columns(plan.child, child_req))
    if isinstance(plan, Filter):
        child_req = required | set(plan.condition.references)
        return Filter(plan.condition, prune_columns(plan.child, child_req))
    if isinstance(plan, Aggregate):
        child_req = set(plan.group_cols)
        for a in plan.aggs:
            child_req.update(a.references)
        child = _narrow(prune_columns(plan.child, child_req), child_req)
        return Aggregate(plan.group_cols, plan.aggs, child)
    if isinstance(plan, Sort):
        child_req = required | {c for c, _ in plan.orders}
        return Sort(plan.orders, prune_columns(plan.child, child_req))
    if isinstance(plan, Limit):
        return Limit(plan.n, prune_columns(plan.child, required))
    if isinstance(plan, (Union, BucketUnion)):
        return plan.with_children([prune_columns(c, set(required)) for c in plan.children])
    if isinstance(plan, Join):
        wanted = required | (set(plan.condition.references)
                             if plan.condition is not None else set())
        lreq = wanted & set(plan.left.schema.names)
        rreq = wanted & set(plan.right.schema.names)
        left = _narrow(prune_columns(plan.left, lreq), lreq)
        right = _narrow(prune_columns(plan.right, rreq), rreq)
        return Join(left, right, plan.condition, plan.join_type)
    return plan


def _narrow(plan: LogicalPlan, required: Set[str]) -> LogicalPlan:
    """Insert a Project if the plan outputs more than required."""
    names = plan.schema.names
    keep = [n for n in names if n in required]
    if len(keep) == len(names) or not keep:
        return plan
    if isinstance(plan, Project):
        return Project([e for e in plan.exprs if e.name in required], plan.child)
    return Project(keep, plan)
