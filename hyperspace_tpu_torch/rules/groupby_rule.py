"""GroupByIndexRule: an unfiltered group-by over a Scan reads a covering
index whose indexed columns are its grouping keys (counterpart of
``hyperspace_tpu/rules/groupby_rule.py``). The index's bucket order makes
equal key tuples contiguous, so the executor's aggregate skips its sort.
This is the TPC-H Q17 shape: the per-part average over the whole fact
table reads the l_partkey index.
"""

from __future__ import annotations

from typing import Set

from ..plan import expr as E
from ..plan.nodes import Aggregate, Filter, LogicalPlan, Project, Scan
from .index_filters import ReasonCollector
from .rankers import FilterIndexRanker
from .rule_utils import (get_candidate_indexes, get_relation, log_index_usage,
                         transform_plan_to_use_index)


def _scan_level_needed(node: LogicalPlan, needed: Set[str]):
    """(scan, the columns needed at it) below a linear Project/Filter
    chain, or None when the chain ends elsewhere or a Project renames or
    computes a needed column (that would decouple the grouping keys from
    the index's columns)."""
    needed = set(needed)
    while isinstance(node, (Project, Filter)):
        if isinstance(node, Filter):
            needed |= set(node.condition.references)
        else:
            by_name = {e.name: e for e in node.exprs}
            for n in needed:
                e = by_name.get(n)
                inner = e.child if isinstance(e, E.Alias) else e
                if not (isinstance(inner, E.Col) and inner.column == n):
                    return None
        node = node.child
    return (node, needed) if isinstance(node, Scan) else None


class GroupByIndexRule:
    def apply(self, session, plan: LogicalPlan, ctx: ReasonCollector) -> LogicalPlan:
        from .apply_hyperspace import active_indexes
        applied = []

        def rewrite(node: LogicalPlan) -> LogicalPlan:
            if not isinstance(node, Aggregate) or not node.group_cols:
                return node
            top_needed = set(node.group_cols)
            for a in node.aggs:
                top_needed |= set(a.references)
            matched = _scan_level_needed(node.child, top_needed)
            relation = None if matched is None else get_relation(session, matched[0])
            if relation is None:
                return node
            scan, needed = matched
            group_set = set(node.group_cols)
            candidates = []
            for e in get_candidate_indexes(session, active_indexes(session), scan, ctx):
                if e.derivedDataset.kind != "CoveringIndex":
                    continue
                if set(e.indexed_columns) != group_set:
                    ctx.add("NO_GROUPBY_KEY_MATCH", e,
                            f"Indexed columns {e.indexed_columns} do not equal grouping "
                            f"keys {sorted(group_set)}.")
                    continue
                missing = needed - (set(e.indexed_columns) | set(e.included_columns))
                if missing:
                    ctx.add("MISSING_REQUIRED_COL", e,
                            f"Index does not cover required columns {sorted(missing)}.")
                    continue
                candidates.append(e)
            best = FilterIndexRanker.rank(session, relation, candidates)
            if best is None:
                return node
            applied.append(best.name)
            return Aggregate(node.group_cols, node.aggs, transform_plan_to_use_index(
                session, best, node.child, use_bucket_spec=True))

        new_plan = plan.transform_up(rewrite)
        if applied:
            log_index_usage(session, ctx, sorted(set(applied)), new_plan.tree_string(),
                            "Group-by index applied.")
        return new_plan
