"""FilterIndexRule: rewrite Scan→Filter(→Project) to probe a covering index
(counterpart of ``hyperspace_tpu/rules/filter_rule.py``, without whyNot
reason collection). An index applies when

  1. its *first* indexed column appears in the filter predicate (the sort
     order within buckets makes that column cheap to probe), and
  2. it covers every column the plan touches (project + filter).
"""

from __future__ import annotations

from ..index.constants import States
from ..plan.nodes import Filter, LogicalPlan, Project, Scan
from .rankers import FilterIndexRanker
from .rule_utils import (collect_filter_project_columns, get_candidate_indexes,
                         get_relation, transform_plan_to_use_index)


def _extract_filter_node(plan: LogicalPlan):
    """Match Project(Filter(Scan)) / Filter(Scan); returns the scan or None."""
    node = plan.child if isinstance(plan, Project) else plan
    if isinstance(node, Filter) and isinstance(node.child, Scan):
        return node.child
    return None


class FilterIndexRule:
    def apply(self, session, plan: LogicalPlan) -> LogicalPlan:
        scan = _extract_filter_node(plan)
        if scan is None or get_relation(session, scan) is None:
            return plan
        project_cols, filter_cols = collect_filter_project_columns(plan)
        if not filter_cols:
            return plan
        active = session.index_collection_manager.get_indexes([States.ACTIVE])
        needed = set(project_cols) | set(filter_cols)
        candidates = [
            e for e in get_candidate_indexes(active, scan)
            if e.derivedDataset.kind == "CoveringIndex"
            and e.indexed_columns[0] in filter_cols
            and not needed - (set(e.indexed_columns) | set(e.included_columns))]
        best = FilterIndexRanker.rank(candidates)
        if best is None:
            return plan
        return transform_plan_to_use_index(
            best, plan, session.hs_conf.use_bucket_spec_for_filter_rule())
