"""The filter rewrite: Scan→Filter(→Project) probes a covering index
(counterpart of ``hyperspace_tpu/rules/filter_rule.py``'s
``try_rewrite_filter``, which the score-based optimizer calls). An index
applies when

  1. its *first* indexed column appears in the filter predicate (the sort
     order within buckets makes that column cheap to probe), and
  2. it covers every column the plan touches (project + filter).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..index.log_entry import IndexLogEntry
from ..plan.nodes import Filter, LogicalPlan, Project, Scan
from .index_filters import ReasonCollector
from .rankers import FilterIndexRanker
from .rule_utils import (collect_filter_project_columns, get_relation,
                         transform_plan_to_use_index)


def _extract_filter_node(plan: LogicalPlan) -> Optional[Scan]:
    """Match Project(Filter(Scan)) / Filter(Scan); returns the scan or None."""
    node = plan.child if isinstance(plan, Project) else plan
    if isinstance(node, Filter) and isinstance(node.child, Scan):
        return node.child
    return None


def try_rewrite_filter(session, plan: LogicalPlan, ctx: ReasonCollector,
                       candidates_for: Callable[[Scan], List[IndexLogEntry]]
                       ) -> Optional[Tuple[LogicalPlan, IndexLogEntry]]:
    """The filter-index rewrite at this plan root: (new plan, applied index)
    or None. ``candidates_for`` gives a scan's candidate indexes."""
    scan = _extract_filter_node(plan)
    relation = None if scan is None else get_relation(session, scan)
    if relation is None:
        return None
    project_cols, filter_cols = collect_filter_project_columns(plan)
    if not filter_cols:
        return None
    needed = set(project_cols) | set(filter_cols)
    candidates = []
    for e in candidates_for(scan):
        if e.derivedDataset.kind != "CoveringIndex":
            continue
        if e.indexed_columns[0] not in filter_cols:
            ctx.add("NO_FIRST_INDEXED_COL_COND", e,
                    f"The first indexed column '{e.indexed_columns[0]}' does not appear "
                    f"in the filter condition columns {sorted(set(filter_cols))}.")
            continue
        missing = needed - (set(e.indexed_columns) | set(e.included_columns))
        if missing:
            ctx.add("MISSING_REQUIRED_COL", e,
                    f"Index does not cover required columns {sorted(missing)}.")
            continue
        candidates.append(e)
    best = FilterIndexRanker.rank(session, relation, candidates)
    if best is None:
        return None
    for e in candidates:
        if e is not best:
            ctx.add("ANOTHER_INDEX_APPLIED", e,
                    f"Another candidate index '{best.name}' was ranked higher.")
    return transform_plan_to_use_index(
        session, best, plan, session.hs_conf.use_bucket_spec_for_filter_rule()), best
