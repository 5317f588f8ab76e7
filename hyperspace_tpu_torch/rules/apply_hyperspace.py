"""The hyperspace rewrite batch (counterpart of
``hyperspace_tpu/rules/apply_hyperspace.py`` with its default, the
score-based optimizer): covering-index candidates are collected once per
plan and the score-based optimizer picks the join and filter rewrites;
then GroupByIndexRule probes an index under unfiltered group-bys over the
Scan leaves left in place; then DataSkippingIndexRule narrows the Scan
leaves left after that. Each real pass adds one to the session's usage
count of every index its plan applies; a silent pass adds none.
"""

from __future__ import annotations

from typing import List, Optional

from ..index.constants import States
from ..index.log_entry import IndexLogEntry
from ..plan.nodes import IndexScan, LogicalPlan
from .data_skipping_rule import DataSkippingIndexRule
from .groupby_rule import GroupByIndexRule
from .index_filters import CandidateIndexCollector, ReasonCollector
from .rule_utils import log_index_usage
from .score_optimizer import ScoreBasedIndexPlanOptimizer


def active_indexes(session) -> List[IndexLogEntry]:
    """ACTIVE indexes from the session's caching index manager."""
    return session.index_collection_manager.get_indexes([States.ACTIVE])


def applied_index_names(plan: LogicalPlan) -> List[str]:
    return [leaf.index_entry.name for leaf in plan.collect_leaves()
            if isinstance(leaf, IndexScan)]


def apply_hyperspace(session, plan: LogicalPlan,
                     ctx: Optional[ReasonCollector] = None) -> LogicalPlan:
    """One rewrite pass. ``ctx`` collects the whyNot reasons; a query's
    own pass (no ``ctx``) builds none, as nothing reads them."""
    if ctx is None:
        ctx = ReasonCollector(enabled=False)
    covering = [e for e in active_indexes(session)
                if e.derivedDataset.kind == "CoveringIndex"]
    candidates = CandidateIndexCollector.collect(session, plan, covering, ctx)
    plan = ScoreBasedIndexPlanOptimizer().apply(session, plan, candidates, ctx)
    # The final plan's indexes, not every rewrite scored on the way.
    ctx.applied = applied_index_names(plan)
    if ctx.applied:
        log_index_usage(session, ctx, sorted(set(ctx.applied)))
    plan = GroupByIndexRule().apply(session, plan, ctx)
    ctx.applied = applied_index_names(plan)
    # Data skipping last: the covering rewrite is the better win when it
    # applies, and skipping only narrows the Scan leaves left in place.
    return DataSkippingIndexRule().apply(session, plan, ctx)
