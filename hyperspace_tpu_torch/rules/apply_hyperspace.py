"""The hyperspace rewrite batch (counterpart of
``hyperspace_tpu/rules/apply_hyperspace.py`` with its default, the
score-based optimizer): covering-index candidates are collected once per
plan and the score-based optimizer picks the join and filter rewrites;
then GroupByIndexRule probes an index under unfiltered group-bys over the
Scan leaves left in place; then DataSkippingIndexRule narrows the Scan
leaves left after that. Each real pass adds one to the session's usage
count of every index its plan applies, and emits one
HyperspaceIndexUsageEvent; a silent pass does neither. The pass runs under
the ``rewrite.index_rules`` span, whose ``applied`` attribute counts the
IndexScans of its plan.
"""

from __future__ import annotations

from typing import List, Optional

from ..index.constants import States
from ..index.log_entry import IndexLogEntry
from ..plan.nodes import IndexScan, LogicalPlan
from ..telemetry import span_names as SN
from ..telemetry import trace as _trace
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
    with _trace.span(SN.INDEX_REWRITE) as sp:
        plan = _apply_hyperspace(session, plan, ctx)
        if sp is not None:
            sp.attrs["applied"] = len(applied_index_names(plan))
        return plan


def _apply_hyperspace(session, plan: LogicalPlan,
                      ctx: Optional[ReasonCollector]) -> LogicalPlan:
    if ctx is None:
        ctx = ReasonCollector(enabled=False)
    covering = [e for e in active_indexes(session)
                if e.derivedDataset.kind == "CoveringIndex"]
    candidates = CandidateIndexCollector.collect(session, plan, covering, ctx)
    plan = ScoreBasedIndexPlanOptimizer().apply(session, plan, candidates, ctx)
    # The final plan's indexes, not every rewrite scored on the way.
    ctx.applied = applied_index_names(plan)
    if ctx.applied:
        log_index_usage(session, ctx, sorted(set(ctx.applied)), plan.tree_string(),
                        "Hyperspace indexes applied.")
    plan = GroupByIndexRule().apply(session, plan, ctx)
    ctx.applied = applied_index_names(plan)
    # Data skipping last: the covering rewrite is the better win when it
    # applies, and skipping only narrows the Scan leaves left in place.
    plan = DataSkippingIndexRule().apply(session, plan, ctx)
    if not ctx.silent:
        # The advisor's capture reads this pass's applied names.
        session._last_reason_collector = ctx
    return plan
