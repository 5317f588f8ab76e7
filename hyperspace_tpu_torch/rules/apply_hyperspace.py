"""The hyperspace rewrite batch (counterpart of
``hyperspace_tpu/rules/apply_hyperspace.py`` with its default, the
score-based optimizer): covering-index candidates are collected once per
plan and the score-based optimizer picks the join and filter rewrites;
then GroupByIndexRule probes an index under unfiltered group-bys over the
Scan leaves left in place; then DataSkippingIndexRule narrows the Scan
leaves left after that.
"""

from __future__ import annotations

from typing import List

from ..index.constants import States
from ..index.log_entry import IndexLogEntry
from ..plan.nodes import LogicalPlan
from .data_skipping_rule import DataSkippingIndexRule
from .groupby_rule import GroupByIndexRule
from .index_filters import CandidateIndexCollector, ReasonCollector
from .score_optimizer import ScoreBasedIndexPlanOptimizer


def active_indexes(session) -> List[IndexLogEntry]:
    return session.index_collection_manager.get_indexes([States.ACTIVE])


def apply_hyperspace(session, plan: LogicalPlan) -> LogicalPlan:
    ctx = ReasonCollector()
    covering = [e for e in active_indexes(session)
                if e.derivedDataset.kind == "CoveringIndex"]
    candidates = CandidateIndexCollector.collect(session, plan, covering, ctx)
    plan = ScoreBasedIndexPlanOptimizer().apply(session, plan, candidates, ctx)
    plan = GroupByIndexRule().apply(session, plan, ctx)
    # Data skipping last: the covering rewrite is the better win when it
    # applies, and skipping only narrows the Scan leaves left in place.
    return DataSkippingIndexRule().apply(session, plan)
