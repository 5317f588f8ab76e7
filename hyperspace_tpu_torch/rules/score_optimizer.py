"""Score-based index plan optimizer (counterpart of
``hyperspace_tpu/rules/score_optimizer.py``, the JAX package's default).

Each rule proposes a rewrite of a plan node with a score; the optimizer
recurses over the tree (memoized) and keeps, at every node, the larger of
the best rewrite there and the sum of its children's best scores. A
filter rewrite scores 50 and a join rewrite 70 per side, so one join
rewrite (140) beats filter rewrites of both sides (100). The JAX package
scales each by the share of the relation's bytes the index covers, which
is less than 1 only under Hybrid Scan; the port has no Hybrid Scan, so
its candidates cover their relations whole. Equal scores go to the plan
that reads fewer index bytes, then to the first found.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..index.log_entry import IndexLogEntry
from ..plan.nodes import IndexScan, Join, LogicalPlan, Scan
from .filter_rule import try_rewrite_filter
from .index_filters import ReasonCollector
from .join_rule import try_rewrite_join

FILTER_SCORE = 50.0
JOIN_SCORE_PER_SIDE = 70.0


def _plan_index_bytes(plan: LogicalPlan) -> int:
    return sum(leaf.index_entry.index_files_size_in_bytes
               for leaf in plan.collect_leaves() if isinstance(leaf, IndexScan))


class FilterIndexRuleNG:
    def apply(self, session, plan, candidates_for, ctx
              ) -> Tuple[Optional[LogicalPlan], float]:
        result = try_rewrite_filter(session, plan, ctx, candidates_for)
        return (None, 0.0) if result is None else (result[0], FILTER_SCORE)


class JoinIndexRuleNG:
    def apply(self, session, plan, candidates_for, ctx
              ) -> Tuple[Optional[LogicalPlan], float]:
        if not isinstance(plan, Join):
            return None, 0.0
        result = try_rewrite_join(session, plan, ctx, candidates_for)
        return (None, 0.0) if result is None else (result[0], 2 * JOIN_SCORE_PER_SIDE)


class ScoreBasedIndexPlanOptimizer:
    def __init__(self):
        self.rules = [JoinIndexRuleNG(), FilterIndexRuleNG()]

    def apply(self, session, plan: LogicalPlan,
              candidates: Dict[int, Tuple[Scan, List[IndexLogEntry]]],
              ctx: ReasonCollector) -> LogicalPlan:
        def candidates_for(scan: Scan) -> List[IndexLogEntry]:
            found = candidates.get(id(scan))
            return found[1] if found else []

        memo: Dict[int, Tuple[LogicalPlan, float]] = {}

        def rec(node: LogicalPlan) -> Tuple[LogicalPlan, float]:
            cached = memo.get(id(node))
            if cached is not None:
                return cached
            if node.children:
                rec_children = [rec(c) for c in node.children]
                best_plan = node.with_children([p for p, _ in rec_children])
                best_score = sum(s for _, s in rec_children)
            else:
                best_plan, best_score = node, 0.0
            best_bytes = None
            for rule in self.rules:
                rewritten, score = rule.apply(session, node, candidates_for, ctx)
                if rewritten is None:
                    continue
                if score > best_score:
                    best_plan, best_score, best_bytes = rewritten, score, None
                elif score == best_score:
                    if best_bytes is None:
                        best_bytes = _plan_index_bytes(best_plan)
                    rw_bytes = _plan_index_bytes(rewritten)
                    if rw_bytes < best_bytes:
                        best_plan, best_bytes = rewritten, rw_bytes
            memo[id(node)] = (best_plan, best_score)
            return best_plan, best_score

        return rec(plan)[0]
