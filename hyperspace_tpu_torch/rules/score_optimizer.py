"""Score-based index plan optimizer (counterpart of
``hyperspace_tpu/rules/score_optimizer.py``, the JAX package's default).

Each rule proposes a rewrite of a plan node with a score; the optimizer
recurses over the tree (memoized) and keeps, at every node, the larger of
the best rewrite there and the sum of its children's best scores. A
filter rewrite scores 50 and a join rewrite 70 per side, each times the
share of the relation's current bytes the index covers (below 1 only
under Hybrid Scan), so one join rewrite (up to 140) beats filter rewrites
of both sides (up to 100). Equal scores go to the plan that reads fewer
index bytes, then to the first found.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..index.log_entry import IndexLogEntry
from ..plan.nodes import IndexScan, Join, LogicalPlan, Scan
from .filter_rule import try_rewrite_filter
from .index_filters import ReasonCollector
from .join_rule import try_rewrite_join
from .rule_utils import common_source_bytes, get_relation

FILTER_SCORE = 50.0
JOIN_SCORE_PER_SIDE = 70.0


def _coverage_ratio(entry: IndexLogEntry, relation, cache: dict) -> float:
    """The share of the relation's current bytes the index covers: 1.0 for
    an unchanged source, less under Hybrid Scan with appends. Memoized per
    (entry, relation) for one optimizer pass."""
    key = (entry.name, entry.log_version, id(relation))
    if key not in cache:
        total = sum(size for _, size, _ in relation.all_file_infos())
        cache[key] = 1.0 if total <= 0 else \
            min(1.0, common_source_bytes(entry, relation) / total)
    return cache[key]


def _plan_index_bytes(plan: LogicalPlan) -> int:
    return sum(leaf.index_entry.index_files_size_in_bytes
               for leaf in plan.collect_leaves() if isinstance(leaf, IndexScan))


def _record_outscored(ctx: ReasonCollector, alternatives, best_plan: LogicalPlan,
                      best_score: float) -> None:
    """A whyNot reason for each index used only by a losing alternative
    (else "why was my filter index not used" has no answer when a join
    rewrite won the subtree)."""
    from .apply_hyperspace import applied_index_names
    winners = set(applied_index_names(best_plan))
    for alt_plan, alt_score in alternatives:
        if alt_plan is best_plan:
            continue
        for name in set(applied_index_names(alt_plan)) - winners:
            if alt_score == best_score:
                reason = (f"A rewrite using this index tied the chosen plan's score "
                          f"({best_score:.0f}) and lost the tie-break (fewer index "
                          f"bytes read wins; equal plans keep the first found).")
            else:
                reason = (f"A rewrite using this index scored {alt_score:.0f}, below "
                          f"the chosen plan's {best_score:.0f}.")
            ctx.add_name("OUTSCORED", name, reason)


class FilterIndexRuleNG:
    def apply(self, session, plan, candidates_for, ctx, cache
              ) -> Tuple[Optional[LogicalPlan], float]:
        result = try_rewrite_filter(session, plan, ctx, candidates_for)
        if result is None:
            return None, 0.0
        new_plan, entry = result
        relation = get_relation(session, plan.collect_leaves()[0])
        return new_plan, FILTER_SCORE * _coverage_ratio(entry, relation, cache)


class JoinIndexRuleNG:
    def apply(self, session, plan, candidates_for, ctx, cache
              ) -> Tuple[Optional[LogicalPlan], float]:
        if not isinstance(plan, Join):
            return None, 0.0
        result = try_rewrite_join(session, plan, ctx, candidates_for)
        if result is None:
            return None, 0.0
        new_plan, (l_entry, r_entry) = result
        l_rel = get_relation(session, plan.left.collect_leaves()[0])
        r_rel = get_relation(session, plan.right.collect_leaves()[0])
        return new_plan, (JOIN_SCORE_PER_SIDE * _coverage_ratio(l_entry, l_rel, cache)
                          + JOIN_SCORE_PER_SIDE * _coverage_ratio(r_entry, r_rel, cache))


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
        file_stats_cache: Dict = {}

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
            alternatives = [(best_plan, best_score)]
            best_bytes = None
            for rule in self.rules:
                rewritten, score = rule.apply(session, node, candidates_for, ctx,
                                              file_stats_cache)
                if rewritten is None:
                    continue
                alternatives.append((rewritten, score))
                if score > best_score:
                    best_plan, best_score, best_bytes = rewritten, score, None
                elif score == best_score:
                    if best_bytes is None:
                        best_bytes = _plan_index_bytes(best_plan)
                    rw_bytes = _plan_index_bytes(rewritten)
                    if rw_bytes < best_bytes:
                        best_plan, best_bytes = rewritten, rw_bytes
            if ctx.enabled and len(alternatives) > 1:
                _record_outscored(ctx, alternatives, best_plan, best_score)
            memo[id(node)] = (best_plan, best_score)
            return best_plan, best_score

        return rec(plan)[0]
