"""The input-byte cost model for plans, real and hypothetical (counterpart
of ``hyperspace_tpu/advisor/cost.py``).

A plan's cost is the bytes its leaves would read: file sizes for a
relation leaf, the index's content size for an IndexScan (a bucketed
join's scan discounted by ``BUCKET_JOIN_DISCOUNT``). A hypothetical entry
carries its predicted size as a synthetic content file
(whatif.build_hypothetical_entry), so one accounting covers both. A leaf
under a Filter is further discounted by the predicate's estimated
selectivity from the statistics layer (optimizer/stats.py and
cardinality.py), never below ``MIN_COST_SELECTIVITY``. The statistics are
always on in this package (the JAX package can turn them off by conf).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..plan.nodes import Filter, IndexScan, LogicalPlan, Scan


def relation_bytes(relation) -> int:
    return sum(size for _, size, _ in relation.all_file_infos())


def predicted_index_size_bytes(relation, n_index_columns: int) -> int:
    """A covering index over ``n_index_columns`` of ``relation``: the
    source's bytes scaled by the covered share of its columns."""
    total = relation_bytes(relation)
    n_cols = max(1, len(relation.schema.names))
    return int(total * min(1.0, n_index_columns / n_cols))


# An IndexScan that serves a bucketed merge join saves the shuffle and
# sort a plain scan would pay: an effective-bytes discount after the rule
# scores' 70:50 join:filter ratio (rules/score_optimizer.py).
BUCKET_JOIN_DISCOUNT = 50.0 / 70.0

# A filter never talks a leaf's cost below this share of its bytes.
MIN_COST_SELECTIVITY = 0.01


SelectivityKey = Tuple[Tuple[str, ...], str]


def _leaf_source_key(leaf: LogicalPlan) -> Optional[Tuple[str, ...]]:
    """A leaf's source identity, which the IndexScan swap keeps: the
    relation's root paths, or those the index's entry recorded."""
    relation = getattr(leaf, "relation", None)
    if relation is not None:
        return tuple(relation.root_paths)
    if isinstance(leaf, IndexScan):
        return tuple(leaf.index_entry.relation.rootPaths)
    return None


def filter_selectivity_map(session, plan: LogicalPlan) -> Dict[SelectivityKey, float]:
    """(source root paths, condition repr) -> estimated selectivity of every
    Filter directly above a Scan leaf. The same map prices the plan before
    and after a rewrite: an IndexScan swap keeps the Filter's condition and
    its entry records the source's root paths."""
    from ..optimizer import cardinality
    from ..optimizer.stats import provider_for
    provider = provider_for(session)
    out: Dict[SelectivityKey, float] = {}

    def walk(node: LogicalPlan) -> None:
        if isinstance(node, Filter) and isinstance(node.child, Scan):
            ts = provider.table_stats(node.child.relation)
            if ts is not None:
                cap = provider.sketch_row_fraction(node.child.relation, node.condition)
                key = (tuple(node.child.relation.root_paths), repr(node.condition))
                out[key] = cardinality.filter_selectivity(ts, node.condition, cap)
        for c in node.children:
            walk(c)

    walk(plan)
    return out


def plan_cost_bytes(plan: LogicalPlan,
                    selectivities: Optional[Dict[SelectivityKey, float]] = None) -> int:
    """The effective input bytes of an optimized (possibly what-if) plan's
    leaves, each discounted by the selectivities of the Filters above it."""
    total = 0

    def leaf_bytes(leaf: LogicalPlan) -> int:
        relation = getattr(leaf, "relation", None)
        if relation is not None:
            return relation_bytes(relation)
        if isinstance(leaf, IndexScan):
            nbytes = leaf.index_entry.index_files_size_in_bytes
            if leaf.use_bucket_spec:
                nbytes = int(nbytes * BUCKET_JOIN_DISCOUNT)
            return nbytes
        return 0

    def walk(node: LogicalPlan, conds) -> None:
        nonlocal total
        if isinstance(node, Filter) and selectivities:
            conds = conds + [repr(node.condition)]
        if not node.children:
            sel = 1.0
            source_key = _leaf_source_key(node) if conds else None
            if source_key is not None:
                for cond_repr in conds:
                    sel *= selectivities.get((source_key, cond_repr), 1.0)
            total += int(leaf_bytes(node) * max(MIN_COST_SELECTIVITY, min(1.0, sel)))
            return
        for c in node.children:
            walk(c, conds)

    walk(plan, [])
    return total
