"""The join rewrite: an inner equi-join over two covering indexes becomes
a shuffle-free bucketed merge join (counterpart of
``hyperspace_tpu/rules/join_rule.py``). Applicability:

  - the join condition is a conjunction of column = column equalities;
  - both sides are linear Scan/Filter/Project chains;
  - every join column comes directly from a base relation, and the
    mapping between left and right join columns is one to one;
  - each side has an index whose indexed columns are exactly the side's
    join columns, in an order that matches the other side's under the
    column mapping, and which covers every column the side references.

Both sides are then rewritten with the bucket spec exposed: buckets of the
same hash and count let the executor merge them without sorting either.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..index.log_entry import IndexLogEntry
from ..plan import expr as E
from ..plan.nodes import Join, LogicalPlan, Scan
from .index_filters import ReasonCollector
from .rankers import JoinIndexRanker
from .rule_utils import (collect_base_references, get_relation, is_plan_linear,
                         output_to_base_mapping, transform_plan_to_use_index)

Candidates = Callable[[Scan], List[IndexLogEntry]]


def _ensure_one_to_one(pairs) -> Optional[Tuple[List[str], List[str]]]:
    """Order-preserving dedup of (l, r) pairs, or None when a left column
    maps to two right columns or the reverse."""
    l_to_r: Dict[str, str] = {}
    r_to_l: Dict[str, str] = {}
    uniq: List[Tuple[str, str]] = []
    for left, right in pairs:
        if l_to_r.get(left, right) != right or r_to_l.get(right, left) != left:
            return None
        if left not in l_to_r:
            uniq.append((left, right))
        l_to_r[left] = right
        r_to_l[right] = left
    return [p[0] for p in uniq], [p[1] for p in uniq]


def _column_mapping(join: Join, pairs) -> Optional[Tuple[List[str], List[str]]]:
    """Pairs normalized to (left columns, right columns), one to one."""
    left_names = set(join.left.schema.names)
    right_names = set(join.right.schema.names)
    sided = []
    for a, b in pairs:
        if a in left_names and b in right_names:
            sided.append((a, b))
        elif b in left_names and a in right_names:
            sided.append((b, a))
        else:
            return None
    return _ensure_one_to_one(sided)


def _usable_indexes(side_plan: LogicalPlan, scan: Scan, join_cols: List[str],
                    ctx: ReasonCollector, candidates_for: Candidates) -> List[IndexLogEntry]:
    """This side's indexes whose indexed columns are exactly the join
    columns (in any order) and which cover every column the side reads,
    all in base-relation names."""
    referenced = collect_base_references(side_plan) | set(join_cols)
    out = []
    for entry in candidates_for(scan):
        if entry.derivedDataset.kind != "CoveringIndex":
            continue
        if sorted(entry.indexed_columns) != sorted(join_cols):
            ctx.add("NOT_ALL_JOIN_COL_INDEXED", entry,
                    f"Indexed columns {list(entry.indexed_columns)} are not exactly the "
                    f"join columns {sorted(join_cols)}.")
            continue
        covered = set(entry.indexed_columns) | set(entry.included_columns)
        if not referenced <= covered:
            ctx.add("MISSING_REQUIRED_COL", entry,
                    f"Index does not cover required columns {sorted(referenced - covered)}.")
            continue
        out.append(entry)
    return out


def try_rewrite_join(session, join: Join, ctx: ReasonCollector,
                     candidates_for: Candidates
                     ) -> Optional[Tuple[LogicalPlan, Tuple[IndexLogEntry, IndexLogEntry]]]:
    """The shuffle-free join rewrite of this Join node: (new plan, (left
    index, right index)) or None. Only an inner join is rewritten, with no
    whyNot reason for the other types, as in the JAX package."""
    if join.join_type != "inner":
        return None
    pairs = E.extract_equi_join_keys(join.condition)
    if not pairs or not (is_plan_linear(join.left) and is_plan_linear(join.right)):
        return None
    l_scan, r_scan = join.left.collect_leaves()[0], join.right.collect_leaves()[0]
    l_rel, r_rel = get_relation(session, l_scan), get_relation(session, r_scan)
    if l_rel is None or r_rel is None:
        return None
    mapping = _column_mapping(join, pairs)
    if mapping is None:
        return None
    # Trace output names to base columns (alias renames keep working; a
    # computed join key disqualifies the side), then re-check one to one.
    l_base = output_to_base_mapping(join.left)
    r_base = output_to_base_mapping(join.right)
    l_cols = [l_base.get(c) for c in mapping[0]]
    r_cols = [r_base.get(c) for c in mapping[1]]
    if None in l_cols or None in r_cols:
        return None
    based = _ensure_one_to_one(zip(l_cols, r_cols))
    if based is None:
        return None
    l_cols, r_cols = based
    l_usable = _usable_indexes(join.left, l_scan, l_cols, ctx, candidates_for)
    r_usable = _usable_indexes(join.right, r_scan, r_cols, ctx, candidates_for)
    if not l_usable or not r_usable:
        return None
    col_map = dict(zip(l_cols, r_cols))
    compatible = [(le, re_) for le in l_usable for re_ in r_usable
                  if list(re_.indexed_columns) == [col_map[c] for c in le.indexed_columns]]
    if not compatible:
        for e in l_usable + r_usable:
            ctx.add("NO_AVAIL_JOIN_INDEX_PAIR", e,
                    "No compatible index pair: indexed-column order does not match the "
                    "other side's under the join-column mapping.")
        return None
    l_entry, r_entry = JoinIndexRanker.rank(session, l_rel, r_rel, compatible)
    for pair in compatible:
        for e in pair:
            if e is not l_entry and e is not r_entry:
                ctx.add("ANOTHER_INDEX_APPLIED", e,
                        f"Pair ('{l_entry.name}', '{r_entry.name}') was ranked higher.")
    new_left = transform_plan_to_use_index(session, l_entry, join.left, use_bucket_spec=True)
    new_right = transform_plan_to_use_index(session, r_entry, join.right,
                                            use_bucket_spec=True)
    return Join(new_left, new_right, join.condition, join.join_type), (l_entry, r_entry)
