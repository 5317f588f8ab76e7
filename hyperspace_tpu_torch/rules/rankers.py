"""Index rankers (counterpart of ``hyperspace_tpu/rules/rankers.py``).
Filter: the smallest index wins (under Hybrid Scan the one sharing the
most source bytes with the relation), ties broken lexicographically by
name. Join: pairs with equal bucket counts first; among them, under Hybrid
Scan more common source bytes, then more buckets, then the names; unequal
pairs by common bytes, then their input order."""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..index.log_entry import IndexLogEntry
from .rule_utils import common_source_bytes


class FilterIndexRanker:
    @staticmethod
    def rank(session, relation, candidates: List[IndexLogEntry]) -> Optional[IndexLogEntry]:
        if not candidates:
            return None
        if session.hs_conf.hybrid_scan_enabled():
            return min(candidates, key=lambda e: (-common_source_bytes(e, relation), e.name))
        return min(candidates, key=lambda e: (e.index_files_size_in_bytes, e.name))


class JoinIndexRanker:
    @staticmethod
    def rank(session, left_relation, right_relation,
             pairs: List[Tuple[IndexLogEntry, IndexLogEntry]]
             ) -> Optional[Tuple[IndexLogEntry, IndexLogEntry]]:
        if not pairs:
            return None
        hybrid = session.hs_conf.hybrid_scan_enabled()

        def score(pos_pair):
            pos, (left, right) = pos_pair
            common = 0
            if hybrid:
                common = (common_source_bytes(left, left_relation)
                          + common_source_bytes(right, right_relation))
            if left.num_buckets == right.num_buckets:
                return (0, -common, -left.num_buckets, left.name, right.name)
            return (1, -common, pos)

        return min(enumerate(pairs), key=score)[1]
