"""Index rankers (counterpart of ``hyperspace_tpu/rules/rankers.py``,
without Hybrid Scan). Filter: the smallest index wins, ties broken
lexicographically by name. Join: pairs with equal bucket counts first,
more buckets first among them, then the names; unequal pairs keep their
input order."""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..index.log_entry import IndexLogEntry


class FilterIndexRanker:
    @staticmethod
    def rank(candidates: List[IndexLogEntry]) -> Optional[IndexLogEntry]:
        if not candidates:
            return None
        return min(candidates, key=lambda e: (e.index_files_size_in_bytes, e.name))


class JoinIndexRanker:
    @staticmethod
    def rank(pairs: List[Tuple[IndexLogEntry, IndexLogEntry]]
             ) -> Optional[Tuple[IndexLogEntry, IndexLogEntry]]:
        if not pairs:
            return None

        def score(pos_pair):
            pos, (left, right) = pos_pair
            if left.num_buckets == right.num_buckets:
                return (0, -left.num_buckets, left.name, right.name)
            return (1, pos)

        return min(enumerate(pairs), key=score)[1]
