"""Index rankers (counterpart of ``hyperspace_tpu/rules/rankers.py``,
filter ranker without Hybrid Scan): the smallest index wins, ties broken
lexicographically by name."""

from __future__ import annotations

from typing import List, Optional

from ..index.log_entry import IndexLogEntry


class FilterIndexRanker:
    @staticmethod
    def rank(candidates: List[IndexLogEntry]) -> Optional[IndexLogEntry]:
        if not candidates:
            return None
        return min(candidates, key=lambda e: (e.index_files_size_in_bytes, e.name))
