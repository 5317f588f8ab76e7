"""Candidate selection for the score-based optimizer (counterpart of
``hyperspace_tpu/rules/index_filters.py``: the reason collector, trimmed to
what the rules record, and ``CandidateIndexCollector``; there is no whyNot
API, so the reasons are kept only for the caller of one rewrite pass).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..index.log_entry import IndexLogEntry
from ..plan.nodes import LogicalPlan, Scan
from .rule_utils import get_candidate_indexes


class ReasonCollector:
    """Why each index was passed over during one rewrite pass, as
    (code, index name, message) triples, each recorded once."""

    def __init__(self):
        self.reasons: List[Tuple[str, str, str]] = []

    def add(self, code: str, entry: IndexLogEntry, message: str) -> None:
        self.add_name(code, entry.name, message)

    def add_name(self, code: str, index_name: str, message: str) -> None:
        reason = (code, index_name, message)
        if reason not in self.reasons:
            self.reasons.append(reason)


class CandidateIndexCollector:
    """Per supported Scan leaf, the indexes whose indexed and included
    columns all exist in the relation's schema and whose recorded source
    matches the relation's: exactly, or within the Hybrid Scan thresholds
    when it is on (the JAX package's ColumnSchemaFilter and
    FileSignatureFilter)."""

    @staticmethod
    def collect(session, plan: LogicalPlan, indexes: List[IndexLogEntry],
                ctx: ReasonCollector) -> Dict[int, Tuple[Scan, List[IndexLogEntry]]]:
        """Map of id(scan leaf) -> (scan, surviving candidate indexes)."""
        out: Dict[int, Tuple[Scan, List[IndexLogEntry]]] = {}
        for leaf in plan.collect_leaves():
            if not isinstance(leaf, Scan) \
                    or not session.source_provider_manager.is_supported_relation(leaf):
                continue
            available = {n.lower() for n in leaf.relation.schema.names}
            remaining = []
            for entry in indexes:
                missing = [c for c in list(entry.indexed_columns) + list(entry.included_columns)
                           if c.lower() not in available]
                if missing:
                    ctx.add("COL_SCHEMA_MISMATCH", entry,
                            f"Index columns {missing} not found in source schema "
                            f"{sorted(leaf.relation.schema.names)}.")
                else:
                    remaining.append(entry)
            remaining = get_candidate_indexes(session, remaining, leaf, ctx)
            if remaining:
                out[id(leaf)] = (leaf, remaining)
        return out
