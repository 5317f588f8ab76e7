"""Candidate selection for the score-based optimizer and whyNot reason
tagging (counterpart of ``hyperspace_tpu/rules/index_filters.py``: the
reason collector and ``CandidateIndexCollector``). Each rewrite pass
records why an index was passed over into a ``ReasonCollector``;
``Hyperspace.why_not`` renders one.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

from ..index.log_entry import IndexLogEntry
from ..plan.nodes import LogicalPlan, Scan
from .rule_utils import get_candidate_indexes


class FilterReason(NamedTuple):
    """Why one index was filtered out of a rewrite."""

    code: str
    index_name: str
    message: str

    def __str__(self) -> str:
        return f"[{self.index_name}] {self.code}: {self.message}"


class ReasonCollector:
    """The FilterReasons of one rewrite pass, each recorded once.
    ``enabled`` gates building them (why_not builds them, a query's own
    pass does not); ``silent`` marks a diagnostic pass
    (explain, why_not), which counts no index usage. ``applied`` lists the
    indexes the final plan uses."""

    def __init__(self, enabled: bool = True, silent: bool = False):
        self.enabled = enabled
        self.silent = silent
        self.reasons: List[FilterReason] = []
        self.applied: List[str] = []

    def add(self, code: str, entry: IndexLogEntry, message: str) -> None:
        self.add_name(code, entry.name, message)

    def add_name(self, code: str, index_name: str, message: str) -> None:
        if self.enabled:
            reason = FilterReason(code, index_name, message)
            # The optimizer scores overlapping patterns (Filter(Scan) and
            # Project(Filter(Scan))): each reason is recorded once.
            if reason not in self.reasons:
                self.reasons.append(reason)

    def for_index(self, index_name: str) -> List[FilterReason]:
        return [r for r in self.reasons if r.index_name == index_name]

    def format(self, index_name: Optional[str] = None) -> str:
        applied = sorted(set(self.applied))
        if index_name is not None:
            if index_name in applied:
                return f"Index '{index_name}' was applied."
            rows = self.for_index(index_name)
            if not rows:
                return f"No reasons recorded for index '{index_name}'."
            return "\n".join(str(r) for r in rows)
        # Exploratory scoring can record reasons for an index the chosen
        # plan uses after all; those are not reported.
        lines = [str(r) for r in self.reasons if r.index_name not in applied]
        if applied:
            lines.append("Applied indexes: " + ", ".join(applied))
        return "\n".join(lines) if lines else "No reason recorded."


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
