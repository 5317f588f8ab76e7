"""Shared rule machinery: candidate selection + plan transformation
(counterpart of the parts of ``hyperspace_tpu/rules/rule_utils.py`` the
filter rule calls; no Hybrid Scan).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..index.log_entry import IndexLogEntry
from ..index.signatures import LogicalPlanSignatureProvider
from ..plan.nodes import Filter, IndexScan, LogicalPlan, Project, Scan
from ..schema import Schema


def get_relation(session, plan: LogicalPlan):
    """The single supported file-based relation leaf of a linear plan, or
    None (exactly one relation is required)."""
    leaves = plan.collect_leaves()
    if len(leaves) != 1 or not isinstance(leaves[0], Scan):
        return None
    if not session.source_provider_manager.is_supported_relation(leaves[0]):
        return None
    return leaves[0].relation


def _plan_signature(entry: IndexLogEntry, scan: Scan) -> Optional[str]:
    recorded = entry.signature.signatures
    if not recorded:
        return None
    return LogicalPlanSignatureProvider.create(recorded[0].provider).signature(scan)


def get_candidate_indexes(indexes: List[IndexLogEntry], scan: Scan) -> List[IndexLogEntry]:
    """Indexes whose recorded source fingerprint equals the scan's."""
    out = []
    for entry in indexes:
        sig = _plan_signature(entry, scan)
        if sig is not None and sig == entry.signature.signatures[0].value:
            out.append(entry)
    return out


def index_scan_schema(entry: IndexLogEntry, like: Schema) -> Schema:
    """The index schema exposed to the plan, its columns ordered as in
    ``like`` (the replaced Scan's): the rewrite changes the plan's physical
    source, never its output column order."""
    inner = set(entry.schema.names)
    ordered = [n for n in like.names if n in inner]
    ordered += [n for n in entry.schema.names if n not in set(ordered)]
    return entry.schema.select(ordered)


def transform_plan_to_use_index(entry: IndexLogEntry, plan: LogicalPlan,
                                use_bucket_spec: bool) -> LogicalPlan:
    """Replace the plan's Scan leaf with an IndexScan over ``entry``."""

    def replace(node: LogicalPlan) -> LogicalPlan:
        if isinstance(node, Scan):
            return IndexScan(entry, index_scan_schema(entry, node.schema),
                             use_bucket_spec=use_bucket_spec)
        return node

    return plan.transform_up(replace)


def collect_filter_project_columns(plan: LogicalPlan) -> Tuple[List[str], List[str]]:
    """(project/output columns, filter columns) referenced by a linear plan."""
    project_cols: List[str] = []
    filter_cols: List[str] = []
    node = plan
    saw_project = False
    while not isinstance(node, Scan):
        if isinstance(node, Project):
            if not saw_project:
                for e in node.exprs:
                    project_cols.extend(e.references)
                saw_project = True
        elif isinstance(node, Filter):
            filter_cols.extend(node.condition.references)
        node = node.children[0]
    if not saw_project:
        project_cols = list(plan.schema.names)
    return project_cols, filter_cols
