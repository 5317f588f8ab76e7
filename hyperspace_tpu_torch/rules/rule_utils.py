"""Shared rule machinery: candidate selection, plan transformation and
the base-column walk of linear plans (counterpart of the parts of
``hyperspace_tpu/rules/rule_utils.py`` the filter, join and group-by rules
call; no Hybrid Scan).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..index.log_entry import IndexLogEntry
from ..index.signatures import LogicalPlanSignatureProvider
from ..plan import expr as E
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


def get_candidate_indexes(indexes: List[IndexLogEntry], scan: Scan,
                          ctx=None) -> List[IndexLogEntry]:
    """Indexes whose recorded source fingerprint equals the scan's; ``ctx``
    (a ReasonCollector) records why the others were dropped."""
    out = []
    for entry in indexes:
        sig = _plan_signature(entry, scan)
        if sig is not None and sig == entry.signature.signatures[0].value:
            out.append(entry)
        elif ctx is not None:
            ctx.add("SOURCE_DATA_CHANGED", entry,
                    "Source fingerprint mismatch (files were added, removed, or "
                    "modified since the index was built); refresh the index.")
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


def is_plan_linear(plan: LogicalPlan) -> bool:
    """A Scan/Filter/Project chain with single children all the way down."""
    node = plan
    while isinstance(node, (Filter, Project)):
        node = node.child
    return isinstance(node, Scan)


def _walk_base_references(plan: LogicalPlan) -> Optional[Tuple[Dict[str, Optional[str]], Set[str]]]:
    """(output name -> base column, every base column the chain reads) for
    a linear chain, tracing Alias renames level by level. A computed
    output maps to None (it is no base column), but its inputs still count
    as read. None for a plan that is not linear."""
    if isinstance(plan, Scan):
        return {n: n for n in plan.schema.names}, set()
    if not isinstance(plan, (Filter, Project)):
        return None
    walked = _walk_base_references(plan.child)
    if walked is None:
        return None
    mapping, refs = walked
    refs = set(refs)
    exprs = [plan.condition] if isinstance(plan, Filter) else plan.exprs
    for e in exprs:
        refs.update(mapping[r] for r in e.references if mapping.get(r) is not None)
    if isinstance(plan, Filter):
        return mapping, refs
    out: Dict[str, Optional[str]] = {}
    for e in plan.exprs:
        inner = e.child if isinstance(e, E.Alias) else e
        out[e.name] = mapping.get(inner.column) if isinstance(inner, E.Col) else None
    return out, refs


def output_to_base_mapping(plan: LogicalPlan) -> Optional[Dict[str, Optional[str]]]:
    """Output column name -> base relation column through a linear chain."""
    walked = _walk_base_references(plan)
    return None if walked is None else walked[0]


def collect_base_references(plan: LogicalPlan) -> Optional[Set[str]]:
    """Every base column a linear chain reads, plus its direct base
    outputs: the coverage check's input. None for a non-linear plan."""
    walked = _walk_base_references(plan)
    if walked is None:
        return None
    mapping, refs = walked
    return refs | {b for b in mapping.values() if b is not None}
