"""Shared rule machinery: candidate selection, plan transformation and
the base-column walk of linear plans (counterpart of
``hyperspace_tpu/rules/rule_utils.py``).

A scan of a versioned source at an older version first swaps in the
index log version built closest to it (``resolve_time_travel_entry``).
Without Hybrid Scan an index applies when its recorded source fingerprint
equals the scan's. With it, an index applies while its source shares files
with the scan and the appended and deleted bytes stay within their
thresholds (deletes only with lineage); the rewritten IndexScan then
carries the appended files and the deleted files' lineage ids.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..index.constants import IndexConstants, States
from ..index.log_entry import FileInfo, IndexLogEntry
from ..index.signatures import LogicalPlanSignatureProvider
from ..plan import expr as E
from ..plan.nodes import Filter, IndexScan, LogicalPlan, Project, Scan
from ..schema import Schema


def log_index_usage(session, ctx, index_names: List[str], plan_string: str,
                    message: str) -> None:
    """Add one to the session's usage count of each index and emit a
    HyperspaceIndexUsageEvent, unless ``ctx`` is a silent (diagnostic)
    pass: the one place that keeps explain and why_not from counting."""
    if ctx.silent:
        return
    with session._usage_counts_lock:
        counts = session._index_usage_counts
        for name in index_names:
            counts[name] = counts.get(name, 0) + 1
    from ..telemetry.events import HyperspaceIndexUsageEvent
    from ..telemetry.logging import log_event
    log_event(session, HyperspaceIndexUsageEvent(
        index_names=index_names, plan_string=plan_string, message=message))


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


def _current_file_infos(relation) -> List[FileInfo]:
    return [FileInfo(p, size, mtime) for p, size, mtime in relation.all_file_infos()]


def resolve_time_travel_entry(session, entry: IndexLogEntry, relation) -> IndexLogEntry:
    """For a versioned source (delta), the ACTIVE log version of ``entry``
    built closest to the scanned table version; other relations, and a
    scan the latest entry covers, keep ``entry``. History pairs are keyed
    by op-log id, the id an action's final commit was written at."""
    closest_fn = getattr(relation, "closest_index_log_version", None)
    if closest_fn is None:
        return entry
    target = closest_fn(entry.derivedDataset.properties)
    if target is None or target == entry.id:
        return entry
    older = session.index_collection_manager.log_manager_for(entry.name).get_log(target)
    if older is not None and older.state == States.ACTIVE:
        return older
    return entry


def get_candidate_indexes(session, indexes: List[IndexLogEntry], scan: Scan,
                          ctx=None) -> List[IndexLogEntry]:
    """Indexes applicable to this scan: equal fingerprints, or with Hybrid
    Scan on, bounded file overlap. ``ctx`` (a ReasonCollector) records why
    the others were dropped."""
    hybrid = session.hs_conf.hybrid_scan_enabled()
    out = []
    for entry in indexes:
        entry = resolve_time_travel_entry(session, entry, scan.relation)
        if not hybrid:
            sig = _plan_signature(entry, scan)
            if sig is not None and sig == entry.signature.signatures[0].value:
                out.append(entry)
            elif ctx is not None:
                ctx.add("SOURCE_DATA_CHANGED", entry,
                        "Source fingerprint mismatch (files were added, removed, or "
                        "modified since the index was built); enable hybrid scan or "
                        "refresh the index.")
            continue
        ok, appended, deleted = hybrid_scan_file_diff(session, entry, scan.relation)
        if ok:
            out.append(entry)
        elif ctx is not None:
            ctx.add("SOURCE_DATA_CHANGED", entry,
                    f"Hybrid Scan not applicable: {len(appended)} appended"
                    f" / {len(deleted)} deleted files exceed thresholds, "
                    "no common files, or deletes without lineage.")
    return out


def hybrid_scan_file_diff(session, entry: IndexLogEntry, relation
                          ) -> Tuple[bool, List[FileInfo], List[FileInfo]]:
    """(applicable?, appended files, deleted files) under the Hybrid Scan
    rules: some common file, deletes only with lineage, and appended and
    deleted bytes each within their ratio of the common bytes plus their
    own."""
    current = set(_current_file_infos(relation))
    logged = entry.source_file_info_set
    common = current & logged
    if not common:
        return False, [], []
    appended = sorted(current - logged, key=lambda f: f.name)
    deleted = sorted(logged - common, key=lambda f: f.name)
    if deleted and not entry.has_lineage_column():
        return False, [], []
    common_bytes = sum(f.size for f in common)
    appended_bytes = sum(f.size for f in appended)
    deleted_bytes = sum(f.size for f in deleted)
    appended_ratio = appended_bytes / (appended_bytes + common_bytes) if appended_bytes else 0.0
    deleted_ratio = deleted_bytes / (deleted_bytes + common_bytes) if deleted_bytes else 0.0
    if appended_ratio > session.hs_conf.hybrid_scan_appended_ratio_threshold():
        return False, [], []
    if deleted_ratio > session.hs_conf.hybrid_scan_deleted_ratio_threshold():
        return False, [], []
    return True, appended, deleted


def common_source_bytes(entry: IndexLogEntry, relation) -> int:
    current = set(_current_file_infos(relation))
    return sum(f.size for f in (current & entry.source_file_info_set))


def index_scan_schema(entry: IndexLogEntry, like: Schema) -> Schema:
    """The index schema exposed to the plan, its columns ordered as in
    ``like`` (the replaced Scan's): the rewrite changes the plan's physical
    source, never its output columns. The lineage column is hidden."""
    inner = set(entry.schema.names)
    ordered = [n for n in like.names if n in inner]
    ordered += [n for n in entry.schema.names if n not in set(ordered)]
    return entry.schema.select([n for n in ordered if n != IndexConstants.DATA_FILE_NAME_ID])


def transform_plan_to_use_index(session, entry: IndexLogEntry, plan: LogicalPlan,
                                use_bucket_spec: bool) -> LogicalPlan:
    """Replace the plan's Scan leaf with an IndexScan over ``entry``: an
    index-only scan when the source is unchanged, else (Hybrid Scan) one
    that also reads the appended files and drops the deleted files' rows."""

    def replace(node: LogicalPlan) -> LogicalPlan:
        if not isinstance(node, Scan):
            return node
        appended_paths: List[str] = []
        deleted_ids: List[int] = []
        if session.hs_conf.hybrid_scan_enabled():
            ok, appended, deleted = hybrid_scan_file_diff(session, entry, node.relation)
            if ok:
                appended_paths = [f.name for f in appended]
                if deleted:
                    by_key = {(f.name, f.size, f.modifiedTime): f.id
                              for f in entry.source_file_info_set}
                    deleted_ids = [by_key[(f.name, f.size, f.modifiedTime)] for f in deleted]
        return IndexScan(entry, index_scan_schema(entry, node.schema),
                         use_bucket_spec=use_bucket_spec, deleted_file_ids=deleted_ids,
                         appended_files=appended_paths, source_relation=node.relation)

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
