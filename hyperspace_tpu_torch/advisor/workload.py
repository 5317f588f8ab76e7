"""Workload capture: one record per executed plan (counterpart of
``hyperspace_tpu/advisor/workload.py``).

``Session.execute`` calls :func:`capture_execution` while
``hyperspace.tpu.advisor.capture.enabled`` is on, after the result is
back, so a record carries the latency of whatever path ran (rewritten,
cached or plain). The captured plan is the normalized one the serving
fingerprint uses (serving/fingerprint.normalize): syntactic variants of
one query share a fingerprint, and the what-if planner can optimize the
same tree again later.

Shapes come from the rules' own matchers (linear chains, equi-join keys,
base-column translation), so the candidate generator proposes exactly
what the rules could use.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..plan import expr as E
from ..plan.nodes import Filter, Join, LogicalPlan, Project, Scan


@dataclass(frozen=True)
class ScanShape:
    """The columns one linear Scan/Filter/Project chain touches, by role.
    ``equality_cols`` and ``range_cols`` classify its literal-compare
    conjuncts (the sketch-kind decision); every name is the relation's."""

    root_paths: Tuple[str, ...]
    file_format: str
    project_cols: Tuple[str, ...]
    filter_cols: Tuple[str, ...]
    equality_cols: Tuple[str, ...]
    range_cols: Tuple[str, ...]


@dataclass(frozen=True)
class JoinSideShape:
    root_paths: Tuple[str, ...]
    file_format: str
    join_cols: Tuple[str, ...]        # base names, in join order
    referenced_cols: Tuple[str, ...]  # base names, the whole read set


@dataclass(frozen=True)
class JoinShape:
    """One equi-join the join rule could rewrite: both sides linear, the
    keys one to one and translated to base columns."""

    left: JoinSideShape
    right: JoinSideShape


@dataclass
class WorkloadRecord:
    fingerprint: Optional[str]
    plan: LogicalPlan                 # normalized; kept in the session only
    scan_shapes: Tuple[ScanShape, ...]
    join_shapes: Tuple[JoinShape, ...]
    latency_s: float
    applied_indexes: Tuple[str, ...]
    rules_fired: Tuple[str, ...]


class WorkloadLog:
    """A bounded, locked list of records (the serving workers capture
    concurrently). The oldest records drop first at the bound."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: List[WorkloadRecord] = []
        self.dropped = 0

    def add(self, record: WorkloadRecord, max_entries: int) -> None:
        with self._lock:
            self._records.append(record)
            while max_entries > 0 and len(self._records) > max_entries:
                self._records.pop(0)
                self.dropped += 1

    def snapshot(self) -> List[WorkloadRecord]:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def to_rows(self) -> List[dict]:
        with self._lock:
            return [{
                "fingerprint": r.fingerprint,
                "tables": [",".join(s.root_paths) for s in r.scan_shapes],
                "latency_s": r.latency_s,
                "appliedIndexes": list(r.applied_indexes),
                "rulesFired": list(r.rules_fired),
            } for r in self._records]


def log_for(session) -> WorkloadLog:
    """The session's workload log (made in Session.__init__, so concurrent
    captures share one)."""
    return session._workload_log


# Shape extraction.

def _iter_nodes(plan: LogicalPlan):
    yield plan
    for c in plan.children:
        yield from _iter_nodes(c)


def _classify_conjunct(conjunct: E.Expr):
    """("equality" | "range", column) for a literal-compare conjunct the
    sketch probes can evaluate, else None."""
    if isinstance(conjunct, E.In) and isinstance(conjunct.value, E.Col) \
            and all(isinstance(o, E.Lit) for o in conjunct.options):
        return "equality", conjunct.value.column
    if isinstance(conjunct, (E.EqualTo, E.LessThan, E.LessThanOrEqual,
                             E.GreaterThan, E.GreaterThanOrEqual)):
        left, right = conjunct.left, conjunct.right
        if isinstance(left, E.Lit) and isinstance(right, E.Col):
            left, right = right, left
        if isinstance(left, E.Col) and isinstance(right, E.Lit):
            kind = "equality" if isinstance(conjunct, E.EqualTo) else "range"
            return kind, left.column
    return None


def _chain_scan_shape(session, root: LogicalPlan) -> Optional[ScanShape]:
    from ..rules.rule_utils import collect_filter_project_columns, get_relation
    leaves = root.collect_leaves()
    relation = get_relation(session, leaves[0]) if leaves else None
    if relation is None:
        return None
    project_cols, filter_cols = collect_filter_project_columns(root)
    schema_names = set(relation.schema.names)
    equality, rng = [], []
    node = root
    while not isinstance(node, Scan):
        if isinstance(node, Filter):
            for conj in E.split_conjunctive_predicates(node.condition):
                classified = _classify_conjunct(conj)
                if classified is not None and classified[1] in schema_names:
                    (equality if classified[0] == "equality" else rng).append(classified[1])
        node = node.children[0]

    def clean(cols) -> Tuple[str, ...]:
        return tuple(sorted({c for c in cols if c in schema_names}))

    return ScanShape(root_paths=tuple(relation.root_paths), file_format=relation.file_format,
                     project_cols=clean(project_cols), filter_cols=clean(filter_cols),
                     equality_cols=clean(equality), range_cols=clean(rng))


def _join_shape(session, join: Join) -> Optional[JoinShape]:
    from ..rules.join_rule import _column_mapping, _ensure_one_to_one
    from ..rules.rule_utils import (collect_base_references, get_relation, is_plan_linear,
                                    output_to_base_mapping)
    if join.join_type != "inner" or join.condition is None:
        return None
    pairs = E.extract_equi_join_keys(join.condition)
    if not pairs:
        return None
    if not (is_plan_linear(join.left) and is_plan_linear(join.right)):
        return None
    l_rel = get_relation(session, join.left.collect_leaves()[0])
    r_rel = get_relation(session, join.right.collect_leaves()[0])
    if l_rel is None or r_rel is None:
        return None
    mapping = _column_mapping(join, pairs)
    if mapping is None:
        return None
    l_cols, r_cols = mapping
    l_base = output_to_base_mapping(join.left)
    r_base = output_to_base_mapping(join.right)
    if l_base is None or r_base is None:
        return None
    l_cols = [l_base.get(c) for c in l_cols]
    r_cols = [r_base.get(c) for c in r_cols]
    if any(c is None for c in l_cols) or any(c is None for c in r_cols):
        return None
    based = _ensure_one_to_one(zip(l_cols, r_cols))
    if based is None:
        return None
    l_cols, r_cols = based
    l_refs = collect_base_references(join.left)
    r_refs = collect_base_references(join.right)
    if l_refs is None or r_refs is None:
        return None
    return JoinShape(
        left=JoinSideShape(tuple(l_rel.root_paths), l_rel.file_format, tuple(l_cols),
                           tuple(sorted(l_refs | set(l_cols)))),
        right=JoinSideShape(tuple(r_rel.root_paths), r_rel.file_format, tuple(r_cols),
                            tuple(sorted(r_refs | set(r_cols)))))


def extract_shapes(session, plan: LogicalPlan
                   ) -> Tuple[Tuple[ScanShape, ...], Tuple[JoinShape, ...]]:
    """Every linear chain's scan shape and every rewritable join shape of a
    normalized plan. A chain's root is the topmost Filter/Project/Scan of
    each maximal linear chain."""
    from ..rules.rule_utils import is_plan_linear

    parents = {}
    for node in _iter_nodes(plan):
        for c in node.children:
            parents[id(c)] = node
    scan_shapes: List[ScanShape] = []
    join_shapes: List[JoinShape] = []
    for node in _iter_nodes(plan):
        if isinstance(node, Join):
            js = _join_shape(session, node)
            if js is not None:
                join_shapes.append(js)
        if isinstance(node, (Scan, Filter, Project)) and is_plan_linear(node):
            parent = parents.get(id(node))
            if isinstance(parent, (Filter, Project)) and is_plan_linear(parent):
                continue  # not the chain's root
            shape = _chain_scan_shape(session, node)
            if shape is not None:
                scan_shapes.append(shape)
    return tuple(scan_shapes), tuple(join_shapes)


# Capture (the Session.execute hook).

def _rules_fired(session, applied: Tuple[str, ...]) -> Tuple[str, ...]:
    """The rule families behind the applied indexes, by their kinds."""
    if not applied:
        return ()
    from ..index.constants import States
    kinds = {e.name: e.derivedDataset.kind
             for e in session.index_collection_manager.get_indexes([States.ACTIVE])}
    fired = set()
    for name in applied:
        kind = kinds.get(name)
        if kind == "CoveringIndex":
            fired.add("CoveringIndexRules")
        elif kind == "DataSkippingIndex":
            fired.add("DataSkippingIndexRule")
    return tuple(sorted(fired))


def capture_execution(session, plan: LogicalPlan, latency_s: float) -> None:
    """Append one WorkloadRecord for an executed plan. Session.execute
    cleared ``_last_reason_collector`` before running, so ``applied`` is
    this execution's: empty on a result-cache hit (no rewrite ran) or with
    hyperspace disabled."""
    from ..serving import fingerprint as fp
    norm = fp.normalize(plan)
    collector = session._last_reason_collector
    applied = tuple(sorted(set(collector.applied))) if collector else ()
    scan_shapes, join_shapes = extract_shapes(session, norm)
    record = WorkloadRecord(
        fingerprint=fp.plan_fingerprint(plan, normalized=norm), plan=norm,
        scan_shapes=scan_shapes, join_shapes=join_shapes, latency_s=latency_s,
        applied_indexes=applied, rules_fired=_rules_fired(session, applied))
    log_for(session).add(record, session.hs_conf.advisor_capture_max_entries())
