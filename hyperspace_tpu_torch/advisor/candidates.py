"""Candidate generation: the index configs the workload's shapes could use
(counterpart of ``hyperspace_tpu/advisor/candidates.py``).

Three families, from the columns the captured shapes touch:

  filter — per filter column ``f`` of a chain, a covering index indexed on
           ``[f]`` including the chain's other columns (the filter rule's
           surface: the first indexed column in the predicate, every column
           covered);
  join   — per rewritable equi-join, a PAIR of covering indexes (one a side,
           indexed on the join columns in mapped order, covering the side's
           read set), proposed as ONE group: the join rule needs both;
  sketch — per table, one DataSkippingIndexConfig: MinMax for the
           range-compared columns, BloomFilter for the equality/IN ones.

Groups are deduplicated by content, counted once per captured query that
shows them, dropped when existing ACTIVE indexes cover them, and named
deterministically (the same workload gives the same names).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..api import BloomFilterSketch, DataSkippingIndexConfig, IndexConfig, MinMaxSketch
from ..util import hashing
from .constants import MAX_CANDIDATES, AdvisorConstants
from .workload import WorkloadRecord


@dataclass(frozen=True)
class CandidateSpec:
    """One proposed index and the table it belongs to."""

    config: object  # IndexConfig | DataSkippingIndexConfig
    root_paths: Tuple[str, ...]
    file_format: str


@dataclass
class CandidateGroup:
    """Indexes that pay off only together (a join pair) or alone.
    ``support`` counts the captured queries that show the shape."""

    key: tuple
    kind: str  # "filter" | "join" | "sketch"
    specs: Tuple[CandidateSpec, ...]
    support: int = 0


def _slug(root_paths: Tuple[str, ...]) -> str:
    base = os.path.basename(root_paths[0].rstrip("/")) if root_paths else "t"
    cleaned = "".join(ch if ch.isalnum() else "_" for ch in base.lower())
    return (cleaned or "t")[:24]


def _name(kind: str, root_paths: Tuple[str, ...], detail: tuple) -> str:
    h = hashing.md5_hex((kind, root_paths, detail))[:6]
    return f"{AdvisorConstants.CANDIDATE_NAME_PREFIX}_{kind}_{_slug(root_paths)}_{h}"


def _covering_spec(kind: str, root_paths, file_format, indexed: Tuple[str, ...],
                   included: Tuple[str, ...]) -> CandidateSpec:
    name = _name(kind, tuple(root_paths), (indexed, included))
    return CandidateSpec(IndexConfig(name, list(indexed), list(included)),
                         tuple(root_paths), file_format)


def _spec_key(spec: CandidateSpec) -> tuple:
    cfg = spec.config
    if isinstance(cfg, IndexConfig):
        return (spec.root_paths, "ci", tuple(cfg.indexed_columns), tuple(cfg.included_columns))
    return (spec.root_paths, "ds", tuple(sorted((s.kind, s.column) for s in cfg.sketches)))


def _groups_from_record(record: WorkloadRecord) -> List[CandidateGroup]:
    out: List[CandidateGroup] = []
    for shape in record.scan_shapes:
        referenced = tuple(sorted(set(shape.project_cols) | set(shape.filter_cols)))
        for f in shape.filter_cols:
            included = tuple(c for c in referenced if c != f)
            spec = _covering_spec("ci", shape.root_paths, shape.file_format, (f,), included)
            out.append(CandidateGroup(("filter", _spec_key(spec)), "filter", (spec,)))
        sketches = [MinMaxSketch(c) for c in shape.range_cols]
        sketches += [BloomFilterSketch(c) for c in shape.equality_cols
                     if c not in set(shape.range_cols)]
        if sketches:
            name = _name("ds", shape.root_paths,
                         tuple(sorted((s.kind, s.column) for s in sketches)))
            spec = CandidateSpec(DataSkippingIndexConfig(name, sketches), shape.root_paths,
                                 shape.file_format)
            out.append(CandidateGroup(("sketch", _spec_key(spec)), "sketch", (spec,)))
    for js in record.join_shapes:
        l_inc = tuple(c for c in js.left.referenced_cols if c not in set(js.left.join_cols))
        r_inc = tuple(c for c in js.right.referenced_cols if c not in set(js.right.join_cols))
        l_spec = _covering_spec("ji", js.left.root_paths, js.left.file_format,
                                js.left.join_cols, l_inc)
        r_spec = _covering_spec("ji", js.right.root_paths, js.right.file_format,
                                js.right.join_cols, r_inc)
        specs = (l_spec,) if _spec_key(l_spec) == _spec_key(r_spec) \
            else (l_spec, r_spec)  # a self-join: one index serves both sides
        out.append(CandidateGroup(("join", tuple(sorted(_spec_key(s) for s in specs))),
                                  "join", specs))
    return out


def _covered_by_existing(spec: CandidateSpec, actives) -> bool:
    cfg = spec.config
    for entry in actives:
        if tuple(entry.relation.rootPaths) != spec.root_paths:
            continue
        if isinstance(cfg, IndexConfig):
            if entry.derivedDataset.kind != "CoveringIndex":
                continue
            if list(entry.indexed_columns) != list(cfg.indexed_columns):
                continue
            covered = set(entry.indexed_columns) | set(entry.included_columns)
            if set(cfg.included_columns) <= covered:
                return True
        else:
            if entry.derivedDataset.kind != "DataSkippingIndex":
                continue
            have = {(s.kind, s.column) for s in entry.derivedDataset.sketches}
            if {(s.kind, s.column) for s in cfg.sketches} <= have:
                return True
    return False


def generate(session, records: List[WorkloadRecord]) -> List[CandidateGroup]:
    """Deduplicated, support-counted groups no existing ACTIVE index covers,
    highest support first, at most ``MAX_CANDIDATES``."""
    from ..index.constants import States
    groups: Dict[tuple, CandidateGroup] = {}
    for record in records:
        seen_in_record = set()
        for g in _groups_from_record(record):
            existing = groups.get(g.key)
            if existing is None:
                groups[g.key] = existing = g
            if g.key not in seen_in_record:
                existing.support += 1
                seen_in_record.add(g.key)
    actives = session.index_collection_manager.get_indexes([States.ACTIVE])
    min_support = session.hs_conf.advisor_min_support()
    out = [g for g in groups.values()
           if g.support >= min_support
           and not all(_covered_by_existing(s, actives) for s in g.specs)]
    out.sort(key=lambda g: (-g.support, g.key))
    return out[:MAX_CANDIDATES]
