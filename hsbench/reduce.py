"""Reductions from spans and device records to numbers: interval unions,
gaps, and span self times. Plain Python over plain tuples."""

from __future__ import annotations

import re


def union(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], sorted and
    disjoint."""
    out: list = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals, lo: float, hi: float) -> float:
    """The length of [lo, hi] that some interval covers."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def self_seconds(span, children: list) -> float:
    """A span's duration less the part of it its children cover."""
    end = span.end_perf if span.end_perf is not None else span.start_perf
    return (end - span.start_perf) - covered(
        [(c.start_perf, c.end_perf if c.end_perf is not None else c.start_perf)
         for c in children], span.start_perf, end)


def children_of(spans: list) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.parent_id, []).append(s)
    return out


def outermost(spans: list, names: set) -> list:
    """The spans named in ``names`` with no ancestor named in ``names``."""
    by_id = {s.span_id: s for s in spans}
    out = []
    for s in spans:
        if s.name not in names:
            continue
        p = by_id.get(s.parent_id)
        while p is not None and p.name not in names:
            p = by_id.get(p.parent_id)
        if p is None:
            out.append(s)
    return out


def kernel_name(name: str) -> str:
    """A device record's name without its return type, template and
    argument lists: ``void mask_kernel<ComparePred, int>(...)`` is
    ``mask_kernel``; copies and fills keep their kind (``Memcpy DtoH``)."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_][A-Za-z0-9_:]*)\s*(<|\(|$)", name)
    return (m.group(1) if m else name)[:80]
