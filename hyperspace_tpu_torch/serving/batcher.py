"""Literal sweeps: queries that differ only in filter literals, run as one
batch (counterpart of ``hyperspace_tpu/serving/batcher.py``).

A serving workload is full of literal sweeps: many users issue one query
shape with different constants (dates, keys, thresholds). Run one by one,
each reads the same source. This module finds such queries and shares
the read:

1. Template matching (:func:`plan_template`): the normalized plan written
   out with its Filter literals abstracted. Two plans batch together only
   if their templates are equal: same operators, columns and expression
   structure, only Filter literals differing. A shape the writer does not
   fully know keeps its concrete text, so unknown shapes never match.

2. :class:`SweepContext`, installed around each member's execution by the
   serving frontend. It keeps shared scans: the first member's source read
   serves every other member. There is no row-group pushdown under a
   sweep: each member's full predicate is applied again on the device, so
   the unpruned read gives the same answer, and one shared table beats N
   pruned reads.

Each member evaluates its own mask over the shared table on the
single-query path (the mask kernels on a card), keeps its own downstream
pipeline, result-cache key and answer, equal bit for bit to its serial
execution. This is what the JAX package does on the TPU, where its Pallas
masks take every filter; its stacked ``vmap`` mask pass, which it runs
only off the TPU, is not ported. An IndexScan child or a chunked scan
shares nothing and runs per member inside the same batch.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Callable, List, Optional, Tuple

from ..plan import expr as E
from ..plan.nodes import Filter, LogicalPlan

_SWEEP: contextvars.ContextVar = contextvars.ContextVar("hst_torch_literal_sweep",
                                                        default=None)


class Unbatchable(Exception):
    """A plan shape the template writer cannot soundly abstract."""


_COMPARISONS = (E.EqualTo, E.LessThan, E.LessThanOrEqual, E.GreaterThan,
                E.GreaterThanOrEqual)


def condition_template(e: E.Expr, lits: Optional[list] = None) -> Tuple[str, list]:
    """(literal-abstracted template, literal values) of a filter condition.
    Column-literal comparisons and IN over literals, under And/Or/Not, are
    abstracted; anything else is written concretely. The literal's Python
    type is part of the template."""
    if lits is None:
        lits = []
    if isinstance(e, (E.And, E.Or)):
        lt, _ = condition_template(e.left, lits)
        rt, _ = condition_template(e.right, lits)
        return f"{'And' if isinstance(e, E.And) else 'Or'}({lt},{rt})", lits
    if isinstance(e, E.Not):
        ct, _ = condition_template(e.child, lits)
        return f"Not({ct})", lits
    if isinstance(e, E.In) and isinstance(e.value, E.Col) \
            and all(isinstance(o, E.Lit) for o in e.options):
        tags = []
        for o in e.options:
            tags.append(type(o.value).__name__)
            lits.append(o.value)
        return f"In({e.value.column};{len(e.options)};{','.join(tags)})", lits
    if isinstance(e, _COMPARISONS):
        left, right = e.left, e.right
        flipped = False
        if isinstance(left, E.Lit) and not isinstance(right, E.Lit):
            left, right = right, left
            flipped = True
        if isinstance(left, E.Col) and isinstance(right, E.Lit):
            from ..execution.evaluator import _op_name
            lits.append(right.value)
            return (f"{_op_name(e, flipped)}({left.column};"
                    f"{type(right.value).__name__})"), lits
    return repr(e), lits


def plan_template(plan: LogicalPlan) -> Tuple[str, List[E.Expr]]:
    """(template, swept Filter conditions in depth-first order) of a
    normalized plan. Raises :class:`Unbatchable` for a node the result
    cache's writer does not know (the same soundness bar)."""
    from .fingerprint import _node_detail
    parts: List[str] = []
    conditions: List[E.Expr] = []

    def walk(p: LogicalPlan) -> None:
        if isinstance(p, Filter):
            lits: list = []
            t, _ = condition_template(p.condition, lits)
            parts.append(f"(Filter[{t}]")
            if lits:
                conditions.append(p.condition)
        else:
            detail = _node_detail(p)
            if detail is None:
                raise Unbatchable(p.node_name)
            parts.append("(" + detail)
        for c in p.children:
            walk(c)
        parts.append(")")

    walk(plan)
    return "".join(parts), conditions


def template_key(session, plan: LogicalPlan) -> Optional[Tuple[str, str]]:
    """The batch key of a normalized plan: its template and the session's
    conf hash (sessions whose conf could plan differently never share a
    sweep). None when the plan cannot batch."""
    from ..util import hashing
    from .fingerprint import config_hash
    try:
        template, conditions = plan_template(plan)
    except Unbatchable:
        return None
    if not conditions:
        return None  # no literal to sweep
    return hashing.md5_hex(template), config_hash(session)


class SweepContext:
    """Shared execution state of one batch of literal-variant plans, built
    by the frontend and activated per member (:func:`use_sweep`). The
    executor reads it through :func:`active_sweep`."""

    def __init__(self, size: int):
        self.size = size
        self._lock = threading.Lock()
        self._tables: dict = {}  # scan share key -> Table
        self.shared_scans = 0
        self.shared_scan_hits = 0

    def shared_scan(self, key, compute: Callable):
        """The scanned Table for ``key``, read once per batch (the reads are
        charged to the member that made them)."""
        with self._lock:
            table = self._tables.get(key)
            if table is not None:
                self.shared_scan_hits += 1
                return table
        table = compute()  # outside the lock: reads are slow
        with self._lock:
            existing = self._tables.get(key)
            if existing is not None:
                self.shared_scan_hits += 1
                return existing
            self._tables[key] = table
            self.shared_scans += 1
        return table

    def stats(self) -> dict:
        with self._lock:
            return {
                "members": self.size,
                "shared_scans": self.shared_scans,
                "shared_scan_hits": self.shared_scan_hits,
            }


@contextlib.contextmanager
def use_sweep(sweep: Optional[SweepContext]):
    """Activate ``sweep`` for one member's execution; the contextvar keeps
    other workers' batches apart."""
    if sweep is None:
        yield
        return
    token = _SWEEP.set(sweep)
    try:
        yield
    finally:
        _SWEEP.reset(token)


def active_sweep() -> Optional[SweepContext]:
    return _SWEEP.get()
