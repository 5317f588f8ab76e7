"""Whole-plan fusion: one region over a keep mask (counterpart of
``hyperspace_tpu/execution/fusion.py``).

The staged executor runs operator at a time: every plan node materializes
a ``Table``, so a filter -> project -> join-probe -> aggregate chain
compacts its rows (one host sync each) at every stage. This module is
the single-device counterpart of the mesh tier's per-device program
(execution/spmd.py): a planner walks the optimized plan, carves it into
maximal fusible regions, and runs each region as one plain Python body
over torch tensors in which no intermediate ``Table`` is compacted.

Region shape (the SPMD chain grammar)::

    [Aggregate (grouped or global, no COUNT DISTINCT)]
      └─ {Filter, Project, inner/semi/anti single-key equi-Join}*
           └─ Scan | IndexScan | <any barrier subtree, executed staged>

The body streams the leaf once: filters AND into a keep mask (through the
evaluator, so on a card they run the compare and range mask kernels, as
the staged filter does); projects evaluate over every row; joins probe a
prepared side (key-sorted, key-unique for an inner join) with
``torch.searchsorted`` and gather its columns in place. At a chain root
the mask compacts once (the survivor count is the region's one host
sync); under an aggregate the kept rows feed the staged executor's
aggregate code, so float sums add the kept rows in the staged path's
order and equal its bits. The inner-side uniqueness check is the other
host sync, as in the JAX program.

Answers equal the staged path's but for one thing the JAX package's fused
default shares: the stream is read whole when its pushed-down read keeps
no row, so a nullable column stays nullable, and a global aggregate of it
over no kept rows answers NULL where the staged path answers 0.0, an
infinity or the dtype's far end.

Anything the body does not absorb falls back at a named boundary
(execution/fusion_boundaries.py): sorts, windows, outer and cross joins,
COUNT DISTINCT, chunked (over-budget) sources, bucket-ordered streams
(the staged executor owns the covering-index fast paths) and literal
sweeps. ``hyperspace.tpu.execution.fusion.enabled=false`` restores the
staged executor. A region is tried only where the mesh tier declined.

A region's key (its literal-free structure) keys its stage in the
process-wide program bank (serving/program_bank.py), as the JAX package's
compiled region program is keyed, and the memo of regions whose body
failed, which stay staged. The body runs eagerly; its aggregate's stages
take no bank stage of their own (traced into the one program there).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException, QueryDeadlineError
from ..plan import expr as E
from ..plan.nodes import (Aggregate, BucketUnion, Filter, IndexScan, Join, Limit,
                          LogicalPlan, Project, Scan, Sort, Union, Window, infer_dtype)
from ..schema import STRING
from ..shapes import padded_length
from ..telemetry import span_names as SN
from ..telemetry import trace as _trace
from . import fusion_boundaries as FB
from .columnar import DEVICE_DTYPE, Column, Table, dictionaries_equal, translate_codes
from .evaluator import eval_expr, eval_predicate_mask
from .leaf import load_leaf, meta_column, within_budget

# Fused region executions in this process (tests and chip_smoke.py assert
# the path is taken, the spmd.DISPATCH_COUNT convention). Written under
# the state lock: concurrent serving workers run regions.
DISPATCH_COUNT = 0

_FUSABLE_AGGS = (E.Count, E.Sum, E.Avg, E.Min, E.Max)

# The fewest plan nodes a region fuses (the JAX package's
# fusion.minStages default): one node alone is a staged stage already.
MIN_STAGES = 2


class _FuseFallback(Exception):
    """Runtime bailout on an otherwise fusible region; ``kind`` names the
    boundary and the staged executor runs the region instead. ``node``
    (when the bailout belongs to one plan node: a duplicate-keyed join
    side, a chunked or bucket-ordered leaf) is marked so the staged
    descent's sub-region attempts skip it instead of repeating its reads."""

    def __init__(self, kind: str, node: Optional[LogicalPlan] = None):
        super().__init__(kind)
        self.kind = kind
        self.node = node


class _FusionState:
    """Process-wide counters and the poisoned-region memo (a region whose
    body failed once stays staged instead of failing again per query)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.boundaries: Dict[str, int] = {}
        self.poisoned: Set[tuple] = set()
        self.fused_nodes_total = 0

    def stats(self) -> dict:
        with self.lock:
            return {
                "fused_executions": DISPATCH_COUNT,
                "fused_nodes_total": self.fused_nodes_total,
                "fallbacks": dict(self.boundaries),
                "poisoned_regions": len(self.poisoned),
            }


_STATE = _FusionState()


def note_boundary(kind: str) -> None:
    """Count a region boundary or fallback by its registry kind."""
    with _STATE.lock:
        _STATE.boundaries[kind] = _STATE.boundaries.get(kind, 0) + 1


def stats() -> dict:
    return _STATE.stats()


def reset_stats() -> None:
    """Zero the counters (the poisoned memo stays: a broken region stays
    broken in this process)."""
    global DISPATCH_COUNT
    with _STATE.lock:
        _STATE.boundaries.clear()
        _STATE.fused_nodes_total = 0
        DISPATCH_COUNT = 0


# ---------------------------------------------------------------------------
# Region planning (plan shape only; no IO).
# ---------------------------------------------------------------------------

_BARRIER_KINDS = {
    Sort: FB.SORT, Window: FB.WINDOW, Limit: FB.LIMIT, Union: FB.UNION,
    BucketUnion: FB.UNION, Aggregate: FB.AGGREGATE,
}


class _Region:
    """A planned region: ``stages`` bottom-up over ``bottom`` (a leaf or a
    staged barrier subtree), with an optional ``agg`` root."""

    def __init__(self, stages: List[tuple], bottom: LogicalPlan,
                 agg: Optional[Aggregate], root: LogicalPlan):
        self.stages = stages  # bottom-up ("filter"|"project"|"join", node[, pair])
        self.bottom = bottom
        self.agg = agg
        self.root = root

    @property
    def node_count(self) -> int:
        return len(self.stages) + (1 if self.agg is not None else 0)


def _strip_alias(e: E.Expr) -> E.Expr:
    while isinstance(e, E.Alias):
        e = e.child
    return e


def _normalized_pair(node: Join) -> Optional[Tuple[str, str]]:
    """The single (left, right) equi-join key pair, or None (a barrier)."""
    pairs = E.extract_equi_join_keys(node.condition)
    if pairs is None:
        note_boundary(FB.NON_EQUI_JOIN)
        return None
    if len(pairs) != 1:
        note_boundary(FB.MULTI_KEY_JOIN)
        return None
    a, b = pairs[0]
    left_names = set(node.left.schema.names)
    right_names = set(node.right.schema.names)
    if a in left_names and b in right_names:
        return a, b
    if b in left_names and a in right_names:
        return b, a
    note_boundary(FB.NON_EQUI_JOIN)
    return None


def _agg_barrier(agg: Aggregate) -> Optional[str]:
    """The boundary kind that keeps an Aggregate out of a region, decided
    from the plan before any IO: COUNT DISTINCT, a non-fusable aggregate,
    a sum or mean of strings (the staged path raises it), or a string
    MIN/MAX whose child is no plain column (its dictionary could not be
    re-attached)."""
    child_schema = agg.child.schema
    for a in agg.aggs:
        inner = _strip_alias(a)
        if isinstance(inner, E.CountDistinct):
            return FB.COUNT_DISTINCT
        if not isinstance(inner, _FUSABLE_AGGS):
            return FB.UNSUPPORTED_AGG
        try:
            if isinstance(inner, (E.Sum, E.Avg)) \
                    and infer_dtype(inner.child, child_schema) == STRING:
                return FB.UNSUPPORTED_AGG
            if isinstance(inner, (E.Min, E.Max)) \
                    and infer_dtype(inner, child_schema) == STRING \
                    and not isinstance(_strip_alias(inner.child), E.Col):
                return FB.UNSUPPORTED_AGG
        except HyperspaceException:
            return FB.UNSUPPORTED_AGG
    return None


def _plan_region(root: LogicalPlan, session) -> Optional[_Region]:
    agg = None
    node = root
    if isinstance(node, Aggregate):
        barrier = _agg_barrier(node)
        if barrier is not None:
            note_boundary(barrier)
            return None
        agg = node
        node = node.child
    stages_td: List[tuple] = []
    while isinstance(node, (Filter, Project, Join)):
        if isinstance(node, Filter):
            stages_td.append(("filter", node))
            node = node.child
        elif isinstance(node, Project):
            stages_td.append(("project", node))
            node = node.child
        else:
            if getattr(node, "_fusion_skip", None) is not None:
                # This join bailed at runtime before (duplicate keys, an
                # empty side): the chain stops here, and the stages above
                # fuse over the staged join's output.
                break
            jt = node.join_type
            if jt == "cross":
                note_boundary(FB.CROSS_JOIN)
                break
            if jt in ("left", "right", "full"):
                note_boundary(FB.OUTER_JOIN)
                break
            pair = _normalized_pair(node)
            if pair is None:
                break
            stages_td.append(("join", node, pair))
            node = node.left
    skip = getattr(node, "_fusion_skip", None)
    if skip is not None:
        note_boundary(skip)  # the kind recorded at the original bailout
        if isinstance(node, (Scan, IndexScan)):
            # A marked leaf is the stream itself (chunked, bucket order):
            # no region over it can fuse.
            return None
    elif isinstance(node, (Scan, IndexScan)):
        if isinstance(node, IndexScan) and node.use_bucket_spec:
            # Bucket-spec index scans feed the staged shuffle-free merge
            # join and the sort-skipping group-by, which the region does
            # not replay. Decided from the plan, before any IO.
            note_boundary(FB.BUCKET_ORDER)
            return None
        note_boundary(FB.LEAF)
    else:
        note_boundary(_BARRIER_KINDS.get(type(node), FB.UNSUPPORTED_EXPR))
    region = _Region(list(reversed(stages_td)), node, agg, root)
    if region.node_count < MIN_STAGES:
        note_boundary(FB.REGION_TOO_SMALL)
        return None
    return region


def _region_needs(region: _Region, out_names: List[str]):
    """Top-down column needs: the bottom subtree's and each join stage's
    right side's (its key included)."""
    if region.agg is not None:
        needed: Set[str] = set(region.agg.group_cols)
        for a in region.agg.aggs:
            needed |= set(a.references)
    else:
        needed = set(out_names)
    right_needed: Dict[int, Set[str]] = {}
    for i in range(len(region.stages) - 1, -1, -1):
        st = region.stages[i]
        kind, node = st[0], st[1]
        if kind == "filter":
            needed |= set(node.condition.references)
        elif kind == "project":
            # As in the staged executor, every project expression runs.
            below: Set[str] = set()
            for e in node.exprs:
                below |= set(e.references)
            needed = below
        else:
            lname, rname = st[2]
            if node.join_type in ("semi", "anti"):
                right_needed[i] = {rname}
                needed = needed | {lname}
            else:
                rnames = set(node.right.schema.names)
                right_needed[i] = {n for n in needed if n in rnames} | {rname}
                needed = {n for n in needed if n not in rnames} | {lname}
    return needed, right_needed


# ---------------------------------------------------------------------------
# Preparation: leaf load, join sides, the region key.
# ---------------------------------------------------------------------------

def _dict_fp(dic: Optional[np.ndarray]):
    """A dictionary's place in the region key: its size and end entries.
    The JAX key holds the whole dictionary (a compiled program's
    constant); here the key remembers failed regions and keys the bank's
    stage, so a cheap fingerprint will do: a collision only runs a region
    staged, or counts two regions' programs as one stage's."""
    if dic is None:
        return None
    return (len(dic), str(dic[0]), str(dic[-1])) if len(dic) else (0,)


def _meta_of(cols: Dict[str, Column]) -> Dict[str, Tuple]:
    return {n: (c.dtype, c.dictionary, c.validity is not None) for n, c in cols.items()}


def _tiny(meta: Dict[str, Tuple]) -> Dict[str, Column]:
    """Zero-length columns carrying (dtype, dictionary, nullability): the
    prep walk evaluates expressions over them to learn output metadata."""
    return {n: meta_column(dt, dic, nul) for n, (dt, dic, nul) in meta.items()}


class _SidePrep:
    """A prepared join side: ``keys`` ascending in the stream key's code
    space, ``cols`` aligned with them (inner joins only). An inner side's
    keys are unique."""

    def __init__(self, keys: torch.Tensor, cols: Dict[str, Column]):
        self.keys = keys
        self.cols = cols


def _prepare_side(node: Join, pair, tiny: Dict[str, Column], right_needed: Set[str],
                  session) -> Tuple[_SidePrep, tuple]:
    """Execute and key-sort one join side: (prep, key descriptor)."""
    from ..ops import kernels
    from . import executor as ex
    lname, rname = pair
    jt = node.join_type
    right = ex._execute(node.right, set(right_needed), session)
    if right.num_rows == 0:
        raise _FuseFallback(FB.EMPTY_INPUT, node)
    rk = right.column(rname)
    lcol = tiny[lname]
    if (lcol.dtype == STRING) != (rk.dtype == STRING):
        raise _FuseFallback(FB.KEY_DTYPE, node)
    if rk.validity is not None:
        # Null side keys never match an inner, semi or anti join: dropped
        # up front, as the staged join drops them.
        right = right.filter(rk.validity)
        if right.num_rows == 0:
            raise _FuseFallback(FB.EMPTY_INPUT, node)
        rk = right.column(rname)
    if rk.dtype == STRING:
        codes = rk.data if dictionaries_equal(lcol.dictionary, rk.dictionary) \
            else translate_codes(lcol.dictionary, rk)
    else:
        ldt = DEVICE_DTYPE[lcol.dtype]
        if ldt == torch.bool or rk.data.dtype == torch.bool:
            raise _FuseFallback(FB.KEY_DTYPE, node)
        promo = torch.promote_types(ldt, rk.data.dtype)
        codes = rk.data if rk.data.dtype == promo else rk.data.to(promo)
    order = kernels.lex_sort_indices([codes])
    codes = codes[order]
    if jt == "inner" and codes.shape[0] > 1 \
            and bool(torch.any(codes[1:] == codes[:-1])):  # HOST SYNC (single scalar).
        # An m:n join: the mask cannot expand matches; the staged merge
        # join owns it.
        raise _FuseFallback(FB.DUPLICATE_PROBE_KEYS, node)
    cols: Dict[str, Column] = {}
    if jt == "inner":
        right = right.take(order)
        cols = dict(right.columns)
    descr = ("J", jt, lname, rname, str(codes.dtype),
             tuple((n, c.dtype, _dict_fp(c.dictionary), c.validity is not None)
                   for n, c in cols.items()))
    return _SidePrep(codes, cols), descr


# ---------------------------------------------------------------------------
# The region body.
# ---------------------------------------------------------------------------

def _run_body(region: _Region, stream: Table, sides: List[_SidePrep],
              out_names: List[str]):
    """The fused body over the stream's tensors: (output table, observed
    rows of each inner join as 0-d tensors)."""
    from . import executor as ex
    from ..ops import kernels
    cols: Dict[str, Column] = dict(stream.columns)
    n = stream.num_rows
    keep = torch.ones(n, dtype=torch.bool, device=stream.device)
    jrows: List[torch.Tensor] = []
    side_i = 0
    for st in region.stages:
        kind, node = st[0], st[1]
        if kind == "filter":
            keep = keep & eval_predicate_mask(Table(dict(cols)), node.condition)
        elif kind == "project":
            t = Table(dict(cols))
            cols = {e.name: eval_expr(t, e) for e in node.exprs}
        else:
            lname, _ = st[2]
            side = sides[side_i]
            side_i += 1
            lc = cols[lname]
            keys = side.keys
            lk = lc.data if lc.dtype == STRING else lc.data.to(keys.dtype)
            lo = torch.searchsorted(keys, lk, side="left")
            matched = lo < torch.searchsorted(keys, lk, side="right")
            if lc.validity is not None:
                matched = matched & lc.validity
            if node.join_type == "inner":
                keep = keep & matched
                pos = lo.clamp(0, keys.shape[0] - 1)
                for sname, sc in side.cols.items():
                    cols[sname] = sc.take(pos)
                # The staged join's output rows: kept so far and matched.
                jrows.append(keep.sum())
            elif node.join_type == "semi":
                keep = keep & matched
            else:  # anti: a null left key matches nothing, so it stays.
                keep = keep & ~matched
    # The one compaction: the survivor count is the region's host sync.
    idx = kernels.filter_indices(keep)
    if region.agg is None:
        return Table({nm: cols[nm].take(idx) for nm in out_names}), jrows
    agg = region.agg
    needed = set(agg.group_cols)
    for a in agg.aggs:
        needed |= set(a.references)
    kept = Table({nm: c.take(idx) for nm, c in cols.items() if nm in needed})
    if not kept.columns:
        # count(*) alone references no column: the rows still count.
        any_name = next(iter(cols))
        kept = Table({any_name: cols[any_name].take(idx)})
    token = ex._BANK_STAGES.set(False)
    try:
        if not agg.group_cols:
            return ex._execute_global_aggregate(agg, kept), jrows
        return ex._execute_aggregate(agg, kept), jrows
    finally:
        ex._BANK_STAGES.reset(token)


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------

def try_execute(plan: LogicalPlan, needed: Optional[Set[str]], session) -> Optional[Table]:
    """Fuse and run the maximal region rooted at ``plan``, or None for the
    staged executor. Called from executor._execute for Filter, Project and
    Join roots and from the Aggregate branch after the SPMD attempt (the
    mesh tier keeps right of way)."""
    if session is None:
        return None
    if not session.hs_conf.fusion_enabled():
        note_boundary(FB.DISABLED)
        return None
    from ..serving import batcher
    if batcher.active_sweep() is not None:
        # A literal sweep shares one scan among its members on the staged
        # path: its win, its path.
        note_boundary(FB.SWEEP)
        return None
    region = _plan_region(plan, session)
    if region is None:
        return None
    try:
        return _execute_region(region, needed, session)
    except _FuseFallback as f:
        note_boundary(f.kind)
        if f.node is not None:
            # A data-dependent bailout: the responsible node is marked so
            # the staged descent's sub-region attempts skip it instead of
            # repeating the leaf read or the side's preparation.
            f.node._fusion_skip = f.kind
        return None
    except QueryDeadlineError:
        raise
    except Exception as e:
        from ..adaptive.feedback import ReplanRequested
        if isinstance(e, ReplanRequested):
            # A staged join under the region asked for a re-plan: a control
            # transfer to Session._execute_uncaptured, not a region failure.
            raise
        # A failed region never fails the query while degradation is on:
        # the staged path runs it. With robustness.degrade.enabled=false
        # the error surfaces.
        if not session.hs_conf.robustness_degrade_enabled():
            raise
        note_boundary(FB.FUSED_PROGRAM_ERROR)
        return None


def _execute_region(region: _Region, needed: Optional[Set[str]], session) -> Table:
    from . import executor as ex
    from ..serving.batcher import condition_template
    root = region.root
    if region.agg is not None:
        out_names = list(region.agg.schema.names)
    else:
        out_names = [n for n in root.schema.names if needed is None or n in needed] \
            or [root.schema.names[0]]
    bottom_needed, right_needed = _region_needs(region, out_names)

    # ---- the stream -------------------------------------------------------
    bottom = region.bottom
    if isinstance(bottom, (Scan, IndexScan)):
        # As the mesh tier does: a leaf past maxChunkRows belongs to the
        # staged chunked path, and the filters right above the leaf are
        # pushed into its read (the mask applies them again; a pushed
        # read that keeps no row falls through to the full read).
        if not within_budget(bottom, session):
            raise _FuseFallback(FB.CHUNKED_SOURCE, bottom)
        lead_filters = []
        for st in region.stages:
            if st[0] != "filter":
                break
            lead_filters.append(("filter", st[1]))
        stream = load_leaf(bottom, lead_filters, bottom_needed, session)
    else:
        stream = ex._execute(bottom, bottom_needed, session)
    if stream.bucket_order is not None:
        # The staged executor owns the covering-index fast paths (the merge
        # join without a sort, the sort-skipping group-by) and their order.
        raise _FuseFallback(FB.BUCKET_ORDER, bottom)
    if stream.num_rows == 0 or not stream.columns:
        raise _FuseFallback(FB.EMPTY_INPUT)

    # ---- per stage: metadata walk, join sides, the key --------------------
    stream_meta = _meta_of(stream.columns)
    tiny = _tiny(stream_meta)
    descr: List[tuple] = []
    sides: List[_SidePrep] = []
    for stage_i, st in enumerate(region.stages):
        kind, node = st[0], st[1]
        if kind == "join":
            prep, side_descr = _prepare_side(node, st[2], tiny, right_needed[stage_i],
                                             session)
            descr.append(side_descr)
            sides.append(prep)
            tiny.update(_tiny(_meta_of(prep.cols)))
            continue
        try:
            if kind == "filter":
                eval_predicate_mask(Table(dict(tiny)), node.condition)
                descr.append(("F", condition_template(node.condition)[0]))
            else:
                t = Table(dict(tiny))
                tiny = {e.name: eval_expr(t, e) for e in node.exprs}
                descr.append(("P", tuple(repr(e) for e in node.exprs)))
        except QueryDeadlineError:
            raise
        except (HyperspaceException, KeyError):
            # An expression shape the evaluator refuses (or a column the
            # walk cannot see): the staged path handles it.
            raise _FuseFallback(FB.UNSUPPORTED_EXPR)
    if region.agg is not None:
        descr.append(("A", tuple(region.agg.group_cols),
                      tuple((a.name, repr(a)) for a in region.agg.aggs)))
        missing = [g for g in region.agg.group_cols if g not in tiny]
    else:
        missing = [nm for nm in out_names if nm not in tiny]
    if missing:
        raise _FuseFallback(FB.UNSUPPORTED_EXPR)
    key = ("region", tuple(descr),
           tuple((n, dt, _dict_fp(dic), nul) for n, (dt, dic, nul) in stream_meta.items()),
           tuple(out_names))
    with _STATE.lock:
        poisoned = key in _STATE.poisoned
    if poisoned:
        raise _FuseFallback(FB.FUSED_PROGRAM_ERROR)

    if _trace.idle():
        return _run_region(region, key, stream, sides, out_names, session)
    with _trace.span(SN.EXEC_FUSED, fused_nodes=region.node_count,
                     root=root.node_name) as sp:
        table = _run_region(region, key, stream, sides, out_names, session)
        if sp is not None:
            sp.attrs["rows"] = int(table.num_rows)
        return table


def _run_region(region: _Region, key, stream: Table, sides: List[_SidePrep],
                out_names: List[str], session) -> Table:
    global DISPATCH_COUNT
    from ..serving.program_bank import get_bank
    # The region's program in the bank, per shape-class vector of its
    # inputs: the stream's length class and each join side's.
    shape_vec = (padded_length(int(stream.num_rows)),) + tuple(
        padded_length(int(p.keys.shape[0])) for p in sides)
    try:
        get_bank().lookup(("fused-region", key), shape_vec, lambda: _run_body)
        table, jrows = _run_body(region, stream, sides, out_names)
    except Exception as e:
        # Poison only real defects of the body, which would fail every
        # query of this shape. A transient error (OSError, a timeout, an
        # injected fault, a deadline) leaves the region fusible.
        from ..robustness.faults import InjectedFaultError
        if not isinstance(e, (OSError, TimeoutError, InjectedFaultError,
                              QueryDeadlineError)):
            with _STATE.lock:
                _STATE.poisoned.add(key)
        raise
    with _STATE.lock:
        DISPATCH_COUNT += 1
        _STATE.fused_nodes_total += region.node_count
    _record_actuals(region, jrows, session)
    return table


def _record_actuals(region: _Region, jrows: List[torch.Tensor], session) -> None:
    """Each inner join's observed output rows into the join-actuals store
    (and, with the adaptive tier on, its corrections), as the staged join
    records them."""
    from ..serving import context as qctx
    joins = [st[1] for st in region.stages
             if st[0] == "join" and st[1].join_type == "inner"]
    for node, rows in zip(joins, jrows):
        if node.condition is None:
            continue
        key = qctx.join_actual_key(node.condition, node.left, node.right)
        qctx.record_join_actual(session, key, int(rows))  # HOST SYNC (single scalar).


# The fusion layer's counters are a named collector of the process metrics
# registry (telemetry/metrics.py).
from ..telemetry import metric_names as _mn  # noqa: E402
from ..telemetry import metrics as _metrics  # noqa: E402

_metrics.get_registry().register_collector(_mn.COLLECTOR_FUSION, stats)
