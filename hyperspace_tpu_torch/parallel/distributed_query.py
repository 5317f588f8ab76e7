"""Distributed query programs over the device mesh (counterpart of
``hyperspace_tpu/parallel/distributed_query.py``).

- ``distributed_range_agg``: a range filter and sums in one per-device
  program; each device masks its shard and one psum per partial combines
  (the TPC-H Q6 shape).
- ``distributed_join_agg``: the inner-join aggregate of two tables
  bucket-co-partitioned on the same key (two outputs of
  ``distributed_build_sorted_buckets`` over one mesh and bucket count):
  equal keys sit on one device on both sides, so each device merge-joins
  locally and psums combine, with no row moving between devices.
- ``distributed_join_filter_agg``: the same join with a range filter on a
  stream column folded into the stream's mask before the merge.

``*_collectives`` report the collectives each program issues: the
co-bucketed joins issue no all-to-all and no all-gather, only the final
all-reduces.

Sharded inputs are lists of per-device tensors (``parallel/mesh``); a
co-bucketed table is a list of per-device tables with a list of masks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..exceptions import HyperspaceException
from ..execution.columnar import Table
from ..execution.spmd import _fsum
from ..ops import kernels
from .mesh import Mesh, make_mesh, pad_and_shard
from .sharding import bank_program, collective_counts, shape_vector


def _range_mask(fd: torch.Tensor, lo, hi, lo_incl: bool, hi_incl: bool) -> torch.Tensor:
    ml = (fd >= lo) if lo_incl else (fd > lo)
    mh = (fd <= hi) if hi_incl else (fd < hi)
    return ml & mh


def distributed_range_agg(table: Table, filter_col: str, lo, hi,
                          value_cols: Tuple[str, ...] = (), mesh: Optional[Mesh] = None,
                          lo_incl: bool = True, hi_incl: bool = True,
                          counts: Optional[Dict[str, int]] = None):
    """count and per-column sums of the rows with ``lo <(=) filter_col <(=)
    hi``, computed over the mesh. Returns (count, {col: sum})."""
    mesh = mesh or make_mesh()
    fcol = table.column(filter_col)
    if fcol.validity is not None:
        raise HyperspaceException("distributed_range_agg: nullable filter column not "
                                  "supported yet")
    arrays = {"__f": fcol.data}
    for c in value_cols:
        col = table.column(c)
        if col.validity is not None:
            raise HyperspaceException(
                f"distributed_range_agg: nullable value column '{c}' not supported yet")
        arrays[c] = col.data
    shards, valid = pad_and_shard(mesh, arrays, table.num_rows)

    def per_device(ax, arrs, v):
        m = _range_mask(arrs["__f"], lo, hi, lo_incl, hi_incl) & v
        count = ax.psum(m.to(torch.int64).sum())
        sums = {name: ax.psum(_fsum(torch.where(m, arrs[name], torch.zeros(
            (), dtype=arrs[name].dtype, device=m.device)))) for name in value_cols}
        return count, sums

    specs = ("sharded", "sharded")
    launch = bank_program("range-agg", mesh, (tuple(value_cols), lo_incl, hi_incl),
                          shape_vector((shards, valid), specs))
    count, sums = launch(per_device, mesh, specs, counts)(shards, valid)[0]
    return int(count), {k: v.item() for k, v in sums.items()}


def _merge_join_agg_body(ax, lk, lvalid, lval, rk, rvalid, rval):
    """The per-device co-bucketed merge-join aggregate: the right shard
    re-sorted by key (invalid rows last, at the dtype's max), each left key
    probed by searchsorted, segment totals from a prefix sum, psums to
    combine. Probe bounds clamp to the valid prefix, so a real key equal to
    the sentinel never matches padding."""
    info = torch.finfo(rk.dtype) if rk.dtype.is_floating_point else torch.iinfo(rk.dtype)
    rk_eff = torch.where(rvalid, rk, torch.full_like(rk, info.max))
    order = kernels.lex_sort_indices([rk_eff, (~rvalid).to(torch.int32)])
    n_valid = int(rvalid.sum())
    rk_sorted = rk_eff[order]
    rval_sorted = torch.where(rvalid[order], rval[order], torch.zeros_like(rval))
    prefix = torch.cat([rval_sorted.new_zeros(1), torch.cumsum(rval_sorted, 0)])
    probe, lkk = kernels.same_dtype(rk_sorted, lk)
    lo = torch.clamp(torch.searchsorted(probe, lkk, side="left"), max=n_valid)
    hi = torch.clamp(torch.searchsorted(probe, lkk, side="right"), max=n_valid)
    counts = torch.where(lvalid, (hi - lo).to(torch.int64), torch.zeros_like(lo))
    pair_count = ax.psum(counts.sum())
    left_sum = ax.psum(_fsum(counts.to(lval.dtype) * torch.where(lvalid, lval,
                                                                torch.zeros_like(lval))))
    seg = prefix[hi] - prefix[lo]
    right_sum = ax.psum(_fsum(torch.where(lvalid, seg, torch.zeros_like(seg))))
    return pair_count, left_sum, right_sum


def _check_non_null(what: str, tables_cols) -> None:
    for tables, cols in tables_cols:
        for t in tables:
            for c in cols:
                if t.column(c).validity is not None:
                    raise HyperspaceException(
                        f"{what}: nullable column '{c}' not supported yet (SQL null-key "
                        "semantics)")


def _join_agg(mesh, left, left_valid, right, right_valid, key, left_value, right_value,
              filt=None, counts=None):
    def per_device(ax, lt, lv, rt, rv):
        lvalid = lv
        if filt is not None:
            col, lo, hi, lo_incl, hi_incl = filt
            lvalid = lvalid & _range_mask(lt.column(col).data, lo, hi, lo_incl, hi_incl)
        return _merge_join_agg_body(ax, lt.column(key).data, lvalid,
                                    lt.column(left_value).data, rt.column(key).data, rv,
                                    rt.column(right_value).data)

    # The JAX package's "join-agg" / "join-filter-agg" programs, their
    # shape vectors over the key, validity and value columns they take.
    def cols(tables, name):
        return [t.column(name).data for t in tables]

    leaves = [cols(left, key), list(left_valid), cols(left, left_value)]
    if filt is not None:
        leaves.append(cols(left, filt[0]))
    leaves += [cols(right, key), list(right_valid), cols(right, right_value)]
    shape_vec = shape_vector(leaves, ("sharded",) * len(leaves))
    if filt is None:
        launch = bank_program("join-agg", mesh, (), shape_vec)
    else:
        launch = bank_program("join-filter-agg", mesh, (filt[3], filt[4]), shape_vec)
    count, lsum, rsum = launch(
        per_device, mesh, ("sharded",) * 4, counts)(left, left_valid, right, right_valid)[0]
    return int(count), lsum.item(), rsum.item()


def distributed_join_agg(left: Sequence[Table], left_valid: Sequence[torch.Tensor],
                         right: Sequence[Table], right_valid: Sequence[torch.Tensor],
                         key: str, left_value: str, right_value: str,
                         mesh: Optional[Mesh] = None, counts: Optional[Dict[str, int]] = None):
    """The inner-join aggregate of two co-bucketed sharded tables:
    (pair count, sum of left_value over pairs, sum of right_value over
    pairs), with no row moving between devices."""
    mesh = mesh or make_mesh()
    _check_non_null("distributed_join_agg", ((left, (key, left_value)),
                                             (right, (key, right_value))))
    return _join_agg(mesh, left, left_valid, right, right_valid, key, left_value,
                     right_value, counts=counts)


def distributed_join_filter_agg(left: Sequence[Table], left_valid: Sequence[torch.Tensor],
                                right: Sequence[Table], right_valid: Sequence[torch.Tensor],
                                key: str, left_value: str, right_value: str,
                                filter_col: str, lo, hi, mesh: Optional[Mesh] = None,
                                lo_incl: bool = True, hi_incl: bool = True,
                                counts: Optional[Dict[str, int]] = None):
    """``distributed_join_agg`` over the join pairs whose stream row passes
    ``lo <(=) filter_col <(=) hi``: the filter folds into the stream's
    mask before the merge, in the same one program."""
    mesh = mesh or make_mesh()
    _check_non_null("distributed_join_filter_agg",
                    ((left, (key, left_value, filter_col)), (right, (key, right_value))))
    return _join_agg(mesh, left, left_valid, right, right_valid, key, left_value,
                     right_value, filt=(filter_col, lo, hi, lo_incl, hi_incl), counts=counts)


def join_agg_collectives(left, left_valid, right, right_valid, key: str, left_value: str,
                         right_value: str, mesh: Optional[Mesh] = None) -> Dict[str, int]:
    """The collectives of the co-bucketed join-aggregate program for these
    inputs: only all-reduces (the shuffle-free property)."""
    counts: Dict[str, int] = {}
    distributed_join_agg(left, left_valid, right, right_valid, key, left_value,
                         right_value, mesh=mesh, counts=counts)
    return collective_counts(counts)


def join_filter_agg_collectives(left, left_valid, right, right_valid, key: str,
                                left_value: str, right_value: str, filter_col: str, lo, hi,
                                mesh: Optional[Mesh] = None, lo_incl: bool = True,
                                hi_incl: bool = True) -> Dict[str, int]:
    """The collectives of the fused join+filter+aggregate program."""
    counts: Dict[str, int] = {}
    distributed_join_filter_agg(left, left_valid, right, right_valid, key, left_value,
                                right_value, filter_col, lo, hi, mesh=mesh, lo_incl=lo_incl,
                                hi_incl=hi_incl, counts=counts)
    return collective_counts(counts)
