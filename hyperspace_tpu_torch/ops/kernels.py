"""Plain torch compute ops the engine is built from (counterpart of
``hyperspace_tpu/ops/kernels.py``, trimmed to hashing, sorting, the filter
front end, the merge join and the segment aggregates).

uint32 arithmetic: torch has no ``>>``, ``<<``, ``+`` or ``%`` for
``torch.uint32``, so a 32-bit word travels as an ``int32`` tensor holding
its bit pattern ("words"), and the arithmetic runs in int64 on values in
``[0, 2**32)`` masked with ``& 0xFFFFFFFF``. Products are split so that no
int64 multiply overflows.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..schema import BOOL, DATE, FLOAT32, FLOAT64, INT32, INT64, STRING

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & M32


def to_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns (exact, no
    reliance on a wrapping narrowing cast)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for a in [0, 2**32) and a constant c < 2**32."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over int64-held u32 values."""
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _fold_u64(u: torch.Tensor) -> torch.Tensor:
    """lo ^ (hi * GOLDEN) of an int64 tensor's bits. ``>> 32`` of a negative
    int64 is arithmetic, so the high word is masked to make it logical."""
    lo = u & M32
    hi = (u >> 32) & M32
    return to_words(lo ^ mul32(hi, GOLDEN))


def fold_u32(data: torch.Tensor, dtype: str,
             dictionary: Optional[np.ndarray] = None) -> torch.Tensor:
    """Value-stable fold of a column into pre-avalanche u32 words (int32
    bit patterns). The hash+bucket kernel applies the murmur finalizer to
    exactly these words, as the JAX package's Pallas kernel does."""
    if dtype == STRING:
        if dictionary is None:
            raise HyperspaceException("hash32 of string column requires dictionary")
        crcs = np.array([zlib.crc32(s.encode("utf-8")) for s in dictionary],
                        dtype=np.uint32) if len(dictionary) else np.zeros(1, np.uint32)
        table = torch.from_numpy(crcs.view(np.int32)).to(data.device)
        return table[data.clamp(0, max(len(dictionary) - 1, 0)).to(torch.int64)]
    if dtype in (INT32, DATE):
        return data
    if dtype == BOOL:
        return data.to(torch.int32)
    if dtype == INT64:
        return _fold_u64(data)
    if dtype == FLOAT32:
        return data.view(torch.int32)
    if dtype == FLOAT64:
        return _fold_u64(data.view(torch.int64))
    raise HyperspaceException(f"Cannot hash dtype {dtype}")


def hash32_values(data: torch.Tensor, dtype: str,
                  dictionary: Optional[np.ndarray] = None) -> torch.Tensor:
    """Stable 32-bit hash of a column's values (int32 bit patterns)."""
    return to_words(fmix32(u32(fold_u32(data, dtype, dictionary))))


def hash_combine(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Boost-style combiner over u32 words."""
    a, b = u32(h1), u32(h2)
    return to_words(a ^ ((b + GOLDEN + ((a << 6) & M32) + (a >> 2)) & M32))


def bucket_ids(hashes: torch.Tensor, num_buckets: int) -> torch.Tensor:
    return (u32(hashes) % num_buckets).to(torch.int32)


def _fmix32_host(x: int) -> int:
    """Host mirror of fmix32 for single literals (bucket pruning)."""
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x


def hash_combine_host(h1: int, h2: int) -> int:
    """Host mirror of hash_combine."""
    return (h1 ^ ((h2 + GOLDEN + ((h1 << 6) & M32) + (h1 >> 2)) & M32)) & M32


def hash32_value_host(value, dtype: str) -> int:
    """Host-side hash of one literal, identical to hash32_values on device.
    Used to compute the bucket a literal lands in (bucket pruning)."""
    if dtype == STRING:
        return _fmix32_host(zlib.crc32(str(value).encode("utf-8")))
    if dtype in (INT32, DATE, BOOL):
        return _fmix32_host(int(value) & M32)
    if dtype == INT64:
        u = int(value) & 0xFFFFFFFFFFFFFFFF
        lo, hi = u & M32, u >> 32
        return _fmix32_host((lo ^ ((hi * GOLDEN) & M32)) & M32)
    if dtype == FLOAT32:
        return _fmix32_host(struct.unpack("<I", struct.pack("<f", float(value)))[0])
    if dtype == FLOAT64:
        bits = struct.unpack("<Q", struct.pack("<d", float(value)))[0]
        lo, hi = bits & M32, bits >> 32
        return _fmix32_host((lo ^ ((hi * GOLDEN) & M32)) & M32)
    raise HyperspaceException(f"Cannot hash dtype {dtype}")


def _sort_key_view(data: torch.Tensor, ascending: bool) -> torch.Tensor:
    """The key an ascending sort orders in the requested direction: a
    descending key is negated (not sorted with ``descending=True``), as in
    the JAX package, so NaN still sorts last, -0.0 and 0.0 still tie, and
    the integer minimum wraps to itself and sorts first."""
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    return data if ascending else -data


def lex_sort_indices(keys: Sequence[torch.Tensor],
                     ascending: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Indices that stably sort by keys[0], then keys[1], ... (each
    ascending unless ``ascending`` says otherwise): chained stable sorts,
    last key first. Floats order as the JAX package's sort does: -0.0 ties
    0.0 and NaN sorts last."""
    if ascending is None:
        ascending = [True] * len(keys)
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k, asc in reversed(list(zip(keys, ascending))):
        perm = perm[torch.sort(_sort_key_view(k, asc)[perm], stable=True).indices]
    return perm


# ---------------------------------------------------------------------------
# Merge join over sorted keys.
# ---------------------------------------------------------------------------

def same_dtype(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in their promoted dtype (searchsorted takes one)."""
    if a.dtype == b.dtype:
        return a, b
    wide = torch.promote_types(a.dtype, b.dtype)
    return a.to(wide), b.to(wide)


def merge_join_indices(left_keys: torch.Tensor, right_keys_sorted: torch.Tensor,
                       return_counts: bool = False):
    """Inner equi-join: (left_idx, right_idx) gather indices of every
    (left row, matching right row) pair, ascending by left row and, within
    one, by right row, and with ``return_counts`` each left row's match
    count (an outer join pads the rows with none). ``right_keys_sorted``
    must be ascending. One host sync, for the output length."""
    left_keys, right_keys_sorted = same_dtype(left_keys, right_keys_sorted)
    lo = torch.searchsorted(right_keys_sorted, left_keys, side="left")
    counts = torch.searchsorted(right_keys_sorted, left_keys, side="right") - lo
    total = int(counts.sum())  # HOST SYNC (single scalar).
    li, ri = _expand_matches(counts, lo, total)
    return (li, ri, counts) if return_counts else (li, ri)


def _expand_matches(counts: torch.Tensor, lo: torch.Tensor, total: int):
    dev = counts.device
    left_idx = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts,
                                       output_size=total)
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts,
                                     output_size=total)
    right_idx = torch.repeat_interleave(lo, counts, output_size=total) \
        + (torch.arange(total, device=dev) - starts)
    return left_idx, right_idx


def pack2_int32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two int32 key columns packed into one int64 key that orders as (a,
    b) does: ``b`` is sign-biased (XOR 0x80000000) into the low word."""
    b_biased = (b.to(torch.int64) ^ 0x80000000) & M32
    return (a.to(torch.int64) << 32) | b_biased


def bucket_composite_keys(keys: torch.Tensor, dtype: str, num_buckets: int):
    """(bucket << 32 | biased key) probe keys for the shuffle-free merge
    join, which order as a covering index's rows do, and for int64 keys a
    0-d bool tensor, whether every key lies in (-2**31, 2**31), where the
    packing is exact (None for narrower keys). The JAX package tests the
    largest |key| instead, which misses the int64 minimum (its absolute
    value wraps to itself). The bucket ids come from the hash+bucket
    kernel."""
    from . import cuda_kernels
    _, bids = cuda_kernels.hash_bucket([fold_u32(keys, dtype).contiguous()], num_buckets)
    comp = pack2_int32(bids, keys.to(torch.int32))
    fits = None
    if keys.dtype == torch.int64 and keys.shape[0]:
        fits = (keys.max() < 2 ** 31) & (keys.min() > -2 ** 31)
    return comp, fits


def change_mask(sorted_keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where a row's key tuple differs from the previous row's (rows
    sorted by the keys); row 0 is False."""
    change = torch.zeros(sorted_keys[0].shape[0], dtype=torch.bool,
                         device=sorted_keys[0].device)
    for k in sorted_keys:
        change[1:] |= k[1:] != k[:-1]
    return change


def dense_rank(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Dense int32 rank of each row's key tuple in lexicographic order:
    equal tuples get equal ranks, so a multi-column equi-join becomes a
    join on one rank column. No host sync."""
    n = keys[0].shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=keys[0].device)
    if n:
        order = lex_sort_indices(keys)
        out[order] = torch.cumsum(change_mask([k[order] for k in keys]), 0).to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# Grouping and segment aggregates over rows sorted by group.
#
# Group ids are ascending and contiguous (0, 0, 1, 2, 2, ...), as
# group_ids_from_sorted makes them. A float sum adds each segment's values
# one by one in row order, starting from 0.0: the order in which the JAX
# package's scatter-add accumulates on the CPU, so float64 sums equal its
# bit for bit. torch.segment_reduce over an (n, 1) view runs one thread
# per segment in that order on the card too, so a query gives the same
# bytes on every run (index_add_ and scatter_add_ use float atomics, whose
# order changes from run to run). Integer sums, counts, min and max do not
# depend on the order.
# ---------------------------------------------------------------------------

def group_ids_from_sorted(keys: Sequence[torch.Tensor]):
    """(int64 group id per row, number of groups) for rows sorted by
    ``keys``. One host sync, for the group count."""
    if keys[0].shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=keys[0].device), 0
    gids = torch.cumsum(change_mask(keys), 0)
    return gids, int(gids[-1]) + 1  # HOST SYNC (single scalar).


def segment_offsets(gids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Start of each segment, and the row count last: int64[num_groups + 1]."""
    return torch.searchsorted(gids, torch.arange(num_groups + 1, device=gids.device))


def _segment_float(data: torch.Tensor, gids: torch.Tensor, num_groups: int,
                   reduce: str) -> torch.Tensor:
    # unsafe: the offsets are valid by construction, and the checks of
    # the safe call would read them back on the host.
    return torch.segment_reduce(data.reshape(-1, 1), reduce,
                                offsets=segment_offsets(gids, num_groups),
                                axis=0, unsafe=True).reshape(-1)


def segment_sum(data: torch.Tensor, gids: torch.Tensor, num_groups: int) -> torch.Tensor:
    if data.is_floating_point():
        return _segment_float(data, gids, num_groups, "sum")
    return torch.zeros(num_groups, dtype=data.dtype, device=data.device) \
        .index_add_(0, gids, data)


def _segment_minmax(data: torch.Tensor, gids: torch.Tensor, num_groups: int,
                    op: str) -> torch.Tensor:
    if data.is_floating_point():
        return _segment_float(data, gids, num_groups, op)
    # Seeded with the dtype's far end, so a segment with no rows holds it,
    # as the reference's staged path gives.
    return torch.full((num_groups,), _sentinel(data.dtype, op == "min"), dtype=data.dtype,
                      device=data.device).scatter_reduce_(
        0, gids, data, "amin" if op == "min" else "amax", include_self=True)


def segment_min(data: torch.Tensor, gids: torch.Tensor, num_groups: int) -> torch.Tensor:
    return _segment_minmax(data, gids, num_groups, "min")


def segment_max(data: torch.Tensor, gids: torch.Tensor, num_groups: int) -> torch.Tensor:
    return _segment_minmax(data, gids, num_groups, "max")


def segment_first_index(gids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Index of each segment's first row."""
    return segment_offsets(gids, num_groups)[:-1]


def segment_last_index(gids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Index of each segment's last row."""
    return segment_offsets(gids, num_groups)[1:] - 1


def segment_count(gids: torch.Tensor, num_groups: int,
                  validity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 rows (or valid rows) per segment."""
    if validity is None:
        return torch.diff(segment_offsets(gids, num_groups))
    return segment_sum(validity.to(torch.int64), gids, num_groups)


def _sentinel(dtype: torch.dtype, largest: bool):
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.max if largest else info.min


def segment_agg(data: torch.Tensor, validity: Optional[torch.Tensor], gids: torch.Tensor,
                num_groups: int, op: str, widen: bool = True):
    """Null-aware per-segment "sum", "mean", "min" or "max": (value,
    per-segment valid counts, or None when there is no validity and op is
    not a mean). Sums and means widen floats to float64 and integers to
    int64; invalid rows add zero, and min/max see them as the dtype's
    far end."""
    counts = None
    if validity is not None or op == "mean":
        counts = segment_count(gids, num_groups, validity)
    if op in ("sum", "mean"):
        acc = data
        if widen:
            acc = data.to(torch.float64 if data.is_floating_point() else torch.int64)
        if validity is not None:
            acc = torch.where(validity, acc, torch.zeros((), dtype=acc.dtype, device=acc.device))
        sums = segment_sum(acc, gids, num_groups)
        if op == "sum":
            return sums, counts
        return sums.to(torch.float64) / counts.clamp(min=1).to(torch.float64), counts
    if validity is not None:
        data = torch.where(validity, data, torch.full(
            (), _sentinel(data.dtype, op == "min"), dtype=data.dtype, device=data.device))
    return _segment_minmax(data, gids, num_groups, op), counts


def segment_heads(gids: torch.Tensor, arrays: Sequence[torch.Tensor], num_groups: int):
    """Each segment's first row's value, for every array."""
    firsts = segment_offsets(gids, num_groups)[:-1]
    return [a[firsts] for a in arrays]


def gather_segment(partial: torch.Tensor, order: torch.Tensor, gids: torch.Tensor,
                   num_groups: int, op: str) -> torch.Tensor:
    """The two-phase aggregate's combine: ``partial`` gathered through
    ``order``, then reduced per segment ("sum", "min" or "max")."""
    taken = partial[order]
    if op == "sum":
        return segment_sum(taken, gids, num_groups)
    return _segment_minmax(taken, gids, num_groups, op)


def isin_sorted(data: torch.Tensor, sorted_values: torch.Tensor) -> torch.Tensor:
    """Membership of each ``data`` value in the ascending ``sorted_values``
    (the lineage anti-filter of deleted source files, semi and anti joins)."""
    if sorted_values.shape[0] == 0:
        return torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    pos = torch.searchsorted(sorted_values, data).clamp(0, sorted_values.shape[0] - 1)
    return sorted_values[pos] == data


def filter_indices(mask: torch.Tensor) -> torch.Tensor:
    """Row indices of a keep mask's True entries (the nonzero/gather front
    end of the JAX package's mask_count_nonzero; one host sync for the
    survivor count)."""
    return torch.nonzero(mask).flatten()


def kleene_and_or(ld, lv, rd, rv, is_and: bool):
    """Kleene 3-valued AND/OR (TRUE OR NULL = TRUE, FALSE AND NULL =
    FALSE). ``lv``/``rv`` may be None (all-valid side). Returns
    (true, known)."""
    lt = ld if lv is None else lv & ld
    lf = ~ld if lv is None else lv & ~ld
    rt = rd if rv is None else rv & rd
    rf = ~rd if rv is None else rv & ~rd
    if is_and:
        true, false = lt & rt, lf | rf
    else:
        true, false = lt | rt, lf & rf
    return true, true | false


# ---------------------------------------------------------------------------
# Segmented running aggregates.
# ---------------------------------------------------------------------------

def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.empty(even.shape[0] + odd.shape[0], dtype=even.dtype, device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(combine, elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan of ``combine`` over the rows of ``elems``, combined
    in the tree order of ``jax.lax.associative_scan``: adjacent pairs are
    combined, the halved sequence is scanned recursively, and the even
    rows are combined from it. A running float sum therefore rounds as the
    JAX package's does, where ``torch.cumsum`` (left to right) would not."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:n - 1:2] for e in elems], [e[1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    tails = [e[2::2] for e in elems]
    if n % 2 == 0:
        even = combine([e[:-1] for e in odd], tails)
    else:
        even = combine(odd, tails)
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def segmented_scan(data: torch.Tensor, seg_start: torch.Tensor, op) -> torch.Tensor:
    """Inclusive running ``op`` within segments of rows sorted by segment:
    ``seg_start`` marks each segment's first row, where the accumulator
    restarts."""
    def combine(a, b):
        af, av = a
        bf, bv = b
        return [af | bf, torch.where(bf, bv, op(av, bv))]

    return associative_scan(combine, [seg_start, data])[1]
