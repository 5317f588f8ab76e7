"""Data-skipping sketch builders: per-source-file MinMax, BloomFilter and
value list (counterpart of ``hyperspace_tpu/ops/sketches.py``).

The sketches are one-pass device reductions over one file's column: the
MinMax sketch runs the masked_minmax kernel over 32-bit columns
(ops/cuda_kernels.py) and plain torch over 64-bit ones; the Bloom sketch
hashes every value with the same murmur-style hash the bucket exchange
uses (ops/kernels.py), derives k probe positions by double hashing and
scatters them into a bit array on the device. Probing at plan time is
host-side (native/): one literal against one row per file is
no work worth a device round trip.

There is no shape-class padding here (the JAX package pads each file's
column to a length class so that files share one compiled program): a
column is reduced at its own length, and the MinMax sketch takes the
length class into account only where it changes the result (the
sentinels that padded rows bring in, ``shapes.padded_length``).
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..execution.columnar import Column
from ..schema import DATE, STRING
from ..shapes import padded_length
from . import cuda_kernels, kernels

# Second hash for double hashing: mix of the first with a golden-ratio salt
# (device and host mirrors must match bit-for-bit).
_SALT = 0x9E3779B9
_EPOCH = datetime.date(1970, 1, 1)
# Weights of the 8 bits of a byte, most significant first (np.packbits).
_BIT_WEIGHTS = [128, 64, 32, 16, 8, 4, 2, 1]


def _h2_host(h1: int) -> int:
    return kernels._fmix32_host(h1 ^ _SALT)


def bloom_parameters(expected_items: int, fpp: float) -> Tuple[int, int]:
    """Classic (num_bits, num_hashes) sizing for a target false-positive
    rate. Bits are rounded up to a byte multiple for packing."""
    if not (0.0 < fpp < 1.0):
        raise HyperspaceException(f"fpp must be in (0, 1); got {fpp}")
    n = max(int(expected_items), 1)
    m = max(8, int(math.ceil(-n * math.log(fpp) / (math.log(2) ** 2))))
    m = ((m + 7) // 8) * 8
    k = max(1, int(round(m / n * math.log(2))))
    return m, k


def to_host(t: torch.Tensor) -> np.ndarray:
    """The sketch build's one device->host crossing per result."""
    return t.cpu().numpy()


def bloom_build(col: Column, num_bits: int, num_hashes: int) -> np.ndarray:
    """Build a bloom bitset over the column's valid values on the device.
    Returns the packed bits (most significant bit first) as host uint8,
    num_bits/8 bytes."""
    return to_host(bloom_bits(col, num_bits, num_hashes))


def bloom_bits(col: Column, num_bits: int, num_hashes: int) -> torch.Tensor:
    """bloom_build's device part: the packed bitset as a uint8 tensor on
    the column's device. Null rows scatter onto an overflow bit that is
    sliced away."""
    device = col.data.device
    h1 = kernels.u32(kernels.hash32_values(col.data, col.dtype, col.dictionary))
    h2 = kernels.fmix32(h1 ^ _SALT)
    i = torch.arange(num_hashes, dtype=torch.int64, device=device)[:, None]
    # Wrapping u32 arithmetic: i < 2**31 and h2 < 2**32, so the int64
    # product cannot overflow before the mask.
    pos = ((h1[None, :] + i * h2[None, :]) & kernels.M32) % num_bits
    if col.validity is not None:
        pos = torch.where(col.validity[None, :], pos, num_bits)
    bits = torch.zeros(num_bits + 1, dtype=torch.bool, device=device)
    bits[pos.reshape(-1)] = True
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=device)
    packed = (bits[:num_bits].view(-1, 8).to(torch.int32) * weights).sum(1)
    return packed.to(torch.uint8)


def bloom_might_contain(packed: np.ndarray, value, dtype: str,
                        num_bits: int, num_hashes: int) -> bool:
    """Host-side membership probe for one literal (mirrors bloom_build)."""
    h1 = kernels.hash32_value_host(value, dtype)
    h2 = _h2_host(h1)
    bits = np.unpackbits(np.frombuffer(packed, dtype=np.uint8), count=num_bits)
    for i in range(num_hashes):
        # Mirror the device's wrapping uint32 arithmetic exactly.
        if not bits[((h1 + i * h2) & 0xFFFFFFFF) % num_bits]:
            return False
    return True


def value_list(col: Column, max_values: int) -> Optional[list]:
    """Sorted distinct valid values of the column as host python objects,
    or None when cardinality exceeds ``max_values`` (the sketch degrades
    to "no information" for that file -- it must never prune wrongly)."""
    data = to_host(col.data)
    if col.validity is not None:
        data = data[to_host(col.validity)]
    if data.size == 0:
        return []
    uniq = np.unique(data)
    if uniq.size > max_values:
        return None
    if col.dtype == STRING:
        return [str(col.dictionary[int(c)]) for c in uniq]
    if col.dtype == DATE:
        return [_EPOCH + datetime.timedelta(days=int(d)) for d in uniq]
    return [v.item() for v in uniq]


def minmax_values(col: Column) -> Tuple[Optional[object], Optional[object]]:
    """(min, max) of the column's valid values as host python objects in the
    column's logical domain (dates as datetime.date, strings as str).
    Returns (None, None) when the column is empty or every row is null.

    32-bit columns (int32, float32, dates, string codes) run the
    masked_minmax kernel, with the validity as its mask only when the
    column has nulls; 64-bit columns take the plain path with the same
    semantics. The sentinels enter where the JAX package's would: when the
    column is shorter than its length class, or (32-bit columns, which the
    JAX package reduces with its Pallas kernel) not a multiple of that
    kernel's block. One device->host copy per call, of the kernel's output
    words (min, max, any row valid)."""
    n = len(col)
    if n == 0:
        return None, None
    data, valid = col.data, col.validity
    pad = padded_length(n) != n
    if data.dtype in (torch.int32, torch.float32):
        words = cuda_kernels.masked_minmax_words(
            data, valid, pad or cuda_kernels.pallas_pads(n))
    else:
        words = cuda_kernels.masked_minmax_words_plain(data, valid, pad)
    raw = to_host(words)
    if valid is not None and not raw.view(f"i{raw.itemsize}")[2]:
        return None, None
    mn, mx = raw[0], raw[1]
    if col.dtype == STRING:
        return str(col.dictionary[int(mn)]), str(col.dictionary[int(mx)])
    if col.dtype == DATE:
        return (_EPOCH + datetime.timedelta(days=int(mn)),
                _EPOCH + datetime.timedelta(days=int(mx)))
    return mn.item(), mx.item()
