"""Plain torch compute ops the engine is built from (counterpart of
``hyperspace_tpu/ops/kernels.py``, trimmed to hashing, sorting and the
filter front end).

uint32 arithmetic: torch has no ``>>``, ``<<``, ``+`` or ``%`` for
``torch.uint32``, so a 32-bit word travels as an ``int32`` tensor holding
its bit pattern ("words"), and the arithmetic runs in int64 on values in
``[0, 2**32)`` masked with ``& 0xFFFFFFFF``. Products are split so that no
int64 multiply overflows.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

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


def lex_sort_indices(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Indices that stably sort by keys[0], then keys[1], ... (ascending):
    chained stable sorts, last key first. Floats order as the JAX
    package's sort does: -0.0 ties 0.0 and NaN sorts last."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


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
