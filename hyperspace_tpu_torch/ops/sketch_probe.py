"""Host-side sketch probes: one literal against every file's sketch row
(counterpart of the numpy probe in ``hyperspace_tpu/native/__init__.py``,
which the JAX package runs by default).

The sketch tables hold one row per source file, so a probe is a few
vectorised numpy comparisons over arrays of at most a few thousand
entries. The arrays are assembled once per sketch table (``prepare_*``)
and cached beside it by the data-skipping rule; each literal is then
probed in microseconds.

The JAX package also carries a C++ version of these loops, behind
``HST_NATIVE_PROBE=on`` and off by default (numpy measured faster there at
every lake size it could generate). It is host code, not a TPU kernel, and
is not ported yet.
"""

from __future__ import annotations

import datetime
import math
from typing import List, Optional, Tuple

import numpy as np

from ..schema import BOOL, DATE, FLOAT32, FLOAT64, INT32, INT64
from . import kernels
from .sketches import _h2_host

_OPS = {"EqualTo": 0, "LessThan": 1, "LessThanOrEqual": 2,
        "GreaterThan": 3, "GreaterThanOrEqual": 4}

_I64_MAX = 2 ** 63 - 1
_I64_MIN = -(2 ** 63)
_EPOCH = datetime.date(1970, 1, 1)


# ---------------------------------------------------------------------------
# Bloom probe: one literal vs many per-file bitsets.
# ---------------------------------------------------------------------------

def bloom_positions(value, dtype: str, num_bits: int, num_hashes: int) -> np.ndarray:
    """The literal's k probe positions, mirroring ops/sketches.py double
    hashing (wrapping uint32 arithmetic)."""
    h1 = kernels.hash32_value_host(value, dtype)
    h2 = _h2_host(h1)
    return np.array([((h1 + i * h2) & 0xFFFFFFFF) % num_bits
                     for i in range(num_hashes)], dtype=np.int32)


def prepare_bloom(bits_rows: List[Optional[bytes]],
                  num_bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """The per-file bitset matrix (one row of num_bits/8 bytes per file)
    and a flag per file that has a bitset."""
    n = len(bits_rows)
    stride = num_bits // 8
    buf = np.zeros((n, stride), dtype=np.uint8)
    valid = np.zeros(n, dtype=np.uint8)
    for i, b in enumerate(bits_rows):
        if b is not None:
            row = np.frombuffer(b, dtype=np.uint8)
            buf[i, :row.shape[0]] = row[:stride]
            valid[i] = 1
    return buf, valid


def bloom_probe_prepared(buf: np.ndarray, valid: np.ndarray, value, dtype: str,
                         num_bits: int, num_hashes: int) -> np.ndarray:
    """Keep-mask over files from a prepare_bloom matrix: False where the
    bitset proves the literal absent; files without a bitset are kept."""
    keep = np.ones(buf.shape[0], dtype=bool)
    for p in bloom_positions(value, dtype, num_bits, num_hashes):
        byte = buf[:, p >> 3]
        keep &= ((byte >> (7 - (p & 7))) & 1).astype(bool)
    return keep | ~valid.astype(bool)


# ---------------------------------------------------------------------------
# MinMax prune: one comparison vs many per-file (min, max) rows.
# ---------------------------------------------------------------------------

def _int_domain_literal(op: str, value):
    """Rewrite ``col <op> value`` for an integer-domain column into an exact
    int64 form. Returns one of:

    - (op, int_value): the (possibly transformed) comparison;
    - ("ALL", None): the predicate keeps every file;
    - ("NONE", None): no stats-backed file can match (all-null files are
      still kept by the caller -- only IS NULL matches them).

    Handles fractional float literals (col < 5.5 <=> col <= 5) and literals
    outside the int64 range."""
    if isinstance(value, float):
        if math.isnan(value):
            return "NONE", None
        if math.isinf(value):
            up = value > 0
            keep_all = (op in ("LessThan", "LessThanOrEqual")) == up
            return ("ALL", None) if keep_all else ("NONE", None)
        if not float(value).is_integer():
            if op == "EqualTo":
                return "NONE", None  # no integer equals a fractional.
            if op in ("LessThan", "LessThanOrEqual"):
                bound = math.floor(value)           # col <= floor(v)
                if bound > _I64_MAX:
                    return "ALL", None
                if bound < _I64_MIN:
                    return "NONE", None
                return "LessThanOrEqual", bound
            bound = math.floor(value) + 1           # col >= floor(v)+1
            if bound < _I64_MIN:
                return "ALL", None
            if bound > _I64_MAX:
                return "NONE", None
            return "GreaterThanOrEqual", bound
    v = int(value)
    if v > _I64_MAX:
        return ("ALL", None) if op in ("LessThan", "LessThanOrEqual") \
            else ("NONE", None)
    if v < _I64_MIN:
        return ("ALL", None) if op in ("GreaterThan", "GreaterThanOrEqual") \
            else ("NONE", None)
    return op, v


def prepare_minmax(lo_rows: List, hi_rows: List, dtype: str) -> Optional[Tuple]:
    """The per-file (min, max) pylists as probe-ready numpy arrays:
    (lo, hi, has), int64 for integer domains (dates as days), float64 for
    floats; None for dtypes without an array form (strings)."""
    n = len(lo_rows)
    has = np.array([lo is not None and hi is not None
                    for lo, hi in zip(lo_rows, hi_rows)], dtype=np.uint8)

    def fill(rows, np_dtype, conv):
        a = np.zeros(n, dtype=np_dtype)
        for i, r in enumerate(rows):
            if has[i]:
                a[i] = conv(r)
        return a

    if dtype in (INT32, INT64, BOOL, DATE):
        conv = (lambda v: (v - _EPOCH).days) if dtype == DATE else int
        return fill(lo_rows, np.int64, conv), fill(hi_rows, np.int64, conv), has
    if dtype in (FLOAT32, FLOAT64):
        return fill(lo_rows, np.float64, float), fill(hi_rows, np.float64, float), has
    return None


def minmax_prune_prepared(prep: Tuple, op: str, value, dtype: str) -> np.ndarray:
    """Keep-mask from a prepare_minmax triple for ``col <op> value``."""
    lo, hi, has = prep
    n = lo.shape[0]
    if dtype in (FLOAT32, FLOAT64):
        try:
            v = float(value)
        except OverflowError:
            v = math.inf if value > 0 else -math.inf
        if math.isnan(v):
            return ~has.astype(bool)
        return _np_prune(lo, hi, has, v, _OPS[op])
    if dtype == DATE:
        v = (value - _EPOCH).days
    else:
        op, v = _int_domain_literal(op, value)
        if op == "ALL":
            return np.ones(n, dtype=bool)
        if op == "NONE":
            return ~has.astype(bool)  # only all-null files survive.
    return _np_prune(lo, hi, has, v, _OPS[op])


def _np_prune(lo, hi, has, v, op_code) -> np.ndarray:
    if op_code == 0:
        keep = (lo <= v) & (v <= hi)
    elif op_code == 1:
        keep = lo < v
    elif op_code == 2:
        keep = lo <= v
    elif op_code == 3:
        keep = hi > v
    else:
        keep = hi >= v
    return keep | ~has.astype(bool)
