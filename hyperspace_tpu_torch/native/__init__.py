"""Native host runtime: builds ``hst_native.cpp`` with ``g++`` and binds it
with ``ctypes`` (counterpart of ``hyperspace_tpu/native/__init__.py``, the
same entry points and argument types).

The shared library is compiled once per source hash into
``hyperspace_tpu_torch/_build/native/`` (``g++ -O3 -shared -fPIC
-std=c++17``) at first use. A failed build raises
:class:`NativeBuildError` with the compiler's output: there is no switch
that turns the library off and no quiet fallback to Python.

Entry points (host-side loops of scan planning and of the avro reader):

- ``avro_decode_block``: one C++ pass over an avro block, which
  ``util/avro.read_avro`` takes for every block. The row-by-row Python
  decoder stays in ``util/avro.py`` as the plain version the tests hold
  this one to.
- ``bloom_probe_prepared`` / ``minmax_prune_prepared``: one literal
  against every file's sketch row. Their numpy form is the default; the
  C++ loops run only under ``HST_NATIVE_PROBE`` (``probe_native_enabled``),
  with the JAX package's defaults: ``off``; ``on`` from
  ``HST_NATIVE_PROBE_MIN_FILES`` (100,000) files up; ``force`` always.
"""

from __future__ import annotations

import ctypes
import datetime
import hashlib
import math
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..exceptions import HyperspaceException
from ..schema import BOOL, DATE, FLOAT32, FLOAT64, INT32, INT64

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hst_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build", "native")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class NativeBuildError(HyperspaceException):
    """``g++`` failed to build the native library (the message holds its
    output), or the built library did not load."""


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(_SRC, "rb") as f:
        tag = hashlib.md5(" ".join(GXX_FLAGS).encode() + b"\0" + f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"hst_native_{tag}.so")


def _build() -> ctypes.CDLL:
    so_path = library_path()
    if not os.path.isfile(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeBuildError(f"native build failed: {' '.join(cmd)}: {e}") from e
        if p.returncode != 0:
            raise NativeBuildError(f"native build failed (rc={p.returncode}): "
                                   f"{' '.join(cmd)}\n{p.stdout}{p.stderr}")
        os.replace(tmp, so_path)  # atomic: concurrent builders converge.
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as e:
        raise NativeBuildError(f"native library {so_path} did not load: {e}") from e
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.hst_bloom_probe_many.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, u8p, i32p, ctypes.c_int32, u8p]
    lib.hst_bloom_probe_many.restype = None
    lib.hst_minmax_prune_f64.argtypes = [
        f64p, f64p, u8p, ctypes.c_int64, ctypes.c_double, ctypes.c_int32, u8p]
    lib.hst_minmax_prune_f64.restype = None
    lib.hst_minmax_prune_i64.argtypes = [
        i64p, i64p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, u8p]
    lib.hst_minmax_prune_i64.restype = None
    lib.hst_avro_decode_block.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i32p,
        ctypes.POINTER(i64p), ctypes.POINTER(f64p), ctypes.POINTER(i32p),
        ctypes.POINTER(u8p), i64p, ctypes.POINTER(u8p)]
    lib.hst_avro_decode_block.restype = ctypes.c_int64
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises NativeBuildError."""
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                _lib = _build()
    return _lib


def probe_min_files() -> int:
    """File count below which ``HST_NATIVE_PROBE=on`` keeps the numpy
    probe (the JAX package measured numpy faster at every lake up to 50,000
    files: the arrays are small and the ctypes call dominates)."""
    try:
        return int(os.environ.get("HST_NATIVE_PROBE_MIN_FILES", "100000"))
    except ValueError:
        return 100000


def probe_native_enabled(n_files: Optional[int] = None) -> bool:
    """Whether the sketch probes take the C++ loops: ``HST_NATIVE_PROBE``
    ``force`` always, ``on`` from :func:`probe_min_files` files up, anything
    else (``off``, the default) never. The one ``HST_*`` variable the port
    reads: it is the JAX package's only way into these loops."""
    mode = os.environ.get("HST_NATIVE_PROBE", "off").lower()
    if mode == "force":
        return True
    if mode != "on":
        return False
    return n_files is None or n_files >= probe_min_files()


_OPS = {"EqualTo": 0, "LessThan": 1, "LessThanOrEqual": 2,
        "GreaterThan": 3, "GreaterThanOrEqual": 4}

_I64_MAX = 2 ** 63 - 1
_I64_MIN = -(2 ** 63)
_EPOCH = datetime.date(1970, 1, 1)


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# Bloom probe: one literal vs many per-file bitsets.
# ---------------------------------------------------------------------------

def bloom_positions(value, dtype: str, num_bits: int, num_hashes: int) -> np.ndarray:
    """The literal's k probe positions, mirroring ops/sketches.py double
    hashing (wrapping uint32 arithmetic)."""
    from ..ops import kernels
    from ..ops.sketches import _h2_host

    h1 = kernels.hash32_value_host(value, dtype)
    h2 = _h2_host(h1)
    return np.array([((h1 + i * h2) & 0xFFFFFFFF) % num_bits
                     for i in range(num_hashes)], dtype=np.int32)


def prepare_bloom(bits_rows: List[Optional[bytes]],
                  num_bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """The per-file bitset matrix (one row of num_bits/8 bytes per file)
    and a flag per file that has a bitset. Callers cache it beside the
    sketch table: at lake scale this loop costs more than every probe."""
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
    n, stride = buf.shape
    positions = bloom_positions(value, dtype, num_bits, num_hashes)
    if probe_native_enabled(n):
        out = np.zeros(n, dtype=np.uint8)
        get_lib().hst_bloom_probe_many(
            _as_u8p(buf), stride, n, _as_u8p(valid),
            positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(positions), _as_u8p(out))
        return out.astype(bool)
    # numpy: gather each position's byte, test the MSB-first bit.
    keep = np.ones(n, dtype=bool)
    for p in positions:
        byte = buf[:, p >> 3]
        keep &= ((byte >> (7 - (p & 7))) & 1).astype(bool)
    return keep | ~valid.astype(bool)


def bloom_probe_many(bits_rows: List[Optional[bytes]], value, dtype: str,
                     num_bits: int, num_hashes: int) -> np.ndarray:
    """One-shot prepare + probe."""
    buf, valid = prepare_bloom(bits_rows, num_bits)
    return bloom_probe_prepared(buf, valid, value, dtype, num_bits, num_hashes)


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
    outside the int64 range (which would otherwise wrap through c_int64)."""
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
    native = probe_native_enabled(n)
    if dtype in (FLOAT32, FLOAT64):
        try:
            v = float(value)
        except OverflowError:
            v = math.inf if value > 0 else -math.inf
        if math.isnan(v):
            return ~has.astype(bool)
        if native:
            out = np.zeros(n, dtype=np.uint8)
            get_lib().hst_minmax_prune_f64(
                lo.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                hi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                _as_u8p(has), n, v, _OPS[op], _as_u8p(out))
            return out.astype(bool)
        return _np_prune(lo, hi, has, v, _OPS[op])
    if dtype == DATE:
        v = (value - _EPOCH).days
    else:
        op, v = _int_domain_literal(op, value)
        if op == "ALL":
            return np.ones(n, dtype=bool)
        if op == "NONE":
            return ~has.astype(bool)  # only all-null files survive.
    if native:
        out = np.zeros(n, dtype=np.uint8)
        get_lib().hst_minmax_prune_i64(
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _as_u8p(has), n, v, _OPS[op], _as_u8p(out))
        return out.astype(bool)
    return _np_prune(lo, hi, has, v, _OPS[op])


def minmax_prune(lo_rows: List, hi_rows: List, op: str, value,
                 dtype: str) -> Optional[np.ndarray]:
    """One-shot prepare + prune; None for dtypes without an array form
    (the caller's generic per-file loop handles strings)."""
    prep = prepare_minmax(lo_rows, hi_rows, dtype)
    if prep is None:
        return None
    return minmax_prune_prepared(prep, op, value, dtype)


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


# ---------------------------------------------------------------------------
# Avro block decode: one C++ pass over a block instead of a Python row loop.
# ---------------------------------------------------------------------------

# prim name -> wire code (must match hst_native.cpp's switch).
AVRO_PRIMS = {"boolean": 0, "int": 1, "long": 2, "float": 3, "double": 4,
              "string": 5, "bytes": 6, "null": 7}

_AVRO_ERRORS = {-1: "truncated data", -2: "bad union branch",
                -3: "varint too long", -4: "unknown primitive"}


def avro_decode_block(block: bytes, count: int, plans: List) -> List:
    """Decode one OCF block of ``count`` (> 0) rows. ``plans`` is
    [(prim, null_branch)] per field (null_branch None for non-nullable).
    Returns per-field (kind, values, valid) where kind is "i" (int64
    array), "d" (float64 array), or "s" (offsets int32 array, data bytes).
    Raises ValueError on a corrupt block (the plain decoder's conditions)
    and NativeBuildError when the library does not build."""
    lib = get_lib()
    n_fields = len(plans)
    buf = np.frombuffer(block, dtype=np.uint8)
    plan_arr = np.zeros(2 * n_fields, dtype=np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ivals = (i64p * n_fields)()
    dvals = (f64p * n_fields)()
    offs = (i32p * n_fields)()
    sdata = (u8p * n_fields)()
    valids = (u8p * n_fields)()
    holders = []  # per field: the numpy arrays the library writes into
    sdata_len = np.zeros(n_fields, dtype=np.int64)
    for f, (prim, null_branch) in enumerate(plans):
        code = AVRO_PRIMS[prim]
        plan_arr[2 * f] = code
        plan_arr[2 * f + 1] = -1 if null_branch is None else null_branch
        valid = np.ones(count, dtype=np.uint8)
        valids[f] = valid.ctypes.data_as(u8p)
        if code in (0, 1, 2):
            a = np.zeros(count, dtype=np.int64)
            ivals[f] = a.ctypes.data_as(i64p)
            holders.append(("i", a, valid))
        elif code in (3, 4):
            a = np.zeros(count, dtype=np.float64)
            dvals[f] = a.ctypes.data_as(f64p)
            holders.append(("d", a, valid))
        elif code in (5, 6):
            o = np.zeros(count + 1, dtype=np.int32)
            d = np.zeros(max(len(block), 1), dtype=np.uint8)
            offs[f] = o.ctypes.data_as(i32p)
            sdata[f] = d.ctypes.data_as(u8p)
            holders.append(("s", o, d, valid))
        else:  # null type
            a = np.zeros(count, dtype=np.int64)
            ivals[f] = a.ctypes.data_as(i64p)
            valid[:] = 0
            holders.append(("i", a, valid))
    rc = lib.hst_avro_decode_block(
        buf.ctypes.data_as(u8p), len(block), count, n_fields,
        plan_arr.ctypes.data_as(i32p), ivals, dvals, offs, sdata,
        sdata_len.ctypes.data_as(i64p), valids)
    if rc < 0:
        raise ValueError(str(_AVRO_ERRORS.get(int(rc), rc)))
    out = []
    for f, h in enumerate(holders):
        if h[0] == "s":
            _, o, d, valid = h
            out.append(("s", o, bytes(d[:int(sdata_len[f])]), valid))
        else:
            out.append(h)
    return out
