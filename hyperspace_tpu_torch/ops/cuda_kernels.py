"""Hand-written Hopper kernels and their plain torch versions.

The five kernels replace the TPU kernels of the index-build, filter and
sketch-build paths (``hyperspace_tpu/ops/pallas_kernels.py``):

=================  ==========================  ===========================
wrapper            CUDA source (csrc/)         replaces
=================  ==========================  ===========================
hash_bucket        hash_bucket.cu              fused_hash_bucket
bucket_histogram   bucket_histogram.cu         bucket_histogram
compare_mask       compare_mask.cu             fused_compare_mask
range_mask         range_mask.cu               fused_range_mask
masked_minmax      masked_minmax.cu            masked_minmax
=================  ==========================  ===========================

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and bound with ``ctypes``. The libraries
are built at first use into ``hyperspace_tpu_torch/_build/<hash of the
sources>/``; :func:`build` compiles every missing one with all ``nvcc``
processes started together.

A wrapper checks device, dtype, contiguity and shape, then launches its
kernel for a CUDA tensor (on PyTorch's current stream) or computes the
plain version for a CPU tensor. There is no mode switch and nothing that
falls back: a CUDA tensor either runs the kernel or raises. Each wrapper
counts its launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException
from . import kernels

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_ROOT = os.path.join(PACKAGE_DIR, "_build")

# Kernel name -> CUDA source in csrc/.
SOURCES = {
    "hash_bucket": "hash_bucket.cu",
    "bucket_histogram": "bucket_histogram.cu",
    "compare_mask": "compare_mask.cu",
    "range_mask": "range_mask.cu",
    "masked_minmax": "masked_minmax.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAX_HASH_COLS = 8  # HS_MAX_HASH_COLS in hash_bucket.cu

# Launches per kernel since the last reset_launches().
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_ENTRIES: Dict[str, Callable[..., int]] = {}
_BUILD_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}  # kernel -> nvcc's stderr (ptxas -v report)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise HyperspaceException("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_dir() -> str:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together. Returns name -> library
    path. A failed compile raises with nvcc's output."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    paths = {n: os.path.join(out_dir, f"lib{n}.so") for n in names}
    with _BUILD_LOCK:
        todo = [n for n in names if not os.path.exists(paths[n])]
        if not todo:
            return paths
        os.makedirs(out_dir, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for n in todo:
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
                   os.path.join(CSRC_DIR, SOURCES[n])]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failures = []
        for n, tmp, p in procs:
            stdout, stderr = p.communicate()
            BUILD_LOG[n] = stdout + stderr
            if p.returncode != 0:
                failures.append(f"{SOURCES[n]} (rc={p.returncode}):\n{stdout}{stderr}")
                continue
            os.replace(tmp, paths[n])
        if failures:
            raise HyperspaceException("nvcc failed for " + "\n".join(failures))
    return paths


_VP = ctypes.c_void_p
_ARGTYPES = {
    "hash_bucket": ("hs_hash_bucket", [ctypes.POINTER(_VP), ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_uint, _VP, _VP, _VP]),
    "bucket_histogram": ("hs_bucket_histogram", [_VP, ctypes.c_longlong, ctypes.c_int,
                                                 _VP, _VP]),
    "compare_mask": ("hs_compare_mask", [_VP, ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_uint, ctypes.c_int, _VP, _VP]),
    "range_mask": ("hs_range_mask", [_VP, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                                     ctypes.c_int, _VP, _VP]),
    "masked_minmax": ("hs_masked_minmax", [_VP, _VP, ctypes.c_int, ctypes.c_longlong,
                                           _VP, _VP, _VP]),
}


def _entry(name: str):
    """The C entry point of kernel ``name``, building and loading its
    library on first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        symbol, argtypes = _ARGTYPES[name]
        fn = getattr(ctypes.CDLL(build([name])[name]), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise HyperspaceException(
            f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Argument checks.
# ---------------------------------------------------------------------------

def _where(x: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a supported device; raises otherwise."""
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise HyperspaceException(f"unsupported device {x.device}")


def _check_column(x: torch.Tensor, dtypes: Tuple[torch.dtype, ...], what: str) -> None:
    if x.dim() != 1:
        raise HyperspaceException(f"{what}: expected a 1-D column, got shape {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise HyperspaceException(f"{what}: dtype {x.dtype} not in {dtypes}")
    if not x.is_contiguous():
        raise HyperspaceException(f"{what}: column must be contiguous")


_MASK_DTYPES = (torch.int32, torch.uint32, torch.float32)
_DTYPE_CODE = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}
_PACK = {torch.int32: "<i", torch.uint32: "<I", torch.float32: "<f"}
_NP_DTYPE = {torch.int32: np.int32, torch.uint32: np.uint32, torch.float32: np.float32}


def literal_fits(value, dtype: torch.dtype) -> bool:
    """True when ``value`` converts to ``dtype`` exactly enough for the
    mask kernels: integers must lie in the dtype's range (a float literal
    against a float32 column rounds, as the JAX kernel's cast does)."""
    if dtype == torch.float32:
        return isinstance(value, (int, float, bool))
    if not isinstance(value, (int, bool)):
        return False
    info = np.iinfo(_NP_DTYPE[dtype])
    return info.min <= int(value) <= info.max


def _literal_bits(value, dtype: torch.dtype) -> int:
    """The 32-bit pattern of ``value`` cast to ``dtype``."""
    if not literal_fits(value, dtype):
        raise HyperspaceException(f"literal {value!r} does not fit {dtype}")
    cast = np.asarray(value).astype(_NP_DTYPE[dtype])
    return struct.unpack("<I", struct.pack(_PACK[dtype], cast.item()))[0]


def _cast_literal(value, x: torch.Tensor) -> torch.Tensor:
    """The literal cast to the column's dtype, as a 0-d tensor beside it."""
    if x.dtype == torch.uint32:
        return torch.tensor(int(value), dtype=torch.int64, device=x.device)
    return torch.tensor(np.asarray(value).astype(_NP_DTYPE[x.dtype]).item(),
                        dtype=x.dtype, device=x.device)


def _widen(x: torch.Tensor) -> torch.Tensor:
    # torch has no comparisons for uint32: compare as int64 values.
    return kernels.u32(x.view(torch.int32)) if x.dtype == torch.uint32 else x


# ---------------------------------------------------------------------------
# hash_bucket.
# ---------------------------------------------------------------------------

def hash_bucket_plain(folded: Sequence[torch.Tensor], num_buckets: int,
                      with_hash: bool = False
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """fmix32 each column's words, boost-combine, mod num_buckets."""
    h = kernels.to_words(kernels.fmix32(kernels.u32(folded[0])))
    for f in folded[1:]:
        h = kernels.hash_combine(h, kernels.to_words(kernels.fmix32(kernels.u32(f))))
    return (h if with_hash else None), kernels.bucket_ids(h, num_buckets)


def hash_bucket(folded: Sequence[torch.Tensor], num_buckets: int,
                with_hash: bool = False
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(combined hash or None, int32 bucket id) per row from pre-folded u32
    words (int32 bit patterns, kernels.fold_u32), at most 8 columns."""
    folded = list(folded)
    if not 1 <= len(folded) <= MAX_HASH_COLS:
        raise HyperspaceException(
            f"hash_bucket takes 1..{MAX_HASH_COLS} columns, got {len(folded)}")
    if not 1 <= num_buckets < 2 ** 31:
        raise HyperspaceException(f"bad num_buckets {num_buckets}")
    n = folded[0].shape[0]
    for f in folded:
        _check_column(f, (torch.int32,), "hash_bucket")
        if f.shape[0] != n or f.device != folded[0].device:
            raise HyperspaceException("hash_bucket: columns differ in length or device")
    if _where(folded[0]) == "cpu":
        return hash_bucket_plain(folded, num_buckets, with_hash)
    bids = torch.empty(n, dtype=torch.int32, device=folded[0].device)
    hashes = torch.empty_like(bids) if with_hash else None
    if n == 0:
        return hashes, bids
    ptrs = (_VP * len(folded))(*[f.data_ptr() for f in folded])
    _launch("hash_bucket", bids.device, ptrs, len(folded), n, num_buckets,
            hashes.data_ptr() if with_hash else None, bids.data_ptr())
    return hashes, bids


# ---------------------------------------------------------------------------
# bucket_histogram.
# ---------------------------------------------------------------------------

def bucket_histogram_plain(bids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Row count per bucket id; ids outside [0, num_buckets) count nowhere."""
    valid = (bids >= 0) & (bids < num_buckets)
    return torch.bincount(bids[valid].to(torch.int64),
                          minlength=num_buckets).to(torch.int32)


def bucket_histogram(bids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """int32 row count for each bucket id of an int32 column."""
    _check_column(bids, (torch.int32,), "bucket_histogram")
    if not 1 <= num_buckets < 2 ** 31:
        raise HyperspaceException(f"bad num_buckets {num_buckets}")
    if _where(bids) == "cpu":
        return bucket_histogram_plain(bids, num_buckets)
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=bids.device)
    if bids.shape[0] == 0:
        return counts
    _launch("bucket_histogram", bids.device, bids.data_ptr(), bids.shape[0],
            num_buckets, counts.data_ptr())
    return counts


# ---------------------------------------------------------------------------
# compare_mask.
# ---------------------------------------------------------------------------

OPS = ("==", "!=", "<", "<=", ">", ">=")


def compare_mask_plain(x: torch.Tensor, op: str, value) -> torch.Tensor:
    xv, v = _widen(x), _cast_literal(value, x)
    return {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
            ">": torch.gt, ">=": torch.ge}[op](xv, v)


def compare_mask(x: torch.Tensor, op: str, value) -> torch.Tensor:
    """``x <op> value`` over an int32/uint32/float32 column; the literal is
    cast to the column's dtype first."""
    if op not in OPS:
        raise HyperspaceException(f"bad op {op!r}")
    _check_column(x, _MASK_DTYPES, "compare_mask")
    bits = _literal_bits(value, x.dtype)
    if _where(x) == "cpu":
        return compare_mask_plain(x, op, value)
    out = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    if x.shape[0] == 0:
        return out
    _launch("compare_mask", x.device, x.data_ptr(), _DTYPE_CODE[x.dtype],
            x.shape[0], bits, OPS.index(op), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# range_mask.
# ---------------------------------------------------------------------------

def range_mask_plain(x: torch.Tensor, lo, hi, lo_incl: bool = True,
                     hi_incl: bool = True) -> torch.Tensor:
    xv = _widen(x)
    lo_t, hi_t = _cast_literal(lo, x), _cast_literal(hi, x)
    above = xv >= lo_t if lo_incl else xv > lo_t
    below = xv <= hi_t if hi_incl else xv < hi_t
    return above & below


def range_mask(x: torch.Tensor, lo, hi, lo_incl: bool = True,
               hi_incl: bool = True) -> torch.Tensor:
    """``lo <(=) x <(=) hi`` over an int32/uint32/float32 column in one
    pass; both bounds are cast to the column's dtype first."""
    _check_column(x, _MASK_DTYPES, "range_mask")
    lo_bits, hi_bits = _literal_bits(lo, x.dtype), _literal_bits(hi, x.dtype)
    if _where(x) == "cpu":
        return range_mask_plain(x, lo, hi, lo_incl, hi_incl)
    out = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    if x.shape[0] == 0:
        return out
    _launch("range_mask", x.device, x.data_ptr(), _DTYPE_CODE[x.dtype], x.shape[0],
            lo_bits, hi_bits, int(lo_incl), int(hi_incl), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# masked_minmax.
# ---------------------------------------------------------------------------

_MINMAX_DTYPES = (torch.int32, torch.float32)
# Float dtype -> (same-width int dtype, every bit but the sign).
_FLOAT_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF),
               torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF)}


def minmax_sentinels(dtype: torch.dtype) -> Tuple[object, object]:
    """(dtype min, dtype max): finfo's finite extremes for floats."""
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.min, info.max


def _flip_negatives(bits: torch.Tensor, low_bits: int) -> torch.Tensor:
    """Flip the bits below the sign of each negative integer: a float's
    bits become an integer that orders as the float does (-0.0 below
    +0.0; NaN aside), and that integer becomes the float's bits again."""
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & low_bits)


def masked_minmax_plain(x: torch.Tensor, valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version, for any int or float column (the MinMax
    sketch also runs it over 64-bit columns): (min, max) over the valid
    rows as 0-d tensors. The reduction starts from the dtype's sentinels
    (max for the min, min for the max), -0.0 orders below +0.0, and a
    valid NaN makes both results NaN."""
    lo_sent, hi_sent = minmax_sentinels(x.dtype)
    # The reduction's starting values: (dtype max, dtype min).
    start = torch.tensor([hi_sent, lo_sent], dtype=x.dtype, device=x.device)
    use = torch.ones_like(x, dtype=torch.bool) if valid is None else valid.clone()
    keys = x
    if x.dtype.is_floating_point:
        nan = torch.isnan(x)
        nan_seen = (nan & use).any()
        use &= ~nan
        int_dtype, low_bits = _FLOAT_BITS[x.dtype]
        keys = _flip_negatives(x.view(int_dtype), low_bits)
        start = _flip_negatives(start.view(int_dtype), low_bits)
    lo, hi = start[0], start[1]
    if x.shape[0]:
        lo = torch.minimum(torch.where(use, keys, lo).amin(), lo)
        hi = torch.maximum(torch.where(use, keys, hi).amax(), hi)
    out = torch.stack([lo, hi])
    if x.dtype.is_floating_point:
        out = torch.where(nan_seen, float("nan"), _flip_negatives(out, low_bits).view(x.dtype))
    return out[0], out[1]


def masked_minmax(x: torch.Tensor, valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) over the valid rows of an int32/float32 column as two 0-d
    tensors on its device; ``valid=None`` means every row is valid. No
    valid row gives (dtype max, dtype min); a valid NaN gives (NaN, NaN)."""
    _check_column(x, _MINMAX_DTYPES, "masked_minmax")
    if valid is not None:
        _check_column(valid, (torch.bool,), "masked_minmax validity")
        if valid.shape != x.shape or valid.device != x.device:
            raise HyperspaceException("masked_minmax: validity differs in length or device")
    if _where(x) == "cpu":
        return masked_minmax_plain(x, valid)
    n = x.shape[0]
    if n == 0:
        lo_sent, hi_sent = minmax_sentinels(x.dtype)
        out = torch.tensor([hi_sent, lo_sent], dtype=x.dtype, device=x.device)
        return out[0], out[1]
    out = torch.empty(2, dtype=x.dtype, device=x.device)
    scratch = torch.empty(4, dtype=torch.int32, device=x.device)
    _launch("masked_minmax", x.device, x.data_ptr(),
            None if valid is None else valid.data_ptr(), _DTYPE_CODE[x.dtype], n,
            scratch.data_ptr(), out.data_ptr())
    return out[0], out[1]
