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

The binding stays ``ctypes`` on purpose: a library with a plain C interface
builds in seconds, where one that includes PyTorch's headers takes minutes
on the card's machine, inside ``chip_smoke.py``'s time limit. So the host
path around the call is kept lean instead, since at the main path's sizes
(under a million rows) the card's work takes a few microseconds and the
host's share decides the call's time. Per call a wrapper allocates its
output and nothing else, does no numpy work and no memset, opens a device
context only when the tensor is not on the current device, and reads the
stream handle once.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import struct
import subprocess
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

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
                                           ctypes.c_int, _VP, _VP, _VP]),
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


# (device index, stream handle) -> (words, their address): masked_minmax's
# scratch, zeroed when made and left zeroed by every launch on that stream.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}
SCRATCH_WORDS = 8  # 6 used (masked_minmax.cu)


def _scratch(device: int, stream: int) -> int:
    """The address of the current stream's masked_minmax scratch words.
    Made on first use on that stream, zeroed on it before any launch."""
    entry = _SCRATCH.get((device, stream))
    if entry is None:
        words = torch.zeros(SCRATCH_WORDS, dtype=torch.int32, device=f"cuda:{device}")
        # Two threads first on one stream both make words; one set is kept.
        entry = _SCRATCH.setdefault((device, stream), (words, words.data_ptr()))
    return entry[1]


def _launch(name: str, x: torch.Tensor, *args, scratch: bool = False) -> None:
    """Launch kernel ``name`` on the current stream of ``x``'s device,
    appending the stream's scratch address (``scratch``) and the stream to
    ``args``."""
    fn = _ENTRIES.get(name) or _entry(name)
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(name, x, *args, scratch=scratch)
    # With the device index given, current_stream skips the lookup of the
    # current device: the cheapest public way to the stream's handle.
    stream = torch.cuda.current_stream(device).cuda_stream
    if scratch:
        args += (_scratch(device, stream),)
    rc = fn(*args, stream)
    if rc != 0:
        raise HyperspaceException(
            f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Argument checks.
# ---------------------------------------------------------------------------

def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
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
_INT_RANGE = {torch.int32: (-2 ** 31, 2 ** 31 - 1), torch.uint32: (0, 2 ** 32 - 1)}
_F32 = struct.Struct("<f")


def literal_fits(value, dtype: torch.dtype) -> bool:
    """True when ``value`` converts to ``dtype`` exactly enough for the
    mask kernels: integers (bools among them) must lie in the dtype's range
    (a float literal against a float32 column rounds, as the JAX kernel's
    cast does)."""
    if dtype == torch.float32:
        return isinstance(value, (int, float))
    if not isinstance(value, int):
        return False
    lo, hi = _INT_RANGE[dtype]
    return lo <= value <= hi


def _int_as_float(value: int) -> float:
    """A Python int as the float whose float32 rounding is the int's own
    (one rounding, to nearest even, as numpy casts an int64 or uint64):
    ints beyond 2**53 are first cut to 24 significant bits here, since
    float() would round them once more on the way."""
    if -2 ** 53 <= value <= 2 ** 53:
        return float(value)
    mag = abs(value)
    shift = mag.bit_length() - 24
    q, r = divmod(mag, 1 << shift)
    half = 1 << (shift - 1)
    if r > half or (r == half and q & 1):
        q += 1
    return math.copysign(float(q << shift), value)


def _literal_bits(value, dtype: torch.dtype) -> int:
    """The 32-bit pattern of ``value`` cast to ``dtype``, as numpy's cast
    gives it: two's complement for int32, the value for uint32, and for
    float32 the nearest float32 (ties to even; +-inf past its range)."""
    if not literal_fits(value, dtype):
        raise HyperspaceException(f"literal {value!r} does not fit {dtype}")
    if dtype != torch.float32:
        return value & 0xFFFFFFFF
    f = _int_as_float(value) if isinstance(value, int) else value
    try:
        packed = _F32.pack(f)
    except OverflowError:  # rounds past FLT_MAX: numpy gives +-inf
        packed = _F32.pack(math.copysign(math.inf, f))
    return int.from_bytes(packed, "little")


def _cast_literal(value, x: torch.Tensor) -> torch.Tensor:
    """The literal cast to the column's dtype, as a 0-d tensor beside it
    (uint32 as its int64 value: torch does not compare uint32)."""
    bits = _literal_bits(value, x.dtype)
    if x.dtype == torch.uint32:
        return torch.tensor(bits, dtype=torch.int64, device=x.device)
    signed = bits - (1 << 32) if bits >> 31 else bits
    return torch.tensor(signed, dtype=torch.int32, device=x.device).view(x.dtype)


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
    if not _on_cuda(folded[0]):
        return hash_bucket_plain(folded, num_buckets, with_hash)
    bids = torch.empty(n, dtype=torch.int32, device=folded[0].device)
    hashes = torch.empty_like(bids) if with_hash else None
    if n == 0:
        return hashes, bids
    ptrs = (_VP * len(folded))(*[f.data_ptr() for f in folded])
    _launch("hash_bucket", bids, ptrs, len(folded), n, num_buckets,
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
    if not _on_cuda(bids):
        return bucket_histogram_plain(bids, num_buckets)
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=bids.device)
    if bids.shape[0] == 0:
        return counts
    _launch("bucket_histogram", bids, bids.data_ptr(), bids.shape[0],
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
    if not _on_cuda(x):
        return compare_mask_plain(x, op, value)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=x.device)
    if n:
        _launch("compare_mask", x, x.data_ptr(), _DTYPE_CODE[x.dtype], n, bits,
                OPS.index(op), out.data_ptr())
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
    if not _on_cuda(x):
        return range_mask_plain(x, lo, hi, lo_incl, hi_incl)
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=x.device)
    if n:
        _launch("range_mask", x, x.data_ptr(), _DTYPE_CODE[x.dtype], n, lo_bits,
                hi_bits, int(lo_incl), int(hi_incl), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# masked_minmax.
# ---------------------------------------------------------------------------

_MINMAX_DTYPES = (torch.int32, torch.float32)
# Float dtype -> (same-width int dtype, every bit but the sign).
_FLOAT_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF),
               torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF)}
# The JAX kernel pads a column to a multiple of its block, 256 x 128 lanes
# (hyperspace_tpu/ops/pallas_kernels.py _BLK_ROWS, _LANES).
PALLAS_BLOCK_LANES = 256 * 128


def minmax_sentinels(dtype: torch.dtype) -> Tuple[object, object]:
    """(dtype min, dtype max): finfo's finite extremes for floats."""
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.min, info.max


def pallas_pads(n: int) -> bool:
    """True when the JAX kernel pads a column of ``n`` rows: its sentinels
    then enter the reduction through the padded lanes."""
    return n % PALLAS_BLOCK_LANES != 0 or n == 0


def _flip_negatives(bits: torch.Tensor, low_bits: int) -> torch.Tensor:
    """Flip the bits below the sign of each negative integer: a float's
    bits become an integer that orders as the float does (-0.0 below
    +0.0; NaN aside), and that integer becomes the float's bits again."""
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & low_bits)


def masked_minmax_words_plain(x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                              pad: Optional[bool] = None) -> torch.Tensor:
    """The kernel's plain version, for any int or float column (the MinMax
    sketch also runs it over 64-bit columns): ``x.dtype[4]`` holding (min,
    max, any row valid, 0), the last two as integer bit patterns.

    The sentinels (dtype max for the min, dtype min for the max) enter the
    reduction exactly when a row is invalid or ``pad`` holds (by default:
    when the JAX kernel pads the column, :func:`pallas_pads`). -0.0 orders
    below +0.0. A valid NaN makes both results NaN with its own bits; with
    several NaN bit patterns the min is the one smallest as an unsigned
    integer and the max the largest."""
    n = x.shape[0]
    if pad is None:
        pad = pallas_pads(n)
    lo_sent, hi_sent = minmax_sentinels(x.dtype)
    # The sentinels as keys: (dtype max, dtype min).
    sent = torch.tensor([hi_sent, lo_sent], dtype=x.dtype, device=x.device)
    any_valid = torch.tensor(n > 0, device=x.device) if valid is None else valid.any()
    use = torch.ones_like(x, dtype=torch.bool) if valid is None else valid
    keys, word_dtype = x, x.dtype
    if x.dtype.is_floating_point:
        word_dtype, low_bits = _FLOAT_BITS[x.dtype]
        is_nan = torch.isnan(x)
        nan = is_nan & use
        use = use & ~is_nan
        keys = _flip_negatives(x.view(word_dtype), low_bits)
        sent = _flip_negatives(sent.view(word_dtype), low_bits)
    lo, hi = sent[0], sent[1]
    if n:
        lo = torch.where(use, keys, lo).amin()
        hi = torch.where(use, keys, hi).amax()
    if pad:
        lo, hi = torch.minimum(lo, sent[0]), torch.maximum(hi, sent[1])
    out = torch.stack([lo, hi])
    if x.dtype.is_floating_point:
        out = _flip_negatives(out, low_bits)
        # NaN bits in unsigned order: flipping the sign bit makes it the
        # signed order that amin/amax take.
        sign = torch.iinfo(word_dtype).min
        ordered = x.view(word_dtype) ^ sign
        if n:
            nan_words = torch.stack([
                torch.where(nan, ordered, torch.iinfo(word_dtype).max).amin(),
                torch.where(nan, ordered, sign).amax()]) ^ sign
            out = torch.where(nan.any(), nan_words, out)
    tail = torch.stack([any_valid.to(word_dtype), torch.zeros((), dtype=word_dtype,
                                                              device=x.device)])
    return torch.cat([out, tail]).view(x.dtype)


def masked_minmax_plain(x: torch.Tensor, valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of :func:`masked_minmax_words_plain` as 0-d tensors."""
    out = masked_minmax_words_plain(x, valid)
    return out[0], out[1]


def masked_minmax_words(x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                        pad: Optional[bool] = None) -> torch.Tensor:
    """The kernel's output: ``x.dtype[4]`` on the column's device, holding
    (min, max, any row valid, 0) over an int32/float32 column, the last two
    as integer bit patterns; ``valid=None`` means every row is valid.
    Semantics as :func:`masked_minmax_words_plain`, ``pad`` included."""
    _check_column(x, _MINMAX_DTYPES, "masked_minmax")
    if valid is not None:
        _check_column(valid, (torch.bool,), "masked_minmax validity")
        if valid.shape != x.shape or valid.device != x.device:
            raise HyperspaceException("masked_minmax: validity differs in length or device")
    n = x.shape[0]
    if pad is None:
        pad = pallas_pads(n)
    if not _on_cuda(x):
        return masked_minmax_words_plain(x, valid, pad)
    if n == 0:
        lo_sent, hi_sent = minmax_sentinels(x.dtype)
        return torch.tensor([hi_sent, lo_sent, 0, 0], dtype=x.dtype, device=x.device)
    out = x.new_empty(4)
    _launch("masked_minmax", x, x.data_ptr(), None if valid is None else valid.data_ptr(),
            _DTYPE_CODE[x.dtype], n, pad, out.data_ptr(), scratch=True)
    return out


def masked_minmax(x: torch.Tensor, valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) over the valid rows of an int32/float32 column as two 0-d
    tensors on its device, as the JAX kernel computes them; ``valid=None``
    means every row is valid. No valid row gives (dtype max, dtype min); a
    valid NaN gives NaN in both, with its bits."""
    out = masked_minmax_words(x, valid)
    return out[0], out[1]
