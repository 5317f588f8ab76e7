"""The card's peaks and the least bytes each of the port's CUDA kernels
must move, from the arguments of one launch.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power
limit (the run records the card's own limit beside its readings): HBM3 at
3.35 TB/s. The kernels are bound by memory: their least time is their
bytes over that rate, each input byte read once and each output byte
written once.

A launch is seen as the port's ``cuda_kernels._launch(name, x, *args)``
is called: ``x`` is the tensor whose device and stream the launch uses,
``args`` the kernel's own arguments (see ``hyperspace_tpu_torch/ops/
cuda_kernels.py``). ``CUDA_NAME`` maps a wrapper to the kernel the
profiler names.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12

# Wrapper name -> the CUDA kernel's name in the profiler's records.
CUDA_NAME = {
    "compare_mask": "mask_kernel",
    "range_mask": "mask_kernel",
    "hash_bucket": "hash_bucket_kernel",
    "bucket_histogram": "bucket_histogram_kernel",
    "masked_minmax": "masked_minmax_kernel",
}


def mask_bytes(n: int, itemsize: int) -> int:
    """compare_mask and range_mask: read n values, write n bools."""
    return n * (itemsize + 1)


def hash_bucket_bytes(n: int, columns: int, with_hash: bool) -> int:
    """Read ``columns`` int32 words a row, write an int32 bucket id (and
    the int32 hash, when asked for)."""
    return n * 4 * (columns + 1 + (1 if with_hash else 0))


def bucket_histogram_bytes(n: int, buckets: int) -> int:
    """Read n int32 ids, write one int32 count a bucket."""
    return 4 * (n + buckets)


def masked_minmax_bytes(n: int, itemsize: int, with_valid: bool) -> int:
    """Read n values (and n validity bools), write four words."""
    return n * itemsize + (n if with_valid else 0) + 4 * itemsize


def launch_bytes(name: str, x, args: tuple) -> int:
    """The least bytes of one launch of ``name``, by its argument layout
    in cuda_kernels.py."""
    if name in ("compare_mask", "range_mask"):
        # (x ptr, dtype code, n, ...)
        return mask_bytes(int(args[2]), x.element_size())
    if name == "hash_bucket":
        # (column ptrs, columns, n, buckets, hashes ptr or None, ids ptr)
        return hash_bucket_bytes(int(args[2]), int(args[1]), args[4] is not None)
    if name == "bucket_histogram":
        # (ids ptr, n, buckets, counts ptr)
        return bucket_histogram_bytes(int(args[1]), int(args[2]))
    if name == "masked_minmax":
        # (x ptr, valid ptr or None, dtype code, n, pad, out ptr)
        return masked_minmax_bytes(int(args[3]), x.element_size(), args[1] is not None)
    raise KeyError(name)


def least_seconds(n_bytes: int) -> float:
    return n_bytes / PEAK_BYTES_PER_S


def kernel_share(r, kernel: str):
    """A kernel's share of its roofline in a traced run's profiled slice:
    the least time of every launch of a wrapper that runs ``kernel`` over
    the device time of the records of ``kernel`` (namespace aside), in
    percent; None where the slice holds no launch or no record of it."""
    if r.slice is None:
        return None
    least = sum(least_seconds(n) for name, n in r.launches if CUDA_NAME[name] == kernel)
    lo, hi = r.slice
    from hsbench.reduce import kernel_name
    device = sum(max(0.0, min(e, hi) - max(s, lo)) for n, s, e in r.device_events
                 if kernel_name(n).split("::")[-1] == kernel)
    return 100.0 * least / device if least > 0 and device > 0 else None
