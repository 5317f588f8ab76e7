"""Length classes (counterpart of ``hyperspace_tpu/execution/shapes.py``).

The JAX package pads every data-dependent array length to a geometric
LENGTH CLASS (power-of-``growthFactor`` multiples of ``minPadElements``)
with an explicit valid count riding along, so one compiled XLA program
serves every length of a class. Eager torch compiles nothing per length,
so the port keeps its arrays exact and has no pad primitives. Two answers
still depend on the classes, and they read :func:`padded_length` under
the session's ``hyperspace.tpu.execution.shapeBucketing.*`` conf:

- the mesh tier's shard boundaries (``execution/spmd.py``): a leaf pads
  to its class before the device split, so every device holds the rows it
  holds in the JAX package, and float partial sums agree;
- the MinMax sketch (``ops/sketches.minmax_values``): a column shorter
  than its class is padded there with invalid rows, which bring the
  sentinels into the reduction.

The module sits at the package's top, beside ``config.py``, because both
readers lie below the executor. ``padded_length(n) == n`` whenever
bucketing is disabled or the array is huge (``exactFallbackRows`` and
``maxWasteRatio``). The executor, the action runner and the streaming
tier's load-time prebuild scope the session's conf with :func:`use_conf`,
where the JAX package does.

The program bank (serving/program_bank.py) counts its programs per
class vector under these classes too. Not ported: the pad primitives
(``pad_to``, ``pad_class``, ``unpad``, ``valid_mask``, ``mask_tail``),
which nothing here pads with; the XLA compile counter (``compile_count``,
``compile_scope``) and the XLA cache opt-in. Eager torch compiles no
programs; ``KernelCompileEvent`` and explain's "Compilation:" section
count the CUDA kernel libraries' nvcc builds instead
(ops/cuda_kernels.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Optional

from .index.constants import IndexConstants


@dataclass(frozen=True)
class ShapeParams:
    enabled: bool = IndexConstants.TPU_SHAPE_BUCKETING_ENABLED_DEFAULT == "true"
    growth_factor: float = float(IndexConstants.TPU_SHAPE_BUCKETING_GROWTH_FACTOR_DEFAULT)
    min_pad: int = int(IndexConstants.TPU_SHAPE_BUCKETING_MIN_PAD_DEFAULT)
    max_waste_ratio: float = float(IndexConstants.TPU_SHAPE_BUCKETING_MAX_WASTE_RATIO_DEFAULT)
    exact_fallback_rows: int = int(
        IndexConstants.TPU_SHAPE_BUCKETING_EXACT_FALLBACK_ROWS_DEFAULT)


_DEFAULT_PARAMS = ShapeParams()
_PARAMS: contextvars.ContextVar = contextvars.ContextVar("hst_torch_shape_params",
                                                         default=None)


def params_from_conf(hs_conf) -> ShapeParams:
    """ShapeParams from a HyperspaceConf, clamped as the JAX package
    clamps them (a growth factor of at least 1.125, a rung of at least 1)."""
    return ShapeParams(
        enabled=bool(hs_conf.shape_bucketing_enabled()),
        growth_factor=max(float(hs_conf.shape_bucketing_growth_factor()), 1.125),
        min_pad=max(int(hs_conf.shape_bucketing_min_pad()), 1),
        max_waste_ratio=max(float(hs_conf.shape_bucketing_max_waste_ratio()), 0.0),
        exact_fallback_rows=max(int(hs_conf.shape_bucketing_exact_fallback_rows()), 1))


def active_params() -> ShapeParams:
    p = _PARAMS.get()
    return p if p is not None else _DEFAULT_PARAMS


@contextlib.contextmanager
def use_params(p: Optional[ShapeParams]):
    """Scope the active shape parameters (None: the defaults)."""
    token = _PARAMS.set(p)
    try:
        yield
    finally:
        _PARAMS.reset(token)


@contextlib.contextmanager
def use_conf(hs_conf):
    with use_params(params_from_conf(hs_conf) if hs_conf is not None else None):
        yield


# ---------------------------------------------------------------------------
# Length classes.
# ---------------------------------------------------------------------------

def padded_length(n: int, params: Optional[ShapeParams] = None) -> int:
    """The geometric length class of ``n``: ``n`` itself when bucketing is
    disabled, ``n <= 0``, or the array is huge and the padding would waste
    more than ``max_waste_ratio`` of its size."""
    p = params if params is not None else active_params()
    if not p.enabled or n <= 0:
        return n
    c = p.min_pad
    # Geometric ladder; ceil keeps a growth above 1 making progress.
    while c < n:
        c = int(math.ceil(c * p.growth_factor))
    if n >= p.exact_fallback_rows and (c - n) > p.max_waste_ratio * n:
        return n
    return c
