"""hyperspace_tpu_torch -- the PyTorch/CUDA port of hyperspace_tpu.

Covering and data-skipping indexes over data lakes (parquet, csv, json,
orc, text and avro files, and versioned delta and iceberg tables with time
travel), built and
probed on an NVIDIA GPU: the covering build hash-partitions and sorts
within buckets on the device, the sketch build reduces each source file's
column there (MinMax, Bloom, value list), and queries evaluate their
predicates there, with hand-written CUDA kernels on the hot passes
(ops/cuda_kernels.py). Joins, group-bys and sorts are torch ops on the
device; an equi-join over two covering indexes on its keys merges their
buckets without sorting either side. Indexes are refreshed (full,
incremental, quick) and optimized as their sources change, and Hybrid
Scan reads an index whose source gained or (with lineage) lost files;
inputs above the device budget stream in chunks. ``df.write`` writes
results, bucketed by the same hash and histogram kernels or
hive-partitioned, and the planner can reorder inner-join chains by
estimated rows. Eligible queries run as one per-device program over a
mesh of devices (on one card, the default route of every plan whose
leaf fits the device budget), and index builds exchange buckets over a
mesh of several. Sketch probes at plan time are host numpy. The
on-disk layout and the operation log are the JAX package's, so either
package reads the other's indexes; an index may live on an object store
registered for its system path's scheme.

This package imports torch, numpy and pyarrow, and nothing of JAX or of
``hyperspace_tpu``.
"""

from .api import (BloomFilterSketch, DataSkippingIndexConfig, Hyperspace,  # noqa: F401
                  IndexConfig, MinMaxSketch, SketchSpec, ValueListSketch)
from .config import Conf, HyperspaceConf  # noqa: F401
from .exceptions import HyperspaceException  # noqa: F401
from .index.constants import IndexConstants, States  # noqa: F401
from .plan.expr import avg, col, lit, sum_  # noqa: F401
from .schema import Field, Schema  # noqa: F401
from .session import Session  # noqa: F401

__version__ = "0.1.0"
