"""Covering-index build: hash-partition + sort-within-bucket on the device
(counterpart of ``hyperspace_tpu/ops/index_build.py``, in-memory build
only).

The whole dataset is bucket-assigned by the hash+bucket kernel and sorted
by (bucket, indexed columns); the bucket boundaries come from the bucket
histogram kernel plus a cumsum, one pass over the unsorted bucket ids.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..execution.columnar import Table
from . import cuda_kernels, kernels


def bucket_ids_for(table: Table, indexed_cols: Sequence[str],
                   num_buckets: int) -> torch.Tensor:
    """Bucket id per row: combined value-stable hash of the indexed columns
    modulo num_buckets. The fold to u32 words is torch ops; fmix32,
    combine and modulo are one kernel pass over all indexed columns."""
    folded = [kernels.fold_u32(table.column(c).data, table.column(c).dtype,
                               table.column(c).dictionary).contiguous()
              for c in indexed_cols]
    _, bids = cuda_kernels.hash_bucket(folded, num_buckets)
    return bids


def build_sorted_buckets(table: Table, indexed_cols: Sequence[str],
                         num_buckets: int) -> Tuple[Table, np.ndarray]:
    """Sort all rows by (bucket id, indexed columns); return the sorted table
    and per-bucket boundary offsets (len num_buckets+1, host numpy). Rows
    within each bucket end up sorted by the indexed columns, with stable
    ties."""
    bids = bucket_ids_for(table, indexed_cols, num_buckets)
    perm = kernels.lex_sort_indices([bids] + [table.column(c).data for c in indexed_cols])
    counts = cuda_kernels.bucket_histogram(bids, num_buckets)
    boundaries = torch.cat([torch.zeros(1, dtype=torch.int64, device=counts.device),
                            torch.cumsum(counts.to(torch.int64), 0)])
    return table.take(perm), boundaries.cpu().numpy()


def bucket_file_name(bucket: int) -> str:
    """One file per bucket; the bucket id is recoverable from the name."""
    return f"part-{bucket:05d}.parquet"


def bucket_id_from_file(path: str) -> Optional[int]:
    m = re.match(r"part-(\d{5})", os.path.basename(path))
    return int(m.group(1)) if m else None
