"""Covering-index build: hash-partition + sort-within-bucket on the device
(counterpart of ``hyperspace_tpu/ops/index_build.py``: the in-memory
build and the chunked build; the mesh build is not ported).

The in-memory build bucket-assigns the whole dataset with the hash+bucket
kernel and sorts it by (bucket, indexed columns); the bucket boundaries
come from the bucket histogram kernel plus a cumsum, one pass over the
unsorted bucket ids. A source above the device budget
(``hyperspace.tpu.maxChunkRows``) streams through the chunked build
instead: the same hash + sort per chunk, each bucket's run spilled to a
host parquet file, then batches of whole buckets read back, sorted once
more and written one file per bucket.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow.parquet as pq
import torch

from ..execution.columnar import (Column, Table, iter_parquet_chunks, parquet_row_counts,
                                  read_parquet)
from ..index import data_store
from ..parallel import io as pio
from ..schema import INT64
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


# The chunked build's device footprint: tests and chip_smoke.py hold
# max_device_rows to the chunk budget. Concurrent builds update it under
# the lock.
CHUNK_STATS = {"max_device_rows": 0, "chunks": 0, "spill_bytes": 0}
_CHUNK_STATS_LOCK = threading.Lock()


def _note_device_rows(n: int) -> None:
    with _CHUNK_STATS_LOCK:
        CHUNK_STATS["max_device_rows"] = max(CHUNK_STATS["max_device_rows"], n)


def _bump_chunk_stat(key: str, delta: int) -> None:
    with _CHUNK_STATS_LOCK:
        CHUNK_STATS[key] += delta


def build_sorted_buckets_chunked(
        files: Sequence[str], columns: Sequence[str], indexed_cols: Sequence[str],
        num_buckets: int, chunk_rows: int, out_dir: str, row_group_size: int, device,
        lineage_ids: Optional[Sequence[int]] = None,
        lineage_col: Optional[str] = None) -> None:
    """Streaming covering-index build for a source above the device budget.

    Per chunk of at most ``chunk_rows`` rows: hash + bucket-sort it on the
    device (the in-memory build's kernels), copy it to the host and append
    each bucket's run to that bucket's spill file. Then batches of whole
    buckets, up to ``chunk_rows`` rows each, are read back, sorted by
    (bucket, indexed columns) and written one file per bucket: the files
    and the order within them are the in-memory build's. With
    ``lineage_ids`` every row gets its file's id (``lineage_ids[i]`` for
    ``files[i]``) in ``lineage_col``.
    """
    # Not under out_dir: pyarrow would read a "v__" column into any file
    # under the "v__=<n>" version directory. Removed on failure too.
    spill_dir = tempfile.mkdtemp(prefix="hs_build_spill_")
    try:
        rows_of = _spill_chunks(files, columns, indexed_cols, num_buckets, chunk_rows,
                                device, lineage_ids, lineage_col, spill_dir)
        # Double-buffered merge: batch i+1 reads back while batch i sorts
        # and writes. Two batches alive at most (threads=2, depth 0: one
        # read in flight and the one being merged), each about chunk_rows
        # device rows, the footprint this build exists to bound.
        p = pio.active_params()
        merge_params = pio.IoParams(enabled=p.enabled, threads=min(2, p.resolved_threads()),
                                    prefetch_depth=0, max_inflight_bytes=p.max_inflight_bytes)
        for batch, merged in pio.zip_prefetch(
                _bucket_batches(rows_of, chunk_rows),
                lambda batch: read_parquet([_spill_path(spill_dir, b) for b in batch], None,
                                           device),
                weight=lambda batch: sum(os.path.getsize(_spill_path(spill_dir, b))
                                         for b in batch),
                params=merge_params, label="spill_merge"):
            _note_device_rows(merged.num_rows)
            merged = _sort_batch(merged, [rows_of[b] for b in batch], indexed_cols)
            _write_batch(merged, batch, [rows_of[b] for b in batch], out_dir, row_group_size)
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)


def _spill_path(spill_dir: str, bucket: int) -> str:
    return os.path.join(spill_dir, f"bucket{bucket:05d}.parquet")


def _spill_chunks(files, columns, indexed_cols, num_buckets, chunk_rows, device,
                  lineage_ids, lineage_col, spill_dir) -> Dict[int, int]:
    """Hash + sort every chunk and append its bucket runs to the spill
    files; returns the rows spilled per bucket."""
    writers: Dict[int, pq.ParquetWriter] = {}
    try:
        for chunk, provenance in iter_parquet_chunks(files, columns, chunk_rows, device):
            if lineage_ids is not None:
                ids = np.concatenate([np.full(cnt, lineage_ids[fi], np.int64)
                                      for fi, cnt in provenance])
                chunk = chunk.with_column(lineage_col,
                                          Column(INT64, torch.from_numpy(ids).to(device)))
            _note_device_rows(chunk.num_rows)
            _bump_chunk_stat("chunks", 1)
            sorted_chunk, bounds = build_sorted_buckets(chunk, indexed_cols, num_buckets)
            _spill_runs(sorted_chunk, bounds, num_buckets, writers, spill_dir)
    finally:
        for w in writers.values():
            w.close()
    return dict(zip(sorted(writers), parquet_row_counts(
        [_spill_path(spill_dir, b) for b in sorted(writers)])))


def _spill_runs(sorted_chunk: Table, bounds, num_buckets: int,
                writers: Dict[int, pq.ParquetWriter], spill_dir: str) -> None:
    """Append each non-empty bucket run of a sorted chunk to its spill file,
    the files written over threads (each by one)."""
    at = sorted_chunk.to_arrow()
    runs = []
    for b in range(num_buckets):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        if hi <= lo:
            continue
        run = at.slice(lo, hi - lo)
        _bump_chunk_stat("spill_bytes", run.nbytes)
        if b not in writers:
            writers[b] = pq.ParquetWriter(_spill_path(spill_dir, b), run.schema)
        runs.append((writers[b], run))
    pio.run_all(lambda wr: wr[0].write_table(wr[1]), runs)


def _bucket_batches(rows_of: Dict[int, int], chunk_rows: int) -> List[List[int]]:
    """Buckets in order, packed whole into batches of at most
    ``chunk_rows`` rows (a bucket larger than that is a batch alone)."""
    batches: List[List[int]] = []
    batch: List[int] = []
    batch_rows = 0
    for b in sorted(rows_of):
        if batch and batch_rows + rows_of[b] > chunk_rows:
            batches.append(batch)
            batch, batch_rows = [], 0
        batch.append(b)
        batch_rows += rows_of[b]
    if batch:
        batches.append(batch)
    return batches


def _sort_batch(merged: Table, rows: Sequence[int], indexed_cols: Sequence[str]) -> Table:
    """Sort a batch of whole buckets, read back in bucket order, by
    (bucket, indexed columns), stable."""
    bids = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(rows)])
    keys = [torch.from_numpy(bids).to(merged.column(indexed_cols[0]).data.device)] + \
        [merged.column(c).data for c in indexed_cols]
    return merged.take(kernels.lex_sort_indices(keys))


def _write_batch(merged: Table, batch: Sequence[int], rows: Sequence[int], out_dir: str,
                 row_group_size: int) -> None:
    """One parquet file per bucket of a sorted batch, written over threads,
    through the index path's data store if it has one."""
    at = merged.to_arrow()
    starts = np.concatenate([[0], np.cumsum(rows, dtype=np.int64)[:-1]]).tolist()

    def write(job) -> None:
        fs, path = data_store.fs_and_path(os.path.join(out_dir, bucket_file_name(job[0])))
        pq.write_table(at.slice(job[1], job[2]), path, row_group_size=row_group_size,
                       filesystem=fs)

    pio.run_all(write, list(zip(batch, starts, rows)))


def bucket_file_name(bucket: int) -> str:
    """One file per bucket; the bucket id is recoverable from the name."""
    return f"part-{bucket:05d}.parquet"


def bucket_id_from_file(path: str) -> Optional[int]:
    m = re.match(r"part-(\d{5})", os.path.basename(path))
    return int(m.group(1)) if m else None
