"""The mesh build of a covering index (counterpart of
``hyperspace_tpu/parallel/distributed_build.py``): radix partition, one
all-to-all bucket exchange, per-device sort.

Every device

  1. bucket-assigns its row shard with the same hash+bucket kernel the
     single-device build uses (``ops/index_build.bucket_ids_for``), so the
     two builds agree bit for bit;
  2. groups its rows by destination device (contiguous bucket ranges);
  3. sends each device exactly its rows with one all-to-all per array
     (torch needs no fixed-capacity blocks, so nothing overflows);
  4. sorts what it received by (bucket, indexed columns), stably.

Device ``i`` then holds exactly the buckets of its range, each sorted as
the single-device build sorts it. Padding rows never leave their device.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..execution.columnar import Column, Table
from ..ops import kernels
from ..ops.index_build import bucket_ids_for
from ..schema import STRING
from .mesh import Mesh, bucket_owner, make_mesh, pad_and_shard
from .sharding import bank_program, collective_counts, shape_vector

# Successful mesh builds in this process, and the string-dictionary unions
# of multi-process builds; bumped under the lock (builds may run
# concurrently).
DISPATCH_COUNT = 0
DICT_UNION_COUNT = 0
_COUNT_LOCK = threading.Lock()

# The collectives of the most recent build exchange.
_LAST_COLLECTIVES: Dict[str, int] = {}


def last_collectives() -> Dict[str, int]:
    return dict(_LAST_COLLECTIVES)


def _exchange_and_sort(mesh: Mesh, arrays, valid, names: Sequence[str],
                       dtypes: Dict[str, tuple], indexed_cols: Sequence[str],
                       num_buckets: int, counts: Dict[str, int]):
    n_dev = mesh.size

    def shard_table(arrs: Dict[str, torch.Tensor]) -> Table:
        return Table({n: Column(dtypes[n][0], arrs[f"d:{n}"], arrs.get(f"v:{n}"),
                                dtypes[n][1]) for n in names})

    def per_device(ax, arrs, vmask):
        bids = bucket_ids_for(shard_table(arrs), indexed_cols, num_buckets)
        dst = bucket_owner(bids, n_dev, num_buckets)
        dst = torch.where(vmask, dst, torch.full_like(dst, n_dev))
        perm = kernels.lex_sort_indices([dst])
        sorted_dst = dst[perm]
        starts = torch.searchsorted(sorted_dst, torch.arange(
            n_dev + 1, dtype=sorted_dst.dtype, device=dst.device)).tolist()
        recv = {}
        for name, a in arrs.items():
            taken = a[perm]
            recv[name] = torch.cat(ax.all_to_all(
                [taken[starts[j]:starts[j + 1]] for j in range(n_dev)]))
        table = shard_table(recv)
        rbids = bucket_ids_for(table, indexed_cols, num_buckets)
        perm2 = kernels.lex_sort_indices([rbids] + [table.column(c).data
                                                    for c in indexed_cols])
        return {name: a[perm2] for name, a in recv.items()}, rbids[perm2]

    specs = ("sharded", "sharded")
    # The JAX package's "bucket-exchange" program (its static key less the
    # send capacity, which the port does not size).
    launch = bank_program(
        "bucket-exchange", mesh,
        (num_buckets, n_dev, tuple(indexed_cols), tuple(str(dtypes[c][0]) for c in indexed_cols)),
        shape_vector((arrays, valid), specs))
    return launch(per_device, mesh, specs, counts)(arrays, valid)


def _union_string_dictionaries(table: Table, mesh: Mesh) -> Table:
    """A multi-process build's global dictionaries: each process encodes
    its strings against its own dictionary, so before any code crosses the
    exchange every process contributes its dictionaries once (two small
    allgathers per column through the cluster's gather seam: sizes, then
    the padded, length-prefixed utf-8 bytes), the sorted union becomes the
    one dictionary, and local codes re-encode into it. A single-process
    build returns the table untouched."""
    global DICT_UNION_COUNT
    if not mesh.multiprocess:
        return table
    if not any(table.column(n).dtype == STRING for n in table.names):
        return table
    from ..cluster import gather as _gather

    new_cols = {}
    for name in table.names:
        col = table.column(name)
        if col.dtype != STRING:
            new_cols[name] = col
            continue
        words = [str(w) for w in col.dictionary.tolist()]
        encoded = [w.encode("utf-8") for w in words]
        lengths = np.array([len(b) for b in encoded], np.int64)
        blob = np.frombuffer(b"".join(encoded), np.uint8) if encoded \
            else np.zeros(0, np.uint8)
        dims = np.asarray(_gather.allgather(np.array([len(words), blob.size], np.int64)))
        dims = dims.reshape(-1, 2)
        max_words = max(int(dims[:, 0].max()), 1)
        max_bytes = max(int(dims[:, 1].max()), 1)
        lengths_p = np.zeros(max_words, np.int64)
        lengths_p[:lengths.size] = lengths
        blob_p = np.zeros(max_bytes, np.uint8)
        blob_p[:blob.size] = blob
        all_lengths = np.asarray(_gather.allgather(lengths_p))
        all_blobs = np.asarray(_gather.allgather(blob_p))
        union = set()
        for i in range(dims.shape[0]):
            off = 0
            for ln in all_lengths[i][:int(dims[i, 0])]:
                ln = int(ln)
                union.add(all_blobs[i][off:off + ln].tobytes().decode("utf-8"))
                off += ln
        global_dict = np.array(sorted(union), dtype=object)
        data = col.data
        if words:
            remap = torch.from_numpy(np.searchsorted(
                global_dict, np.array(words, dtype=object)).astype(np.int32)).to(data.device)
            data = torch.where(data >= 0, remap[data.clamp(min=0).to(torch.int64)], data)
        new_cols[name] = Column(STRING, data, col.validity, global_dict)
    with _COUNT_LOCK:
        DICT_UNION_COUNT += 1
    return Table(new_cols)


def distributed_build_sorted_buckets(
        table: Table, indexed_cols: Sequence[str], num_buckets: int,
        mesh: Optional[Mesh] = None, process_local_rows: bool = False
        ) -> Tuple[List[Table], List[torch.Tensor]]:
    """Hash-partition and sort ``table`` over ``mesh``. Returns, per local
    device, its rows (exactly the buckets of its contiguous range, each
    sorted by the indexed columns, ties in source order) and their bucket
    ids. ``process_local_rows`` says, on a mesh that spans processes, that
    ``table`` is this process's disjoint slice of the source."""
    global DISPATCH_COUNT, _LAST_COLLECTIVES
    mesh = mesh or make_mesh()
    table = _union_string_dictionaries(table, mesh)
    arrays = {}
    dtypes = {}
    for name in table.names:
        col = table.column(name)
        arrays[f"d:{name}"] = col.data
        if col.validity is not None:
            arrays[f"v:{name}"] = col.validity
        dtypes[name] = (col.dtype, col.dictionary)
    shards, valid = pad_and_shard(mesh, arrays, table.num_rows,
                                  process_local=process_local_rows)
    counts: Dict[str, int] = {}
    outs = _exchange_and_sort(mesh, shards, valid, list(table.names), dtypes,
                              list(indexed_cols), num_buckets, counts)
    tables, bids = [], []
    for recv, rbids in outs:
        tables.append(Table({n: Column(dtypes[n][0], recv[f"d:{n}"], recv.get(f"v:{n}"),
                                       dtypes[n][1]) for n in table.names}))
        bids.append(rbids)
    with _COUNT_LOCK:
        DISPATCH_COUNT += 1
        _LAST_COLLECTIVES = collective_counts(counts)
    return tables, bids
