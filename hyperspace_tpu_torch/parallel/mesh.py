"""The device mesh (counterpart of ``hyperspace_tpu/parallel/mesh.py``).

A 1-D mesh over the data axis ``d``: an ordered list of torch devices.
Buckets are assigned to devices in contiguous ranges, so the build's
bucket exchange is one all-to-all and each device's output is already
grouped for the bucketed parquet write.

A row-sharded array is a list of per-device tensors, one per local device
(device ``i``'s rows ``[i * shard, (i + 1) * shard)`` of the padded
whole), with a validity mask sharded the same way. Torch needs no static
shapes, but the shard boundaries are the JAX package's (the rows' length
class under the session's ``shapeBucketing.*`` conf, from ``shapes.py``,
split evenly), so every device holds the rows it holds there: partial sums
and exchange orders then agree.

A mesh that spans several processes (``parallel/multihost.global_mesh``)
lists this process's devices and carries the job's process count; its
collectives cross processes over ``torch.distributed``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..exceptions import HyperspaceException

DATA_AXIS = "d"


class Mesh:
    """Devices on the axis ``d``. ``devices`` are this process's;
    ``processes`` is the job's process count (1 unless the mesh spans a
    ``torch.distributed`` group), and ``rank`` this process's place."""

    axis_names = (DATA_AXIS,)

    def __init__(self, devices: Sequence, processes: int = 1, rank: int = 0):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise HyperspaceException("a mesh needs at least one device")
        self.processes = int(processes)
        self.rank = int(rank)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local_size * self.processes

    @property
    def platform(self) -> str:
        return self.devices[0].type

    @property
    def multiprocess(self) -> bool:
        return self.processes > 1

    def global_index(self, local: int) -> int:
        return self.rank * self.local_size + local


def mesh_devices(session=None) -> List[torch.device]:
    """The devices a session's mesh spans (the query dispatch's and the
    mesh build's): every visible CUDA device for a CUDA session, the one
    CPU device for a CPU session, capped by ``distributed.mesh.maxDevices``
    (0 = no cap). The tests build a several-device CPU mesh by replacing
    this function."""
    dev = torch.device(session.device) if session is not None else torch.device("cpu")
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    if session is not None:
        cap = session.hs_conf.distributed_mesh_max_devices()
        if cap > 0:
            devices = devices[:cap]
    return devices


def session_mesh(session=None) -> Mesh:
    """The mesh over :func:`mesh_devices`."""
    return Mesh(mesh_devices(session))


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices``, by default every visible CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise HyperspaceException("make_mesh: no CUDA device is visible; pass devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(list(devices))


def _split(a: torch.Tensor, bounds: Sequence[int], shard: int, devices) -> List[torch.Tensor]:
    """Device ``i`` gets ``a[bounds[i]:bounds[i+1]]`` zero-padded to
    ``shard`` rows, on its device."""
    parts = []
    for i, dev in enumerate(devices):
        lo, hi = min(int(bounds[i]), a.shape[0]), min(int(bounds[i + 1]), a.shape[0])
        blk = a[lo:hi]
        if blk.shape[0] < shard:
            blk = torch.cat([blk, torch.zeros((shard - blk.shape[0],) + tuple(a.shape[1:]),
                                              dtype=a.dtype, device=a.device)])
        parts.append(blk.to(dev))
    return parts


def _valid_shards(sizes: Sequence[int], shard: int, devices) -> List[torch.Tensor]:
    out = []
    for size, dev in zip(sizes, devices):
        v = torch.zeros(shard, dtype=torch.bool, device=dev)
        v[:size] = True
        out.append(v)
    return out


def pad_and_shard(mesh: Mesh, arrays: Dict[str, torch.Tensor], rows: int,
                  process_local: bool = False, pad_rows: Optional[int] = None) -> tuple:
    """Pad each array to a device multiple (at least ``pad_rows``), split it
    evenly over the mesh and build the validity mask. Returns (name -> list
    of per-device shards, list of per-device valid masks).

    On a mesh that spans processes, ``process_local=True`` says ``arrays``
    hold this process's disjoint slice; a full copy read by every process
    would duplicate rows, so it is refused."""
    if mesh.multiprocess:
        if not process_local:
            raise NotImplementedError(
                "pad_and_shard over a multi-process mesh needs process-local input rows "
                "(process_local=True); sharding a full-dataset copy from every process "
                "would duplicate rows")
        return _pad_and_shard_multihost(mesh, arrays, rows)
    n_dev = mesh.size
    cur_max = max((int(a.shape[0]) for a in arrays.values()), default=0)
    target = max(rows, pad_rows or 0, cur_max, 1)
    shard = -(-target // n_dev)
    bounds = [i * shard for i in range(n_dev + 1)]
    sizes = [max(0, min(rows, bounds[i + 1]) - bounds[i]) for i in range(n_dev)]
    out = {n: _split(a, bounds, shard, mesh.devices) for n, a in arrays.items()}
    return out, _valid_shards(sizes, shard, mesh.devices)


def pad_and_shard_blocks(mesh: Mesh, arrays: Dict[str, torch.Tensor], bounds,
                         shard_rows: Optional[int] = None) -> tuple:
    """File-aligned sharding: ``bounds`` (``n_dev + 1`` ascending row
    offsets) give each device a contiguous block of whole files, padded to
    the largest block (or ``shard_rows``); the mask marks each block's
    rows. Same rows in the same order as the even split."""
    n_dev = mesh.size
    if len(bounds) != n_dev + 1:
        raise ValueError("bounds must have n_dev + 1 offsets")
    sizes = [int(bounds[i + 1]) - int(bounds[i]) for i in range(n_dev)]
    shard = max(max(sizes), shard_rows or 0, 1)
    out = {}
    for name, a in arrays.items():
        parts = []
        for i, dev in enumerate(mesh.devices):
            blk = a[int(bounds[i]):int(bounds[i + 1])]
            if sizes[i] < shard:
                blk = torch.cat([blk, torch.zeros((shard - sizes[i],) + tuple(a.shape[1:]),
                                                  dtype=a.dtype, device=a.device)])
            parts.append(blk.to(dev))
        out[name] = parts
    return out, _valid_shards(sizes, shard, mesh.devices)


def _pad_and_shard_multihost(mesh: Mesh, arrays: Dict[str, torch.Tensor], rows: int) -> tuple:
    """This process's rows onto its devices of a multi-process mesh. Every
    process pads to the worldwide largest local block (one allgather of
    (rows, local devices) through the cluster's gather seam), so every
    device's shard has one size."""
    from ..cluster import gather as _gather

    n_local = mesh.local_size
    stats = np.asarray(_gather.allgather(np.array([rows, n_local], np.int64)))
    stats = stats.reshape(-1, 2)
    if not (stats[:, 1] == n_local).all():
        raise NotImplementedError(
            "multi-process pad_and_shard requires every process to hold the same number "
            f"of mesh-local devices; saw {stats[:, 1].tolist()}")
    shard = -(-max(int(stats[:, 0].max()), 1) // n_local)
    bounds = [i * shard for i in range(n_local + 1)]
    sizes = [max(0, min(rows, bounds[i + 1]) - bounds[i]) for i in range(n_local)]
    out = {n: _split(a, bounds, shard, mesh.devices) for n, a in arrays.items()}
    return out, _valid_shards(sizes, shard, mesh.devices)


def device_bucket_range(device_index: int, n_devices: int, num_buckets: int) -> tuple:
    """Contiguous bucket range [lo, hi) owned by a device."""
    lo = (device_index * num_buckets) // n_devices
    hi = ((device_index + 1) * num_buckets) // n_devices
    return lo, hi


def bucket_owner(bucket_ids: torch.Tensor, n_devices: int, num_buckets: int) -> torch.Tensor:
    """Device index owning each bucket id (inverse of device_bucket_range)."""
    owner = (bucket_ids.to(torch.int64) * n_devices) // num_buckets
    return torch.clamp(owner, max=n_devices - 1)
