"""Several processes, one mesh (counterpart of
``hyperspace_tpu/parallel/multihost.py``).

Every process runs the same program; ``initialize_multihost`` joins it to
a ``torch.distributed`` process group (gloo on the CPU, NCCL on cards) and
pins each rank to its own card, and ``global_mesh()`` is then one mesh
over the job: this process's device at its rank's place. The mesh's
collectives cross processes over the group (``parallel/sharding``), and
the cluster's ``native`` gather uses it too.
What changes for a caller is its input: each process feeds its own
disjoint slice of the source (``pad_and_shard(..., process_local=True)``);
a full copy read by every process is refused rather than duplicated.
String columns build across processes through a global dictionary union
(``distributed_build._union_string_dictionaries``).

A single process skips the group entirely: ``global_mesh()`` is then
``make_mesh()``, every visible card. Either way the mesh is on the card
unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..exceptions import HyperspaceException
from .mesh import Mesh, make_mesh

# The coordinator address this process joined with ("" for one process):
# the cluster gather's rendezvous key.
_COORDINATOR = ""


def last_coordinator_address() -> str:
    return _COORDINATOR


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         local_rank: Optional[int] = None) -> dict:
    """Join this process to the job's process group (idempotent; a no-op
    for one process). The backend defaults to NCCL when CUDA is visible,
    else gloo. Where CUDA is visible the process drives card ``local_rank``
    (by default its rank modulo the host's cards), so ranks on one host
    never share a card. A coordinator with one process is refused: running
    alone would compute over a fraction of the data. Returns {initialized,
    process_index, process_count, local_devices, global_devices}."""
    import torch.distributed as dist

    global _COORDINATOR
    coordinator = coordinator_address
    n_proc = int(num_processes or 0)
    if coordinator and n_proc <= 1:
        raise ValueError("Coordinator address set but num_processes <= 1; pass the "
                         "job's process count (and this process's id) in every process")
    initialized = False
    if coordinator and n_proc > 1:
        pid = int(process_id or 0)
        if torch.cuda.is_available():
            torch.cuda.set_device(int(local_rank) if local_rank is not None
                                  else pid % torch.cuda.device_count())
        if not dist.is_initialized():
            if backend is None:
                backend = "nccl" if torch.cuda.is_available() else "gloo"
            dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                    world_size=n_proc, rank=pid)
        _COORDINATOR = str(coordinator)
        from ..cluster import gather as _gather
        _gather.init_process(dist.get_rank(), dist.get_world_size(), _COORDINATOR)
        initialized = True
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"initialized": initialized, "process_index": rank, "process_count": world,
            "local_devices": 1, "global_devices": world}


def _local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else its card (the one
    ``initialize_multihost`` pinned)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise HyperspaceException("global_mesh: no CUDA device is visible; pass device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh(device=None) -> Mesh:
    """The data mesh over the job: every visible card for one process
    (``make_mesh()``), one device a process under a group. ``device``
    ("cpu") asks for the CPU instead."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return make_mesh(None if device is None else [torch.device(device)])
    return Mesh([_local_device(device)], processes=dist.get_world_size(), rank=dist.get_rank())
