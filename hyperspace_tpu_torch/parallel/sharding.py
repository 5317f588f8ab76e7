"""The mesh launcher (counterpart of ``hyperspace_tpu/parallel/sharding.py``).

A single controller drives every device of a :class:`~.mesh.Mesh`. Every
distributed path (``execution/spmd.py``, ``parallel/distributed_build.py``,
``parallel/distributed_query.py``) writes its program as a *per-device*
body, as the JAX package does: the body sees one device's shard of each
row-sharded input, a replicated copy of the others, and an :class:`Axis`
whose collectives combine values across the mesh axis ``"d"``:
``psum``, ``pmin``, ``pmax``, ``all_to_all``, ``all_gather`` and the
axis ``index``.

:func:`device_view` runs the body once per device. On one device it is a
plain call: every collective is the identity and nothing else starts (the
H100's case). On ``n`` devices each body runs on a thread of its own, and a
collective is a rendezvous of all ``n``: each thread leaves its value,
every thread combines the same ``n`` values in device order, so the answer
never depends on thread timing.

Eager torch compiles no program: a stage is a plain call of
:func:`device_view`. :func:`bank_program` looks each stage up in the
process-wide program bank (serving/program_bank.py) under the JAX
package's key (stage name, static fingerprint, mesh signature), so the
bank counts the mesh programs the JAX package compiles. The launcher
counts every collective a body issues (device 0's
count: each device issues the same sequence), which :func:`last_collectives`
reports in the JAX package's HLO categories ("all-reduce" for
psum/pmin/pmax, "all-to-all", "all-gather").
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .mesh import Mesh

# The categories the JAX package counts in a compiled program's HLO.
# "collective-permute" and "reduce-scatter" stay 0: no body asks for them.
COLLECTIVE_OPS = ("all-to-all", "all-reduce", "all-gather",
                  "collective-permute", "reduce-scatter")

def mesh_signature(mesh: Mesh) -> tuple:
    """(axis names, device grid shape, platform): the mesh's identity in
    events and stats."""
    return (tuple(mesh.axis_names), (mesh.size,), mesh.platform)


class _Rendezvous:
    """The meeting point of one launch's ``n`` device threads."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots: List = [None] * n


class Axis:
    """The collectives one device's body may call over the mesh axis."""

    def __init__(self, mesh: Mesh, index: int, rdv: Optional[_Rendezvous],
                 counts: Dict[str, int]):
        self.mesh = mesh
        self.index = index
        self.size = mesh.size
        self.device = mesh.devices[index]
        self._rdv = rdv
        self._counts = counts

    def _count(self, op: str) -> None:
        if self.index == 0:
            self._counts[op] = self._counts.get(op, 0) + 1

    def _exchange(self, value) -> list:
        """Every device's ``value``, in device order."""
        rdv = self._rdv
        rdv.slots[self.index] = value
        rdv.barrier.wait()
        parts = list(rdv.slots)
        # A second wait keeps the slots until every device has read them.
        rdv.barrier.wait()
        return parts

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self._rdv is None:
            return x
        parts = self._exchange(x)
        acc = parts[0].to(self.device)
        for p in parts[1:]:
            acc = op(acc, p.to(self.device))
        return acc

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._count("all-reduce")
        return self._reduce(x, torch.add)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        self._count("all-reduce")
        return self._reduce(x, torch.minimum)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._count("all-reduce")
        return self._reduce(x, torch.maximum)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(n, *x.shape)``: every device's ``x`` in device order."""
        self._count("all-gather")
        if self._rdv is None:
            return x.unsqueeze(0)
        return torch.stack([p.to(self.device) for p in self._exchange(x)])

    def all_to_all(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks[j]`` goes to device ``j``; returns the blocks every
        device sent here, in source-device order. Blocks may differ in
        length: the receiver takes what was sent (torch has no static
        shapes to pad to)."""
        self._count("all-to-all")
        if self._rdv is None:
            return list(blocks)
        parts = self._exchange(list(blocks))
        return [parts[j][self.index].to(self.device) for j in range(self.size)]


class _ProcessAxis(Axis):
    """The collectives of a mesh that spans processes, one device each:
    ``torch.distributed`` over the default group (gloo on the CPU, NCCL on
    cards). gloo moves host tensors only, so a rank on a card stages its
    values through host memory there. Reductions gather every rank's value
    and combine them in rank order, as the in-process mesh does, so the
    answer never depends on a backend's reduction tree."""

    def __init__(self, mesh: Mesh, counts: Dict[str, int]):
        import torch.distributed as dist
        super().__init__(mesh, 0, None, counts)
        self.index = mesh.global_index(0)
        self._wire_device = torch.device("cpu") if dist.get_backend() == "gloo" else self.device

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        # gloo moves no bool tensors.
        return (x.to(torch.uint8) if x.dtype == torch.bool else x).to(
            self._wire_device).contiguous()

    def _gathered(self, x: torch.Tensor) -> List[torch.Tensor]:
        import torch.distributed as dist
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w)
        return [p.to(device=self.device, dtype=x.dtype) for p in parts]

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        parts = self._gathered(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = op(acc, p)
        return acc

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._count("all-gather")
        return torch.stack(self._gathered(x))

    def all_to_all(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """gloo's all-to-all moves equal blocks only: every rank learns
        every block's length (one all-gather), pads its blocks to the
        longest, and each receiver trims what it got."""
        import torch.distributed as dist
        self._count("all-to-all")
        sizes = torch.tensor([b.shape[0] for b in blocks], dtype=torch.int64,
                             device=self._wire_device)
        table = [torch.empty_like(sizes) for _ in range(self.size)]
        dist.all_gather(table, sizes)
        longest = max(int(t.max()) for t in table)
        wire = []
        for b in blocks:
            w = self._wire(b)
            pad = longest - w.shape[0]
            if pad:
                w = torch.cat([w, w.new_zeros((pad,) + tuple(w.shape[1:]))])
            wire.append(w)
        out = [torch.empty_like(wire[0]) for _ in range(self.size)]
        dist.all_to_all(out, wire)
        return [o[:int(table[j][self.index])].to(device=self.device, dtype=blocks[0].dtype)
                for j, o in enumerate(out)]


def _local_view(arg, spec: str, i: int, device):
    """Device ``i``'s view of one argument: its shard of a sharded one
    (a list of per-device tensors, or a dict of such lists), the whole of
    a replicated one on its device."""
    if spec == "sharded":
        if isinstance(arg, dict):
            return {k: v[i] for k, v in arg.items()}
        return arg[i]
    if isinstance(arg, dict):
        return {k: v.to(device) for k, v in arg.items()}
    if isinstance(arg, torch.Tensor):
        return arg.to(device)
    return arg


def device_view(fn: Callable, mesh: Mesh, in_specs: Sequence[str],
                counts: Optional[Dict[str, int]] = None) -> Callable:
    """``run(*args)`` calls ``fn(axis, *local_args)`` on every device of
    ``mesh`` and returns the list of per-device results. ``in_specs``
    names each argument "sharded" or "replicated". ``counts`` receives the
    collectives the body issued."""
    counts = {} if counts is None else counts

    def run(*args):
        n = mesh.local_size
        if mesh.multiprocess:
            if n != 1:
                raise NotImplementedError(
                    "a mesh that spans processes holds one device per process")
            dev = mesh.devices[0]
            local = [_local_view(a, s, 0, dev) for a, s in zip(args, in_specs)]
            return [fn(_ProcessAxis(mesh, counts), *local)]
        if n == 1:
            dev = mesh.devices[0]
            local = [_local_view(a, s, 0, dev) for a, s in zip(args, in_specs)]
            return [fn(Axis(mesh, 0, None, counts), *local)]
        rdv = _Rendezvous(n)
        results: List = [None] * n
        errors: List = [None] * n

        def body(i: int) -> None:
            dev = mesh.devices[i]
            try:
                local = [_local_view(a, s, i, dev) for a, s in zip(args, in_specs)]
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    results[i] = fn(Axis(mesh, i, rdv, counts), *local)
            except threading.BrokenBarrierError as e:
                errors[i] = e
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors[i] = e
                rdv.barrier.abort()

        threads = []
        for i in range(n):
            ctx = contextvars.copy_context()
            threads.append(threading.Thread(target=ctx.run, args=(body, i),
                                            name=f"mesh-d{i}", daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # The first real error wins over the broken barriers it caused.
        real = [e for e in errors if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if real:
            raise real[0]
        if any(e is not None for e in errors):
            raise next(e for e in errors if e is not None)
        return results

    return run


def collective_counts(counts: Dict[str, int]) -> Dict[str, int]:
    """Every category of :data:`COLLECTIVE_OPS`, 0 where none was issued."""
    return {op: int(counts.get(op, 0)) for op in COLLECTIVE_OPS}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def shape_vector(args, in_specs: Sequence[str]) -> tuple:
    """The bank's shape-class vector of a launch's arguments: one (global
    shape, dtype) pair per tensor leaf, dict entries in key order (the JAX
    package's tree order). A sharded leaf's global length is the sum of
    its per-device blocks, which are padded as the JAX package pads them."""
    out = []
    for arg, spec in zip(args, in_specs):
        items = [arg[k] for k in sorted(arg)] if isinstance(arg, dict) else [arg]
        for leaf in items:
            if spec == "sharded":
                blocks = list(leaf)
                if not blocks or not isinstance(blocks[0], torch.Tensor):
                    continue
                shape = (sum(int(b.shape[0]) for b in blocks),) + tuple(blocks[0].shape[1:])
                out.append((shape, _dtype_name(blocks[0])))
            elif isinstance(leaf, torch.Tensor):
                out.append((tuple(leaf.shape), _dtype_name(leaf)))
    return tuple(out)


def bank_program(name: str, mesh: Mesh, static_key: tuple, shape_vec: tuple) -> Callable:
    """Look mesh stage ``name`` up in the process-wide program bank under
    (stage name, static fingerprint, mesh signature), as the JAX package
    keys its compiled mesh programs, with ``shape_vec`` as the bank's
    shape-class vector. Returns the launcher, :func:`device_view`: the
    stage runs eagerly, nothing compiled to reuse."""
    from ..serving.program_bank import get_bank
    key = ("spmd", name, static_key, mesh_signature(mesh))
    get_bank().lookup(key, shape_vec, lambda: device_view)
    return device_view
