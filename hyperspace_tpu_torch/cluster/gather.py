"""The host allgather of the cluster (counterpart of
``hyperspace_tpu/cluster/gather.py``): the one place a host-side
allgather decides its transport.

:func:`allgather` stacks an array across the processes of one job. A single
process gets its array back untouched. Several pick a path by
``cluster.gather``:

- ``host``: the star over the cluster transport. Rank 0 runs a gather hub
  (one blocking slot per sequence number); every rank, rank 0 included,
  sends its array and blocks until the hub answers with all ``n`` parts
  stacked in rank order. Sequence numbers are per-process and count up, so
  program order keeps them aligned across ranks. The rendezvous is a port
  file under the system temp dir, keyed by the job's coordinator address.
- ``native``: ``all_gather`` over ``torch.distributed``'s process group
  (``parallel/multihost.initialize_multihost`` joins it); without an
  initialized group it raises :class:`NativeGatherUnavailable`.
- ``auto``: ``host`` while ``torch.distributed`` has no initialized
  process group (the reference's verdict for a backend without
  multiprocess collectives), else ``native``.

A process names its place in the job with :func:`init_process` (rank,
count, coordinator address); without it the identity is the initialized
process group's, else rank 0 of 1. The result is ``(n, *x.shape)``, the
parts in rank order.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..exceptions import HyperspaceException
from ..parallel import io as pio
from ..telemetry import span_names as SN
from ..telemetry import trace as _trace
from . import transport
from .constants import GATHER_TIMEOUT_S

_HUB_LOCK = threading.Lock()
_HUB = None        # rank 0's running (_GatherHub, Server, rendezvous dir)
_SEQ = 0           # this process's gather sequence number
_FORCED = None     # the test seam: force "native" or "host" over the conf
_IDENTITY: Optional[Tuple[int, int, str]] = None  # (rank, n, coordinator)


class NativeGatherUnavailable(HyperspaceException):
    """``cluster.gather=native`` without an initialized
    ``torch.distributed`` process group."""


def init_process(rank: int, n: int, coordinator: str) -> None:
    """This process's place in a job of ``n`` processes; ``coordinator``
    names the job (its rendezvous directory)."""
    global _IDENTITY
    with _HUB_LOCK:
        _IDENTITY = (int(rank), int(n), str(coordinator))


def force_mode(mode: Optional[str]) -> None:
    """Pin the path ("native" or "host"), or None to follow the conf."""
    global _FORCED
    with _HUB_LOCK:
        _FORCED = mode


def reset_for_tests() -> None:
    """Stop the hub, remove its rendezvous directory, and forget the
    identity, the pin and the sequence."""
    global _HUB, _SEQ, _FORCED, _IDENTITY
    with _HUB_LOCK:
        if _HUB is not None:
            _HUB[1].stop()
            shutil.rmtree(_HUB[2], ignore_errors=True)
        _HUB = None
        _SEQ = 0
        _FORCED = None
        _IDENTITY = None


def _process_group() -> Optional[Tuple[int, int]]:
    """(rank, world size) of an initialized torch.distributed group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def process_identity() -> Tuple[int, int, str]:
    """(rank, process count, coordinator) of this process."""
    with _HUB_LOCK:
        ident = _IDENTITY
    if ident is not None:
        return ident
    pg = _process_group()
    if pg is not None:
        return pg[0], pg[1], "torch.distributed"
    return 0, 1, "local"


def _mode() -> str:
    with _HUB_LOCK:
        if _FORCED is not None:
            return _FORCED
    session = pio.active_session()
    return session.hs_conf.cluster_gather_mode() if session is not None else "auto"


def allgather(x: np.ndarray) -> np.ndarray:
    """Stack ``x`` across every process of the job."""
    rank, n, coordinator = process_identity()
    x = np.asarray(x)
    if n <= 1:
        return x
    mode = _mode()
    if mode == "auto":
        mode = "host" if _process_group() is None else "native"
    if mode == "native":
        return _native_allgather(x)
    global _SEQ
    with _HUB_LOCK:
        _SEQ += 1
        seq = _SEQ
    with _trace.span(SN.CLUSTER_GATHER):
        return host_allgather(x, rank=rank, n=n, seq=seq,
                              rendezvous_dir=_rendezvous_dir(coordinator),
                              timeout_s=GATHER_TIMEOUT_S)


def _native_allgather(x: np.ndarray) -> np.ndarray:
    """``all_gather`` over the initialized process group (every rank's
    ``x`` has one shape and dtype, as the host star requires too)."""
    import torch
    import torch.distributed as dist
    if _process_group() is None:
        raise NativeGatherUnavailable(
            "cluster.gather=native needs an initialized torch.distributed process group "
            "(parallel/multihost.initialize_multihost); use cluster.gather=host or auto")
    src = np.ascontiguousarray(x)
    wire = src.view(np.uint8) if src.dtype == np.bool_ else src
    t = torch.from_numpy(wire.copy())
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    with _trace.span(SN.CLUSTER_GATHER):
        dist.all_gather(parts, t)
    out = np.stack([p.cpu().numpy() for p in parts])
    return out.view(np.bool_) if src.dtype == np.bool_ else out


def _rendezvous_dir(coordinator: str) -> str:
    """One rendezvous directory per job, keyed by its coordinator."""
    digest = hashlib.md5(coordinator.encode("utf-8")).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"hst-gather-{digest}")


class _GatherHub:
    """Rank 0's accumulator: one slot per sequence number, each collecting
    ``n`` parts, then answering every rank blocked on it."""

    def __init__(self, n: int):
        self._n = n
        self._cond = threading.Condition()
        self._slots = {}  # seq -> {"parts": {rank: array}, "served": int}

    def handle(self, request: dict) -> dict:
        if request.get("op") != "gather":
            return {"ok": False, "error": "gather hub: unknown op"}
        seq = int(request["seq"])
        rank = int(request["rank"])
        deadline = time.monotonic() + float(request.get("timeout_s", 60.0))
        with self._cond:
            slot = self._slots.setdefault(seq, {"parts": {}, "served": 0})
            slot["parts"][rank] = request["payload"]
            if len(slot["parts"]) >= self._n:
                self._cond.notify_all()
            while len(slot["parts"]) < self._n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"ok": False,
                            "error": f"gather hub: seq {seq} timed out at "
                                     f"{len(slot['parts'])}/{self._n} parts"}
                self._cond.wait(remaining)
            parts = [slot["parts"][r] for r in range(self._n)]
            slot["served"] += 1
            if slot["served"] >= self._n:
                del self._slots[seq]  # every rank has its answer
        return {"ok": True, "parts": parts}


def host_allgather(x: np.ndarray, *, rank: int, n: int, seq: int, rendezvous_dir: str,
                   timeout_s: float = 60.0) -> np.ndarray:
    """The star allgather, with rank, count and sequence explicit, so a test
    can run every rank as a thread of one process."""
    host, port = _hub_address(rank, n, rendezvous_dir, timeout_s)
    response = transport.send_request(
        host, port, {"op": "gather", "seq": seq, "rank": rank, "n": n,
                     "payload": np.asarray(x), "timeout_s": timeout_s},
        timeout_s=timeout_s, attempts=3)
    if not response.get("ok"):
        raise RuntimeError(f"cluster gather failed: {response.get('error', 'unknown')}")
    parts: List[np.ndarray] = [np.asarray(p) for p in response["parts"]]
    return np.stack(parts)


def _hub_address(rank: int, n: int, rendezvous_dir: str, timeout_s: float) -> tuple:
    """Rank 0 starts the hub once and publishes its port; the others poll
    the port file until it appears."""
    global _HUB
    portfile = os.path.join(rendezvous_dir, "hub-port")
    if rank == 0:
        with _HUB_LOCK:
            if _HUB is None:
                hub = _GatherHub(n)
                server = transport.Server("127.0.0.1", 0, hub.handle, name="cluster-gather")
                os.makedirs(rendezvous_dir, exist_ok=True)
                tmp = portfile + f".tmp.{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(f"{server.host} {server.port}")
                os.replace(tmp, portfile)
                _HUB = (hub, server, rendezvous_dir)
            server = _HUB[1]
        return server.host, server.port
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with open(portfile, "r", encoding="utf-8") as f:
                text = f.read().strip()
            if text:
                host, port = text.split()
                return host, int(port)
        except OSError:
            pass  # rank 0 is not up yet
        if time.monotonic() > deadline:
            raise TimeoutError(f"cluster gather: no hub port file at {portfile} "
                               f"within {timeout_s}s")
        time.sleep(0.02)
