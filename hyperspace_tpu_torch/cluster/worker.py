"""Cluster node: one process's seat in the shared-nothing fleet
(counterpart of ``hyperspace_tpu/cluster/worker.py``).

A :class:`ClusterNode` ties the tiers together: the transport server
(``ping``, ``forward``, ``commit`` and ``metrics`` requests), the
lake-resident membership record with its heartbeat, the consistent-hash
router the serving frontend asks per submission, and the commit broadcast
that makes standing queries fire on every worker.

The node is lazy and process-wide: ``get_node(session)`` starts it on first
use when ``cluster.enabled`` is set and returns None otherwise, one conf
read. Every failure degrades: an owner that does not answer, a refused
forward or an injected ``cluster.forward`` fault runs the query locally, to
the same bytes; a failed or injected ``cluster.broadcast`` costs that peer
one standing-query fire, never the commit.

A forwarded answer crosses processes as host data: the owner moves its
table to the CPU before pickling it, and the sender puts it back on its
own session's device. Bytes equal the owner's answer.
"""

from __future__ import annotations

import os
import pickle
import platform
import threading
import time
from typing import Optional

from ..robustness import fault_names as FN
from ..robustness import faults as _faults
from ..telemetry import metric_names as MN
from ..telemetry import span_names as SN
from ..telemetry import trace as _trace
from . import transport
from .constants import TRANSPORT_ATTEMPTS, VNODES
from .hashring import HashRing
from .membership import MemberInfo, Membership

_NODE = None
_NODE_LOCK = threading.Lock()
# A forward handler's own submit never routes again (membership drift could
# bounce a query between owners); thread-local, as each handler runs on its
# connection's thread.
_HANDLING = threading.local()


def get_node(session) -> Optional["ClusterNode"]:
    """The process's node, started on first use; None while the cluster is
    disabled."""
    global _NODE
    if not session.hs_conf.cluster_enabled():
        return None
    node = _NODE
    if node is not None:
        return node
    with _NODE_LOCK:
        if _NODE is None:
            _NODE = ClusterNode(session)
        return _NODE


def maybe_node() -> Optional["ClusterNode"]:
    """The running node, if any; never starts one (the exposition label
    and the stats surfaces must not boot a cluster)."""
    return _NODE


def shutdown_for_tests() -> None:
    """Stop the process's node (a clean leave), if one runs."""
    global _NODE
    with _NODE_LOCK:
        node = _NODE
        _NODE = None
    if node is not None:
        node.stop()


def _table_on(table, device):
    """``table`` with every tensor on ``device`` (CPU before pickling; the
    sender's device after)."""
    from ..execution.buffer_pool import _moved
    return _moved(table, device, False)


class ClusterNode:
    """One worker: transport server, membership, router and broadcast."""

    def __init__(self, session):
        self._session = session
        conf = session.hs_conf
        self._lock = threading.Lock()
        self._stats = {
            "forwarded": 0, "forward_hits": 0, "forward_fallbacks": 0,
            "forward_served": 0, "forward_cache_hits": 0, "forward_executed": 0,
            "forward_refused": 0, "broadcasts_sent": 0, "broadcast_failures": 0,
            "broadcasts_received": 0,
        }
        self._server = transport.Server(conf.cluster_bind(), conf.cluster_port(),
                                        self._dispatch, name="cluster")
        wid = conf.cluster_worker_id() or f"{platform.node()}-{os.getpid()}"
        self.membership = Membership(session, wid, self._server.host, self._server.port)
        try:
            self.membership.register()
        except FileExistsError:
            # A live record holds the identity (two nodes, one configured
            # id): salt ours rather than take theirs.
            wid = f"{wid}-{self._server.port}"
            self.membership = Membership(session, wid, self._server.host, self._server.port)
            self.membership.register()
        self.worker_id = wid
        self.membership.start_heartbeat()
        from ..telemetry import metrics as _metrics
        _metrics.get_registry().register_collector(MN.COLLECTOR_CLUSTER, self.stats)
        from ..telemetry.events import ClusterJoinEvent
        self._emit(ClusterJoinEvent(
            message=f"cluster worker {wid} joined at {self._server.host}:{self._server.port}",
            worker_id=wid, host=self._server.host, port=self._server.port))

    def stop(self) -> None:
        from ..telemetry.events import ClusterLeaveEvent
        self._emit(ClusterLeaveEvent(message=f"cluster worker {self.worker_id} leaving",
                                     worker_id=self.worker_id))
        self.membership.leave()
        self._server.stop()

    # Request dispatch.

    def _dispatch(self, request: dict):
        op = request.get("op")
        if op == "ping":
            return {"ok": True, "worker": self.worker_id}
        if op == "forward":
            return self._handle_forward(request)
        if op == "commit":
            return self._handle_commit(request)
        if op == "metrics":
            return self._handle_metrics(request)
        return {"ok": False, "error": f"cluster: unknown op {op!r}"}

    def _handle_forward(self, request: dict) -> dict:
        from ..serving.fingerprint import compute_key
        from ..serving.frontend import get_frontend
        plan = pickle.loads(request["plan"])
        key = compute_key(self._session, plan)
        if key is None or key.digest() != request.get("digest"):
            self._note(forward_refused=1)
            return {"ok": False, "error": "fingerprint mismatch: sender and owner disagree "
                                          "on the plan's cache key (conf or lake drift)"}
        fe = get_frontend(self._session)
        cache = fe.result_cache()
        found = cache.get(key) if cache is not None else None
        if found is not None:
            self._note(forward_served=1, forward_cache_hits=1)
            return {"ok": True, "hit": True, "table": _table_on(found[0], "cpu")}
        _HANDLING.active = True
        try:
            pending = fe.submit(plan, session=self._session, client=request.get("client", ""),
                                deadline_ms=request.get("deadline_ms"))
        finally:
            _HANDLING.active = False
        table = pending.result(timeout=float(request.get("timeout_s", 30.0)))
        self._note(forward_served=1, forward_executed=1)
        return {"ok": True, "hit": False, "table": _table_on(table, "cpu")}

    def _handle_commit(self, request: dict) -> dict:
        from ..serving import frontend as _frontend
        table = str(request.get("table", ""))
        fired = 0
        for fe in _frontend.all_frontends():
            try:
                fe.notify_commit(self._session, table)
                fired += 1
            except Exception:
                pass  # one sick frontend must not mute the rest
        self._note(broadcasts_received=1)
        return {"ok": True, "frontends": fired}

    def _handle_metrics(self, request: dict) -> dict:
        from ..telemetry import metrics as _metrics
        return {"ok": True, "worker": self.worker_id,
                "metrics": _metrics.get_registry().snapshot()}

    # The router.

    def route_owner(self, digest: str) -> Optional[MemberInfo]:
        """The live member owning ``digest`` on the ring, or None when this
        worker (or nobody) owns it."""
        members = self.membership.live_members()
        if len(members) < 2:
            return None
        ring = HashRing([m.worker_id for m in members],
                        vnodes=VNODES)
        wid = ring.owner(digest)
        if wid is None or wid == self.worker_id:
            return None
        return next((m for m in members if m.worker_id == wid), None)

    def forward(self, owner: MemberInfo, plan, digest: str, *, client: str = "",
                deadline_ms: Optional[float] = None, est: int = 0, device=None):
        """Ship one submission to its shard owner: a finished PendingQuery
        (its table on ``device``) on success, None to run locally."""
        from ..serving.context import next_query_id
        from ..serving.frontend import PendingQuery
        from ..telemetry.events import ClusterForwardEvent
        conf = self._session.hs_conf
        timeout_s = conf.cluster_forward_timeout_ms() / 1000.0
        t0 = time.perf_counter()
        try:
            with _trace.span(SN.CLUSTER_FORWARD) as sp:
                _faults.fault_point(FN.CLUSTER_FORWARD)
                response = transport.send_request(
                    owner.host, owner.port,
                    {"op": "forward", "digest": digest,
                     "plan": pickle.dumps(plan, protocol=pickle.HIGHEST_PROTOCOL),
                     "client": client, "deadline_ms": deadline_ms, "timeout_s": timeout_s,
                     "origin": self.worker_id},
                    timeout_s=timeout_s, attempts=TRANSPORT_ATTEMPTS,
                    session=self._session)
                if sp is not None:
                    sp.attrs["owner"] = owner.worker_id
                    sp.attrs["ok"] = bool(response.get("ok"))
            if not response.get("ok"):
                raise RuntimeError(response.get("error", "forward refused"))
        except Exception as e:
            self._note(forward_fallbacks=1)
            _faults.note(cluster_forward_fallbacks=1)
            self._emit(ClusterForwardEvent(
                message=(f"forward to {owner.worker_id} degraded to local execution: "
                         f"{type(e).__name__}: {e}"),
                worker_id=self.worker_id, owner=owner.worker_id, key_digest=digest, ok=False,
                millis=(time.perf_counter() - t0) * 1000.0))
            return None
        hit = bool(response.get("hit"))
        table = response["table"]
        pending = PendingQuery(next_query_id(), client, est)
        pending._finish(result=_table_on(table, device) if device is not None else table)
        self._note(forwarded=1, forward_hits=int(hit))
        self._emit(ClusterForwardEvent(
            message=f"forwarded to {owner.worker_id} ({'cache hit' if hit else 'executed'})",
            worker_id=self.worker_id, owner=owner.worker_id, key_digest=digest, ok=True,
            hit=hit, millis=(time.perf_counter() - t0) * 1000.0))
        return pending

    # The commit broadcast.

    def broadcast_commit(self, table: str, batches: int = 0) -> int:
        """One commit notice to every live peer; returns the count
        delivered. ``batches`` is the wave's width (group commit sends one
        notice a wave). A peer's failure costs it one fire and is counted,
        never raised."""
        from ..telemetry.events import ClusterBroadcastEvent
        conf = self._session.hs_conf
        if not conf.cluster_enabled():
            return 0
        peers = self.membership.peers()
        if not peers:
            return 0
        timeout_s = conf.cluster_forward_timeout_ms() / 1000.0
        delivered = 0
        with _trace.span(SN.CLUSTER_BROADCAST) as sp:
            for peer in peers:
                try:
                    _faults.fault_point(FN.CLUSTER_BROADCAST)
                    response = transport.send_request(
                        peer.host, peer.port,
                        {"op": "commit", "table": table, "origin": self.worker_id,
                         "batches": batches},
                        timeout_s=timeout_s, attempts=TRANSPORT_ATTEMPTS,
                        session=self._session)
                    if response.get("ok"):
                        delivered += 1
                    else:
                        self._note(broadcast_failures=1)
                except Exception:
                    self._note(broadcast_failures=1)
            if sp is not None:
                sp.attrs["peers"] = len(peers)
                sp.attrs["delivered"] = delivered
        self._note(broadcasts_sent=delivered)
        self._emit(ClusterBroadcastEvent(
            message=(f"commit notice for {table!r} "
                     + (f"({batches} batches) " if batches else "")
                     + f"delivered to {delivered}/{len(peers)} peers"),
            worker_id=self.worker_id, table=table, peers=len(peers), delivered=delivered,
            batches=batches))
        return delivered

    # Surfaces.

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
        out["members"] = len(self.membership.live_members())
        return out

    def _note(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._stats[k] = self._stats.get(k, 0) + v

    def _emit(self, event) -> None:
        from ..telemetry.logging import log_event
        log_event(self._session, event)


def try_forward(session, plan, norm, *, client: str = "",
                deadline_ms: Optional[float] = None, est: int = 0):
    """The frontend's router hook: a finished PendingQuery when a remote
    shard owner answered, None to run locally. Called only once
    ``cluster_routing_enabled()`` holds."""
    if getattr(_HANDLING, "active", False):
        return None  # a forwarded execution never forwards again
    node = get_node(session)
    if node is None:
        return None
    from ..serving.fingerprint import compute_key
    key = compute_key(session, plan, normalized=norm)
    if key is None:
        return None  # a plan that is not cacheable has no shard
    digest = key.digest()
    owner = node.route_owner(digest)
    if owner is None:
        return None
    return node.forward(owner, plan, digest, client=client, deadline_ms=deadline_ms, est=est,
                        device=session.device)


def broadcast_commit(session, table: str, batches: int = 0) -> int:
    """The ingest hook: a commit notice to the fleet (0 while the cluster
    is disabled). One call per publication wave."""
    node = get_node(session)
    if node is None:
        return 0
    return node.broadcast_commit(table, batches=batches)
