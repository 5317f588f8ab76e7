"""The serving cluster (``hyperspace_tpu_torch/cluster/``) against the JAX
package's ``cluster/``. The oracle is the JAX package's
``tests/test_cluster.py``.

- the hash ring gives every digest the owner the JAX ring gives it;
- the transport frames, round-trips and retries as the JAX one does, and
  the two talk to each other;
- membership records are one format: either package reads the other's,
  and staleness expires them alike;
- the host gather stacks like ``np.stack`` (threads as ranks), a single
  process gets its array back, and ``native`` gathers over a torch.distributed group;
- disabled, the cluster is a no-op with the same bytes;
- one enabled worker degrades as the JAX one does (node counters and
  events compared scenario by scenario);
- two port processes over one lake (an owner and a client) forward,
  answer from the owner's cache, fall back under an armed
  ``cluster.forward`` with the same bytes, and fire the owner's standing
  query from the client's commit.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.cluster import gather as jgather
from hyperspace_tpu.cluster import hashring as jhashring
from hyperspace_tpu.cluster import membership as jmembership
from hyperspace_tpu.cluster import transport as jtransport
from hyperspace_tpu.cluster import worker as jworker
from hyperspace_tpu.cluster.constants import ClusterConstants as JCC
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.robustness import faults as jfaults
from hyperspace_tpu.serving import fingerprint as jfp
from hyperspace_tpu.serving import frontend as jfrontend
from hyperspace_tpu.telemetry import metric_names as JMN
from hyperspace_tpu.telemetry import span_names as JSN
from hyperspace_tpu_torch.cluster import constants as tconstants
from hyperspace_tpu_torch.cluster import gather as tgather
from hyperspace_tpu_torch.cluster import hashring as thashring
from hyperspace_tpu_torch.cluster import membership as tmembership
from hyperspace_tpu_torch.cluster import transport as ttransport
from hyperspace_tpu_torch.cluster import worker as tworker
from hyperspace_tpu_torch.cluster.constants import ClusterConstants as CC
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.robustness import fault_names as FN
from hyperspace_tpu_torch.robustness import faults as tfaults
from hyperspace_tpu_torch.serving import fingerprint as tfp
from hyperspace_tpu_torch.serving import frontend as tfrontend
from hyperspace_tpu_torch.telemetry import metric_names as MN
from hyperspace_tpu_torch.telemetry import span_names as SN

from conftest import capture_logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_CONF = {"hyperspace.tpu.distributed.enabled": "false",
             "hyperspace.tpu.execution.fusion.enabled": "false",
             IndexConstants.INDEX_NUM_BUCKETS: "4",
             IndexConstants.EVENT_LOGGER_CLASS: "tests.conftest.CaptureLogger"}


class Pkg:
    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.mod = hst if jax else ht
        self.E = JE if jax else TE
        self.worker = jworker if jax else tworker
        self.membership = jmembership if jax else tmembership
        self.transport = jtransport if jax else ttransport
        self.gather = jgather if jax else tgather
        self.hashring = jhashring if jax else thashring
        self.faults = jfaults if jax else tfaults
        self.fp = jfp if jax else tfp
        self.frontend = jfrontend if jax else tfrontend

    def session(self, root, **conf):
        full = dict(BASE_CONF, **conf)
        if self.name == "torch":
            return ht.Session(conf=full, system_path=str(root / "indexes"), device="cpu")
        return hst.Session(conf=full, system_path=str(root / "indexes"))


PKGS = [Pkg("jax"), Pkg("torch")]


@pytest.fixture(autouse=True)
def _fresh_cluster():
    yield
    for p in PKGS:
        p.worker.shutdown_for_tests()
        p.gather.reset_for_tests()
        with p.frontend._DEFAULT_LOCK:
            p.frontend._DEFAULT = None


def frame(seed=17, n=2000):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int64),
                         "v": rng.integers(0, 9, n).astype(np.int64)})


def write_base(d, seed=17):
    os.makedirs(d, exist_ok=True)
    pq.write_table(pa.Table.from_pandas(frame(seed)), os.path.join(d, "p0.parquet"))
    return d


def ipc(table) -> bytes:
    if not isinstance(table, pa.Table):
        table = table.to_arrow()
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def plant_peer(session, p: Pkg, wid, port):
    """A fresh-looking membership record of a worker nobody runs."""
    root = p.membership.membership_dir(session)
    os.makedirs(root, exist_ok=True)
    now = time.time() * 1000.0
    with open(os.path.join(root, f"member-{wid}.json"), "w", encoding="utf-8") as f:
        f.write(json.dumps({"worker_id": wid, "host": "127.0.0.1", "port": port,
                            "pid": 999999, "started_ms": now, "heartbeat_ms": now}))


def variant_owned_by(p: Pkg, session, data, node, owner_wid):
    ids = [m.worker_id for m in node.membership.live_members()]
    t = session.read.parquet(data)
    for i in range(60):
        q = t.filter(p.E.col("k") < 3 + i).select("k", "v")
        key = p.fp.compute_key(session, q.plan)
        if key is None:
            continue
        ring = p.hashring.HashRing(ids, vnodes=tconstants.VNODES)
        if ring.owner(key.digest()) == owner_wid:
            return i, q
    raise AssertionError(f"no variant owned by {owner_wid}")


# ---------------------------------------------------------------------------
# Registries.
# ---------------------------------------------------------------------------

def test_names_and_conf_keys_equal_the_reference():
    assert (SN.CLUSTER_FORWARD, SN.CLUSTER_BROADCAST, SN.CLUSTER_GATHER) == \
        (JSN.CLUSTER_FORWARD, JSN.CLUSTER_BROADCAST, JSN.CLUSTER_GATHER)
    assert (FN.CLUSTER_FORWARD, FN.CLUSTER_BROADCAST) == ("cluster.forward", "cluster.broadcast")
    assert MN.COLLECTOR_CLUSTER == JMN.COLLECTOR_CLUSTER == "cluster"
    # The port keeps the JAX package's keys and defaults for the knobs an
    # operator sets; the rest are module constants with the JAX defaults,
    # and the commit broadcast follows the master switch (its JAX switch
    # defaults to on).
    jkeys = {k: v for k, v in vars(JCC).items() if k.isupper()}
    tkeys = {k: v for k, v in vars(CC).items() if k.isupper()}
    assert tkeys == {k: v for k, v in jkeys.items() if k in tkeys}
    assert set(jkeys) - set(tkeys) == {
        key for name in ("VNODES", "RETRY_MAX_ATTEMPTS", "GATHER_TIMEOUT_MS", "BROADCAST_ENABLED")
        for key in (name, name + "_DEFAULT")}
    assert tconstants.VNODES == int(jkeys["VNODES_DEFAULT"])
    assert tconstants.TRANSPORT_ATTEMPTS == int(jkeys["RETRY_MAX_ATTEMPTS_DEFAULT"])
    assert tconstants.GATHER_TIMEOUT_S == float(jkeys["GATHER_TIMEOUT_MS_DEFAULT"]) / 1000.0
    assert jkeys["BROADCAST_ENABLED_DEFAULT"] == "true"


def test_event_hierarchy_and_fields_equal_the_reference():
    import dataclasses
    from hyperspace_tpu.telemetry import events as jev
    from hyperspace_tpu_torch.telemetry import events as tev
    for name in ("ClusterJoinEvent", "ClusterLeaveEvent", "ClusterForwardEvent",
                 "ClusterBroadcastEvent"):
        assert issubclass(getattr(tev, name), tev.ClusterEvent)
        assert [f.name for f in dataclasses.fields(getattr(tev, name))] == \
            [f.name for f in dataclasses.fields(getattr(jev, name))]


@pytest.mark.parametrize("conf", [{}, {CC.ENABLED: "true", CC.ROUTING_ENABLED: "false"},
                                  {CC.ENABLED: "true", CC.GATHER: "bogus",
                                   CC.HEARTBEAT_MS: "1", CC.STALENESS_MS: "1",
                                   CC.FORWARD_TIMEOUT_MS: "1", CC.PORT: "-5"}])
def test_conf_accessors_match(tmp_path, conf):
    names = ["cluster_enabled", "cluster_worker_id", "cluster_bind", "cluster_port",
             "cluster_dir", "cluster_heartbeat_ms", "cluster_staleness_ms",
             "cluster_routing_enabled", "cluster_forward_timeout_ms",
             "cluster_gather_mode"]
    got = [[getattr(p.session(tmp_path / p.name, **conf).hs_conf, n)() for n in names]
           for p in PKGS]
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# The hash ring.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("members,vnodes", [(["a", "b", "c"], 32), (["w0", "w1"], 64),
                                            (["w-client", "w-owner", "w-third"], 64),
                                            ([f"host-{i}" for i in range(7)], 5)])
def test_ring_owners_equal_the_reference_for_1000_digests(members, vnodes):
    import hashlib
    digests = [hashlib.md5(str(i).encode()).hexdigest()[:12] for i in range(1000)]
    jring = jhashring.HashRing(members, vnodes=vnodes)
    tring = thashring.HashRing(list(reversed(members)), vnodes=vnodes)
    assert [tring.owner(d) for d in digests] == [jring.owner(d) for d in digests]
    assert tring.members == jring.members and len(tring) == len(jring)


def test_ring_join_moves_about_one_over_n():
    keys = [f"digest-{i}" for i in range(2000)]
    before = thashring.HashRing(["w0", "w1", "w2", "w3"])
    after = thashring.HashRing(["w0", "w1", "w2", "w3", "w4"])
    moved = [k for k in keys if before.owner(k) != after.owner(k)]
    assert 0.08 <= len(moved) / len(keys) <= 0.35
    assert all(after.owner(k) == "w4" for k in moved)
    assert thashring.HashRing([]).owner("x") is None


# ---------------------------------------------------------------------------
# The transport.
# ---------------------------------------------------------------------------

def _handler(request):
    if request.get("boom"):
        raise ValueError("boom")
    return {"ok": True, "echo": request.get("x"),
            "twice": None if "arr" not in request else request["arr"] * 2}


@pytest.mark.parametrize("server_pkg,client_pkg", [("torch", "torch"), ("jax", "torch"),
                                                   ("torch", "jax")])
def test_transport_round_trip_and_error_envelope(server_pkg, client_pkg):
    server = {p.name: p for p in PKGS}[server_pkg].transport
    client = {p.name: p for p in PKGS}[client_pkg].transport
    srv = server.Server("127.0.0.1", 0, _handler, name="t")
    try:
        arr = np.arange(12, dtype=np.int64).reshape(3, 4)
        resp = client.send_request(srv.host, srv.port, {"x": [1, "a", (2, 3)], "arr": arr})
        assert resp["echo"] == [1, "a", (2, 3)]
        np.testing.assert_array_equal(resp["twice"], arr * 2)
        bad = client.send_request(srv.host, srv.port, {"boom": True})
        assert bad == {"ok": False, "error": "ValueError: boom"}
    finally:
        srv.stop()


def test_transport_dead_port_retries_alike():
    outs = []
    for p in PKGS:
        srv = p.transport.Server("127.0.0.1", 0, lambda r: r, name="t")
        host, port = srv.host, srv.port
        srv.stop()
        time.sleep(0.05)
        before = p.faults.stats()
        with pytest.raises(OSError) as err:
            p.transport.send_request(host, port, {"op": "ping"}, timeout_s=0.5, attempts=2)
        after = p.faults.stats()
        outs.append((type(err.value).__name__,
                     after["retries"] - before["retries"],
                     after["retry_failures"] - before["retry_failures"]))
    assert outs[0] == outs[1] == ("ConnectionRefusedError", 1, 1)


def test_frame_header_over_the_cap_is_refused():
    import socket
    import struct
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">Q", ttransport.MAX_FRAME_BYTES + 1))
        with pytest.raises(ConnectionError, match="over the cap"):
            ttransport.recv_obj(b)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# Membership.
# ---------------------------------------------------------------------------

def test_membership_register_heartbeat_expire_reclaim(tmp_path):
    def run(p: Pkg):
        s = p.session(tmp_path / p.name, **{CC.STALENESS_MS: "150"})
        M = p.membership.Membership
        steps = []
        a = M(s, "w-a", "127.0.0.1", 1111)
        a.register()
        try:
            M(s, "w-a", "127.0.0.1", 2222).register()
            steps.append("dup registered")
        except FileExistsError:
            steps.append("dup refused")
        b = M(s, "w-b", "127.0.0.1", 3333)
        b.register()
        steps.append([m.worker_id for m in a.live_members()])
        steps.append([m.worker_id for m in a.peers()])
        time.sleep(0.2)
        a.heartbeat()
        steps.append([m.worker_id for m in a.live_members()])
        b2 = M(s, "w-b", "127.0.0.1", 4444)
        b2.register()
        steps.append([(m.worker_id, m.port) for m in b2.live_members()])
        a.leave()
        steps.append([m.worker_id for m in b2.live_members()])
        return steps

    assert run(PKGS[0]) == run(PKGS[1]) == [
        "dup refused", ["w-a", "w-b"], ["w-b"], ["w-a"], [("w-a", 1111), ("w-b", 4444)],
        ["w-b"]]


def test_membership_records_cross_read(tmp_path):
    """One roster format: the JAX package's records are live members to the
    port and the other way round; torn records are skipped by both."""
    js = PKGS[0].session(tmp_path)
    ts = PKGS[1].session(tmp_path)
    assert jmembership.membership_dir(js) == tmembership.membership_dir(ts)
    j = jmembership.Membership(js, "w-jax", "127.0.0.1", 1)
    t = tmembership.Membership(ts, "w-torch", "127.0.0.1", 2)
    j.register()
    t.register()
    with open(os.path.join(tmembership.membership_dir(ts), "member-torn.json"), "w") as f:
        f.write('{"worker_id": "torn", "ho')
    assert [m.worker_id for m in t.live_members()] == ["w-jax", "w-torch"]
    assert [m.worker_id for m in j.live_members()] == ["w-jax", "w-torch"]
    assert [m.port for m in t.peers()] == [1]


def test_heartbeat_daemon_refreshes(tmp_path):
    s = PKGS[1].session(tmp_path, **{CC.HEARTBEAT_MS: "50"})
    a = tmembership.Membership(s, "w-a", "127.0.0.1", 1111)
    a.register()
    first = a.live_members()[0].heartbeat_ms
    a.start_heartbeat()
    deadline = time.time() + 5.0
    while time.time() < deadline and a.live_members()[0].heartbeat_ms <= first:
        time.sleep(0.02)
    assert a.live_members()[0].heartbeat_ms > first
    a.leave()


# ---------------------------------------------------------------------------
# The host gather.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x", [np.arange(6, dtype=np.int64),
                               np.arange(12, dtype=np.float32).reshape(3, 4),
                               np.array([b"ab", b"c"], dtype=object)])
def test_single_process_gather_is_the_identity(x):
    out = tgather.allgather(x)
    assert out.dtype == x.dtype and out.shape == x.shape and np.array_equal(out, x)
    assert jgather.allgather(x).shape == out.shape


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_threaded_three_rank_star_equals_np_stack(tmp_path, pkg):
    g = {p.name: p for p in PKGS}[pkg].gather
    rdv = str(tmp_path / "rdv")
    parts = [np.array([1000 * r + 7, r + 1], dtype=np.int64) for r in range(3)]
    out, errors = [None] * 3, []

    def rank(r):
        try:
            out[r] = g.host_allgather(parts[r], rank=r, n=3, seq=1, rendezvous_dir=rdv,
                                      timeout_s=30.0)
        except Exception as e:  # collected for the assertion
            errors.append(f"rank {r}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    for r in range(3):
        np.testing.assert_array_equal(out[r], np.stack(parts))


def test_allgather_modes(tmp_path):
    """Two ranks through ``allgather`` (rank 1 a thread through the star);
    ``native`` without a torch.distributed process group raises the typed
    error naming the group (with one it gathers over it:
    tests/test_torch_multihost.py); ``auto`` without a process group takes
    the host path."""
    tgather.init_process(0, 2, f"test-{tmp_path}")
    ident = tgather.process_identity()
    rdv = tgather._rendezvous_dir(ident[2])
    other = {}

    def rank1():
        other["out"] = tgather.host_allgather(np.array([5, 6]), rank=1, n=2, seq=1,
                                              rendezvous_dir=rdv, timeout_s=30.0)

    th = threading.Thread(target=rank1)
    th.start()
    got = tgather.allgather(np.array([3, 4]))
    th.join(timeout=60)
    np.testing.assert_array_equal(got, [[3, 4], [5, 6]])
    np.testing.assert_array_equal(other["out"], got)
    tgather.force_mode("native")
    with pytest.raises(tgather.NativeGatherUnavailable, match="process group"):
        tgather.allgather(np.array([1]))
    tgather.force_mode(None)
    assert tgather._mode() == "auto"


# ---------------------------------------------------------------------------
# Disabled: a no-op.
# ---------------------------------------------------------------------------

def test_disabled_is_a_no_op_with_the_same_bytes(tmp_path):
    answers = []
    for p in PKGS:
        root = tmp_path / p.name
        data = write_base(str(root / "tbl"))
        s = p.session(root)
        assert p.worker.get_node(s) is None and p.worker.maybe_node() is None
        front = p.frontend.ServingFrontend(s)
        q = s.read.parquet(data).filter(p.E.col("k") == 7).select("k", "v")
        base = ipc(q.to_arrow())
        got = ipc(front.submit(q).result(timeout=120))
        hs = p.mod.Hyperspace(s)
        answers.append((base == got, os.path.exists(root / "indexes" / "_hst_cluster"),
                        "worker=" in hs.metrics_text(), p.worker.broadcast_commit(s, "tbl"),
                        sorted(hs.fleet_metrics()["workers"]), got))
    assert answers[0] == answers[1]
    assert answers[1][:5] == (True, False, False, 0, ["local"])


def test_config_hash_ignores_cluster_keys(tmp_path):
    plain = PKGS[1].session(tmp_path)
    tuned = PKGS[1].session(tmp_path, **{CC.ENABLED: "true", CC.WORKER_ID: "w-elsewhere",
                                         CC.PORT: "12345", CC.FORWARD_TIMEOUT_MS: "5"})
    assert tfp.config_hash(plain) == tfp.config_hash(tuned)


# ---------------------------------------------------------------------------
# One enabled worker, each scenario through both packages.
# ---------------------------------------------------------------------------

def solo(p: Pkg, root, **conf):
    data = write_base(str(root / "tbl"))
    s = p.session(root, **{CC.ENABLED: "true", CC.WORKER_ID: "w-solo", **conf})
    node = p.worker.get_node(s)
    assert node is not None
    return s, data, node


def events_of(kind):
    return [e for e in capture_logger().events if type(e).__name__ == kind]


def test_lifecycle_ping_and_metrics_surfaces(tmp_path):
    outs = []
    for p in PKGS:
        capture_logger().events.clear()
        s, data, node = solo(p, tmp_path / p.name)
        me = node.membership.live_members()[0]
        ping = p.transport.send_request(me.host, me.port, {"op": "ping"})
        hs = p.mod.Hyperspace(s)
        text = hs.metrics_text()
        fleet = hs.fleet_metrics()
        members = hs.metrics()["collectors"]["cluster"]["members"]
        p.worker.shutdown_for_tests()
        outs.append((node.worker_id, ping, 'worker="w-solo"' in text,
                     text.rstrip().endswith("# EOF"), sorted(fleet["workers"]),
                     bool(fleet["aggregate"]), members,
                     [type(e).__name__ for e in capture_logger().events
                      if type(e).__name__.startswith("Cluster")]))
    assert outs[0] == outs[1]
    assert outs[1][:3] == ("w-solo", {"ok": True, "worker": "w-solo"}, True)
    assert outs[1][7] == ["ClusterJoinEvent", "ClusterLeaveEvent"]


def test_lonely_worker_serves_locally(tmp_path):
    outs = []
    for p in PKGS:
        s, data, node = solo(p, tmp_path / p.name)
        q = s.read.parquet(data).filter(p.E.col("k") == 5).select("k", "v")
        got = ipc(p.frontend.ServingFrontend(s).submit(q).result(timeout=120))
        outs.append((got == ipc(q.to_arrow()), got, node.stats()))
    assert outs[0] == outs[1] and outs[1][0]
    assert outs[1][2]["forwarded"] == 0 and outs[1][2]["members"] == 1


@pytest.mark.parametrize("how", ["unreachable", "injected"])
def test_forward_falls_back_with_the_same_bytes(tmp_path, how):
    outs = []
    for p in PKGS:
        capture_logger().events.clear()
        s, data, node = solo(p, tmp_path / p.name, **{CC.FORWARD_TIMEOUT_MS: "300"})
        plant_peer(s, p, "w-gone", port=1)  # nothing listens on port 1
        _, q = variant_owned_by(p, s, data, node, "w-gone")
        base = ipc(q.to_arrow())
        front = p.frontend.ServingFrontend(s)
        before = p.faults.stats()
        if how == "injected":
            reg = p.faults.FaultRegistry.from_conf_specs({"cluster.forward": "error:p=1"},
                                                         seed=7)
            with p.faults.scope(reg):
                got = ipc(front.submit(q).result(timeout=120))
            hits = reg.hit_count("cluster.forward")
        else:
            got = ipc(front.submit(q).result(timeout=120))
            hits = None
        after = p.faults.stats()
        fwd = events_of("ClusterForwardEvent")
        # The variant differs between packages: each keys its plans its own
        # way, so each ring places them on its own.
        outs.append((got == base, node.stats()["forward_fallbacks"], hits,
                     [(e.owner, e.ok, e.hit) for e in fwd],
                     after.get("cluster_forward_fallbacks", 0)
                     - before.get("cluster_forward_fallbacks", 0)))
    assert outs[0] == outs[1]
    assert outs[1][0] and outs[1][1] == 1 and outs[1][3] == [("w-gone", False, False)]


def test_broadcast_failure_and_fault_degrade(tmp_path):
    outs = []
    for p in PKGS:
        capture_logger().events.clear()
        s, data, node = solo(p, tmp_path / p.name, **{CC.FORWARD_TIMEOUT_MS: "300"})
        plant_peer(s, p, "w-gone", port=1)
        first = node.broadcast_commit("tbl")
        failures = node.stats()["broadcast_failures"]
        reg = p.faults.FaultRegistry.from_conf_specs({"cluster.broadcast": "error:p=1"},
                                                     seed=7)
        with p.faults.scope(reg):
            second = node.broadcast_commit("tbl", batches=3)
        outs.append((first, failures, second, node.stats()["broadcast_failures"],
                     reg.hit_count("cluster.broadcast"),
                     [(e.peers, e.delivered, e.batches)
                      for e in events_of("ClusterBroadcastEvent")]))
    assert outs[0] == outs[1] == (0, 1, 0, 2, 1, [(1, 0, 0), (1, 0, 3)])


def test_forward_refused_on_a_fingerprint_mismatch(tmp_path):
    """An owner whose key for the plan differs (conf or lake drift) refuses
    the forward, and the sender runs the query itself."""
    s, data, node = solo(PKGS[1], tmp_path)
    me = node.membership.live_members()[0]
    import pickle
    q = s.read.parquet(data).filter(TE.col("k") == 1).select("k", "v")
    resp = ttransport.send_request(me.host, me.port, {
        "op": "forward", "digest": "not-the-digest", "plan": pickle.dumps(q.plan)})
    assert resp["ok"] is False and "fingerprint mismatch" in resp["error"]
    assert node.stats()["forward_refused"] == 1


# ---------------------------------------------------------------------------
# Two port processes over one lake.
# ---------------------------------------------------------------------------

CHILD_SETUP = textwrap.dedent("""
    import json, os, sys, time
    import numpy as np
    import pandas as pd
    import pyarrow as pa
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.cluster import worker as cw
    from hyperspace_tpu_torch.cluster.constants import ClusterConstants as CC
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.serving.constants import ServingConstants as SC
    from hyperspace_tpu_torch.serving.frontend import get_frontend

    LAKE, RUN, WID = sys.argv[1], sys.argv[2], sys.argv[3]
    DATA = os.path.join(LAKE, "tbl")
    session = ht.Session(system_path=os.path.join(LAKE, "indexes"), device="cpu", conf={
        "hyperspace.index.num.buckets": "4", SC.SERVING_ENABLED: "true",
        SC.RESULT_CACHE_ENABLED: "true", SC.RESULT_CACHE_MIN_COMPUTE_SECONDS: "0",
        CC.ENABLED: "true", CC.WORKER_ID: WID, CC.HEARTBEAT_MS: "200",
        CC.FORWARD_TIMEOUT_MS: "60000"})
""")

OWNER_BODY = textwrap.dedent("""
    node = cw.get_node(session)
    fe = get_frontend(session)
    sub = fe.subscribe(session.read.parquet(DATA).filter(col("k") == 7).select("k", "v"))
    with open(os.path.join(RUN, "owner-ready"), "w") as f:
        f.write(json.dumps({"pid": os.getpid(), "worker": node.worker_id}))
    t = sub.wait_for(1, timeout=180.0)[0].result.to_arrow()
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    with open(os.path.join(RUN, "owner-fired"), "wb") as f:
        f.write(sink.getvalue().to_pybytes())
    while True:  # serve forwards until the client kills us
        time.sleep(0.2)
""")

CLIENT_BODY = textwrap.dedent("""
    from hyperspace_tpu_torch.cluster.hashring import HashRing
    from hyperspace_tpu_torch.robustness import faults
    from hyperspace_tpu_torch.serving.fingerprint import compute_key

    def ipc(table):
        t = table.to_arrow()
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, t.schema) as w:
            w.write_table(t)
        return sink.getvalue().to_pybytes().hex()

    node = cw.get_node(session)
    fe = get_frontend(session)
    hs = ht.Hyperspace(session)
    deadline = time.time() + 120
    while len(node.membership.live_members()) < 2:
        assert time.time() < deadline, "owner never joined"
        time.sleep(0.05)

    def owned_variant(owner_wid):
        ids = [m.worker_id for m in node.membership.live_members()]
        t = session.read.parquet(DATA)
        for i in range(60):
            q = t.filter(col("k") < 3 + i).select("k", "v")
            key = compute_key(session, q.plan)
            ring = HashRing(ids)
            if key is not None and ring.owner(key.digest()) == owner_wid:
                return i, q
        raise AssertionError("no variant owned by " + owner_wid)

    out = {}
    i, q = owned_variant("w-owner")
    out["variant"] = i
    out["local"] = ipc(q)
    out["first"] = ipc(fe.submit(q).result(timeout=180.0))
    s1 = node.stats()
    out["first_forwarded"] = [s1["forwarded"], s1["forward_hits"]]
    out["second"] = ipc(fe.submit(q).result(timeout=180.0))
    s2 = node.stats()
    out["second_forwarded"] = [s2["forwarded"], s2["forward_hits"]]
    reg = faults.FaultRegistry.from_conf_specs({"cluster.forward": "error"})
    with faults.scope(reg):
        out["armed"] = ipc(fe.submit(q).result(timeout=180.0))
    out["armed_fallbacks"] = node.stats()["forward_fallbacks"]
    fleet = hs.fleet_metrics()
    out["fleet_workers"] = sorted(fleet["workers"])
    owner_cl = fleet["workers"].get("w-owner", {}).get("collectors", {}).get("cluster", {})
    out["owner_cache_hits"] = owner_cl.get("forward_cache_hits", 0)
    out["label"] = 'worker="w-client"' in hs.metrics_text()
    rng = np.random.default_rng(4)
    hs.append(DATA, pd.DataFrame({"k": rng.integers(0, 40, 80).astype(np.int64),
                                  "v": rng.integers(0, 9, 80).astype(np.int64)}))
    hs.commit(DATA)
    out["broadcasts_sent"] = node.stats()["broadcasts_sent"]
    out["after_commit"] = ipc(session.read.parquet(DATA).filter(col("k") == 7)
                              .select("k", "v"))
    with open(os.path.join(RUN, "summary.json"), "w") as f:
        f.write(json.dumps(out))
""")


def test_two_port_processes_forward_fall_back_and_broadcast(tmp_path):
    write_base(str(tmp_path / "tbl"))
    run = tmp_path / "run"
    run.mkdir()
    (run / "owner.py").write_text(CHILD_SETUP + OWNER_BODY)
    (run / "client.py").write_text(CHILD_SETUP + CLIENT_BODY)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    owner = subprocess.Popen([sys.executable, str(run / "owner.py"), str(tmp_path), str(run),
                              "w-owner"], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not (run / "owner-ready").exists():
            if owner.poll() is not None:
                raise AssertionError(f"owner died early:\n{owner.stdout.read()}")
            assert time.time() < deadline, "owner never came up"
            time.sleep(0.1)
        client = subprocess.run([sys.executable, str(run / "client.py"), str(tmp_path),
                                 str(run), "w-client"], env=env, capture_output=True,
                                text=True, timeout=300)
        assert client.returncode == 0, f"{client.stdout}\n{client.stderr}"
        out = json.loads((run / "summary.json").read_text())
        deadline = time.time() + 60
        while not (run / "owner-fired").exists() and time.time() < deadline:
            time.sleep(0.1)
        fired = (run / "owner-fired").read_bytes().hex()
    finally:
        if owner.poll() is None:
            owner.kill()
        owner.wait(timeout=30)

    # The JAX package's answers on the same lake, before and after the
    # client's commit (its appended file is in the lake now).
    js = PKGS[0].session(tmp_path / "jax")
    appended = js.read.parquet(str(tmp_path / "tbl"))
    after = bytes.fromhex(out["after_commit"])
    assert ipc(appended.filter(JE.col("k") == 7).select("k", "v").to_arrow()) == after
    assert out["first"] == out["second"] == out["armed"] == out["local"]
    assert out["first_forwarded"] == [1, 0] and out["second_forwarded"] == [2, 1]
    assert out["armed_fallbacks"] == 1 and out["owner_cache_hits"] == 1
    assert out["fleet_workers"] == ["w-client", "w-owner"] and out["label"]
    assert out["broadcasts_sent"] == 1
    assert fired == out["after_commit"]
