"""The one-device SPMD dispatch (``distributed.singleDevice``) of the port
against the JAX package's, over a one-device mesh on both sides.

``on`` runs the per-device program on the one device (both dispatch
counters advance, and the answers are equal bit for bit), ``off`` keeps the
staged executor, and ``auto`` dispatches on a CUDA session and not on the
CPU (the JAX package keys ``auto`` on its backend). The five
``distributed.*`` keys carry the JAX package's defaults.
"""

import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hj
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import spmd as jspmd
from hyperspace_tpu.index.constants import IndexConstants as JIC
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu_torch.execution import spmd as tspmd
from hyperspace_tpu_torch.index.constants import IndexConstants as TIC
from hyperspace_tpu_torch.plan import expr as TE

KEYS = ("TPU_DISTRIBUTED_ENABLED", "TPU_DISTRIBUTED_SINGLE_DEVICE",
        "TPU_DISTRIBUTED_MESH_MAX_DEVICES", "TPU_DISTRIBUTED_MIN_STREAM_ROWS")


@pytest.fixture(autouse=True)
def one_device(monkeypatch):
    monkeypatch.setattr(jspmd, "_device_count", lambda *a: 1)
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device("cpu")])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("single")
    rng = np.random.default_rng(70)
    out = {}
    for name, table in (
            ("l", pa.table({"k": rng.integers(0, 50, 2000).astype(np.int64),
                            "g": rng.integers(0, 7, 2000).astype(np.int64),
                            "v": np.round(rng.uniform(0, 10, 2000), 3)})),
            ("r", pa.table({"rk": np.arange(50, dtype=np.int64),
                            "w": rng.integers(0, 100, 50).astype(np.int64)})),
            ("rdup", pa.table({"rk": rng.integers(0, 50, 200).astype(np.int64),
                               "w": np.arange(200, dtype=np.int64)}))):
        d = root / name
        d.mkdir()
        pq.write_table(table, str(d / "part0.parquet"))
        out[name] = str(d)
    return out


QUERIES = {
    "filtered_grouped_aggregate": lambda f, E: f["l"].filter(E.col("k") < 30).group_by(
        "g").agg(E.count(None).alias("n"), E.sum_(E.col("v")).alias("sv")),
    "global_aggregate": lambda f, E: f["l"].filter(E.col("k") < 30).agg(
        E.sum_(E.col("v")).alias("sv"), E.avg(E.col("v")).alias("av")),
    "join_then_aggregate": lambda f, E: f["l"].join(
        f["r"], on=E.col("k") == E.col("rk")).group_by("g").agg(E.sum_(E.col("w")).alias("sw")),
    "row_returning_stream": lambda f, E: f["l"].filter(E.col("k") < 10).select("k", "v"),
    "exchange_join_degenerates_cleanly": lambda f, E: f["l"].join(
        f["rdup"], on=E.col("k") == E.col("rk")).group_by("k").agg(E.count(None).alias("n")),
}


def _run(pkg, s, E, dirs, name):
    f = {n: s.read.parquet(d) for n, d in dirs.items()}
    return QUERIES[name](f, E).to_arrow()


def _sessions(tmp_path, mode):
    js = hj.Session(system_path=str(tmp_path / "j"))
    ts = ht.Session(system_path=str(tmp_path / "t"), device="cpu")
    for s in (js, ts):
        s.conf.set(TIC.TPU_DISTRIBUTED_MIN_STREAM_ROWS, "0")
        s.conf.set(TIC.TPU_DISTRIBUTED_SINGLE_DEVICE, mode)
    return js, ts


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_on_dispatches_and_equals_jax(dirs, tmp_path, name):
    js, ts = _sessions(tmp_path, "on")
    j0, t0 = jspmd.DISPATCH_COUNT, tspmd.DISPATCH_COUNT
    want = _run("jax", js, JE, dirs, name)
    got = _run("torch", ts, TE, dirs, name)
    assert jspmd.DISPATCH_COUNT > j0 and tspmd.DISPATCH_COUNT > t0
    assert got.equals(want)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_off_stays_staged_and_equals_jax(dirs, tmp_path, name):
    js, ts = _sessions(tmp_path, "off")
    j0, t0 = jspmd.DISPATCH_COUNT, tspmd.DISPATCH_COUNT
    want = _run("jax", js, JE, dirs, name)
    got = _run("torch", ts, TE, dirs, name)
    assert jspmd.DISPATCH_COUNT == j0 and tspmd.DISPATCH_COUNT == t0
    assert got.equals(want)


def test_auto_stays_off_on_the_cpu(dirs, tmp_path):
    js, ts = _sessions(tmp_path, "auto")
    j0, t0 = jspmd.DISPATCH_COUNT, tspmd.DISPATCH_COUNT
    _run("jax", js, JE, dirs, "filtered_grouped_aggregate")
    _run("torch", ts, TE, dirs, "filtered_grouped_aggregate")
    assert jspmd.DISPATCH_COUNT == j0 and tspmd.DISPATCH_COUNT == t0


@pytest.mark.parametrize("device,want", [("cuda", True), ("cpu", False)])
def test_auto_keys_on_the_session_device(device, want, monkeypatch, tmp_path):
    """``auto`` is on exactly for a CUDA session's one-device mesh; ``off``
    is off for both."""
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device(session.device)])
    ts = ht.Session(system_path=str(tmp_path), device="cpu")
    session = types.SimpleNamespace(hs_conf=ts.hs_conf, device=device)
    assert tspmd._spmd_eligible(session) is want
    ts.conf.set(TIC.TPU_DISTRIBUTED_SINGLE_DEVICE, "off")
    assert not tspmd._spmd_eligible(session)


def test_conf_keys_and_defaults_equal_jax():
    for k in KEYS:
        assert getattr(TIC, k) == getattr(JIC, k)
        assert getattr(TIC, k + "_DEFAULT") == getattr(JIC, k + "_DEFAULT")
    # fileAlignedScan is no key of the port: a multi-file leaf always
    # shards on file boundaries, the reference's default.
    assert not hasattr(TIC, "TPU_DISTRIBUTED_MESH_FILE_ALIGNED_SCAN")
    assert JIC.TPU_DISTRIBUTED_MESH_FILE_ALIGNED_SCAN_DEFAULT == "true"


@pytest.mark.parametrize("value", ["garbage", "ON", "true", "false", "auto"])
def test_single_device_values_parse_as_jax(value, tmp_path):
    js = hj.Session(system_path=str(tmp_path / "j"))
    ts = ht.Session(system_path=str(tmp_path / "t"), device="cpu")
    js.conf.set(TIC.TPU_DISTRIBUTED_SINGLE_DEVICE, value)
    ts.conf.set(TIC.TPU_DISTRIBUTED_SINGLE_DEVICE, value)
    try:
        want = js.hs_conf.distributed_single_device()
    except Exception as e:
        with pytest.raises(ht.HyperspaceException) as got:
            ts.hs_conf.distributed_single_device()
        assert str(got.value) == str(e)
        return
    assert ts.hs_conf.distributed_single_device() == want


def _xla_tree_sum(x: np.ndarray) -> float:
    """XLA's CPU reduction order: windows of 32 added one by one from 0.0,
    centre-padded to a multiple of 32, until at most 32 values remain."""
    vals = [float(v) for v in x]
    while len(vals) > 32:
        pad = -(-len(vals) // 32) * 32 - len(vals)
        vals = [0.0] * (pad // 2) + vals + [0.0] * (pad - pad // 2)
        nxt = []
        for i in range(0, len(vals), 32):
            acc = 0.0
            for v in vals[i:i + 32]:
                acc += v
            nxt.append(acc)
        vals = nxt
    acc = 0.0
    for v in vals:
        acc += v
    return acc


def test_one_device_float_sum_keeps_the_staged_order(tmp_path):
    """Queue C item 22, held by design: on one device the port's global
    float sum adds row by row, the staged executor's order, so a dispatched
    query and the same query on the staged route (a serving batch's) agree
    bit for bit; the reference's one-device program adds in XLA's tree
    order over its padded shard. Each side equals its own oracle, and here
    the two differ."""
    from hyperspace_tpu_torch.shapes import padded_length
    rng = np.random.default_rng(11)
    n = 6000
    k = rng.integers(0, 500, n).astype(np.int64)
    rng.integers(0, 7, n)
    v = np.round(rng.uniform(0, 10, n), 3)
    d = tmp_path / "f"
    d.mkdir()
    for i in range(3):
        pq.write_table(pa.table({"k": k[i * 2000:(i + 1) * 2000],
                                 "v": v[i * 2000:(i + 1) * 2000]}), str(d / f"p{i}.parquet"))
    js, ts = _sessions(tmp_path, "on")
    got = {}
    for pkg, s, E in (("jax", js, JE), ("torch", ts, TE)):
        got[pkg] = s.read.parquet(str(d)).filter(E.col("k") < 300).agg(
            E.sum_(E.col("v")).alias("sv")).to_arrow()["sv"][0].as_py()
    seq = 0.0
    for x in v[k < 300]:
        seq += float(x)
    # The pushed filter reads only the kept rows; the shard pads them to
    # their length class.
    kept = v[k < 300]
    tree = _xla_tree_sum(np.concatenate([kept, np.zeros(padded_length(len(kept)) - len(kept))]))
    assert got["torch"] == seq
    assert got["jax"] == tree
    assert got["torch"] != got["jax"]
    ts.conf.set(TIC.TPU_DISTRIBUTED_SINGLE_DEVICE, "off")
    staged = ts.read.parquet(str(d)).filter(TE.col("k") < 300).agg(
        TE.sum_(TE.col("v")).alias("sv")).to_arrow()["sv"][0].as_py()
    assert staged == got["torch"]
