"""The mesh tier's SPMD query dispatch (``hyperspace_tpu_torch/execution/
spmd.py``) against the JAX package's on an 8-device CPU mesh.

The JAX package runs at its default (the 8 virtual devices of
``tests/conftest.py``, ``distributed.enabled`` on); the port's mesh is 8
entries of ``torch.device("cpu")``, made by replacing ``parallel/mesh.mesh_devices``
(the one function that lists the mesh's devices). Every query runs through
both packages' public DataFrame API on the same numpy-seeded parquet lake:
the Arrow results must be equal (rows, order and float64 bits), and both
packages' dispatch counters must advance. The shapes are those of the JAX
package's ``test_spmd.py``, ``test_spmd_outer.py``, ``test_spmd_sort.py``,
``test_spmd_wide.py`` and ``test_spmd_many_groups.py``. Declined shapes
must decline alike: the same ``DistributedFallbackEvent`` (where, reason)
on both sides, or none.
"""

import importlib
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hj
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import spmd as jspmd
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu_torch.execution import spmd as tspmd
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.plan import expr as TE

N_DEV = 8
MIN_ROWS = IndexConstants.TPU_DISTRIBUTED_MIN_STREAM_ROWS


@pytest.fixture(autouse=True)
def mesh8(monkeypatch):
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device("cpu")] * N_DEV)


def _write(root, name, table, parts=1):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    step = -(-table.num_rows // parts)
    for i in range(parts):
        pq.write_table(table.slice(i * step, step), os.path.join(d, f"part{i}.parquet"))
    return d


def _nullable(values, rng, p):
    return [None if rng.random() < p else v for v in values.tolist()]


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spmd_lake"))
    rng = np.random.default_rng(11)
    n = 6000
    v = np.round(rng.uniform(100, 1000, n), 2)
    fact = pa.table({
        "k": rng.integers(0, 500, n).astype(np.int64),
        "k2": rng.integers(0, 6, n).astype(np.int32),
        "g": rng.integers(0, 7, n).astype(np.int64),
        "qty": rng.integers(1, 50, n).astype(np.int64),
        "v": v,
        "nv": pa.array(_nullable(v, rng, 0.12), type=pa.float64()),
        "nk": pa.array(_nullable(rng.integers(0, 60, n), rng, 0.1), type=pa.int64()),
        "tag": rng.choice(["a", "b", "c", "d"], n),
    })
    dim = pa.table({
        "dk": np.arange(500, dtype=np.int64),
        "dk2": (np.arange(500) % 6).astype(np.int32),
        "w": rng.integers(0, 100, 500).astype(np.int64),
        "dname": rng.choice(["x", "y", "z"], 500),
        "dn": pa.array(_nullable(rng.integers(0, 9, 500), rng, 0.3), type=pa.int64()),
    })
    mn = pa.table({
        "rk": rng.integers(0, 520, 900).astype(np.int64),
        "rw": np.arange(900, dtype=np.int64),
        "rtag": rng.choice(["p", "q"], 900),
    })
    nullkeys = pa.table({
        "rk": pa.array(_nullable(rng.integers(0, 80, 300), rng, 0.2), type=pa.int64()),
        "rw": np.arange(300, dtype=np.int64),
    })
    names = np.array([f"n{i:03d}" for i in range(40)])
    skew = np.where(rng.random(3000) < 0.6, 7, rng.integers(0, 400, 3000)).astype(np.int64)
    dirs = {
        "fact": _write(root, "fact", fact, parts=6),
        "dim": _write(root, "dim", dim),
        "mn": _write(root, "mn", mn),
        "nullkeys": _write(root, "nullkeys", nullkeys),
        "skew": _write(root, "skew", pa.table({"k": skew, "v": np.arange(3000,
                                                                            dtype=np.int64)})),
        "skewr": _write(root, "skewr", pa.table({
            "rk": np.concatenate([np.full(40, 7), rng.integers(0, 400, 200)]).astype(np.int64),
            "w": np.arange(240, dtype=np.int64)})),
        "sl": _write(root, "sl", pa.table({"sk": names[rng.integers(0, 40, 2000)],
                                           "sv": np.arange(2000, dtype=np.int64)})),
        "sr": _write(root, "sr", pa.table({"srk": names[rng.integers(0, 40, 300)],
                                           "sw": np.arange(300, dtype=np.int64)})),
        "mk": _write(root, "mk", pa.table({
            "a": rng.integers(0, 20, 4000).astype(np.int64),
            "b": rng.integers(0, 10, 4000).astype(np.int32),
            "c": rng.choice(["u", "v", "w"], 4000),
            "mv": np.arange(4000, dtype=np.int64)})),
        "mkr": _write(root, "mkr", pa.table({
            "ra": rng.integers(0, 22, 500).astype(np.int64),
            "rb": rng.integers(0, 11, 500).astype(np.int32),
            "rc": rng.choice(["u", "w", "zz"], 500),
            "mw": np.arange(500, dtype=np.int64)})),
    }
    csv_dir = os.path.join(root, "csv")
    os.makedirs(csv_dir)
    pacsv.write_csv(fact.select(["k", "g", "qty"]), os.path.join(csv_dir, "f.csv"))
    dirs["csv"] = csv_dir
    return dirs


def _sessions(tmp_path, conf=None):
    conf = dict(conf or {})
    conf.setdefault(MIN_ROWS, "0")
    js = hj.Session(system_path=str(tmp_path / "sj"))
    ts = ht.Session(system_path=str(tmp_path / "st"), device="cpu")
    for k, v in conf.items():
        js.conf.set(k, v)
        ts.conf.set(k, v)
    return js, ts


def _frames(s, E, lake):
    rd = s.read.parquet
    return {n: rd(lake[n]) for n in lake if n != "csv"}


# name -> builder(frames, E); each returns the DataFrame to run.
QUERIES = {
    # Global aggregates (test_spmd.py::TestGlobalAggregate).
    "global_filter_sum_count": lambda f, E: f["fact"].filter(E.col("qty") > 25).agg(
        E.sum_(E.col("v")).alias("sv"), E.count(None).alias("n")),
    "global_min_max_avg": lambda f, E: f["fact"].filter(E.col("tag") != "d").agg(
        E.min_(E.col("v")).alias("mn"), E.max_(E.col("qty")).alias("mx"),
        E.avg(E.col("v")).alias("av")),
    "global_min_max_string": lambda f, E: f["fact"].filter(E.col("qty") < 10).agg(
        E.min_(E.col("tag")).alias("mn"), E.max_(E.col("tag")).alias("mx")),
    "global_arithmetic": lambda f, E: f["fact"].agg(
        E.sum_(E.col("v") * E.col("qty")).alias("rev")),
    "global_nullable": lambda f, E: f["fact"].filter(E.col("k") < 250).agg(
        E.sum_(E.col("nv")).alias("s"), E.count(E.col("nv")).alias("n"),
        E.avg(E.col("nv")).alias("a")),
    "global_range_q6": lambda f, E: f["fact"].filter(
        (E.col("qty") >= 5) & (E.col("qty") <= 24)).agg(E.sum_(E.col("v")).alias("s")),
    # Grouped aggregates (TestGroupedAggregate, test_spmd_many_groups.py).
    "grouped_int": lambda f, E: f["fact"].filter(E.col("k") < 300).group_by("g").agg(
        E.sum_(E.col("v")).alias("sv"), E.count(None).alias("n"), E.max_(E.col("v")).alias("mx")),
    "grouped_string_two_keys": lambda f, E: f["fact"].group_by("tag", "k2").agg(
        E.avg(E.col("v")).alias("a"), E.min_(E.col("qty")).alias("mq")),
    "grouped_nullable_key": lambda f, E: f["fact"].group_by("nk").agg(
        E.count(None).alias("n"), E.sum_(E.col("nv")).alias("s")),
    "grouped_many_groups": lambda f, E: f["fact"].group_by("k", "g").agg(
        E.sum_(E.col("v")).alias("s")),
    "distinct": lambda f, E: f["fact"].select("k2", "tag").distinct(),
    # Broadcast joins (test_spmd.py, test_spmd_outer.py broadcast cases).
    "bcast_inner_grouped": lambda f, E: f["fact"].join(
        f["dim"], on=E.col("k") == E.col("dk")).group_by("dname").agg(
        E.sum_(E.col("w")).alias("sw"), E.sum_(E.col("v")).alias("sv")),
    "bcast_left_stream": lambda f, E: f["fact"].filter(E.col("k") < 40).join(
        f["dim"].filter(E.col("w") < 50), on=E.col("k") == E.col("dk"), how="left").select(
        "k", "v", "dk", "w", "dn"),
    "bcast_left_group_nullable_right": lambda f, E: f["fact"].join(
        f["dim"], on=E.col("k") == E.col("dk"), how="left").group_by("dn").agg(
        E.count(None).alias("n"), E.sum_(E.col("w")).alias("sw")),
    "bcast_two_key_agg": lambda f, E: f["fact"].join(
        f["dim"], on=(E.col("k") == E.col("dk")) & (E.col("k2") == E.col("dk2"))).agg(
        E.count(None).alias("n"), E.sum_(E.col("w")).alias("sw")),
    # Exchange joins (test_spmd_outer.py, test_spmd_wide.py).
    "xchg_inner_rows": lambda f, E: f["fact"].filter(E.col("k") < 120).join(
        f["mn"], on=E.col("k") == E.col("rk")).select("k", "v", "rw", "rtag"),
    "xchg_left": lambda f, E: f["fact"].filter(E.col("k") < 200).join(
        f["mn"], on=E.col("k") == E.col("rk"), how="left").select("k", "rk", "rw"),
    "xchg_full": lambda f, E: f["fact"].filter(E.col("k") < 200).join(
        f["mn"], on=E.col("k") == E.col("rk"), how="full").select("k", "g", "rk", "rw"),
    "xchg_full_agg_null_group": lambda f, E: f["fact"].filter(E.col("k") < 200).join(
        f["mn"], on=E.col("k") == E.col("rk"), how="full").group_by("g").agg(
        E.count(None).alias("n"), E.sum_(E.col("rw")).alias("s")),
    "xchg_full_null_keys": lambda f, E: f["fact"].filter(E.col("k") < 100).join(
        f["nullkeys"], on=E.col("nk") == E.col("rk"), how="full").select("nk", "rk", "rw"),
    "xchg_right_null_keys": lambda f, E: f["fact"].filter(E.col("k") < 100).join(
        f["nullkeys"], on=E.col("nk") == E.col("rk"), how="right").select("k", "rk", "rw"),
    "xchg_projected_key_full": lambda f, E: f["fact"].filter(E.col("k") < 60).select(
        (E.col("k") + 1).alias("k2p"), "v").join(
        f["mn"], on=E.col("k2p") == E.col("rk"), how="full").select("k2p", "v", "rk", "rw"),
    "xchg_string_key_left": lambda f, E: f["sl"].join(
        f["sr"], on=E.col("sk") == E.col("srk"), how="left").select("sk", "sv", "srk", "sw"),
    "xchg_two_key_m_n": lambda f, E: f["mk"].join(
        f["mkr"], on=(E.col("a") == E.col("ra")) & (E.col("b") == E.col("rb"))).group_by(
        "a").agg(E.count(None).alias("n"), E.sum_(E.col("mw")).alias("s")),
    "xchg_three_key_left": lambda f, E: f["mk"].join(
        f["mkr"], on=(E.col("a") == E.col("ra")) & (E.col("b") == E.col("rb"))
        & (E.col("c") == E.col("rc")), how="left").select("a", "b", "c", "mv", "mw"),
    # Semi and anti (existence probes).
    "semi_rows": lambda f, E: f["fact"].join(
        f["mn"], on=E.col("k") == E.col("rk"), how="semi").select("k", "v"),
    "anti_rows": lambda f, E: f["fact"].join(
        f["mn"], on=E.col("k") == E.col("rk"), how="anti").select("k", "v"),
    "semi_aggregate": lambda f, E: f["fact"].join(
        f["mn"], on=E.col("k") == E.col("rk"), how="semi").group_by("g").agg(
        E.sum_(E.col("v")).alias("s")),
    # Row-returning streams (test_spmd_wide.py::TestRowReturning).
    "stream_filter": lambda f, E: f["fact"].filter(
        (E.col("k") < 50) & (E.col("tag") != "b")).select("k", "tag", "v"),
    "stream_project_expr": lambda f, E: f["fact"].filter(E.col("k2") == 3).select(
        "k", (E.col("v") * 2.0).alias("v2"), (E.col("qty") + E.col("k")).alias("s")),
    "stream_nullable_outputs": lambda f, E: f["fact"].filter(E.col("qty") < 20).select(
        "nk", "nv", "tag"),
    "stream_filter_sort_limit": lambda f, E: f["fact"].filter(E.col("k") < 200).select(
        "k", "v").sort("v").limit(25),
}
SORTS = {
    # The sample sort (test_spmd_sort.py), forced on as the JAX tests force it.
    "sort_ascending_int": lambda f, E: f["fact"].filter(E.col("qty") < 30).select(
        "k", "v").sort("k"),
    "sort_descending_nullable_nulls_last": lambda f, E: f["fact"].select(
        "k", "nv").sort(("nv", False)),
    "sort_ascending_nullable_nulls_first": lambda f, E: f["fact"].select(
        "k", "nk").sort("nk"),
    "sort_string_then_int_desc": lambda f, E: f["fact"].select(
        "tag", "k", "v").sort("tag", ("k", False)),
    "sort_under_limit": lambda f, E: f["fact"].select("k", "v").sort(("v", False)).limit(17),
    "sort_join_then_sort": lambda f, E: f["fact"].join(
        f["mn"], on=E.col("k") == E.col("rk")).select("k", "rw").sort("rw", "k"),
    "sort_skewed_keys": lambda f, E: f["skew"].select("k", "v").sort("k"),
}
# A skewed m:n join: one key holds most rows on both sides.
SKEWED = lambda f, E: f["skew"].join(  # noqa: E731
    f["skewr"], on=E.col("k") == E.col("rk")).group_by("k").agg(
    E.count(None).alias("n"), E.sum_(E.col("w")).alias("sw"))


def run_both(lake, tmp_path, build, conf=None, routed=False, sort=False, monkeypatch=None):
    js, ts = _sessions(tmp_path, conf)
    if routed:
        monkeypatch.setenv("HST_SPMD_ROUTED_MERGE", "on")
        monkeypatch.setattr(tspmd, "_use_routed_merge", lambda mesh: True)
    if sort:
        monkeypatch.setenv("HST_SPMD_SORT", "on")
        monkeypatch.setattr(tspmd, "_use_spmd_sort", lambda session=None: True)
    j0, js0 = jspmd.DISPATCH_COUNT, jspmd.SORT_DISPATCH_COUNT
    t0, ts0 = tspmd.DISPATCH_COUNT, tspmd.SORT_DISPATCH_COUNT
    want = build(_frames(js, JE, lake), JE).to_arrow()
    got = build(_frames(ts, TE, lake), TE).to_arrow()
    assert jspmd.DISPATCH_COUNT > j0, "the JAX package did not dispatch"
    assert tspmd.DISPATCH_COUNT > t0, "the port did not dispatch"
    if sort:
        assert jspmd.SORT_DISPATCH_COUNT > js0 and tspmd.SORT_DISPATCH_COUNT > ts0
    return want, got


@pytest.fixture()
def both(lake, tmp_path, monkeypatch):
    def run(build, **kw):
        return run_both(lake, tmp_path, build, monkeypatch=monkeypatch, **kw)
    return run


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_equals_jax(both, name):
    want, got = both(QUERIES[name])
    assert got.schema == want.schema
    assert got.equals(want), name


@pytest.mark.parametrize("name", sorted(SORTS))
def test_sample_sort_equals_jax(both, name):
    want, got = both(SORTS[name], sort=True)
    assert got.equals(want), name


@pytest.mark.parametrize("name", ["grouped_int", "grouped_nullable_key",
                                  "bcast_inner_grouped", "xchg_two_key_m_n"])
def test_routed_merge_equals_jax(both, name):
    """The owner-routed grouped merge (a CUDA mesh's default), forced on in
    both packages: the same groups in the same order, float sums included."""
    want, got = both(QUERIES[name], routed=True)
    assert got.equals(want), name


def test_single_device_mesh_equals_jax(lake, tmp_path, monkeypatch):
    """One device with singleDevice=on on both sides."""
    monkeypatch.setattr(jspmd, "_device_count", lambda *a: 1)
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device("cpu")])
    conf = {IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE: "on"}
    for name in ("global_filter_sum_count", "grouped_int", "xchg_full", "bcast_left_stream"):
        want, got = run_both(lake, tmp_path / name, QUERIES[name], conf=conf)
        assert got.equals(want), name


def test_port_needs_no_capacity_retry_where_jax_retries(lake, tmp_path, monkeypatch):
    """Queue C: the reference sizes its exchange blocks statically and
    recompiles once when a skewed key overflows them; the port sends exact
    blocks, so the same rows come in one attempt."""
    want, got = run_both(lake, tmp_path, SKEWED)
    assert got.equals(want)
    assert jspmd.LAST_CAP_ATTEMPTS == 3 and tspmd.LAST_CAP_ATTEMPTS == 1


# ---------------------------------------------------------------------------
# Declined shapes: the same fallback, or none, on both sides.
# ---------------------------------------------------------------------------

def _fallbacks(events):
    return [(e.where, e.reason) for e in events
            if type(e).__name__ == "DistributedFallbackEvent"]


def _declined(lake, tmp_path, build, conf, jax_ctx=None, port_ctx=None):
    import contextlib
    conf = dict(conf)
    conf[IndexConstants.EVENT_LOGGER_CLASS] = "tests.conftest.CaptureLogger"
    js, ts = _sessions(tmp_path, conf)
    sink = importlib.import_module("tests.conftest").CaptureLogger
    out = {}
    for pkg, s, E, spmd, ctx in (("jax", js, JE, jspmd, jax_ctx),
                                 ("torch", ts, TE, tspmd, port_ctx)):
        sink.events.clear()
        before = spmd.DISPATCH_COUNT
        with (ctx() if ctx else contextlib.nullcontext()):
            table = build(s, E).to_arrow()
        out[pkg] = (table, spmd.DISPATCH_COUNT - before, _fallbacks(sink.events))
    return out


def _agg(df, E):
    return df.group_by("g").agg(E.count(None).alias("n"), E.sum_(E.col("qty")).alias("q"))


@pytest.mark.parametrize("case", ["min_stream_rows", "over_budget", "csv_leaf", "union",
                                  "active_sweep"])
def test_declined_shapes_fall_back_alike(lake, tmp_path, case):
    conf = {}
    jax_ctx = port_ctx = None
    if case == "min_stream_rows":
        conf[MIN_ROWS] = "100000"
    if case == "over_budget":
        conf[IndexConstants.TPU_MAX_CHUNK_ROWS] = "1000"

    def build(s, E):
        if case == "csv_leaf":
            return _agg(s.read.csv(lake["csv"]), E)
        fact = s.read.parquet(lake["fact"])
        if case == "union":
            return (fact.filter(E.col("k2") <= 2).select("g", "qty")
                    .union(fact.filter(E.col("k2") >= 4).select("g", "qty"))
                    .group_by("g").agg(E.sum_(E.col("qty")).alias("q")))
        return _agg(fact, E)

    if case == "active_sweep":
        from hyperspace_tpu.serving import batcher as jb
        from hyperspace_tpu_torch.serving import batcher as tb

        def jax_ctx():
            return jb.use_sweep(jb.SweepContext([[]]), 0)

        def port_ctx():
            return tb.use_sweep(tb.SweepContext(1))

    out = _declined(lake, tmp_path, build, conf, jax_ctx, port_ctx)
    (jt, jd, jf), (tt, td, tf) = out["jax"], out["torch"]
    assert tt.equals(jt)
    assert td == jd
    assert tf == jf
    if case in ("min_stream_rows", "over_budget", "union", "active_sweep"):
        assert td == 0
    if case in ("min_stream_rows", "over_budget", "union"):
        assert tf, "no fallback event"


def test_sharding_and_exchange_events_equal_jax(lake, tmp_path):
    """One ShardedExecutionEvent per dispatch with the mesh's identity and
    file-aligned flag, and one SpmdExchangeEvent per join stage, alike."""
    conf = {IndexConstants.EVENT_LOGGER_CLASS: "tests.conftest.CaptureLogger"}
    js, ts = _sessions(tmp_path, conf)
    sink = importlib.import_module("tests.conftest").CaptureLogger
    seen = {}
    for pkg, s, E in (("jax", js, JE), ("torch", ts, TE)):
        sink.events.clear()
        fr = _frames(s, E, lake)
        fr["fact"].join(fr["mn"], on=E.col("k") == E.col("rk")).agg(
            E.count(None).alias("n")).to_arrow()
        shard = [e for e in sink.events if type(e).__name__ == "ShardedExecutionEvent"]
        xch = [e for e in sink.events if type(e).__name__ == "SpmdExchangeEvent"]
        seen[pkg] = (shard, xch)
    (js_, jx), (ts_, tx) = seen["jax"], seen["torch"]
    assert len(ts_) == len(js_) == 1
    for f in ("mode", "mesh_axes", "mesh_shape", "mesh_platform", "file_aligned_scan",
              "in_specs", "out_specs"):
        assert getattr(ts_[0], f) == getattr(js_[0], f), f
    assert ts_[0].collectives["all-to-all"] >= 1 and js_[0].collectives["all-to-all"] >= 1
    assert [(e.stage, e.join_type, e.strategy, e.all_to_all) for e in tx] == \
        [(e.stage, e.join_type, e.strategy, e.all_to_all) for e in jx]
    assert all(e.capacity > 0 for e in tx)


def test_file_aligned_scan_as_jax_default(lake, tmp_path):
    """A multi-file leaf shards on file boundaries in the port, as at the
    reference's default (fileAlignedScan on): the event says so in both
    packages, and the rows are equal."""
    sink = importlib.import_module("tests.conftest").CaptureLogger
    conf = {IndexConstants.EVENT_LOGGER_CLASS: "tests.conftest.CaptureLogger"}
    js, ts = _sessions(tmp_path, conf)
    res, flags = [], []
    for s, E in ((js, JE), (ts, TE)):
        sink.events.clear()
        res.append(s.read.parquet(lake["fact"]).agg(
            E.sum_(E.col("v")).alias("s"), E.count(None).alias("n")).to_arrow())
        flags.append([e.file_aligned_scan for e in sink.events
                      if type(e).__name__ == "ShardedExecutionEvent"])
    assert flags[0] == flags[1] == [True]
    assert res[0].equals(res[1])


def test_mesh_max_devices_knob(lake, tmp_path, monkeypatch):
    """maxDevices caps the mesh: the port's mesh lists 2 devices."""
    conf = {IndexConstants.TPU_DISTRIBUTED_MESH_MAX_DEVICES: "2"}
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices", lambda session=None: (
        [torch.device("cpu")] * N_DEV)[:session.hs_conf.distributed_mesh_max_devices()])
    want, got = run_both(lake, tmp_path, QUERIES["grouped_int"], conf=conf)
    assert got.equals(want)
    _, ts = _sessions(tmp_path / "s2", conf)
    assert ht.Hyperspace(ts).spmd_stats()["mesh_devices"] == 2


def test_explain_distributed_section_and_stats(lake, tmp_path):
    from hyperspace_tpu.plananalysis.explain import explain_string as jexplain
    from hyperspace_tpu_torch.plananalysis.explain import explain_string as texplain

    js, ts = _sessions(tmp_path)
    texts, stats = {}, {}
    for pkg, s, E, explain, mod in (("jax", js, JE, jexplain, hj),
                                    ("torch", ts, TE, texplain, ht)):
        q = s.read.parquet(lake["fact"]).agg(E.count(None).alias("n"))
        q.to_arrow()
        text = explain(s, q.plan)
        texts[pkg] = text[text.index("Distributed:"):].split("\n")[:3]
        stats[pkg] = mod.Hyperspace(s).spmd_stats()
    assert texts["torch"][0] == "Distributed:"
    assert texts["torch"][2] == texts["jax"][2]
    assert "mesh devices=8 platform=cpu singleDevice=auto fileAlignedScan=on" in texts["torch"][2]
    assert set(stats["torch"]) == set(stats["jax"])
    for k in ("enabled", "mesh_devices", "platform", "file_aligned_scan"):
        assert stats["torch"][k] == stats["jax"][k], k
    assert stats["torch"]["mesh_programs_compiled"] == 0
    assert stats["torch"]["last_cap_attempts"] == 1
    assert stats["torch"]["last_collectives"]["all-reduce"] >= 1


def test_distributed_disabled_stays_single_device(lake, tmp_path):
    conf = {IndexConstants.TPU_DISTRIBUTED_ENABLED: "false"}
    _, ts = _sessions(tmp_path, conf)
    before = tspmd.DISPATCH_COUNT
    ts.read.parquet(lake["fact"]).group_by("g").agg(TE.count(None).alias("n")).to_arrow()
    assert tspmd.DISPATCH_COUNT == before
