"""The mesh build (``parallel/distributed_build.py`` through
``actions/create.py``) and the distributed query programs
(``parallel/distributed_query.py``) against the JAX package's.

The JAX package builds over its 8 virtual CPU devices (its default); the
port over an 8-entry CPU mesh (``parallel/mesh.mesh_devices`` replaced). Every
bucket file of the two mesh builds, and of the port's single-device build,
must hold the same rows in the same order; the three distributed query
entry points must give the JAX package's answers; the co-bucketed joins
must issue no all-to-all and no all-gather.
"""

import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hj
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution.columnar import Column as JColumn, Table as JTable
from hyperspace_tpu.parallel import distributed_build as jdb
from hyperspace_tpu.parallel import distributed_query as jdq
from hyperspace_tpu.parallel import mesh as jmesh
from hyperspace_tpu_torch.execution import spmd as tspmd
from hyperspace_tpu_torch.execution.columnar import Column, Table
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.ops import index_build
from hyperspace_tpu_torch.parallel import distributed_build as tdb
from hyperspace_tpu_torch.parallel import distributed_query as tdq
from hyperspace_tpu_torch.parallel import mesh as tmesh
from hyperspace_tpu_torch.schema import FLOAT64, INT64

N_DEV = 8


@pytest.fixture()
def mesh8(monkeypatch):
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device("cpu")] * N_DEV)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    d = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(5)
    n = 6000
    t = pa.table({
        "k": rng.integers(0, 900, n).astype(np.int64),
        "s": rng.choice(["alpha", "beta", "gamma", "delta", ""], n),
        "v": np.round(rng.uniform(0, 100, n), 2),
        "nv": pa.array([None if rng.random() < 0.1 else int(x)
                        for x in rng.integers(0, 50, n)], type=pa.int64()),
    })
    for i in range(3):
        pq.write_table(t.slice(i * 2000, 2000), str(d / f"p{i}.parquet"))
    return str(d)


def _index_files(system_path, name):
    files = sorted(glob.glob(os.path.join(system_path, name, "v__=0", "*.parquet")))
    return {os.path.basename(f): pq.read_table(f) for f in files}


@pytest.mark.parametrize("indexed,included", [(["k"], ["v", "s"]), (["s"], ["k"]),
                                              (["k", "s"], ["nv"]), (["nv"], ["v"])])
def test_mesh_build_files_equal_jax_and_single_device(source, tmp_path, mesh8, indexed,
                                                      included):
    conf = {IndexConstants.INDEX_NUM_BUCKETS: "16"}
    files = {}
    for label, mod, extra in (("jax", hj, {}), ("torch", ht, {}),
                              ("single", ht, {IndexConstants.TPU_DISTRIBUTED_ENABLED: "false"})):
        sp = str(tmp_path / label)
        kw = {"device": "cpu"} if mod is ht else {}
        s = mod.Session(system_path=sp, **kw)
        for k, v in dict(conf, **extra).items():
            s.conf.set(k, v)
        b0 = (jdb if mod is hj else tdb).DISPATCH_COUNT
        mod.Hyperspace(s).create_index(s.read.parquet(source),
                                       mod.IndexConfig("idx", indexed, included))
        ran = (jdb if mod is hj else tdb).DISPATCH_COUNT - b0
        assert ran == (0 if label == "single" else 1), label
        files[label] = _index_files(sp, "idx")
    assert files["torch"].keys() == files["jax"].keys() == files["single"].keys()
    for name in files["jax"]:
        assert files["torch"][name].equals(files["jax"][name]), name
        assert files["single"][name].equals(files["jax"][name]), name


def test_mesh_build_declines_small_sources_as_jax(tmp_path, mesh8):
    """Below minStreamRows both packages build single-device and say so."""
    d = tmp_path / "small"
    d.mkdir()
    pq.write_table(pa.table({"k": np.arange(100, dtype=np.int64)}), str(d / "p.parquet"))
    import importlib
    sink = importlib.import_module("tests.conftest").CaptureLogger
    reasons = {}
    for label, mod in (("jax", hj), ("torch", ht)):
        kw = {"device": "cpu"} if mod is ht else {}
        s = mod.Session(system_path=str(tmp_path / label), **kw)
        s.conf.set(IndexConstants.EVENT_LOGGER_CLASS, "tests.conftest.CaptureLogger")
        sink.events.clear()
        mod.Hyperspace(s).create_index(s.read.parquet(str(d)), mod.IndexConfig("i", ["k"]))
        reasons[label] = [(e.where, e.reason) for e in sink.events
                          if type(e).__name__ == "DistributedFallbackEvent"]
    assert reasons["torch"] == reasons["jax"] == [
        ("index_build", "source 100 rows below distributed.minStreamRows 4096")]


def _tables(rng, n, nk):
    k = rng.integers(0, nk, n).astype(np.int64)
    v = rng.integers(-50, 50, n).astype(np.int64)
    f = rng.integers(0, 40, n).astype(np.float64) / 4
    return k, v, f


def test_distributed_build_equals_single_device_bucket_for_bucket():
    rng = np.random.default_rng(9)
    k, v, _ = _tables(rng, 5000, 700)
    table = Table({"k": Column(INT64, torch.from_numpy(k)), "v": Column(INT64,
                                                                        torch.from_numpy(v))})
    for n_dev in (1, 3, 8):
        tables, bids = tdb.distributed_build_sorted_buckets(
            table, ["k"], 32, tmesh.Mesh([torch.device("cpu")] * n_dev))
        whole, bounds = index_build.build_sorted_buckets(table, ["k"], 32)
        got_k = torch.cat([t.column("k").data for t in tables])
        got_b = torch.cat(bids)
        np.testing.assert_array_equal(got_k.numpy(), whole.column("k").data.numpy())
        np.testing.assert_array_equal(torch.cat([t.column("v").data for t in tables]).numpy(),
                                      whole.column("v").data.numpy())
        np.testing.assert_array_equal(np.searchsorted(got_b.numpy(), np.arange(33)), bounds)
        for d, b in enumerate(bids):  # single ownership
            assert (tmesh.bucket_owner(b, n_dev, 32) == d).all()
    assert tdb.last_collectives()["all-to-all"] >= 1


def _co_bucketed(n_dev, arrays, num_buckets=16):
    """Both packages' mesh builds of the same columns, keyed on "k"."""
    t = Table({n: Column(FLOAT64 if a.dtype == np.float64 else INT64, torch.from_numpy(a))
               for n, a in arrays.items()})
    tables, _ = tdb.distributed_build_sorted_buckets(
        t, ["k"], num_buckets, tmesh.Mesh([torch.device("cpu")] * n_dev))
    import jax
    import jax.numpy as jnp
    jt = JTable({n: JColumn("float64" if a.dtype == np.float64 else "int64", jnp.asarray(a))
                 for n, a in arrays.items()})
    jout, jvalid, _ = jdb.distributed_build_sorted_buckets(
        jt, ["k"], num_buckets, jmesh.make_mesh(jax.devices()[:n_dev]))
    valid = [torch.ones(t.num_rows, dtype=torch.bool) for t in tables]
    return tables, valid, jout, jvalid


def test_distributed_query_entry_points_equal_jax():
    import jax
    rng = np.random.default_rng(3)
    lk, lv, lf = _tables(rng, 3000, 400)
    rk, rv, _ = _tables(rng, 800, 450)
    lt, lvalid, jl, jlvalid = _co_bucketed(N_DEV, {"k": lk, "lv": lv, "f": lf})
    rt, rvalid, jr, jrvalid = _co_bucketed(N_DEV, {"k": rk, "rv": rv})
    mesh = tmesh.Mesh([torch.device("cpu")] * N_DEV)
    jm = jmesh.make_mesh(jax.devices()[:N_DEV])

    got = tdq.distributed_join_agg(lt, lvalid, rt, rvalid, "k", "lv", "rv", mesh=mesh)
    want = jdq.distributed_join_agg(jl, jlvalid, jr, jrvalid, "k", "lv", "rv", mesh=jm)
    assert got == want
    left = pa.table({"k": lk, "lv": lv, "f": lf})
    joined = left.join(pa.table({"k2": rk, "rv": rv}), "k", "k2", join_type="inner").to_pandas()
    assert got == (len(joined), int(joined["lv"].sum()), int(joined["rv"].sum()))

    got = tdq.distributed_join_filter_agg(lt, lvalid, rt, rvalid, "k", "lv", "rv", "f", 2.0,
                                          6.5, mesh=mesh, hi_incl=False)
    want = jdq.distributed_join_filter_agg(jl, jlvalid, jr, jrvalid, "k", "lv", "rv", "f",
                                           2.0, 6.5, mesh=jm, hi_incl=False)
    assert got == want

    table = Table({"f": Column(FLOAT64, torch.from_numpy(lf)),
                   "lv": Column(INT64, torch.from_numpy(lv))})
    jtable = JTable({"f": JColumn("float64", jax.numpy.asarray(lf)),
                     "lv": JColumn("int64", jax.numpy.asarray(lv))})
    for lo_incl in (True, False):
        got = tdq.distributed_range_agg(table, "f", 1.0, 5.0, ("lv",), mesh=mesh,
                                        lo_incl=lo_incl)
        want = jdq.distributed_range_agg(jtable, "f", 1.0, 5.0, ("lv",), mesh=jm,
                                         lo_incl=lo_incl)
        assert got[0] == want[0] and got[1]["lv"] == int(want[1]["lv"])

    counts = tdq.join_agg_collectives(lt, lvalid, rt, rvalid, "k", "lv", "rv", mesh=mesh)
    fcounts = tdq.join_filter_agg_collectives(lt, lvalid, rt, rvalid, "k", "lv", "rv", "f",
                                              2.0, 6.5, mesh=mesh)
    jcounts = jdq.join_agg_collectives(jl, jlvalid, jr, jrvalid, "k", "lv", "rv", mesh=jm)
    for c in (counts, fcounts, jcounts):
        for op in ("all-to-all", "all-gather", "collective-permute", "reduce-scatter"):
            assert c[op] == 0, (op, c)
        assert c["all-reduce"] >= 1


def test_nullable_columns_are_refused_as_jax():
    t = Table({"k": Column(INT64, torch.arange(4), torch.tensor([True, False, True, True])),
               "v": Column(INT64, torch.arange(4))})
    mesh = tmesh.Mesh([torch.device("cpu")] * 2)
    with pytest.raises(ht.HyperspaceException, match="nullable"):
        tdq.distributed_join_agg([t], [torch.ones(4, dtype=torch.bool)], [t],
                                 [torch.ones(4, dtype=torch.bool)], "k", "v", "v", mesh=mesh)
    with pytest.raises(ht.HyperspaceException, match="nullable filter column"):
        tdq.distributed_range_agg(t, "k", 0, 2, ("v",), mesh=mesh)
