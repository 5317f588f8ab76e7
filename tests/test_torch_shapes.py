"""The port's length classes (``hyperspace_tpu_torch/shapes.py``) against
the JAX package's ``execution/shapes.py``: the ladder, its clamps and
fallbacks, the conf round trip, and the two answers that depend on the
``shapeBucketing.*`` conf: a MinMax sketch of a +-inf column (a column
shorter than its length class brings the sentinels into the reduction)
and a float sum over the 8-device CPU mesh (the leaf's length class sets
the shard boundaries, and so the order in which each shard adds).

The JAX side runs on the CPU (8 virtual devices from conftest); the port
on CPU tensors, its mesh 8 CPU devices.
"""

import importlib
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu_torch import shapes as tshapes
from hyperspace_tpu.execution import shapes as jshapes
from hyperspace_tpu.execution import spmd as jspmd
from hyperspace_tpu.ops import pallas_kernels
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu_torch.execution import spmd as tspmd
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.plan import expr as TE

SB = "hyperspace.tpu.execution.shapeBucketing."


def float_bits(table: pa.Table) -> dict:
    return {n: np.asarray(table.column(n).combine_chunks().to_numpy(zero_copy_only=False))
            .view(np.uint64).tolist()
            for n in table.column_names if pa.types.is_float64(table.schema.field(n).type)}


ENABLED = dict(enabled=True, min_pad=64, growth_factor=2.0)


def both_params(**kw):
    return jshapes.ShapeParams(**kw), tshapes.ShapeParams(**kw)


# ---------------------------------------------------------------------------
# The ladder (test_shapes.py's cases), against the JAX package's.
# ---------------------------------------------------------------------------

def test_at_least_n_and_on_ladder():
    jp, tp = both_params(**ENABLED)
    for n in range(1, 5000, 37):
        c = tshapes.padded_length(n, tp)
        assert c == jshapes.padded_length(n, jp)
        assert c >= n and c >= 64
        k = c
        while k > 64:
            assert k % 2 == 0
            k //= 2
        assert k == 64


def test_idempotent_ladder():
    _, tp = both_params(**ENABLED)
    with tshapes.use_params(tp):
        for n in (1, 64, 65, 1000, 4096):
            c = tshapes.padded_length(n)
            assert tshapes.padded_length(c) == c


def test_disabled_and_zero():
    with tshapes.use_params(tshapes.ShapeParams(enabled=False)):
        assert tshapes.padded_length(77) == 77
    with tshapes.use_params(tshapes.ShapeParams(**ENABLED)):
        assert tshapes.padded_length(0) == 0
    assert tshapes.padded_length(-3) == -3


def test_huge_exact_fallback():
    jp, tp = both_params(enabled=True, min_pad=64, growth_factor=2.0, max_waste_ratio=0.25,
                         exact_fallback_rows=1000)
    with tshapes.use_params(tp):
        # 1100 -> 2048 wastes 86% > 25% of a "huge" array: exact.
        assert tshapes.padded_length(1100) == 1100
        # 2000 -> 2048 wastes 2.4%: still bucketed.
        assert tshapes.padded_length(2000) == 2048
        # Below the huge threshold any waste is accepted.
        assert tshapes.padded_length(70) == 128
    for n in (70, 999, 1000, 1100, 2000, 5000):
        assert tshapes.padded_length(n, tp) == jshapes.padded_length(n, jp)


@pytest.mark.parametrize("conf", [{}, {SB + "minPadElements": "32", SB + "growthFactor": "4.0"},
                                  {SB + "enabled": "false"},
                                  {SB + "growthFactor": "1.0", SB + "minPadElements": "0",
                                   SB + "maxWasteRatio": "-1", SB + "exactFallbackRows": "0"}])
def test_conf_round_trip_and_clamps_equal_jax(tmp_path, conf):
    """params_from_conf reads the same keys with the same clamps (a growth
    of at least 1.125, a rung of at least 1, no negative waste, at least
    one fallback row), and the classes agree along the ladder."""
    t = tshapes.params_from_conf(
        ht.Session(conf=dict(conf), system_path=str(tmp_path / "t"), device="cpu").hs_conf)
    j = jshapes.params_from_conf(
        hst.Session(conf=dict(conf), system_path=str(tmp_path / "j")).hs_conf)
    assert t == tshapes.ShapeParams(**vars(j))
    for n in (1, 31, 33, 1000, 1025, 5000, 4_194_305, 6_000_000):
        assert tshapes.padded_length(n, t) == jshapes.padded_length(n, j)


def test_scoped_conf_reaches_the_mesh_and_the_sketch(tmp_path):
    """The mesh's shard rows (spmd._pad_rows) and the MinMax sketch's
    sentinel rule read the scoped conf, and only inside its scope."""
    from hyperspace_tpu_torch.execution.columnar import Column
    from hyperspace_tpu_torch.ops import sketches
    from hyperspace_tpu_torch.parallel.mesh import make_mesh
    s = ht.Session(conf={SB + "minPadElements": "16"}, system_path=str(tmp_path), device="cpu")
    mesh = make_mesh([torch.device("cpu")] * 2)
    col = Column("float64", torch.full((17,), np.inf, dtype=torch.float64))
    assert tspmd._pad_rows(mesh, 17) == 1024
    assert sketches.minmax_values(col)[0] != np.inf  # padded: the sentinel comes in
    with tshapes.use_conf(s.hs_conf):
        assert tspmd._pad_rows(mesh, 17) == 32
        assert sketches.minmax_values(col)[0] != np.inf
    with tshapes.use_conf(ht.Session(conf={SB + "enabled": "false"},
                                     system_path=str(tmp_path / "off"), device="cpu").hs_conf):
        assert tspmd._pad_rows(mesh, 17) == 17
        assert sketches.minmax_values(col)[0] == np.inf
    assert tshapes.active_params() == tshapes.ShapeParams()


# ---------------------------------------------------------------------------
# Answers that follow the shapeBucketing conf.
# ---------------------------------------------------------------------------

def infinite_lake(root: str, n: int) -> str:
    """One file of n rows: +inf and -inf columns, float64 and float32."""
    d = os.path.join(root, "inf")
    os.makedirs(d, exist_ok=True)
    pq.write_table(pa.table({
        "pos": np.full(n, np.inf), "neg": np.full(n, -np.inf),
        "pos32": np.full(n, np.inf, dtype=np.float32),
        "k": np.arange(n, dtype=np.int64),
    }), os.path.join(d, "part0.parquet"))
    return d


def sketch_table(pkg, root: str, lake_dir: str, conf: dict) -> pa.Table:
    conf = {"hyperspace.tpu.distributed.enabled": "false", **conf}
    system = os.path.join(root, f"sys_{pkg.__name__}")
    s = pkg.Session(conf=dict(conf), system_path=system, **(
        {"device": "cpu"} if pkg is ht else {}))
    pkg.Hyperspace(s).create_index(s.read.parquet(lake_dir), pkg.DataSkippingIndexConfig(
        "sk", [pkg.MinMaxSketch("pos"), pkg.MinMaxSketch("neg"), pkg.MinMaxSketch("pos32")]))
    return pq.read_table(os.path.join(system, "sk", "v__=0", "sketches.parquet"),
                         partitioning=None).drop(["_file"])


@pytest.fixture()
def pallas_on():
    pallas_kernels.set_mode("on")
    yield
    pallas_kernels.set_mode("auto")


@pytest.mark.parametrize("n,conf,sentinels", [
    (3, {}, True),
    (3, {SB + "enabled": "false"}, False),
    (16, {SB + "minPadElements": "16"}, False),
    (17, {SB + "minPadElements": "16"}, True),
])
def test_minmax_sketch_of_infinite_columns_follows_the_conf(tmp_path, pallas_on, n, conf,
                                                           sentinels):
    """A float64 column shorter than its length class pads with invalid
    rows, so an all-+inf column's min (and an all--inf column's max) reads
    the dtype's far end; at its own class (bucketing off, or a 16-row
    class) it reads the infinity. The float32 column takes the JAX
    package's Pallas reduction (its TPU route, which the port's kernel
    follows), whose block padding brings the sentinel in at these lengths
    whatever the conf. The port's sketch table equals the JAX package's
    under each conf."""
    lake_dir = infinite_lake(str(tmp_path), n)
    want = sketch_table(hst, str(tmp_path), lake_dir, conf)
    got = sketch_table(ht, str(tmp_path), lake_dir, conf)
    assert got.equals(want)
    row = got.to_pylist()[0]
    assert np.isinf(row["minmax__pos__min"]) != sentinels, row
    assert np.isinf(row["minmax__neg__max"]) != sentinels, row
    assert not np.isinf(row["minmax__pos32__min"]), row


@pytest.fixture()
def mesh8(monkeypatch):
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def sum_lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_sum"))
    rng = np.random.default_rng(18)
    n = 6000
    d = os.path.join(root, "fact")
    os.makedirs(d)
    pq.write_table(pa.table({
        "g": rng.integers(0, 7, n).astype(np.int64),
        "q": rng.integers(0, 50, n).astype(np.int64),
        "v": rng.uniform(-1e6, 1e6, n) * np.exp(rng.normal(0, 8, n)),
    }), os.path.join(d, "part0.parquet"))
    return d


@pytest.mark.parametrize("conf", [{}, {SB + "growthFactor": "1.5"},
                                  {SB + "enabled": "false"}, {SB + "minPadElements": "3000"}])
def test_mesh_float_sum_follows_the_conf(tmp_path, sum_lake, mesh8, conf):
    """A global and a grouped float sum over the 8-device mesh: each
    device's shard is a slice of the leaf padded to its length class, so
    the shard boundaries, and the float64 bits of the sums, follow the
    session's shapeBucketing conf in both packages. The buffer pools are
    emptied first: the JAX package's keeps a scan at the length class it
    was read at."""
    conf = {IndexConstants.TPU_DISTRIBUTED_MIN_STREAM_ROWS: "0", **conf}
    out, dispatched = {}, {}
    for pkg, E, spmd in ((hst, JE, jspmd), (ht, TE, tspmd)):
        kw = {"device": "cpu"} if pkg is ht else {}
        importlib.import_module(pkg.__name__ + ".execution.buffer_pool").get_pool().clear()
        s = pkg.Session(conf=dict(conf), system_path=str(tmp_path / pkg.__name__), **kw)
        d0 = spmd.DISPATCH_COUNT
        df = s.read.parquet(sum_lake).filter(E.col("q") > 3)
        out[pkg.__name__] = (
            df.agg(E.sum_(E.col("v")).alias("sv"), E.avg(E.col("v")).alias("av")).to_arrow(),
            df.group_by("g").agg(E.sum_(E.col("v")).alias("sv")).to_arrow())
        dispatched[pkg.__name__] = spmd.DISPATCH_COUNT - d0
    assert dispatched == {"hyperspace_tpu": 2, "hyperspace_tpu_torch": 2}
    for got, want in zip(out["hyperspace_tpu_torch"], out["hyperspace_tpu"]):
        assert got.equals(want)
        assert float_bits(got) == float_bits(want)
