"""ROADMAP queue C item 15, pinned: XLA on the CPU flushes subnormal floats to
zero in masks, arithmetic, min, sort keys and group keys; the port keeps
IEEE values, as numpy and pyarrow do (and the CUDA kernels, built without
``-ftz``). Each test asserts both packages' answers on the item's input:
one file, ``k`` 0..4, float64 ``x`` [3e-310, -3e-310, 0.0, 1.0, 5e-324]
and float32 ``f`` [1e-40, -1e-40, 0, 1, 1e-45]. The JAX package gives the
same answers with fusion on and off.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu_torch.plan import expr as TE

X = np.array([3e-310, -3e-310, 0.0, 1.0, 5e-324])
F = np.array([1e-40, -1e-40, 0, 1, 1e-45], dtype=np.float32)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(JAX DataFrame, port DataFrame) over the item's file."""
    root = tmp_path_factory.mktemp("subnormals")
    src = root / "src"
    src.mkdir()
    pq.write_table(pa.table({"k": np.arange(5, dtype=np.int64), "x": X, "f": F}),
                   src / "p.parquet")
    conf = {"hyperspace.tpu.distributed.enabled": "false"}
    jax_s = hst.Session(conf=dict(conf), system_path=str(root / "sys_jax"))
    torch_s = ht.Session(conf=dict(conf), system_path=str(root / "sys_torch"), device="cpu")
    return jax_s.read.parquet(str(src)), torch_s.read.parquet(str(src))


def bits(values) -> list:
    return [float(v).hex() for v in values]


def test_subnormal_mask_differs_from_xla_cpu(frames):
    jdf, tdf = frames
    for name in ("x", "f"):
        want_ieee = np.flatnonzero((X if name == "x" else F) > 0).tolist()
        assert jdf.filter(JE.col(name) > 0).select("k").to_arrow() \
            .column("k").to_pylist() == [3]
        assert tdf.filter(TE.col(name) > 0).select("k").to_arrow() \
            .column("k").to_pylist() == want_ieee == [0, 3, 4]


def test_subnormal_arithmetic_differs_from_xla_cpu(frames):
    jdf, tdf = frames
    jax_y = jdf.select((JE.col("x") * 1.0).alias("y")).to_arrow().column("y").to_pylist()
    torch_y = tdf.select((TE.col("x") * 1.0).alias("y")).to_arrow().column("y").to_pylist()
    assert bits(jax_y) == bits([0.0, -0.0, 0.0, 1.0, 0.0])
    assert bits(torch_y) == bits(X * 1.0)


def test_subnormal_min_differs_from_xla_cpu(frames):
    jdf, tdf = frames
    jax_m = jdf.agg(JE.min_(JE.col("x")).alias("m")).to_arrow().column("m").to_pylist()
    torch_m = tdf.agg(TE.min_(TE.col("x")).alias("m")).to_arrow().column("m").to_pylist()
    assert bits(jax_m) == bits([-0.0])
    assert bits(torch_m) == bits([X.min()]) == bits([-3e-310])


def test_subnormal_sort_differs_from_xla_cpu(frames):
    jdf, tdf = frames
    # The JAX package sorts the four small values as ties (broken by k).
    assert jdf.sort("x", "k").select("k").to_arrow().column("k").to_pylist() == [0, 1, 2, 4, 3]
    assert tdf.sort("x", "k").select("k").to_arrow().column("k").to_pylist() == \
        np.lexsort((np.arange(5), X)).tolist() == [1, 2, 4, 0, 3]


def test_subnormal_group_keys_differ_from_xla_cpu(frames):
    jdf, tdf = frames

    def groups(df, E):
        g = df.group_by("x").agg(E.count().alias("n")).to_arrow()
        return sorted(zip(bits(g.column("x").to_pylist()), g.column("n").to_pylist()))

    # The JAX package puts the four small values in one group, keyed by the
    # first one's bits.
    assert groups(jdf, JE) == [(float(3e-310).hex(), 4), (float(1.0).hex(), 1)]
    assert groups(tdf, TE) == sorted((float(v).hex(), 1) for v in X)
