"""A float literal against a float32 column, pushed into the parquet read.

The device mask compares a float32 column with the literal rounded to
float32 (the JAX package's weak-scalar rule). The pushed pyarrow filter
must compare the same values, or the read drops rows the mask keeps: on
``x`` float32 ``[1.1, 2.0, 1.1, 3.0]``, ``x == 1.1`` compared in float64
matches no row, since 1.1f is 1.10000002.

The port's answer is held to the JAX package's default (fused) answer for
filter+select and filter+join, and, for every op, IN and the literal edge
cases (NaN, signed zeros, literals past the float32 range, a literal that
is exact in float32), to the JAX evaluator's mask over the unpushed rows,
scanned and through a covering index on ``x``. The JAX package's staged
path keeps the fault; a test pins it.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import columnar as jcolumnar
from hyperspace_tpu.execution import evaluator as jevaluator
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.plan import expr as TE

# conftest gives JAX 8 virtual devices, which would take its mesh build.
JAX_CONF = {"hyperspace.tpu.distributed.enabled": "false",
            IndexConstants.INDEX_NUM_BUCKETS: "2"}
STAGED = {"hyperspace.tpu.execution.fusion.enabled": "false"}

# The input that shows the fault, then one row per edge value.
X = [1.1, 2.0, 1.1, 3.0, -0.0, 0.0, float("inf"), float("-inf"), float("nan"), 0.5]
OPS = ("==", "<", "<=", ">", ">=", "in")
LITERALS = (1.1, 2.0, 0.5, -0.0, 0.0, float("nan"), 1e40, -1e40, 3)


def condition(E, op: str, lit):
    x = E.col("x")
    if op == "in":
        return x.isin([lit, 3.0])
    return {"==": x == lit, "<": x < lit, "<=": x <= lit, ">": x > lit,
            ">=": x >= lit}[op]


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("pushdown_f32")
    src, dim = str(root / "src"), str(root / "dim")
    os.makedirs(src)
    os.makedirs(dim)
    # Row groups of two rows, so statistics prune some and keep others.
    pq.write_table(pa.table({"k": pa.array(np.arange(1, len(X) + 1), pa.int64()),
                             "x": pa.array(X, pa.float32())}),
                   os.path.join(src, "a.parquet"), row_group_size=2)
    pq.write_table(pa.table({"dk": pa.array([1, 2, 3, 4], pa.int64()),
                             "dv": pa.array([10, 20, 30, 40], pa.int64())}),
                   os.path.join(dim, "d.parquet"))
    sessions = {}
    for name, pkg, conf in (("jax", hst, JAX_CONF), ("staged", hst, dict(JAX_CONF, **STAGED)),
                            ("torch", ht, JAX_CONF)):
        kw = {"device": "cpu"} if pkg is ht else {}
        sessions[name] = pkg.Session(conf=dict(conf), system_path=str(root / f"sys_{name}"),
                                     **kw)
    t = sessions["torch"]
    ht.Hyperspace(t).create_index(t.read.parquet(src), ht.IndexConfig("xi", ["x"], ["k"]))
    return {"src": src, "dim": dim, "sessions": sessions}


def keys(table) -> list:
    return sorted(table.column("k").to_pylist())


def jax_mask_keys(src: str, cond) -> list:
    """The JAX evaluator's mask over every row of the file, read without a
    pushed filter."""
    table = jcolumnar.read_parquet([os.path.join(src, "a.parquet")], ["k", "x"])
    mask = np.asarray(jevaluator.eval_predicate_mask(table, cond))
    return sorted(np.asarray(table.column("k").data)[mask].tolist())


def torch_query(lake, cond, indexed: bool, shape: str):
    s = lake["sessions"]["torch"]
    if indexed:
        s.enable_hyperspace()
    try:
        df = s.read.parquet(lake["src"]).filter(cond)
        if shape == "select":
            df = df.select("k")
        plan = df.optimized_plan().tree_string()
        assert ("IndexScan" in plan) == indexed, plan
        return keys(df.to_arrow())
    finally:
        s.disable_hyperspace()


def test_equality_keeps_the_rows_the_mask_keeps(lake):
    """The motivating input: the port returns k = [1, 3] for
    filter(x == 1.1).select(k), as the JAX package's default path does."""
    s = lake["sessions"]["jax"]
    want = keys(s.read.parquet(lake["src"]).filter(hst.col("x") == 1.1).select("k").to_arrow())
    assert want == [1, 3]
    assert torch_query(lake, ht.col("x") == 1.1, False, "select") == want


def test_staged_reference_keeps_the_fault(lake):
    """The JAX package's staged path pushes the float64 literal and loses
    both rows; its fused default re-reads the leaf unpruned when the pushed
    read comes back empty. Pinned as the reference's fault."""
    s = lake["sessions"]["staged"]
    df = s.read.parquet(lake["src"]).filter(hst.col("x") == 1.1)
    assert keys(df.select("k").to_arrow()) == []
    assert keys(lake["sessions"]["jax"].read.parquet(lake["src"])
                .filter(hst.col("x") == 1.1).to_arrow()) == []


@pytest.mark.parametrize("lit", [1.1, 2.0], ids=["inexact", "exact"])
def test_filter_join_equals_the_jax_default(lake, lit):
    answers = {}
    for name, pkg in (("jax", hst), ("torch", ht)):
        s = lake["sessions"][name]
        facts = s.read.parquet(lake["src"]).filter(pkg.col("x") == lit)
        dims = s.read.parquet(lake["dim"])
        out = facts.join(dims, pkg.col("k") == pkg.col("dk")).select("k", "dv").to_arrow()
        answers[name] = sorted(zip(out.column("k").to_pylist(), out.column("dv").to_pylist()))
    assert answers["torch"] == answers["jax"]
    assert answers["torch"] == ([(1, 10), (3, 30)] if lit == 1.1 else [(2, 20)])


@pytest.mark.parametrize("lit", LITERALS, ids=repr)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("indexed", [False, True], ids=["scanned", "indexed"])
@pytest.mark.parametrize("shape", ["filter", "select"])
def test_pushed_read_drops_no_row_the_mask_keeps(lake, op, lit, indexed, shape):
    want = jax_mask_keys(lake["src"], condition(JE, op, lit))
    assert torch_query(lake, condition(TE, op, lit), indexed, shape) == want
