"""The port's kernel wrappers (plain versions on the CPU) against the JAX
package, on the same numpy-seeded inputs, compared exactly.

JAX side: the Pallas kernels in interpret mode (``set_mode("on")``, as
tests/test_pallas_kernels.py runs them) and the evaluator's predicate path.
Port side: hyperspace_tpu_torch's wrappers on CPU tensors, which compute
their plain torch versions. Nothing here is a float computation -- only
compares and bit moves -- so equality is exact.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from hyperspace_tpu.execution import evaluator as jev
from hyperspace_tpu.execution.columnar import Table as JTable
from hyperspace_tpu.ops import kernels as jk
from hyperspace_tpu.ops import pallas_kernels
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu_torch.execution import evaluator as tev
from hyperspace_tpu_torch.execution.columnar import Table as TTable
from hyperspace_tpu_torch.ops import cuda_kernels as ck
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.util.interop import table_from_numpy

SIZES = (3, 130, 32769)


@pytest.fixture()
def pallas_on():
    pallas_kernels.set_mode("on")
    yield
    pallas_kernels.set_mode("auto")


def arrow_table(n: int, seed: int = 0) -> pa.Table:
    """Lineitem-like columns plus the edge values: int64 extremes and
    negatives, float -0.0/NaN/inf, strings, dates, bools and NULLs."""
    rng = np.random.default_rng(seed)
    i64 = rng.integers(-10 ** 12, 10 ** 12, n, dtype=np.int64)
    i64[: min(n, 3)] = np.array([np.iinfo(np.int64).min, -1, np.iinfo(np.int64).max])[: n]
    f64 = rng.uniform(-1e6, 1e6, n)
    f64[: min(n, 3)] = np.array([-0.0, np.nan, np.inf])[: n]
    f32 = rng.uniform(-1e3, 1e3, n).astype(np.float32)
    f32[: min(n, 3)] = np.array([0.0, -0.0, np.nan], dtype=np.float32)[: n]
    nulls = rng.random(n) < 0.1
    return pa.table({
        "i64": pa.array(i64),
        "i32": pa.array(rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int32)),
        "f64": pa.array(f64),
        "f32": pa.array(f32),
        "s": pa.array(rng.choice(["x", "y", "zz", "w", ""], n)),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      type=pa.int32()).cast(pa.date32()),
        "b": pa.array(rng.random(n) < 0.5),
        "i32n": pa.array(rng.integers(-50, 50, n).astype(np.int32), mask=nulls),
        "sn": pa.array(rng.choice(["a", "b", "c"], n), mask=nulls),
        "f64n": pa.array(rng.uniform(-5, 5, n), mask=nulls),
    })


def both(n: int, seed: int = 0):
    at = arrow_table(n, seed)
    return JTable.from_arrow(at), TTable.from_arrow(at, "cpu")


def u32(x) -> np.ndarray:
    """Port words (int32 bit patterns) as the JAX package's uint32."""
    return x.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Hashing.
# ---------------------------------------------------------------------------

HASH_COLS = ["i64", "i32", "f64", "f32", "s", "d", "b", "i32n", "sn", "f64n"]


@pytest.mark.parametrize("name", HASH_COLS)
def test_fold_and_hash32_values_match(name):
    jt, tt = both(1000)
    jc, tc = jt.column(name), tt.column(name)
    np.testing.assert_array_equal(
        u32(tk.fold_u32(tc.data, tc.dtype, tc.dictionary)),
        np.asarray(jk.fold_u32(jc.data, jc.dtype, jc.dictionary)))
    np.testing.assert_array_equal(
        u32(tk.hash32_values(tc.data, tc.dtype, tc.dictionary)),
        np.asarray(jk.hash32_values(jc.data, jc.dtype, jc.dictionary)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("cols", [["i64"], ["i32"], ["s"], ["i64", "s"],
                                  ["d", "i32", "f64"], ["f32", "b", "sn", "i32n"]])
def test_hash_bucket_matches_pallas(pallas_on, cols, n):
    jt, tt = both(n, seed=n)
    jfolded = [jk.fold_u32(jt.column(c).data, jt.column(c).dtype, jt.column(c).dictionary)
               for c in cols]
    tfolded = [tk.fold_u32(tt.column(c).data, tt.column(c).dtype,
                           tt.column(c).dictionary).contiguous() for c in cols]
    jh, jb = pallas_kernels.fused_hash_bucket(jfolded, 37)
    th, tb = ck.hash_bucket(tfolded, 37, with_hash=True)
    np.testing.assert_array_equal(u32(th), np.asarray(jh))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _, tb_only = ck.hash_bucket(tfolded, 37)
    np.testing.assert_array_equal(tb_only.numpy(), np.asarray(jb))


def test_hash_combine_and_bucket_ids_match():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    got = tk.hash_combine(ta, tb)
    want = jk.hash_combine(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    for nb in (1, 4, 37, 200):
        np.testing.assert_array_equal(tk.bucket_ids(got, nb).numpy(),
                                      np.asarray(jk.bucket_ids(want, nb)))


@pytest.mark.parametrize("value,dtype", [
    (0, "int64"), (-1, "int64"), (-(2 ** 63), "int64"), (2 ** 63 - 1, "int64"),
    (123456789012, "int64"), (-7, "int32"), (7, "int32"), (12345, "date"),
    (True, "bool"), (-0.0, "float64"), (float("nan"), "float64"), (1.5, "float64"),
    (2.5, "float32"), ("zz", "string"), ("", "string")])
def test_host_hash_mirror_matches(value, dtype):
    assert tk.hash32_value_host(value, dtype) == jk.hash32_value_host(value, dtype)
    assert tk.hash_combine_host(tk.hash32_value_host(value, dtype), 17) == \
        jk.hash_combine_host(jk.hash32_value_host(value, dtype), 17)


def test_host_hash_equals_device_hash():
    """Bucket pruning hashes literals on the host; the device must agree."""
    jt, tt = both(200)
    for name in ("i64", "i32", "d", "s"):
        c = tt.column(name)
        dev = u32(tk.hash32_values(c.data, c.dtype, c.dictionary))
        values = jt.to_arrow().column(name).to_pylist()
        for i in range(0, 200, 17):
            v = values[i]
            if isinstance(v, datetime.date):
                v = (v - datetime.date(1970, 1, 1)).days
            assert tk.hash32_value_host(v, c.dtype) == int(dev[i])


# ---------------------------------------------------------------------------
# Histogram.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nb", [1, 4, 37])
def test_bucket_histogram_matches_pallas(pallas_on, n, nb):
    bids = np.random.default_rng(n + nb).integers(0, nb, n).astype(np.int32)
    want = np.asarray(pallas_kernels.bucket_histogram(jnp.asarray(bids), nb))
    got = ck.bucket_histogram(torch.from_numpy(bids), nb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_bucket_histogram_pad_ids_count_nowhere():
    bids = torch.tensor([-1, 0, 3, 4, 9, -7, 3], dtype=torch.int32)
    assert ck.bucket_histogram(bids, 4).tolist() == [1, 0, 0, 2]


# ---------------------------------------------------------------------------
# Predicates through the evaluators (compare and range kernels).
# ---------------------------------------------------------------------------

def masks(jt, tt, jcond, tcond):
    want = np.asarray(jev.eval_predicate_mask(jt, jcond))
    got = tev.eval_predicate_mask(tt, tcond).numpy()
    return got, want


def lit_for(name: str):
    return {"i64": -5 * 10 ** 11, "i32": 1234, "f64": 0.0, "f32": -0.0, "s": "y",
            "d": datetime.date(1995, 3, 15), "b": True, "i32n": 3, "sn": "b",
            "f64n": 0.5}[name]


OPS = ["EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual"]


def build(mod, op: str, name: str, value, flip: bool = False):
    c, v = mod.Col(name), mod.Lit(value)
    return getattr(mod, op)(v, c) if flip else getattr(mod, op)(c, v)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", ["i32", "d", "f32", "i64", "f64", "s", "i32n", "sn"])
def test_compare_literal_matches(pallas_on, n, op, name):
    jt, tt = both(n, seed=n)
    value = lit_for(name)
    got, want = masks(jt, tt, build(JE, op, name, value), build(TE, op, name, value))
    np.testing.assert_array_equal(got, want)
    got, want = masks(jt, tt, build(JE, op, name, value, flip=True),
                      build(TE, op, name, value, flip=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name,value", [("i32", 5.5), ("i64", -2.5), ("d", 9000.5),
                                        ("f32", 0.1), ("f32", float("nan")),
                                        ("i32", 2 ** 40), ("f64", 3)])
def test_compare_literal_edge_literals_match(pallas_on, op, name, value):
    jt, tt = both(777)
    if name == "i32" and value == 2 ** 40:
        pytest.raises(OverflowError, jev.eval_predicate_mask, jt, build(JE, op, name, value))
        return
    got, want = masks(jt, tt, build(JE, op, name, value), build(TE, op, name, value))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lo_op,hi_op", [("GreaterThanOrEqual", "LessThanOrEqual"),
                                         ("GreaterThan", "LessThan"),
                                         ("GreaterThanOrEqual", "LessThan"),
                                         ("GreaterThan", "LessThanOrEqual")])
@pytest.mark.parametrize("name,lo,hi", [
    ("i32", -1000, 250000), ("d", datetime.date(1995, 3, 1), datetime.date(1995, 3, 31)),
    ("f32", -0.0, 500.0), ("i32n", -10, 10), ("i64", -10 ** 11, 10 ** 11),
    ("f64", -1.5, 1e5), ("i32", 1.5, 9.5)])
def test_between_matches(pallas_on, n, lo_op, hi_op, name, lo, hi):
    jt, tt = both(n, seed=n + 1)
    jcond = JE.And(getattr(JE, lo_op)(JE.Col(name), JE.Lit(lo)),
                   getattr(JE, hi_op)(JE.Col(name), JE.Lit(hi)))
    tcond = TE.And(getattr(TE, lo_op)(TE.Col(name), TE.Lit(lo)),
                   getattr(TE, hi_op)(TE.Col(name), TE.Lit(hi)))
    got, want = masks(jt, tt, jcond, tcond)
    np.testing.assert_array_equal(got, want)
    # The reversed conjunct order takes the same range path.
    got2, _ = masks(jt, tt, JE.And(jcond.right, jcond.left), TE.And(tcond.right, tcond.left))
    np.testing.assert_array_equal(got2, want)


def test_between_helper_runs_the_range_kernel_path():
    _, tt = both(130)
    ck.reset_launches()
    cond = TE.col("d").between(datetime.date(1990, 1, 1), datetime.date(2000, 1, 1))
    assert tev._try_fused_range(tt, cond) is not None
    assert tev._try_fused_range(tt, TE.col("i64").between(1, 2)) is None  # 64-bit: plain


@pytest.mark.parametrize("is_and", [True, False])
def test_kleene_logic_matches(pallas_on, is_and):
    jt, tt = both(4096, seed=5)

    def cond(mod):
        left = mod.GreaterThan(mod.Col("i32n"), mod.Lit(0))
        right = mod.LessThan(mod.Col("f64n"), mod.Lit(1.0))
        both_ = mod.And(left, right) if is_and else mod.Or(left, right)
        return mod.Or(mod.Not(both_), mod.EqualTo(mod.Col("sn"), mod.Lit("a")))

    got, want = masks(jt, tt, cond(JE), cond(TE))
    np.testing.assert_array_equal(got, want)


def test_column_vs_column_compare_matches():
    jt, tt = both(2000, seed=9)
    for op in OPS:
        got, want = masks(jt, tt, getattr(JE, op)(JE.Col("i32"), JE.Col("i32n")),
                          getattr(TE, op)(TE.Col("i32"), TE.Col("i32n")))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# masked_minmax.
# ---------------------------------------------------------------------------

FMAX = np.finfo(np.float32).max


def minmax_input(n: int, kind: str, dtype, seed: int = 0) -> np.ndarray:
    """A column of ``kind``: random values, random values with the edge
    values planted (+-0.0, +-inf, +-FLT_MAX or int32 extremes), with a
    NaN as well, only signed zeros, or only +inf / -inf."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        x = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
        if kind != "random":
            x[rng.integers(0, n, 2)] = [2 ** 31 - 1, -2 ** 31]
        return x
    if kind == "zeros":
        return np.where(rng.random(n) < 0.5, np.float32(0.0), np.float32(-0.0))
    if kind in ("inf", "-inf"):
        return np.full(n, np.float32(kind), dtype=np.float32)
    x = (rng.standard_normal(n) * 100).astype(np.float32)
    if kind in ("edges", "nan"):
        x[rng.integers(0, n, 6)] = [0.0, -0.0, np.inf, -np.inf, FMAX, -FMAX]
    if kind == "nan":
        x[rng.integers(0, n)] = np.nan
    return x


def minmax_masks(x: np.ndarray, seed: int = 0):
    rng = np.random.default_rng(seed + 1)
    n = x.shape[0]
    masks = {"none": None, "random": rng.random(n) < 0.5,
             "all_invalid": np.zeros(n, dtype=bool)}
    if x.dtype == np.float32:
        masks["hides_nan"] = ~np.isnan(x)
    return masks


def same_minmax(got, want) -> bool:
    """Equal bit patterns, or NaN in both (the port's NaN is the canonical
    0x7FC00000; the Pallas kernel passes a NaN's sign and payload on)."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if np.isnan(w).any() or np.isnan(g).any():
            if not (np.isnan(g) and np.isnan(w)):
                return False
        elif g.tobytes() != w.tobytes() or g.dtype != w.dtype:
            return False
    return True


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype,kind", [
    (np.int32, "random"), (np.int32, "edges"),
    (np.float32, "random"), (np.float32, "edges"), (np.float32, "nan"),
    (np.float32, "zeros"), (np.float32, "inf"), (np.float32, "-inf")])
def test_masked_minmax_matches_pallas(pallas_on, n, dtype, kind):
    x = minmax_input(n, kind, dtype, seed=n)
    for name, valid in minmax_masks(x, seed=n).items():
        want = pallas_kernels.masked_minmax(
            jnp.asarray(x), None if valid is None else jnp.asarray(valid))
        got = ck.masked_minmax(torch.from_numpy(x),
                               None if valid is None else torch.from_numpy(valid))
        assert same_minmax([t.numpy() for t in got], [np.asarray(w) for w in want]), \
            (name, [t.item() for t in got], [np.asarray(w).item() for w in want])


@pytest.mark.parametrize("values,mn,mx", [
    ([0.0, -0.0], "-0.0", "0.0"), ([-0.0, 0.0], "-0.0", "0.0"),
    ([-0.0, -0.0], "-0.0", "-0.0"), ([1.0, float("nan"), 2.0], "nan", "nan")])
def test_masked_minmax_signed_zero_and_nan(values, mn, mx):
    for dtype in (torch.float32, torch.float64):
        got = ck.masked_minmax_plain(torch.tensor(values, dtype=dtype))
        for g, w in zip(got, (mn, mx)):
            assert str(g.item()) == w


def test_masked_minmax_starts_from_the_sentinels():
    f = torch.finfo(torch.float32)
    got = ck.masked_minmax(torch.tensor([float("inf")] * 3))
    assert [t.item() for t in got] == [f.max, float("inf")]
    got = ck.masked_minmax(torch.tensor([1.0, 2.0]), torch.tensor([False, False]))
    assert [t.item() for t in got] == [f.max, f.min]
    got = ck.masked_minmax(torch.zeros(0, dtype=torch.int32))
    assert [t.item() for t in got] == [2 ** 31 - 1, -2 ** 31]


# ---------------------------------------------------------------------------
# Wrapper contract.
# ---------------------------------------------------------------------------

def test_wrappers_check_their_arguments():
    x = torch.arange(10, dtype=torch.int32)
    with pytest.raises(Exception, match="dtype"):
        ck.compare_mask(x.to(torch.int64), "<", 3)
    with pytest.raises(Exception, match="contiguous"):
        ck.range_mask(x[::2], 1, 3)
    with pytest.raises(Exception, match="bad op"):
        ck.compare_mask(x, "<>", 3)
    with pytest.raises(Exception, match="1..8"):
        ck.hash_bucket([x] * 9, 4)
    with pytest.raises(Exception, match="does not fit"):
        ck.compare_mask(x, "<", 2 ** 40)
    with pytest.raises(Exception, match="num_buckets"):
        ck.bucket_histogram(x, 0)
    with pytest.raises(Exception, match="dtype"):
        ck.masked_minmax(x.to(torch.int64))
    with pytest.raises(Exception, match="validity"):
        ck.masked_minmax(x, torch.ones(9, dtype=torch.bool))


def test_cpu_tensors_never_launch():
    ck.reset_launches()
    x = torch.arange(100, dtype=torch.int32)
    ck.compare_mask(x, ">", 5)
    ck.range_mask(x, 5, 50)
    ck.bucket_histogram(x % 4, 4)
    ck.hash_bucket([x], 4)
    ck.masked_minmax(x, x > 3)
    assert all(v == 0 for v in ck.LAUNCHES.values())


def test_uint32_columns_compare_as_unsigned():
    words = torch.tensor([0, 1, -1, -(2 ** 31)], dtype=torch.int32).view(torch.uint32)
    assert ck.compare_mask(words, ">", 2 ** 31 - 1).tolist() == [False, False, True, True]
    assert ck.range_mask(words, 1, 2 ** 31, True, True).tolist() == [False, True, False, True]


def test_interop_table_equals_own_read():
    at = arrow_table(500, seed=11)
    jt = JTable.from_arrow(at)
    cols = {n: (c.dtype, np.asarray(c.data),
                None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for n, c in jt.columns.items()}
    via = table_from_numpy(cols).to_arrow()
    assert_tables_equal(via, TTable.from_arrow(at, "cpu").to_arrow())
    assert_tables_equal(via, jt.to_arrow())


def assert_tables_equal(a: pa.Table, b: pa.Table) -> None:
    """Schema, nulls and values equal, NaN equal to NaN."""
    assert a.schema.equals(b.schema)
    for name in a.column_names:
        np.testing.assert_array_equal(np.asarray(a[name].is_null()),
                                      np.asarray(b[name].is_null()))
        np.testing.assert_array_equal(a[name].to_numpy(zero_copy_only=False),
                                      b[name].to_numpy(zero_copy_only=False))
