"""TPC-H Q3 and Q17 -- covering-index joins, group-bys, sort and limit --
through both packages' public entry points on the same small files, and
the join, grouping, segment and sort ops beneath them on the same
numpy-seeded inputs, all compared exactly: float64 values bit for bit.

The JAX side runs on the CPU with its distributed tier off, as its own
tests do; its queries are bench.py's (``build_q3``, ``build_q17``), and
the port's are chip_smoke.py's copies of them. The port side runs its
plain torch paths on CPU tensors.
"""

import datetime
import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import bench
import chip_smoke
import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import executor as jex
from hyperspace_tpu.execution.columnar import Column as JColumn
from hyperspace_tpu.execution.columnar import Table as JTable
from hyperspace_tpu.ops import kernels as jk
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plan import nodes as JN
from hyperspace_tpu_torch.execution import executor as tex
from hyperspace_tpu_torch.execution.columnar import Column as TColumn
from hyperspace_tpu_torch.execution.columnar import Table as TTable
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.ops import cuda_kernels
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.plan import nodes as TN
from hyperspace_tpu_torch.rules import join_rule
from hyperspace_tpu_torch.rules.index_filters import ReasonCollector

SCALE = 0.002  # 12,000 lineitem, 3,000 orders and 400 part rows.

INDEXES = [
    ("li_idx", "lineitem", ["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"]),
    ("od_idx", "orders", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_shippriority"]),
    ("pt_idx", "part", ["p_partkey"], ["p_brand", "p_container"]),
    ("li_pk_idx", "lineitem", ["l_partkey"], ["l_quantity", "l_extendedprice"]),
]

CONF = {
    IndexConstants.INDEX_NUM_BUCKETS: "8",
    # conftest gives JAX 8 virtual devices, which would take its mesh paths.
    "hyperspace.tpu.distributed.enabled": "false",
}


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch")
    li_dir, od_dir, pt_dir, _, _ = bench.make_tpch_like(str(root / "data"), SCALE)
    dirs = {"lineitem": li_dir, "orders": od_dir, "part": pt_dir}
    sessions = {
        "jax": hst.Session(conf=dict(CONF), system_path=str(root / "jax_indexes")),
        "torch": ht.Session(conf=dict(CONF), system_path=str(root / "torch_indexes"),
                            device="cpu"),
    }
    for pkg, session in ((hst, sessions["jax"]), (ht, sessions["torch"])):
        hs = pkg.Hyperspace(session)
        for name, table, indexed, included in INDEXES:
            hs.create_index(session.read.parquet(dirs[table]),
                            pkg.IndexConfig(name, indexed, included))
    return {"dirs": dirs, **sessions}


def query(lake, pkg: str, name: str):
    session, d = lake[pkg], lake["dirs"]
    builders = bench if pkg == "jax" else chip_smoke
    if name == "q3":
        return builders.build_q3(session, d["lineitem"], d["orders"])
    return builders.build_q17(session, d["lineitem"], d["part"])


def run(lake, pkg: str, name: str, indexed: bool):
    session = lake[pkg]
    df = query(lake, pkg, name)
    (session.enable_hyperspace if indexed else session.disable_hyperspace)()
    try:
        return df.to_arrow(), df.optimized_plan()
    finally:
        session.disable_hyperspace()


def float_bits(table: pa.Table) -> dict:
    """Every float column's bit patterns (``pa.Table.equals`` takes -0.0 ==
    0.0)."""
    return {n: table.column(n).to_numpy().view(np.int64).tolist()
            for n in table.column_names if pa.types.is_float64(table.column(n).type)}


def index_leaves(plan) -> list:
    return [leaf.index_entry.name if hasattr(leaf, "index_entry") else None
            for leaf in plan.collect_leaves()]


@pytest.mark.parametrize("indexed", [True, False])
@pytest.mark.parametrize("name", ["q3", "q17"])
def test_query_results_equal_across_packages(lake, name, indexed):
    got, plan = run(lake, "torch", name, indexed)
    want, jplan = run(lake, "jax", name, indexed)
    assert got.equals(want)
    assert float_bits(got) == float_bits(want)
    assert got.num_rows == (10 if name == "q3" else 1)
    assert got.column(got.column_names[-1]).null_count == 0
    assert index_leaves(plan) == index_leaves(jplan)
    assert plan.tree_string() == jplan.tree_string()


def test_q3_joins_two_bucketed_index_scans(lake):
    _, plan = run(lake, "torch", "q3", True)
    leaves = plan.collect_leaves()
    assert [leaf.index_entry.name for leaf in leaves] == ["li_idx", "od_idx"]
    assert all(leaf.use_bucket_spec for leaf in leaves)


def test_q17_reads_the_partkey_index_under_both_joins_and_the_threshold(lake):
    _, plan = run(lake, "torch", "q17", True)
    assert index_leaves(plan) == ["li_pk_idx", "pt_idx", "li_pk_idx"]
    join2 = plan.child.child.child.child
    assert isinstance(join2, TN.Join)
    thr = join2.right.child
    assert isinstance(thr, TN.Aggregate) and thr.group_cols == ["l_partkey"]


@pytest.mark.parametrize("name", ["q3", "q17"])
def test_indexed_takes_the_sort_free_paths(lake, monkeypatch, name):
    """Indexed Q3 merges without a sort and aggregates its join output in
    two phases; indexed Q17 merges its first join and its threshold
    group-by skips the sort. Scanned, neither happens. These are the
    staged executor's paths: the scanned runs would otherwise fuse."""
    seen = {"merge": [], "two_phase": 0}
    real_merge, real_two = tex._bucketed_merge_keys, tex._execute_aggregate_two_phase

    def merge(*a):
        out = real_merge(*a)
        seen["merge"].append(out is not None)
        return out

    def two_phase(*a):
        seen["two_phase"] += 1
        return real_two(*a)

    monkeypatch.setattr(tex, "_bucketed_merge_keys", merge)
    monkeypatch.setattr(tex, "_execute_aggregate_two_phase", two_phase)
    lake["torch"].conf.set(IndexConstants.TPU_FUSION_ENABLED, "false")
    try:
        for indexed in (True, False):
            seen.update(merge=[], two_phase=0)
            run(lake, "torch", name, indexed)
            if name == "q3":
                assert seen == {"merge": [indexed], "two_phase": int(indexed)}
            else:
                assert seen == {"merge": [indexed, indexed], "two_phase": 0}
    finally:
        lake["torch"].conf.unset(IndexConstants.TPU_FUSION_ENABLED)


def test_indexed_q17_sorts_nothing(lake, monkeypatch):
    """Indexed, both Q17 joins merge bucket-ordered sides and the
    threshold group-by reads li_pk_idx's bucket order: no sort at all.
    Scanned, the group-by and both joins sort."""
    sorted_rows = []
    real = tk.lex_sort_indices
    monkeypatch.setattr(tk, "lex_sort_indices",
                        lambda keys, *a: sorted_rows.append(len(keys[0])) or real(keys, *a))
    run(lake, "torch", "q17", True)
    assert sorted_rows == []
    run(lake, "torch", "q17", False)
    assert len(sorted_rows) == 3 and max(sorted_rows) == 12_000


@pytest.mark.parametrize("name", ["q3", "q17"])
def test_indexed_equals_scanned(lake, name):
    """The same answer both ways, float64 within 1e-9 relative: the sums
    add the same values in another order."""
    indexed, _ = run(lake, "torch", name, True)
    scanned, _ = run(lake, "torch", name, False)
    assert indexed.column_names == scanned.column_names
    for n in indexed.column_names:
        a, b = indexed.column(n).to_pylist(), scanned.column(n).to_pylist()
        if pa.types.is_float64(indexed.column(n).type):
            assert np.allclose(a, b, rtol=1e-9, atol=0)
        else:
            assert a == b


@pytest.mark.parametrize("name", ["q3", "q17"])
def test_query_runs_twice_to_the_same_bytes(lake, name):
    first, _ = run(lake, "torch", name, True)
    second, _ = run(lake, "torch", name, True)
    assert first.equals(second) and float_bits(first) == float_bits(second)


def test_kernels_take_the_cpu_path(lake):
    cuda_kernels.reset_launches()
    run(lake, "torch", "q3", True)
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())


@pytest.mark.parametrize("how", ["left", "right", "full", "semi", "anti", "cross"])
def test_other_join_types_are_refused_by_name(lake, how):
    """Every join type of the JAX package builds a plan now; a type it
    lacks is refused by name, as there, and so are a cross join given a
    condition and another type given none."""
    errors = {}
    for pkg, E, N in (("torch", TE, TN), ("jax", JE, JN)):
        li = lake[pkg].read.parquet(lake["dirs"]["lineitem"])
        od = lake[pkg].read.parquet(lake["dirs"]["orders"])
        cond = E.col("l_orderkey") == E.col("o_orderkey")
        if how == "cross":
            assert li.cross_join(od).plan.simple_string() == "Join cross"
            bad = lambda: li.join(od, on=cond, how="cross")  # noqa: E731
        else:
            assert li.join(od, on=cond, how=how).plan.simple_string() == \
                f"Join {how} ({cond!r})"
            bad = lambda: N.Join(li.plan, od.plan, None, how)  # noqa: E731
        got = []
        for call in (bad, lambda: li.join(od, on=cond, how=how + "_outer")):
            with pytest.raises(Exception) as err:
                call()
            got.append(str(err.value))
        errors[pkg] = got
    assert errors["torch"] == errors["jax"]
    assert errors["torch"][1] == f"Unsupported join type: {how}_outer"


def test_uncovered_join_side_is_not_rewritten(lake):
    """A join side reading a column its index lacks keeps its Scan, and the
    reason names the column, as in the JAX package."""
    s = lake["torch"]
    li = s.read.parquet(lake["dirs"]["lineitem"])
    od = s.read.parquet(lake["dirs"]["orders"])
    df = li.join(od, on=ht.col("l_orderkey") == ht.col("o_orderkey")) \
        .select("l_quantity", "o_orderdate")
    plan = s.optimize(df.plan)
    join = plan.child
    ctx = ReasonCollector()
    found = join_rule.try_rewrite_join(
        s, join, ctx, lambda scan: s.index_collection_manager.get_indexes(["ACTIVE"]))
    assert found is None
    assert ("MISSING_REQUIRED_COL", "li_idx",
            "Index does not cover required columns ['l_quantity'].") in ctx.reasons
    s.enable_hyperspace()
    try:
        assert index_leaves(df.optimized_plan()) == [None, None]
        got = df.to_arrow()
    finally:
        s.disable_hyperspace()
    jdf = lake["jax"].read.parquet(lake["dirs"]["lineitem"]).join(
        lake["jax"].read.parquet(lake["dirs"]["orders"]),
        on=JE.col("l_orderkey") == JE.col("o_orderkey")).select("l_quantity", "o_orderdate")
    assert got.equals(jdf.to_arrow())


# ---------------------------------------------------------------------------
# Joins, group-bys and sorts beyond the two queries: null keys, string keys
# over different dictionaries, two- and three-key joins, nullable group
# keys and aggregates, nulls in a sort, through both packages' sessions.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def null_lake(tmp_path_factory):
    import pyarrow.parquet as pq
    root = tmp_path_factory.mktemp("nulls")
    r = rng(20)
    n, m = 600, 250
    left = pa.table({
        "k64": pa.array(r.integers(0, 40, n), mask=r.random(n) < 0.1),
        "k32": pa.array(r.integers(-5, 5, n).astype(np.int32)),
        "s": pa.array(r.choice(["ant", "bee", "cat", "dog", ""], n), mask=r.random(n) < 0.1),
        "d": pa.array(r.integers(9000, 9008, n).astype(np.int32)).cast(pa.date32()),
        "v": pa.array(r.uniform(-1e4, 1e4, n), mask=r.random(n) < 0.15),
        "q": pa.array(r.integers(-100, 100, n)),
    })
    right = pa.table({
        "rk64": pa.array(r.integers(0, 40, m), mask=r.random(m) < 0.1),
        "rk32": pa.array(r.integers(-5, 5, m).astype(np.int32)),
        "rs": pa.array(r.choice(["bee", "cat", "eel", "fox"], m), mask=r.random(m) < 0.1),
        "rd": pa.array(r.integers(9000, 9008, m).astype(np.int32)).cast(pa.date32()),
        "w": pa.array(r.uniform(-10, 10, m).astype(np.float32)),
    })
    for name, table in (("left", left), ("right", right)):
        os.makedirs(root / name)
        pq.write_table(table, str(root / name / "part0.parquet"))
    return {"root": root,
            "jax": hst.Session(conf=dict(CONF), system_path=str(root / "jax_indexes")),
            "torch": ht.Session(conf=dict(CONF), system_path=str(root / "torch_indexes"),
                                device="cpu")}


NULL_QUERIES = {
    "join_int64_null_keys": lambda a, b, E: a.join(b, on=E.col("k64") == E.col("rk64")),
    "join_string_keys": lambda a, b, E: a.join(b, on=E.col("s") == E.col("rs")),
    "join_two_int32_keys": lambda a, b, E: a.join(
        b, on=(E.col("k32") == E.col("rk32")) & (E.col("d") == E.col("rd"))),
    "join_three_keys": lambda a, b, E: a.join(
        b, on=(E.col("k64") == E.col("rk64")) & (E.col("s") == E.col("rs"))
        & (E.col("d") == E.col("rd"))),
    "group_by_nullable_keys": lambda a, b, E: a.group_by("s", "k32").agg(
        E.sum_(E.col("v")).alias("sv"), E.avg(E.col("q")).alias("aq"),
        E.min_(E.col("v")).alias("lo"), E.max_(E.col("s")).alias("hi"),
        E.count(E.col("v")).alias("cv"), E.count().alias("c")),
    "group_by_join_output": lambda a, b, E: a.join(b, on=E.col("k32") == E.col("rk32"))
    .group_by("rs", "d").agg(E.sum_(E.col("v") * E.col("w")).alias("vw"),
                             E.avg(E.col("w")).alias("aw")),
    "sort_nulls_limit": lambda a, b, E: a.sort(("v", False), ("s", True), "q").limit(25),
    "empty_group_by": lambda a, b, E: a.filter(E.col("q") > 1000).group_by("s").agg(
        E.sum_(E.col("v")).alias("sv"), E.count().alias("c")),
    "join_without_matches": lambda a, b, E: a.filter(E.col("k32") > 100).join(
        b, on=E.col("k64") == E.col("rk64")),
    "global_aggregate": lambda a, b, E: a.agg(
        E.sum_(E.col("v")).alias("sv"), E.avg(E.col("v")).alias("av"),
        E.count(E.col("v")).alias("cv"), E.min_(E.col("q")).alias("lo"),
        E.max_(E.col("q")).alias("hi")),
}


@pytest.mark.parametrize("name", sorted(NULL_QUERIES))
def test_operators_equal_across_packages(null_lake, name):
    out = {}
    for pkg, E in (("torch", TE), ("jax", JE)):
        s = null_lake[pkg]
        a = s.read.parquet(str(null_lake["root"] / "left"))
        b = s.read.parquet(str(null_lake["root"] / "right"))
        out[pkg] = NULL_QUERIES[name](a, b, E).to_arrow()
    got, want = out["torch"], out["jax"]
    assert (got.num_rows > 0) == (name not in ("empty_group_by", "join_without_matches"))
    assert got.equals(want)
    assert float_bits(got) == float_bits(want)


STAGED = {"hyperspace.tpu.execution.fusion.enabled": "false"}


def both_routes(null_lake, query, jax_raises=()):
    """{route: (port's table, JAX package's table)} of ``query(session, E)``
    on each package's default (fused) route and its staged route; on a
    route in ``jax_raises`` the JAX package's ``to_arrow`` must raise
    IndexError, and its table is None."""
    out = {}
    for route, extra in (("default", {}), ("staged", STAGED)):
        tables = {}
        for pkg, mod, E in (("torch", ht, TE), ("jax", hst, JE)):
            kw = {"device": "cpu"} if pkg == "torch" else {}
            s = mod.Session(conf={**CONF, **extra},
                            system_path=str(null_lake["root"] / f"{pkg}_{route}"), **kw)
            if pkg == "jax" and route in jax_raises:
                with pytest.raises(IndexError):
                    query(s, E).to_arrow()
                tables[pkg] = None
            else:
                tables[pkg] = query(s, E).to_arrow()
        out[route] = (tables["torch"], tables["jax"])
    return out


def test_empty_global_sum_follows_the_staged_path(null_lake):
    """Queue C 3: a global sum of a nullable column over no kept rows. Each
    package's default route fuses the region, reads the column whole (its
    pushed-down read keeps nothing) and answers NULL; its staged route
    answers 0.0. The port equals the JAX package route for route. AVG of
    the non-null q stays 0.0 on both."""
    def query(s, E):
        return s.read.parquet(str(null_lake["root"] / "left")).filter(E.col("q") > 1000) \
            .agg(E.sum_(E.col("v")).alias("sv"), E.avg(E.col("q")).alias("aq"),
                 E.count().alias("c"))

    out = both_routes(null_lake, query)
    for got, want in out.values():
        assert got.equals(want)
    assert out["default"][0].to_pydict() == {"sv": [None], "aq": [0.0], "c": [0]}
    assert out["staged"][0].to_pydict() == {"sv": [0.0], "aq": [0.0], "c": [0]}


@pytest.mark.parametrize("fn", ["min_", "max_"])
@pytest.mark.parametrize("column", ["k32", "k64", "d", "s"])
def test_empty_global_min_max_follows_the_staged_path(null_lake, column, fn):
    """Queue C 20: a global MIN/MAX over no kept rows of an int32, a
    nullable int64, a date or a nullable string column. The staged route
    gives the dtype's far end (int32's max for MIN, its min for MAX; the
    string MIN's code reads back as '' and the MAX's as NULL); the default
    (fused) route gives NULL for the nullable columns (queue C 3's
    pattern) and the far end for the others. The port equals the JAX
    package route for route (as arrow tables: a far-end date is no Python
    date). One exception: the JAX package's fused string MIN holds the
    int32 maximum under its NULL, and its ``to_arrow`` indexes the
    dictionary with it and raises IndexError; the port answers NULL."""
    def query(s, E):
        return s.read.parquet(str(null_lake["root"] / "left")).filter(E.col("q") > 1000) \
            .agg(getattr(E, fn)(E.col(column)).alias("m"))

    jax_raises = ("default",) if (column, fn) == ("s", "min_") else ()
    out = both_routes(null_lake, query, jax_raises)
    for got, want in out.values():
        assert want is None or (got.schema == want.schema and got.equals(want))
    staged, fused = out["staged"][0], out["default"][0]
    if column in ("k32", "d"):
        far = 2147483647 if fn == "min_" else -2147483648
        for got in (staged, fused):
            assert got.column(0).combine_chunks().view(pa.int32()).to_pylist() == [far]
    elif column == "k64":
        assert staged.to_pydict() == {"m": [2 ** 63 - 1 if fn == "min_" else -2 ** 63]}
        assert fused.to_pydict() == {"m": [None]}
    else:
        assert staged.to_pydict() == {"m": ["" if fn == "min_" else None]}
        assert fused.to_pydict() == {"m": [None]}


# ---------------------------------------------------------------------------
# The ops, on the same numpy inputs through both packages.
# ---------------------------------------------------------------------------

def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def as_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def join_case(case: str):
    """(left keys, right keys sorted) as numpy."""
    r = rng(1)
    if case == "duplicates":
        left, right = r.integers(0, 20, 300), r.integers(0, 20, 200)
    elif case == "no_matches":
        left, right = r.integers(0, 50, 100), r.integers(100, 150, 80)
    elif case == "empty_left":
        left, right = np.zeros(0, np.int64), r.integers(0, 9, 40)
    elif case == "empty_right":
        left, right = r.integers(0, 9, 40), np.zeros(0, np.int64)
    elif case == "int32":
        left, right = r.integers(-50, 50, 500).astype(np.int32), \
            r.integers(-50, 50, 400).astype(np.int32)
    elif case == "date":
        left, right = r.integers(9000, 9060, 300).astype(np.int32), \
            r.integers(9000, 9060, 300).astype(np.int32)
    else:  # wide int64 keys, past 2**31
        left = r.integers(2 ** 40, 2 ** 40 + 30, 200)
        right = r.integers(2 ** 40, 2 ** 40 + 30, 150)
    return left, np.sort(right, kind="stable")


@pytest.mark.parametrize("case", ["duplicates", "no_matches", "empty_left", "empty_right",
                                  "int32", "date", "int64_wide"])
def test_merge_join_indices(case):
    left, right = join_case(case)
    li, ri = tk.merge_join_indices(torch.from_numpy(left), torch.from_numpy(right))
    jli, jri = jk.merge_join_indices(jnp.asarray(left), jnp.asarray(right))
    assert as_np(li).tolist() == as_np(jli).tolist()
    assert as_np(ri).tolist() == as_np(jri).tolist()
    assert (left[as_np(li)] == right[as_np(ri)]).all()


def bucket_tables(keys: np.ndarray, dtype: str, num_buckets: int = 8):
    """One bucket-ordered key column through both packages (rows sorted by
    (bucket, key), as a covering index stores them)."""
    t = TTable({"k": TColumn(dtype, torch.from_numpy(keys))})
    bids = tk.bucket_ids(tk.hash32_values(t.column("k").data, dtype), num_buckets)
    perm = tk.lex_sort_indices([bids, t.column("k").data]).numpy()
    keys = keys[perm]
    order = (num_buckets, ("k",))
    return (TTable({"k": TColumn(dtype, torch.from_numpy(keys))}, order),
            JTable({"k": JColumn(dtype, jnp.asarray(keys))}, bucket_order=order), keys)


@pytest.mark.parametrize("dtype,edge,fits", [
    ("int64", None, True), ("int32", -(2 ** 31), True), ("date", None, True),
    ("int64", 2 ** 31 - 1, True), ("int64", -(2 ** 31 - 1), True),
    ("int64", 2 ** 31, False), ("int64", -(2 ** 31), False), ("int64", -(2 ** 63), False),
])
def test_bucketed_merge_keys(dtype, edge, fits):
    """The fast path's composite keys equal the JAX package's, and it
    declines where a key does not fit in 32 bits (``edge``, one left key),
    as the JAX package's does."""
    npdt = np.int64 if dtype == "int64" else np.int32
    r = rng(2)
    lkeys = r.integers(-3000, 3000, 400).astype(npdt)
    if edge is not None:
        lkeys[17] = edge
    t_right, j_right, rkeys = bucket_tables(r.integers(-3000, 3000, 300).astype(npdt), dtype)
    t_left = TTable({"a": TColumn(dtype, torch.from_numpy(lkeys))})
    j_left = JTable({"a": JColumn(dtype, jnp.asarray(lkeys))})
    got = tex._bucketed_merge_keys(t_left, t_right, [("a", "k")],
                                   t_left.column("a").data, t_right.column("k").data)
    want = jex._bucketed_merge_keys(j_left, j_right, [("a", "k")],
                                    j_left.column("a").data, j_right.column("k").data)
    assert (got is None) == (not fits)
    # The JAX package tests max |key|, and |int64 min| wraps to itself.
    assert (want is None) == (not fits and edge != -(2 ** 63))
    if fits:
        assert got[2] is want[2] is False
        assert as_np(got[0]).tolist() == as_np(want[0]).tolist()
        assert as_np(got[1]).tolist() == as_np(want[1]).tolist()
        assert (np.diff(as_np(got[1])) >= 0).all()


def test_int64_min_key_is_not_packed():
    """Queue C: with one bucket, the JAX package's fast path packs a key of
    -2**63 as 0 and joins it to a 0 key; the port declines the fast path
    and finds no match."""
    right_t, right_j, _ = bucket_tables(np.array([0], dtype=np.int64), "int64", 1)
    left = np.array([-(2 ** 63), 5], dtype=np.int64)
    pairs = [("a", "k")]
    jl = JTable({"a": JColumn("int64", jnp.asarray(left))})
    lcomp, rcomp, _ = jex._bucketed_merge_keys(jl, right_j, pairs, jl.column("a").data,
                                               right_j.column("k").data)
    jli, _ = jk.merge_join_indices(lcomp, rcomp)
    assert as_np(jli).tolist() == [0]  # the reference's false match
    tl = TTable({"a": TColumn("int64", torch.from_numpy(left))})
    assert tex._bucketed_merge_keys(tl, right_t, pairs, tl.column("a").data,
                                    right_t.column("k").data) is None
    li, _ = tk.merge_join_indices(tl.column("a").data, right_t.column("k").data)
    assert li.tolist() == []


def sorted_group_keys(n: int, seed: int):
    r = rng(seed)
    a = np.sort(r.integers(0, n // 6 + 1, n))
    b = r.integers(0, 3, n).astype(np.int32)
    perm = np.lexsort((b, a))
    return a[perm], b[perm]


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_group_ids_from_sorted(n):
    a, b = sorted_group_keys(n, 3)
    gids, count = tk.group_ids_from_sorted([torch.from_numpy(a), torch.from_numpy(b)])
    jgids, jcount = jk.group_ids_from_sorted([jnp.asarray(a), jnp.asarray(b)])
    assert count == jcount
    assert as_np(gids).tolist() == as_np(jgids).tolist()


def segment_input(dtype, nulls: bool, seed: int):
    n = 2000
    r = rng(seed)
    a, b = sorted_group_keys(n, seed)
    gids, groups = tk.group_ids_from_sorted([torch.from_numpy(a), torch.from_numpy(b)])
    jgids, _ = jk.group_ids_from_sorted([jnp.asarray(a), jnp.asarray(b)])
    if np.dtype(dtype).kind == "f":
        data = (r.uniform(-1e5, 1e5, n) * r.uniform(0, 1, n)).astype(dtype)
        data[:3] = np.array([-0.0, 0.0, 1e-300]).astype(dtype)
    else:
        data = r.integers(-10 ** 6, 10 ** 6, n).astype(dtype)
    valid = r.random(n) < 0.8 if nulls else None
    return data, valid, gids, jgids, groups


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, np.int32])
@pytest.mark.parametrize("op", ["sum", "mean", "min", "max"])
def test_segment_agg(op, dtype, nulls):
    data, valid, gids, jgids, groups = segment_input(dtype, nulls, 4)
    widen = op in ("sum", "mean")
    value, counts = tk.segment_agg(torch.from_numpy(data),
                                   None if valid is None else torch.from_numpy(valid),
                                   gids, groups, op, widen=widen)
    jvalue, jcounts = jk.segment_agg(jnp.asarray(data),
                                     None if valid is None else jnp.asarray(valid),
                                     jgids, groups, op, widen=widen)
    want = as_np(jvalue)
    assert as_np(value).dtype == want.dtype
    assert as_np(value).tobytes() == want.tobytes()
    assert (counts is None) == (jcounts is None)
    if counts is not None:
        assert as_np(counts).tolist() == as_np(jcounts).tolist()


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_gather_segment(op):
    """The two-phase combine: partials gathered through a permutation and
    reduced per segment, float64 bit for bit."""
    data, _, gids, jgids, groups = segment_input(np.float64, False, 5)
    order = rng(6).permutation(len(data))
    got = tk.gather_segment(torch.from_numpy(data), torch.from_numpy(order), gids, groups, op)
    want = jk.gather_segment(jnp.asarray(data), jnp.asarray(order), jgids, groups, op)
    assert as_np(got).tobytes() == as_np(want).tobytes()


def two_phase_tables(float_values: np.ndarray):
    """A join-output-like table in bucket order on ``k`` alone, grouped by
    (k, d): runs of equal (k, d) tuples, some tuples split over runs."""
    r = rng(7)
    n = float_values.shape[0]
    k = np.sort(r.integers(0, 200, n))
    d = r.integers(0, 3, n).astype(np.int32)
    order = (8, ("k",))
    cols = {"k": ("int64", k), "d": ("date", d), "v": ("float64", float_values),
            "q": ("int64", r.integers(0, 50, n))}
    t = TTable({c: TColumn(dt, torch.from_numpy(x)) for c, (dt, x) in cols.items()}, order)
    j = JTable({c: JColumn(dt, jnp.asarray(x)) for c, (dt, x) in cols.items()},
               bucket_order=order)
    return t, j


def aggregate_plans(module, E):
    aggs = [E.sum_(E.col("v")).alias("s"), E.avg(E.col("q")).alias("a"),
            E.min_(E.col("v")).alias("lo"), E.max_(E.col("q")).alias("hi"),
            E.count().alias("c")]
    from hyperspace_tpu.schema import Field as JField, Schema as JSchema
    from hyperspace_tpu_torch.schema import Field as TField, Schema as TSchema
    Field, Schema = (TField, TSchema) if module is TN else (JField, JSchema)
    schema = Schema([Field("k", "int64"), Field("d", "date"), Field("v", "float64"),
                     Field("q", "int64")])

    class Leaf(module.LogicalPlan):
        @property
        def schema(self):
            return schema

    return module.Aggregate(["k", "d"], aggs, Leaf())


def test_two_phase_aggregate_equals_jax():
    t, j = two_phase_tables(rng(8).uniform(0, 1e5, 3000))
    got = tex._execute_aggregate(aggregate_plans(TN, TE), t).to_arrow()
    want = jex._execute_aggregate(aggregate_plans(JN, JE), j).to_arrow()
    assert got.equals(want) and float_bits(got) == float_bits(want)


def test_two_phase_aggregate_equals_the_full_sort_path():
    """With sums that are exact in any order (quarter-integers), the
    two-phase path and the full-sort path return the same table."""
    t, _ = two_phase_tables(rng(9).integers(0, 4000, 3000) / 4.0)
    plan = aggregate_plans(TN, TE)
    two_phase = tex._execute_aggregate(plan, t).to_arrow()
    full_sort = tex._execute_aggregate(plan, TTable(dict(t.columns))).to_arrow()
    assert two_phase.equals(full_sort) and float_bits(two_phase) == float_bits(full_sort)


SORT_KEYS = {
    "nan_and_signed_zeros": np.array([0.0, -0.0, np.nan, 1.0, -0.0, 0.0, -np.nan, -1.0, 2.0]),
    "int64_extremes": np.array([3, -(2 ** 63), 2 ** 63 - 1, 0, -(2 ** 63), 5, -1]),
    "int32": np.array([3, -7, 3, 0, 2 ** 31 - 1, -(2 ** 31), 3], dtype=np.int32),
    "bool": np.array([True, False, True, True, False]),
}


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("case", sorted(SORT_KEYS))
def test_lex_sort_indices_one_key(case, ascending):
    keys = SORT_KEYS[case]
    got = tk.lex_sort_indices([torch.from_numpy(keys)], [ascending])
    want = jk.lex_sort_indices([jnp.asarray(keys)], [ascending])
    assert as_np(got).tolist() == as_np(want).tolist()


@pytest.mark.parametrize("directions", [(True, False, True), (False, True, False),
                                        (False, False, False)])
def test_lex_sort_indices_mixed_directions(directions):
    r = rng(10)
    n = 500
    f = r.choice([0.0, -0.0, np.nan, 1.5, -2.5], n)
    i = r.choice([-(2 ** 63), 0, 7, 2 ** 63 - 1], n)
    b = r.integers(0, 3, n).astype(np.int32)
    got = tk.lex_sort_indices([torch.from_numpy(x) for x in (f, i, b)], list(directions))
    want = jk.lex_sort_indices([jnp.asarray(x) for x in (f, i, b)], list(directions))
    assert as_np(got).tolist() == as_np(want).tolist()


@pytest.mark.parametrize("orders", [[("f", False), ("i", True)], [("i", False), ("f", True)],
                                    [("f", True)], [("i", False)]])
def test_sort_operator_with_nulls(orders):
    """Nulls first ascending and last descending, stable, through both
    executors' Sort."""
    r = rng(11)
    n = 300
    at = pa.table({
        "f": pa.array(r.choice([0.0, -0.0, np.nan, 1.5, -2.5], n), mask=r.random(n) < 0.2),
        "i": pa.array(r.choice([-(2 ** 63), 0, 7, 2 ** 63 - 1], n), mask=r.random(n) < 0.2),
        "row": pa.array(np.arange(n)),
    })
    t = TTable.from_arrow(at, "cpu")
    j = JTable.from_arrow(at)
    got = tex._execute_sort(TN.Sort(orders, _leaf(TN, t)), t).to_arrow()
    want = jex._execute_sort(JN.Sort(orders, _leaf(JN, t)), j).to_arrow()
    assert got.column("row").to_pylist() == want.column("row").to_pylist()


def _leaf(module, table):
    schema = table.schema() if module is TN else _jax_schema(table)

    class Leaf(module.LogicalPlan):
        @property
        def schema(self):
            return schema

    return Leaf()


def _jax_schema(table):
    from hyperspace_tpu.schema import Field, Schema
    return Schema([Field(f.name, f.dtype, f.nullable) for f in table.schema().fields])


def test_dense_rank_and_pack2():
    r = rng(12)
    a = r.integers(-5, 5, 400).astype(np.int32)
    b = r.integers(-(2 ** 31), 2 ** 31 - 1, 400).astype(np.int32)
    assert as_np(tk.dense_rank([torch.from_numpy(a), torch.from_numpy(b)])).tolist() == \
        as_np(jk.dense_rank([jnp.asarray(a), jnp.asarray(b)])).tolist()
    assert as_np(tk.pack2_int32(torch.from_numpy(a), torch.from_numpy(b))).tolist() == \
        as_np(jk.pack2_int32(jnp.asarray(a), jnp.asarray(b))).tolist()


ARITH = {
    "int_times_float": lambda E: E.col("i32") * 2.5,
    "int_plus_int": lambda E: E.col("i32") + 1,
    "one_minus_f64": lambda E: 1 - E.col("f64"),
    "f32_times_float": lambda E: E.col("f32") * 0.2,
    "i64_minus_f64": lambda E: E.col("i64") - E.col("f64"),
    "div_int": lambda E: E.col("i64") / 7,
    "lit_div_f32": lambda E: E.Divide(E.lit(3), E.col("f32")),
    "nested": lambda E: E.col("f64") * (1 - E.col("f32")) + E.col("i32") * 3,
}


@pytest.mark.parametrize("name", sorted(ARITH))
def test_arithmetic_promotion(name):
    """Arithmetic through both evaluators: the same dtype (int64 or
    float64 at every node, x64 promotion) and the same bits; nulls merge."""
    from hyperspace_tpu.execution import evaluator as jev
    from hyperspace_tpu_torch.execution import evaluator as tev
    r = rng(13)
    n = 200
    at = pa.table({
        "i32": pa.array(r.integers(-1000, 1000, n).astype(np.int32)),
        "i64": pa.array(r.integers(-10 ** 12, 10 ** 12, n), mask=r.random(n) < 0.1),
        "f64": pa.array(r.uniform(-1e3, 1e3, n)),
        "f32": pa.array(r.uniform(-1e3, 1e3, n).astype(np.float32)),
    })
    got = tev.eval_expr(TTable.from_arrow(at, "cpu"), ARITH[name](TE))
    want = jev.eval_expr(JTable.from_arrow(at), ARITH[name](JE))
    assert got.dtype == want.dtype
    assert got.data.numpy().tobytes() == np.asarray(want.data).tobytes()
    assert (got.validity is None) == (want.validity is None)


def test_column_versus_column_compare_promotes():
    """Q17's ``l_quantity < qty_thr``: int64 against float64."""
    from hyperspace_tpu.execution import evaluator as jev
    from hyperspace_tpu_torch.execution import evaluator as tev
    at = pa.table({"q": pa.array([1, 5, 6, 2 ** 53 + 1]),
                   "t": pa.array([1.5, 5.0, 5.9999, 2.0 ** 53])})
    cond_t, cond_j = TE.col("q") < TE.col("t"), JE.col("q") < JE.col("t")
    got = tev.eval_predicate_mask(TTable.from_arrow(at, "cpu"), cond_t).tolist()
    want = np.asarray(jev.eval_predicate_mask(JTable.from_arrow(at), cond_j)).tolist()
    assert got == want == [True, False, False, False]


def test_filter_above_join_sinks_to_each_side(lake):
    """A WHERE written above an inner join moves to the side it reads, and
    the normalized plan equals the JAX package's."""
    cutoff = datetime.date(1995, 3, 15)
    plans = []
    for pkg, E in (("torch", TE), ("jax", JE)):
        s, d = lake[pkg], lake["dirs"]
        df = s.read.parquet(d["lineitem"]).join(
            s.read.parquet(d["orders"]), on=E.col("l_orderkey") == E.col("o_orderkey")) \
            .filter((E.col("l_shipdate") > cutoff) & (E.col("o_orderdate") < cutoff)
                    & (E.col("l_quantity") < E.col("o_shippriority"))) \
            .select("l_orderkey", "o_orderdate")
        plans.append(s.optimize(df.plan).tree_string())
    assert plans[0] == plans[1]
    assert "Filter ((col(l_shipdate)" in plans[0]
    assert plans[0].index("Join") > plans[0].index("Filter ((col(l_quantity)")


def test_package_exports_the_aggregate_helpers():
    assert ht.sum_ is TE.sum_ and ht.avg is TE.avg
    assert TE.sum_(TE.col("x")).alias("s").name == "s"
    assert TE.count().name == "count(*)"
    assert TE.extract_equi_join_keys((TE.col("a") == TE.col("b"))
                                     & (TE.col("c") == TE.col("d"))) == [("a", "b"), ("c", "d")]
    assert TE.extract_equi_join_keys(TE.col("a") < TE.col("b")) is None
    assert repr(TE.conjoin([TE.col("a") > 1, TE.col("b") < 2])) == \
        "((col(a) > lit(1)) AND (col(b) < lit(2)))"
