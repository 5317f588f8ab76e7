"""The SQL front end and the relational surface under it -- LIKE, IS NULL,
CASE, EXTRACT, SUBSTRING, UPPER, LOWER, TRIM, CONCAT, SQRT; semi, anti,
left, right, full and cross joins; COUNT DISTINCT; windows; UNION ALL,
INTERSECT, EXCEPT; ROLLUP and WITH -- through both packages' ``sql`` and
DataFrame API on the same numpy-seeded files, indexes off and on.

Results compare exactly: keys, counts and strings equal, float64 values
bit for bit. The JAX side runs on the CPU with its distributed tier off,
its default (fused) path; ``STAGED`` statements also hold the port to its
staged path. The port runs its plain torch paths on CPU tensors.
"""

import datetime
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import buffer_pool as jbuffer_pool
from hyperspace_tpu.execution import evaluator as jev
from hyperspace_tpu.execution import executor as jex
from hyperspace_tpu.ops import kernels as jk
from hyperspace_tpu.parallel import io as jio
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plananalysis.explain import explain_string
from hyperspace_tpu_torch.execution import buffer_pool as tbuffer_pool
from hyperspace_tpu_torch.execution import evaluator as tev
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.parallel import io as tio
from hyperspace_tpu_torch.plan import expr as TE
from test_torch_tracing import fresh_telemetry_state

N_A, N_B = 240, 70
STRINGS = ["PROMO BRUSHED", "promo%x", "a_b", "a.b", "axb", "line\nbreak", "ünïcode",
           "Ωmega", "  padded  ", "", "(paren)", "[x]*+?", "Brand#23", "MED BOX", "zeta"]

CONF = {
    IndexConstants.INDEX_NUM_BUCKETS: "4",
    # conftest gives JAX 8 virtual devices, which would take its mesh paths.
    "hyperspace.tpu.distributed.enabled": "false",
}


def _with_nulls(arr: pa.Array, mask: np.ndarray) -> pa.Array:
    return pa.array(arr.to_pylist(), type=arr.type, mask=mask)


def make_tables(rng: np.random.Generator) -> dict:
    """``a``: nullable int keys, a float column with NaN, +-0.0 and nulls,
    strings with regex metacharacters, newlines and non-ASCII letters,
    dates from 1967 on; ``b``: nullable keys and strings over another
    dictionary."""
    x = np.round(rng.normal(0, 50, N_A), 2)
    x[rng.random(N_A) < 0.05] = np.nan
    x[:4] = [0.0, -0.0, 0.0, -0.0]
    a = {
        "k": _with_nulls(pa.array(rng.integers(0, 40, N_A).astype(np.int64)),
                         rng.random(N_A) < 0.1),
        "g": pa.array(rng.integers(0, 5, N_A).astype(np.int64)),
        "q": pa.array(rng.integers(1, 51, N_A).astype(np.int32)),
        "x": _with_nulls(pa.array(x), rng.random(N_A) < 0.05),
        "s": _with_nulls(pa.array(rng.choice(STRINGS, N_A)), rng.random(N_A) < 0.05),
        "d": pa.array(rng.integers(-1200, 12000, N_A).astype(np.int32),
                      type=pa.int32()).cast(pa.date32()),
    }
    b = {
        "bk": _with_nulls(pa.array(rng.integers(0, 60, N_B).astype(np.int64)),
                          rng.random(N_B) < 0.1),
        "bs": _with_nulls(pa.array(rng.choice(STRINGS[::2] + ["only-in-b", "Ωmega"], N_B)),
                          rng.random(N_B) < 0.1),
        "bv": pa.array(np.round(rng.uniform(-5, 5, N_B), 3)),
        "bg": pa.array(rng.integers(0, 5, N_B).astype(np.int64)),
    }
    return {"a": pa.table(a), "b": pa.table(b)}


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sql")
    dirs = {}
    for name, table in make_tables(np.random.default_rng(8)).items():
        d = os.path.join(str(root), name)
        os.makedirs(d)
        half = table.num_rows // 2
        pq.write_table(table.slice(0, half), os.path.join(d, "part0.parquet"))
        pq.write_table(table.slice(half), os.path.join(d, "part1.parquet"))
        dirs[name] = d
    out = {"dirs": dirs}
    for key, pkg, extra in (("jax", hst, {}), ("torch", ht, {"device": "cpu"}),
                            ("staged", hst, {})):
        conf = dict(CONF)
        if key == "staged":
            conf["hyperspace.tpu.execution.fusion.enabled"] = "false"
        session = pkg.Session(conf=conf, system_path=os.path.join(str(root), key), **extra)
        for name, d in dirs.items():
            session.create_temp_view(name, session.read.parquet(d))
        hs = pkg.Hyperspace(session)
        hs.create_index(session.table("a"), pkg.IndexConfig("a_k", ["k"], ["g", "q", "x", "s"]))
        hs.create_index(session.table("b"), pkg.IndexConfig("b_bk", ["bk"], ["bs", "bv"]))
        out[key] = session
    return out


def float_bits(table: pa.Table) -> dict:
    return {n: table.column(n).to_numpy(zero_copy_only=False).view(np.int64).tolist()
            for n in table.column_names if pa.types.is_float64(table.column(n).type)}


def assert_same(got: pa.Table, want: pa.Table) -> None:
    """Equal schemas, null masks and non-float columns; float64 columns
    equal bit for bit (``pa.Table.equals`` treats NaN as unequal to
    itself and -0.0 as equal to 0.0)."""
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        assert got.column(name).is_null().to_pylist() == \
            want.column(name).is_null().to_pylist(), name
    assert float_bits(got) == float_bits(want)
    others = [n for n in want.column_names if not pa.types.is_float64(want.column(n).type)]
    assert got.select(others).equals(want.select(others))


def run_sql(lake, key: str, text: str, indexed: bool):
    session = lake[key]
    (session.enable_hyperspace if indexed else session.disable_hyperspace)()
    try:
        df = session.sql(text)
        return df.to_arrow(), df.optimized_plan().tree_string()
    finally:
        session.disable_hyperspace()


# (id, text, also held to the JAX package's staged path)
STATEMENTS = [
    ("like_prefix", "select k, s from a where s like 'PROMO%'"),
    ("like_underscore", "select k, s from a where s like 'a_b'"),
    ("like_dot_literal", "select k, s from a where s like '%.%'"),
    ("like_metachars", "select k, s from a where s like '[x]*+?' or s like '(%)'"),
    ("like_percent_in_text", "select k, s from a where s like 'promo%'"),
    ("like_newline", "select k, s from a where s like 'line_break' or s like '%\n%'"),
    ("like_unicode", "select k, s from a where s like '_nïcode' or s like 'Ω%'"),
    ("not_like", "select k, s from a where s not like '%o%'"),
    ("like_projected", "select k, s like '%a%' as has_a from a"),
    ("is_null", "select k, x from a where x is null"),
    ("is_not_null", "select k, s from a where s is not null and k is null"),
    ("is_null_projected", "select k is null as kn, s is not null as sn from a"),
    ("case_strings_and_null",
     "select k, case when x > 0 then 'pos' when x < 0 then 'neg' else null end as sign from a"),
    ("case_column_branches",
     "select k, case when g = 1 then s when g = 2 then 'zz' end as pick from a"),
    ("case_widening", "select k, case when g = 1 then q else x end as w from a"),
    ("case_simple_form", "select k, case g when 1 then 'one' when 2 then 'two' else 'many' end "
                         "as name from a"),
    ("case_in_sum", "select g, sum(case when s like 'PROMO%' then x * (1 - 0.5) else 0 end) "
                    "as promo, sum(case when q > 25 then 1 else 0 end) as big from a "
                    "group by g order by g"),
    ("extract_parts", "select d, extract(year from d) as y, extract(month from d) as m, "
                      "extract(day from d) as dd, extract(quarter from d) as qq from a"),
    ("extract_filter", "select k, d from a where extract(year from d) < 1970"),
    ("substring_forms", "select s, substring(s from 2 for 3) as s1, substr(s, -3, 2) as s2, "
                        "substring(s, 1, 4) as s3 from a"),
    ("upper_lower_trim", "select s, upper(s) as u, lower(s) as l, trim(s) as t from a"),
    ("concat", "select concat('p_', s) as pre, concat(s, '_z') as post from a"),
    ("sqrt", "select k, sqrt(x) as rx, sqrt(q) as rq from a"),
    ("left_join_null_keys", "select k, g, bk, bv from a left join b on k = bk"),
    ("right_join", "select k, g, bk, bv from a right join b on k = bk"),
    ("full_join", "select k, g, bk, bv, bs from a full join b on k = bk"),
    ("left_join_string_keys", "select k, s, bk, bs from a left outer join b on s = bs"),
    ("inner_join_string_keys", "select k, s, bv from a join b on s = bs"),
    ("semi_in", "select k, g from a where k in (select bk from b)"),
    ("anti_not_in", "select k, g from a where k not in (select bk from b)"),
    ("semi_string_in", "select k, s from a where s in (select bs from b where bv > 0)"),
    ("anti_string_not_in", "select k, s from a where s not in (select bs from b)"),
    ("exists", "select k, g from a where exists (select * from b where bk = k and bv > 1)"),
    ("not_exists", "select k, g from a where not exists (select * from b where bk = k)"),
    ("cross_join_aggregates",
     "select na, sb from (select count(*) as na from a) t1, (select sum(bv) as sb from b) t2"),
    ("count_distinct", "select g, count(distinct x) as cx, count(distinct s) as cs, "
                       "count(distinct k) as ck, count(*) as n from a group by g order by g"),
    ("count_distinct_global", "select count(distinct x) as cx, count(distinct s) as cs from a"),
    ("window_ranks", "select k, g, q, rank() over (partition by g order by q) as r, "
                     "dense_rank() over (partition by g order by q desc) as dr, "
                     "row_number() over (partition by g order by q, k) as rn from a"),
    ("window_running_sum", "select k, g, q, sum(x) over (partition by g order by q) as rs, "
                           "avg(x) over (partition by g order by q) as ra from a"),
    ("window_rows_frame", "select k, g, q, sum(x) over (partition by g order by q, k rows "
                          "between unbounded preceding and current row) as rs from a"),
    ("window_partition", "select k, g, sum(x) over (partition by g) as ts, "
                         "min(x) over (partition by g) as mn, max(q) over (partition by g) "
                         "as mx, count(x) over (partition by g) as c from a"),
    ("window_unpartitioned", "select k, q, sum(q) over (order by q) as rq from a"),
    ("union_all", "select k as v from a union all select bk as v from b"),
    ("union_distinct", "select g as v from a union select bg as v from b"),
    ("intersect", "select g, q from a where q < 20 intersect select g, q from a where q > 10"),
    ("except", "select s from a except select bs as s from b"),
    ("rollup", "select g, s, sum(q) as sq, count(*) as n from a group by rollup (g, s) "
               "order by g, s"),
    ("with_cte", "with t as (select g, sum(x) as sx, count(*) as n from a group by g) "
                 "select g, sx, n from t where n > 10 order by g"),
    ("with_join_window", "with t as (select g, sum(q) as sq from a group by g) "
                         "select a.k, a.g, t.sq, rank() over (partition by a.g order by a.q) "
                         "as r from a, t where a.g = t.g"),
    ("global_aggregates", "select sum(x) as sx, avg(x) as ax, min(s) as ms, max(d) as md, "
                          "count(x) as cx, count(*) as n from a"),
    ("q17_shape", "select sum(x) / 7.0 as v from a where q < (select 0.5 * avg(q) from a a2 "
                  "where a2.g = a.g)"),
]


@pytest.mark.parametrize("indexed", [False, True], ids=["scanned", "indexed"])
@pytest.mark.parametrize("text", [t for _, t in STATEMENTS], ids=[i for i, _ in STATEMENTS])
def test_sql_statement_equals_jax(lake, text, indexed):
    got, tree = run_sql(lake, "torch", text, indexed)
    want, jtree = run_sql(lake, "jax", text, indexed)
    assert_same(got, want)
    staged, _ = run_sql(lake, "staged", text, indexed)
    assert_same(got, staged)
    assert tree == jtree


def test_statements_select_rows(lake):
    """No statement is vacuous: each selects rows, and the predicates keep
    some but not all of them."""
    for ident, text in STATEMENTS:
        got, _ = run_sql(lake, "torch", text, False)
        assert got.num_rows > 0, ident
    for ident in ("like_prefix", "like_underscore", "like_dot_literal", "like_metachars",
                  "like_percent_in_text", "like_newline", "like_unicode", "is_null",
                  "semi_in", "anti_not_in", "semi_string_in", "anti_string_not_in",
                  "exists", "not_exists", "extract_filter"):
        text = dict(STATEMENTS)[ident]
        assert 0 < run_sql(lake, "torch", text, False)[0].num_rows < N_A, ident


@pytest.mark.parametrize("text", [
    "select k, lag(q) over (partition by g order by q) as p from a",
    "select k, lead(q) over (partition by g order by q) as p from a",
    "select k from a where s like x",
    "select k, case when g = 1 then 'one' else 2 end as w from a",
], ids=["lag", "lead", "like_column_pattern", "case_string_and_int"])
def test_refused_like_jax(lake, text):
    """Constructs outside the JAX package's grammar are refused by both."""
    with pytest.raises(hst.HyperspaceException) as jerr:
        lake["jax"].sql(text).to_arrow()
    with pytest.raises(ht.HyperspaceException) as terr:
        lake["torch"].sql(text).to_arrow()
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# The DataFrame API under the SQL front end.
# ---------------------------------------------------------------------------

def frames(lake, key):
    s = lake[key]
    return s.table("a"), s.table("b"), (JE if key == "jax" else TE)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
@pytest.mark.parametrize("keys", ["int", "string", "two"])
def test_join_types_equal_jax(lake, how, keys):
    out = {}
    for key in ("torch", "jax"):
        a, b, E = frames(lake, key)
        if keys == "int":
            cond = E.col("k") == E.col("bk")
        elif keys == "string":
            cond = E.col("s") == E.col("bs")
        else:
            cond = (E.col("k") == E.col("bk")) & (E.col("g") == E.col("bg"))
        df = a.join(b, on=cond, how=how)
        out[key] = (df.to_arrow(), df.plan.tree_string(), df.columns)
    assert_same(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]


def test_join_schema_nullability(lake):
    for how, left_nullable, right_nullable in (("left", False, True), ("right", True, False),
                                               ("full", True, True)):
        a, b, E = frames(lake, "torch")
        ja, jb, JEm = frames(lake, "jax")
        got = a.join(b, on=E.col("k") == E.col("bk"), how=how).schema
        want = ja.join(jb, on=JEm.col("k") == JEm.col("bk"), how=how).schema
        assert [(f.name, f.dtype, f.nullable) for f in got.fields] == \
            [(f.name, f.dtype, f.nullable) for f in want.fields]
        assert got.field("g").nullable == left_nullable or not left_nullable
        assert got.field("bv").nullable == right_nullable or not right_nullable
    semi = a.join(b, on=E.col("k") == E.col("bk"), how="semi")
    assert semi.columns == a.columns


def test_cross_join_count_and_guard(lake):
    a, b, E = frames(lake, "torch")
    ja, jb, JEm = frames(lake, "jax")
    small = b.filter(E.col("bv") > 4)
    jsmall = jb.filter(JEm.col("bv") > 4)
    got = a.select("k", "g").cross_join(small)
    want = ja.select("k", "g").cross_join(jsmall)
    assert_same(got.to_arrow(), want.to_arrow())
    assert got.plan.tree_string().splitlines()[0] == "Join cross"
    assert got.count() == want.count()
    assert got.agg(E.count()).to_arrow().equals(want.agg(JEm.count()).to_arrow())


def test_dataframe_api_equals_jax(lake):
    out = {}
    for key in ("torch", "jax"):
        a, b, E = frames(lake, key)
        w = E.window("sum", "x", partition_by=["g"], order_by=[("q", False)])
        r = E.window("row_number", None, partition_by=["g"], order_by=["q", "k"])
        df = (a.with_column("x2", E.col("x") * 2)
              .with_window("wsum", w).with_window("rn", r)
              .drop("d"))
        u = a.select("g").union(b.select(E.col("bg").alias("g"))).distinct()
        out[key] = (df.to_arrow(), df.columns, u.to_arrow(), u.count(),
                    a.group_by("g").count().to_arrow(), a.select("k", "s").collect()[:20],
                    a.select("k", "g").to_pandas().shape)
    t, j = out["torch"], out["jax"]
    assert_same(t[0], j[0])
    assert t[1] == j[1]
    assert_same(t[2], j[2])
    assert t[3] == j[3]
    assert_same(t[4], j[4])
    assert t[5] == j[5]
    assert t[6] == j[6]


def test_union_refuses_mismatched_schemas(lake):
    a, b, _ = frames(lake, "torch")
    with pytest.raises(ht.HyperspaceException, match="column mismatch"):
        a.select("k").union(b.select("bk"))
    with pytest.raises(ht.HyperspaceException, match="dtype mismatch"):
        a.select("q").union(a.select(TE.col("k").alias("q")))


def test_temp_views(lake):
    s = lake["torch"]
    with pytest.raises(ht.HyperspaceException, match="already exists"):
        s.create_temp_view("A", s.table("a"))
    s.create_temp_view("tmp_view", s.table("b"))
    assert s.table("TMP_VIEW").columns == ["bk", "bs", "bv", "bg"]
    assert s.drop_temp_view("tmp_view") and not s.drop_temp_view("tmp_view")
    with pytest.raises(ht.HyperspaceException, match="No such temp view"):
        s.table("tmp_view")
    assert s.create_dataframe(s.table("a").plan).columns == s.table("a").columns


# ---------------------------------------------------------------------------
# Pushdown under outer, semi and anti joins.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["left", "right", "full", "semi", "anti"])
def test_filter_stays_above_non_inner_joins(lake, how):
    """A conjunct on the null-producing side pushed below an outer join
    would drop the rows the join pads instead of the padded rows: the
    filter must stay above every join that is not inner, as in the JAX
    package, and the answer must equal a host reference."""
    out = {}
    for key in ("torch", "jax"):
        a, b, E = frames(lake, key)
        j = a.join(b, on=E.col("k") == E.col("bk"), how=how)
        col = "g" if how in ("semi", "anti") else "bv"
        df = j.filter((E.col(col) > 1) | E.col(col).is_null())
        out[key] = (df.to_arrow(), df.optimized_plan().tree_string())
    assert_same(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    plan_lines = out["torch"][1].splitlines()
    assert plan_lines[0].startswith("Filter")
    assert plan_lines[1].strip().startswith("+- Join " + how)
    if how == "left":
        a_rows = pq.read_table(lake["dirs"]["a"]).to_pylist()
        b_rows = pq.read_table(lake["dirs"]["b"]).to_pylist()
        expected = 0
        for r in a_rows:
            matches = [m for m in b_rows if r["k"] is not None and m["bk"] == r["k"]]
            if not matches:
                expected += 1  # padded: bv is null
            expected += sum(1 for m in matches if m["bv"] > 1)
        assert out["torch"][0].num_rows == expected


def test_filter_still_splits_below_inner_join(lake):
    a, b, E = frames(lake, "torch")
    df = a.join(b, on=E.col("k") == E.col("bk")).filter((E.col("bv") > 1) & (E.col("g") < 3))
    tree = df.optimized_plan().tree_string()
    assert tree.splitlines()[0].startswith("Join inner")
    assert "Filter (" in tree


# ---------------------------------------------------------------------------
# Ops beneath the operators, on the same inputs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 1001])
@pytest.mark.parametrize("op", ["add", "minimum", "maximum"])
def test_segmented_scan_equals_jax(n, op):
    """A running float64 sum rounds as jax.lax.associative_scan's tree
    order does, bit for bit; a left-to-right sum would not."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) * 10.0 ** rng.integers(-6, 9, n)
    starts = rng.random(n) < 0.03
    starts[0] = True
    scan = jax.jit(lambda v, st: jex._segmented_scan(v, st, getattr(jnp, op)))
    want = np.asarray(scan(jnp.asarray(x), jnp.asarray(starts)))
    got = tk.segmented_scan(torch.from_numpy(x), torch.from_numpy(starts),
                            getattr(torch, op)).numpy()
    assert got.view(np.int64).tolist() == want.view(np.int64).tolist()


def test_segmented_scan_differs_from_cumsum():
    """Why the scan's order matters: over these values a left-to-right
    running sum differs from the tree order in the last bits."""
    x = np.random.default_rng(3).normal(size=4096) * 1e6
    starts = np.zeros(4096, dtype=bool)
    starts[0] = True
    tree = tk.segmented_scan(torch.from_numpy(x), torch.from_numpy(starts), torch.add)
    assert not torch.equal(tree, torch.cumsum(torch.from_numpy(x), 0))


def test_sqrt_is_correctly_rounded():
    """ROADMAP queue C item 11: torch's CPU sqrt gives sqrt(2.0) one ulp low on
    some builds; the port's SQRT equals jnp.sqrt and numpy bit for bit."""
    from hyperspace_tpu_torch.execution.columnar import Column, Table
    x = np.array([2.0, 8.0, 19.0, 0.5, 1e300, 2.2250738585072014e-308, 0.0, 1.0, 7.0])
    table = Table({"x": Column("float64", torch.from_numpy(x.copy()))})
    got = tev.eval_expr(table, TE.sqrt(TE.col("x"))).data.numpy()
    want = np.asarray(jnp.sqrt(jnp.asarray(x)))
    assert got.view(np.int64).tolist() == want.view(np.int64).tolist()
    assert got.view(np.int64).tolist() == np.sqrt(x).view(np.int64).tolist()


def test_subnormal_sqrt_differs_from_xla_cpu():
    """ROADMAP queue C item 12: XLA on the CPU flushes a subnormal input to zero;
    the port (numpy on the CPU, CUDA on the card) does not."""
    from hyperspace_tpu_torch.execution.columnar import Column, Table
    x = np.array([3.0e-310])
    table = Table({"x": Column("float64", torch.from_numpy(x.copy()))})
    got = float(tev.eval_expr(table, TE.sqrt(TE.col("x"))).data[0])
    assert float(jnp.sqrt(jnp.asarray(x))[0]) == 0.0
    assert got == float(np.sqrt(x[0])) > 0.0


@pytest.mark.parametrize("sizes", [[1], [3, 1, 4], [1, 1, 1, 1], [10, 5, 20]])
def test_segment_first_index_equals_jax(sizes):
    gids = np.repeat(np.arange(len(sizes)), sizes)
    want = np.asarray(jk.segment_first_index(jnp.asarray(gids.astype(np.int32)), len(sizes)))
    got = tk.segment_first_index(torch.from_numpy(gids), len(sizes)).numpy()
    assert got.tolist() == want.tolist()
    iota = np.arange(len(gids), dtype=np.int32)
    want_last = np.asarray(jk.segment_max(jnp.asarray(iota), jnp.asarray(gids.astype(np.int32)),
                                          len(sizes)))
    assert tk.segment_last_index(torch.from_numpy(gids), len(sizes)).tolist() == \
        want_last.tolist()


@pytest.mark.parametrize("pattern", ["PROMO%", "a_b", "%.%", "[x]*+?", "%\n%", "%%", "_",
                                     "100%", "a\\b", "(a|b)", "^$"])
def test_like_regex_equals_jax(pattern):
    assert tev.like_pattern_to_regex(pattern) == jev.like_pattern_to_regex(pattern)


@pytest.mark.parametrize("day", [-719162, -146097, -36524, -1, 0, 59, 60, 365, 789, 11016,
                                 2932896])
def test_extract_matches_the_calendar(lake, day):
    """The civil-from-days arithmetic floors on negative days (before
    1970): every part equals Python's calendar."""
    from hyperspace_tpu_torch.execution.columnar import Column, Table
    date = datetime.date(1970, 1, 1) + datetime.timedelta(days=day)
    table = Table({"d": Column("date", torch.tensor([day], dtype=torch.int32))})
    got = {part: int(tev.eval_expr(table, TE.DatePart(part, TE.col("d"))).data[0])
           for part in ("year", "month", "day", "quarter")}
    assert got == {"year": date.year, "month": date.month, "day": date.day,
                   "quarter": (date.month - 1) // 3 + 1}


def test_string_dictionaries_sort_like_numpy(lake):
    """CASE, UNION and the set operations meet columns with different
    dictionaries and unify them with np.unique; the port's dictionaries
    come from pyarrow's sort, which must give numpy's order for non-ASCII
    strings too."""
    table = lake["torch"].table("a").select("s").execute()
    dictionary = table.column("s").dictionary
    assert dictionary.tolist() == np.unique(np.asarray(STRINGS)).tolist()
    assert any(ord(ch) > 127 for s in dictionary for ch in s)


def test_expr_reprs_equal_jax():
    """Plan tree strings embed the expressions' reprs."""
    def build(E):
        c = E.col
        return [
            c("s").like("a%"), E.Like(c("s"), "x_", negated=True), c("x").is_null(),
            c("x").is_not_null(), E.case_when([(c("g") == 1, "one")], "other"),
            E.CaseWhen([(c("g") > 1, c("x"))]), E.year(c("d")), E.quarter(c("d")),
            E.substring(c("s"), 2, 3), c("s").substr(-1), E.upper(c("s")), E.trim(c("s")),
            E.Concat([E.lit("p"), c("s")]), E.NullLit("int64"), E.sqrt(c("x")),
            E.count_distinct(c("k")),
            E.window("rank", None, partition_by=["g"], order_by=[("q", False)]),
            E.window("sum", "x", partition_by=["g"], order_by=["q"], frame="rows"),
        ]
    got, want = build(TE), build(JE)
    assert [repr(e) for e in got] == [repr(e) for e in want]
    assert [e.name for e in got] == [e.name for e in want]


# ---------------------------------------------------------------------------
# explain and why_not over the new nodes.
# ---------------------------------------------------------------------------

INTROSPECTED = {
    "left_join": "select k, g, bk, bv from a left join b on k = bk where g > 1",
    "semi_join": "select k, g from a where k in (select bk from b) and g > 1",
    "window_union": "select k, rank() over (partition by g order by q) as r from a where k > 3 "
                    "union all select bk as k, bg as r from b",
}


@pytest.mark.parametrize("name", list(INTROSPECTED))
def test_explain_and_why_not_equal_jax(lake, tmp_path, name):
    """The explain text (plans with and without indexes, the indexes used)
    and why_not's reasons for a_k over outer and semi joins, a window and
    a union, as in the JAX package: the join rule gives no reason for a
    join that is not inner."""
    def normalize(text):
        for key in ("jax", "torch"):
            text = text.replace(str(lake["dirs"]["a"]).rsplit("/", 1)[0] + "/" + key, "<sys>")
        text = re.sub(r"(?:/[\w.\-]+)*/torch_sql\d*/", "<root>/", text)
        return re.sub(r"LogVersion: \d+", "LogVersion: <v>", text)

    texts = {}
    for key, pkg in (("jax", hst), ("torch", ht)):
        session = lake[key]
        df = session.sql(INTROSPECTED[name])
        for io_mod, bp in ((jio, jbuffer_pool), (tio, tbuffer_pool)):
            io_mod.reset_stats()
            bp.get_pool().clear()
        fresh_telemetry_state(session)
        session.enable_hyperspace()
        try:
            if key == "jax":
                explained = explain_string(session, df.plan, verbose=True, diagnostics=False)
            else:
                explained = pkg.Hyperspace(session).explain(df, verbose=True)
            reasons = pkg.Hyperspace(session).why_not(df, index_name="a_k")
        finally:
            session.disable_hyperspace()
        texts[key] = (normalize(explained), reasons)
    assert texts["torch"] == texts["jax"]
    assert "Join " in texts["torch"][0] or "Window [" in texts["torch"][0]
