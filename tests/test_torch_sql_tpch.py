"""The nine TPC-H texts of ``tests/test_tpch_sql.py`` and the statements
of the JAX package's SQL tests through both packages' ``session.sql`` on
the same files, indexes off and on; the copy of the TPC-H texts in
``chip_smoke.py`` and its SF10 generator.

Keys, counts and strings compare exactly and float64 values bit for bit,
against the JAX package's default (fused) path and its staged path
(``hyperspace.tpu.execution.fusion.enabled=false``); plan tree strings
compare equal. The JAX side runs on the CPU with its distributed tier
off; the port runs its plain torch paths on CPU tensors.
"""

import ast
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import chip_smoke
import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
import test_tpch_sql as tpch_sql
from hyperspace_tpu_torch.index.constants import IndexConstants
from test_torch_sql import assert_same

HERE = os.path.dirname(os.path.abspath(__file__))

CONF = {"hyperspace.tpu.distributed.enabled": "false"}
STAGED = {**CONF, "hyperspace.tpu.execution.fusion.enabled": "false"}

# tests/test_tpch_sql.py's indexes.
TPCH_INDEXES = [
    ("lineitem", "sql_li_ok", ["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"]),
    ("lineitem", "sql_li_ship", ["l_shipdate"], ["l_extendedprice", "l_discount", "l_quantity"]),
    ("lineitem", "sql_li_pk", ["l_partkey"], ["l_quantity", "l_extendedprice", "l_discount",
                                               "l_shipdate", "l_shipmode", "l_shipinstruct"]),
    ("orders", "sql_od_ok", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_shippriority"]),
    ("part", "sql_pt_pk", ["p_partkey"], ["p_brand", "p_container", "p_type", "p_size"]),
]


def sessions(root: str, tables: dict, indexes, num_buckets=None) -> dict:
    """The port's session and the JAX package's default and staged
    sessions over one copy of ``tables``, each with ``indexes`` built."""
    dirs = {}
    for name, table in tables.items():
        d = os.path.join(root, "data", name)
        os.makedirs(d)
        pq.write_table(table, os.path.join(d, "part0.parquet"))
        dirs[name] = d
    out = {}
    for key, pkg, conf, extra in (("torch", ht, CONF, {"device": "cpu"}), ("jax", hst, CONF, {}),
                                  ("staged", hst, STAGED, {})):
        conf = dict(conf)
        if num_buckets is not None:
            conf[IndexConstants.INDEX_NUM_BUCKETS] = str(num_buckets)
        session = pkg.Session(conf=conf, system_path=os.path.join(root, key), **extra)
        for name, d in dirs.items():
            session.create_temp_view(name, session.read.parquet(d))
        hs = pkg.Hyperspace(session)
        for table, name, indexed, included in indexes:
            hs.create_index(session.table(table), pkg.IndexConfig(name, indexed, included))
        out[key] = session
    return out


def run(session, text: str, indexed: bool):
    (session.enable_hyperspace if indexed else session.disable_hyperspace)()
    try:
        df = session.sql(text)
        return df.to_arrow(), df.optimized_plan()
    finally:
        session.disable_hyperspace()


def index_leaves(plan) -> list:
    return [leaf.index_entry.name if hasattr(leaf, "index_entry") else None
            for leaf in plan.collect_leaves()]


# ---------------------------------------------------------------------------
# The nine TPC-H texts.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_sql_tpch"))
    tables = tpch_sql._make_tables(np.random.default_rng(20260731))
    return sessions(root, tables, TPCH_INDEXES)


CASES = [(name, text) for name, text, _, _ in tpch_sql._CASES]


@pytest.mark.parametrize("indexed", [False, True], ids=["scanned", "indexed"])
@pytest.mark.parametrize("name,text", CASES, ids=[c[0] for c in CASES])
def test_tpch_text_equals_jax(tpch, name, text, indexed):
    got, plan = run(tpch["torch"], text, indexed)
    want, jplan = run(tpch["jax"], text, indexed)
    assert_same(got, want)
    staged, _ = run(tpch["staged"], text, indexed)
    assert_same(got, staged)
    assert plan.tree_string() == jplan.tree_string()
    assert index_leaves(plan) == index_leaves(jplan)
    assert got.num_rows > 0


def test_tpch_rewrites_fire(tpch):
    """The rewrites the JAX package's suite asserts: Q6 reads the
    l_shipdate index, and the lineitem-part joins of Q14, Q17 and Q19
    read both sides' indexes."""
    rewritten = {}
    for name, text in CASES:
        _, plan = run(tpch["torch"], text, True)
        rewritten[name] = [n for n in index_leaves(plan) if n]
    assert rewritten["q6"] == ["sql_li_ship"]
    for name in ("q14", "q17", "q19"):
        assert {"sql_li_pk", "sql_pt_pk"} <= set(rewritten[name]), name
    assert sum(1 for v in rewritten.values() if v) >= 4


@pytest.mark.parametrize("name", ["q4", "q16", "q17"])
def test_subquery_plans_equal_jax(tpch, name):
    """The lowered plans (before optimization): Q4's EXISTS is a semi join,
    Q16's NOT IN an anti join, Q17's scalar subquery a decorrelated
    group-by joined back."""
    text = dict(CASES)[name]
    tree = tpch["torch"].sql(text).plan.tree_string()
    assert tree == tpch["jax"].sql(text).plan.tree_string()
    marker = {"q4": "Join semi", "q16": "Join anti",
              "q17": "Aggregate [l_partkey] [__sq0_agg]"}[name]
    assert marker in tree


def test_q17_plans_like_its_dataframe(tpch):
    """The SQL text plans like its hand-written DataFrame form."""
    from hyperspace_tpu_torch.plan.expr import Lit, Multiply, avg, col, sum_
    s = tpch["torch"]
    li, pt = s.table("lineitem"), s.table("part")
    thr = (li.group_by("l_partkey").agg(avg(col("l_quantity")).alias("__sq0_agg"))
           .select(col("l_partkey").alias("__sq0_k0"),
                   Multiply(Lit(0.2), col("__sq0_agg")).alias("__sq0_val")))
    df = (li.join(pt.filter((col("p_brand") == "Brand#23") & (col("p_container") == "MED BOX")),
                  on=col("p_partkey") == col("l_partkey"))
          .join(thr, on=col("p_partkey") == col("__sq0_k0"))
          .filter(col("l_quantity") < col("__sq0_val"))
          .agg(sum_(col("l_extendedprice")).alias("__item_0_0"))
          .select((col("__item_0_0") / 7.0).alias("avg_yearly")))
    assert s.sql(dict(CASES)["q17"]).plan.tree_string() == df.plan.tree_string()


def test_tpch_texts_match_the_pandas_oracles(tpch):
    """The JAX package's own oracles (tests/test_tpch_sql.py) hold the port
    too, at their tolerance."""
    frames = {name: t.to_pandas() for name, t in
              tpch_sql._make_tables(np.random.default_rng(20260731)).items()}
    for name, text, oracle, ordered in tpch_sql._CASES:
        got = tpch["torch"].sql(text).to_pandas()
        expected = oracle(frames)
        norm = (lambda df: df.reset_index(drop=True)) if ordered else tpch_sql._norm
        g, e = norm(got.copy()), norm(expected.copy())
        for c in g.columns:
            if g[c].dtype == np.float64:
                g[c], e[c] = g[c].round(4), e[c].round(4)
            if g[c].dtype == object or str(g[c].dtype).startswith("datetime"):
                g[c], e[c] = g[c].astype(str), e[c].astype(str)
        pd.testing.assert_frame_equal(g, e, check_dtype=False)


# ---------------------------------------------------------------------------
# The statements of the JAX package's SQL tests.
# ---------------------------------------------------------------------------

def _sql_literals(path: str) -> list:
    """(test name, text) for every ``.sql("...")`` call with a literal
    text in a test file."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or not fn.name.startswith("test_"):
            continue
        for i, node in enumerate(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                                 and isinstance(n.func, ast.Attribute)
                                 and n.func.attr == "sql" and n.args
                                 and isinstance(n.args[0], ast.Constant)
                                 and isinstance(n.args[0].value, str)):
            out.append((f"{fn.name}-{i}", node.args[0].value))
    return out


def _sql_tables() -> dict:
    """The fixture tables of test_sql.py (li, od), test_sql_cte_window.py
    (t) and test_sql_rollup_setops.py (t), drawn as they draw them."""
    rng = np.random.default_rng(77)
    n = 1500
    li = pa.Table.from_pandas(pd.DataFrame({
        "okey": rng.integers(0, 100, n).astype(np.int64),
        "qty": rng.integers(1, 50, n).astype(np.int64),
        "price": np.round(rng.uniform(1, 1000, n), 2),
        "flag": rng.choice(["A", "N", "R"], n),
        "ship": pd.to_datetime(rng.integers(9000, 9400, n), unit="D").date,
    }))
    od = pa.table({"okey2": pa.array(np.arange(100, dtype=np.int64)),
                   "prio": pa.array(rng.choice(["HI", "LO"], 100))})
    rng = np.random.default_rng(5)
    n = 350
    cte = pa.table({"g": pa.array(rng.integers(0, 5, n).astype(np.int64)),
                    "o": pa.array(rng.integers(0, 30, n).astype(np.int64)),
                    "v": pa.array(np.round(rng.uniform(0, 100, n), 2))})
    rng = np.random.default_rng(9)
    n = 500
    rollup = pa.table({"a": pa.array(rng.integers(0, 4, n).astype(np.int64)),
                       "b": pa.array(rng.choice(["x", "y", "z"], n)),
                       "v": pa.array(np.round(rng.uniform(0, 10, n), 2))})
    return {
        "test_sql.py": ({"li": li, "od": od},
                        [("li", "sql_li", ["okey"], ["qty", "price", "flag", "ship"]),
                         ("od", "sql_od", ["okey2"], ["prio"])]),
        "test_sql_cte_window.py": ({"t": cte}, [("t", "cte_t", ["g"], ["o", "v"])]),
        "test_sql_rollup_setops.py": ({"t": rollup}, [("t", "rollup_t", ["a"], ["b", "v"])]),
    }


SQL_FILES = _sql_tables()
SQL_STATEMENTS = [(f, ident, text) for f in SQL_FILES
                  for ident, text in _sql_literals(os.path.join(HERE, f))]


@pytest.fixture(scope="module")
def sql_lakes(tmp_path_factory):
    out = {}
    for f, (tables, indexes) in SQL_FILES.items():
        root = str(tmp_path_factory.mktemp(f.replace(".py", "")))
        out[f] = sessions(root, tables, indexes, num_buckets=4)
    return out


def test_sql_statements_were_found():
    assert len(SQL_STATEMENTS) >= 70


@pytest.mark.parametrize("indexed", [False, True], ids=["scanned", "indexed"])
@pytest.mark.parametrize("f,ident,text", SQL_STATEMENTS,
                         ids=[f"{f[:-3]}-{i}" for f, i, _ in SQL_STATEMENTS])
def test_sql_suite_statement_equals_jax(sql_lakes, f, ident, text, indexed):
    """A statement the JAX package answers gets the same answer and plan
    from the port; one it refuses, the port refuses with its message."""
    lake = sql_lakes[f]
    try:
        want, jplan = run(lake["jax"], text, indexed)
    except hst.HyperspaceException as e:
        with pytest.raises(ht.HyperspaceException) as err:
            run(lake["torch"], text, indexed)
        assert str(err.value) == str(e)
        return
    got, plan = run(lake["torch"], text, indexed)
    assert_same(got, want)
    assert_same(got, run(lake["staged"], text, indexed)[0])
    assert plan.tree_string() == jplan.tree_string()


# ---------------------------------------------------------------------------
# chip_smoke.py's sql path: its copy of the texts and its generator.
# ---------------------------------------------------------------------------

def test_chip_smoke_texts_equal_the_tests():
    assert chip_smoke.TPCH_TEXTS == {name: text for name, text in CASES}


@pytest.fixture(scope="module")
def smoke_lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("smoke_tpch"))
    return chip_smoke.make_tpch_sql(root, 0.001)


def test_chip_smoke_generator_shapes(smoke_lake):
    dirs, rows = smoke_lake
    expected = {"lineitem": 6_000, "orders": 1_500, "customer": 150, "part": 200,
                "partsupp": 800, "supplier": 10}
    assert rows == expected
    # At SF10: 60M lineitem, 15M orders, 1.5M customer, 2M part, 8M partsupp
    # and 100k supplier rows.
    assert {t: n * 10 for t, n in chip_smoke.TPCH_SQL_ROWS.items()} == \
        {t: n * 10_000 for t, n in expected.items()}
    for name, n in expected.items():
        files = sorted(os.listdir(dirs[name]))
        assert len(files) == chip_smoke.TPCH_SQL_FILES[name]
        assert pq.read_table(dirs[name]).num_rows == n
    part = pq.read_table(dirs["part"])
    assert part.schema.field("p_size").type == pa.int32()
    sizes = part.column("p_size").to_numpy()
    assert sizes.min() >= 1 and sizes.max() <= 50


def test_chip_smoke_generator_covers_the_filters(smoke_lake):
    """Every value the nine texts filter on occurs, so no query is empty."""
    dirs, _ = smoke_lake
    t = {name: pq.read_table(d) for name, d in dirs.items()}

    def values(table, column):
        return set(pc.unique(t[table].column(column).combine_chunks()).to_pylist())

    assert values("lineitem", "l_returnflag") == {"R", "A", "N"}
    assert values("lineitem", "l_linestatus") == {"O", "F"}
    # Q19's 'AIR REG' is no TPC-H ship mode ('REG AIR' is).
    assert values("lineitem", "l_shipmode") == set(chip_smoke.SHIP_MODES)
    assert {"MAIL", "SHIP", "AIR"} <= set(chip_smoke.SHIP_MODES)
    assert "DELIVER IN PERSON" in values("lineitem", "l_shipinstruct")
    assert "BUILDING" in values("customer", "c_mktsegment")
    assert {"1-URGENT", "2-HIGH"} <= values("orders", "o_orderpriority")
    assert {"Brand#12", "Brand#23", "Brand#45"} <= values("part", "p_brand")
    containers = values("part", "p_container")
    assert {"SM CASE", "SM BOX", "MED BOX", "MED PKG", "LG BOX", "LG PKG"} <= containers
    assert len(containers) == 40
    types = values("part", "p_type")
    assert len(types) == 150
    assert any(x.startswith("PROMO") for x in types)
    assert any(x.startswith("MEDIUM POLISHED") for x in types)
    comments = t["supplier"].column("s_comment").to_pylist()
    assert any("Customer" in c and "Complaints" in c for c in comments)
    assert not all("Customer" in c and "Complaints" in c for c in comments)


def test_chip_smoke_sql_queries_answer_on_the_cpu(smoke_lake, tmp_path):
    """The smoke run's queries through the port on the CPU at this scale:
    every one selects rows and equals the script's own pyarrow reference."""
    dirs, _ = smoke_lake
    session = ht.Session(system_path=str(tmp_path / "idx"), device="cpu")
    for name, d in dirs.items():
        session.create_temp_view(name, session.read.parquet(d))
    refs = chip_smoke.tpch_sql_references(dirs)
    for name, text in chip_smoke.SQL_PATH_QUERIES.items():
        got = session.sql(text).to_arrow()
        assert got.num_rows > 0, name
        chip_smoke.check_sql_answer(name, got, refs[name], "cpu")
