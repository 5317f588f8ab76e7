"""The cost-based optimizer (statistics, cardinality estimates and join
reordering) through both packages on the same numpy-seeded files.

Tolerances, all exact: the statistics' fields and NDVs; every
selectivity and join estimate as the same Python float (they decide the
order); reordered tree strings, ``est~N`` notes included; the chain
records, the join actuals and explain's "Join order:" section. Where
reordering changed a tree, the answers reorder-on and reorder-off are
compared after sorting rows (a reorder legitimately permutes them):
keys and strings exact, float64 within 1e-9 relative, since a sum over
reordered rows adds in another order. The JAX package runs on the CPU
with its distributed tier and fusion off.
"""

import datetime
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
import test_tpch_sql as tpch_mod
from goldstandard import tpcds_real
from hyperspace_tpu.optimizer import cardinality as jcard
from hyperspace_tpu.optimizer.stats import provider_for as jprovider_for
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plananalysis.explain import explain_string as jexplain
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu.optimizer import join_order as jjoin_order
from hyperspace_tpu_torch.optimizer import cardinality as tcard
from hyperspace_tpu_torch.optimizer import join_order as tjoin_order
from hyperspace_tpu_torch.optimizer.constants import OptimizerConstants
from hyperspace_tpu_torch.optimizer.stats import provider_for as tprovider_for
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.plananalysis.explain import explain_string as texplain

CONF = {"hyperspace.tpu.distributed.enabled": "false",
        "hyperspace.tpu.execution.fusion.enabled": "false",
        IndexConstants.INDEX_NUM_BUCKETS: "4"}
REORDER = OptimizerConstants.JOIN_REORDER_ENABLED
PKGS = ("jax", "torch")


def write(d, table):
    os.makedirs(d, exist_ok=True)
    pq.write_table(table, os.path.join(d, "part0.parquet"))
    return str(d)


def sessions(root, conf=None):
    c = dict(CONF, **(conf or {}))
    return {"jax": hst.Session(conf=dict(c), system_path=str(root / "sys_jax")),
            "torch": ht.Session(conf=dict(c), system_path=str(root / "sys_torch"),
                                device="cpu")}


def E(pkg):
    return JE if pkg == "jax" else TE


@pytest.fixture()
def star(tmp_path):
    """fact(4000) x dim1(50) x dim2(20), a category on each dimension (the
    JAX package's tests/test_join_reorder.py star)."""
    rng = np.random.default_rng(7)
    n_f, n_d1, n_d2 = 4000, 50, 20
    base = datetime.date(1995, 1, 1).toordinal() - datetime.date(1970, 1, 1).toordinal()
    fact = pa.table({
        "f_d1": pa.array(rng.integers(0, n_d1, n_f).astype(np.int64)),
        "f_d2": pa.array(rng.integers(0, n_d2, n_f).astype(np.int64)),
        "f_date": pa.array((rng.integers(0, 1000, n_f) + base).astype(np.int32),
                           type=pa.int32()).cast(pa.date32()),
        "f_val": pa.array(rng.uniform(0, 100, n_f).round(3)),
    })
    dim1 = pa.table({"d1_key": pa.array(np.arange(n_d1, dtype=np.int64)),
                     "d1_cat": pa.array(rng.choice(["a", "b", "c", "d", "e"], n_d1))})
    dim2 = pa.table({"d2_key": pa.array(np.arange(n_d2, dtype=np.int64)),
                     "d2_cat": pa.array(rng.choice(["x", "y"], n_d2))})
    nulls = pa.table({"k": pa.array([1, None, 3, None], type=pa.int64()),
                      "s": pa.array(["a", None, "b", "b"])})
    paths = {"fact": write(tmp_path / "fact", fact), "dim1": write(tmp_path / "dim1", dim1),
             "dim2": write(tmp_path / "dim2", dim2), "nulls": write(tmp_path / "nulls", nulls)}
    return sessions(tmp_path), paths


def three_way(s, pkg, paths):
    col = E(pkg).col
    fact = s.read.parquet(paths["fact"])
    d1 = s.read.parquet(paths["dim1"]).filter(col("d1_cat") == "b")
    d2 = s.read.parquet(paths["dim2"])
    return (fact.join(d2, on=col("f_d2") == col("d2_key"))
            .join(d1, on=col("f_d1") == col("d1_key"))
            .select("d1_cat", "d2_cat", "f_val"))


def stats_of(pkg, s, path):
    provider = (jprovider_for if pkg == "jax" else tprovider_for)(s)
    return provider.table_stats(s.read.parquet(path).plan.relation)


def sorted_frame(table: pa.Table) -> pd.DataFrame:
    df = table.to_pandas()
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def assert_frames_close(a: pd.DataFrame, b: pd.DataFrame) -> None:
    assert list(a.columns) == list(b.columns) and len(a) == len(b)
    for c in a.columns:
        if a[c].dtype.kind == "f":
            np.testing.assert_allclose(a[c].to_numpy(), b[c].to_numpy(), rtol=1e-9, atol=0)
        else:
            assert a[c].tolist() == b[c].tolist(), c


# ---------------------------------------------------------------------------
# Statistics.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ("fact", "dim1", "dim2", "nulls"))
def test_table_stats_equal_jax(star, table):
    ss, paths = star
    ts = {pkg: stats_of(pkg, ss[pkg], paths[table]) for pkg in PKGS}
    j, t = ts["jax"], ts["torch"]
    assert (t.row_count, t.files, t.file_rows, t.sample_rows) == \
        (j.row_count, j.files, j.file_rows, j.sample_rows)
    assert list(t.columns) == list(j.columns)
    for name in j.columns:
        a, b = t.columns[name], j.columns[name]
        assert (a.dtype, a.minimum, a.maximum, a.null_count, a.has_minmax) == \
            (b.dtype, b.minimum, b.maximum, b.null_count, b.has_minmax), name
        assert t.null_fraction(name) == j.null_fraction(name)
        assert t.ndv(name) == j.ndv(name), name


def test_stats_cache_and_invalidation(star):
    ss, paths = star
    s = ss["torch"]
    provider = tprovider_for(s)
    assert tprovider_for(s) is provider
    relation = s.read.parquet(paths["fact"]).plan.relation
    first = provider.table_stats(relation)
    n = provider.harvest_count
    assert provider.table_stats(relation) is first and provider.harvest_count == n
    pq.write_table(pq.read_table(paths["fact"]).slice(0, 1),
                   os.path.join(paths["fact"], "part1.parquet"))
    fresh = provider.table_stats(s.read.parquet(paths["fact"]).plan.relation)
    assert provider.harvest_count == n + 1 and fresh.row_count == 4001


def test_non_parquet_relation_has_no_stats(star, tmp_path):
    ss, _ = star
    d = tmp_path / "csvdata"
    d.mkdir()
    pd.DataFrame({"k": [1, 2, 3]}).to_csv(d / "p0.csv", index=False)
    for pkg in PKGS:
        provider = (jprovider_for if pkg == "jax" else tprovider_for)(ss[pkg])
        assert provider.table_stats(ss[pkg].read.csv(str(d)).plan.relation) is None


# ---------------------------------------------------------------------------
# Cardinality: the same floats.
# ---------------------------------------------------------------------------

PREDICATES = {
    "eq": lambda e: e.col("f_d1") == 7,
    "eq_out_of_range": lambda e: e.col("f_d1") == 1000,
    "lit_first": lambda e: e.lit(7) < e.col("f_d1"),
    "lt": lambda e: e.col("f_d1") < 25,
    "ge": lambda e: e.col("f_d2") >= 3,
    "date_lt": lambda e: e.col("f_date") < datetime.date(1995, 5, 1),
    "date_iso": lambda e: e.col("f_date") >= "1996-02-01",
    "between": lambda e: e.col("f_val").between(10.5, 20.25),
    "in": lambda e: e.col("f_d1").isin([1, 2, 3, 4, 5, 5]),
    "not_null": lambda e: e.col("f_d1").is_not_null(),
    "is_null": lambda e: e.col("f_d1").is_null(),
    "and": lambda e: (e.col("f_d1") == 7) & (e.col("f_d2") == 3),
    "or": lambda e: (e.col("f_d1") == 7) | (e.col("f_d2") == 3),
    "not": lambda e: ~(e.col("f_d1") < 10),
    "not_opaque": lambda e: ~(e.col("f_val") * 2 > e.col("f_d1")),
    "opaque": lambda e: e.col("f_val") * 2 > e.col("f_d1"),
    "float_eq": lambda e: e.col("f_val") == 3.5,
}


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_selectivity_equals_jax(star, name):
    ss, paths = star
    got = {}
    for pkg in PKGS:
        ts = stats_of(pkg, ss[pkg], paths["fact"])
        card = jcard if pkg == "jax" else tcard
        pred = PREDICATES[name](E(pkg))
        got[pkg] = (card.filter_selectivity(ts, pred),
                    card.filter_selectivity(ts, pred, sketch_cap=0.01),
                    card.filter_selectivity(None, pred))
    assert got["torch"] == got["jax"]


def test_join_estimates_equal_jax():
    cases = [(4000.0, 50.0, [(50.0, 50.0)]), (4000.0, 50.0, [(None, None)]),
             (1e6, 3.0, [(7.0, None), (None, 2.0)]), (10.0, 10.0, [])]
    for rows_l, rows_r, pairs in cases:
        assert tcard.equi_join_rows(rows_l, rows_r, pairs) == \
            jcard.equi_join_rows(rows_l, rows_r, pairs)
    assert tcard.join_output_rows(4000, 50, None, 7.0) == \
        jcard.join_output_rows(4000, 50, None, 7.0)


def test_sketch_row_fraction_equals_jax(tmp_path):
    """A MinMax sketch over a 4-file source caps a range's selectivity."""
    rng = np.random.default_rng(3)
    d = tmp_path / "events"
    d.mkdir()
    for i in range(4):
        pq.write_table(pa.table({
            "e_day": pa.array(np.arange(i * 100, i * 100 + 100 + i, dtype=np.int64)),
            "e_amt": pa.array(rng.uniform(0, 10, 100 + i))}), d / f"p{i}.parquet")
    ss = sessions(tmp_path)
    got = {}
    for pkg in PKGS:
        s = ss[pkg]
        lib = hst if pkg == "jax" else ht
        lib.Hyperspace(s).create_index(s.read.parquet(str(d)), lib.DataSkippingIndexConfig(
            "ev_skip", [lib.MinMaxSketch("e_day")]))
        provider = (jprovider_for if pkg == "jax" else tprovider_for)(s)
        relation = s.read.parquet(str(d)).plan.relation
        col = E(pkg).col
        got[pkg] = [provider.sketch_row_fraction(relation, cond) for cond in (
            col("e_day") < 150, (col("e_day") >= 310) & (col("e_day") < 320),
            col("e_amt") > 5)]
    assert got["torch"] == got["jax"]
    assert got["torch"][0] is not None and got["torch"][2] is None


# ---------------------------------------------------------------------------
# Reordering.
# ---------------------------------------------------------------------------

def plans_both(ss, build, reorder=True):
    out = {}
    for pkg in PKGS:
        s = ss[pkg]
        s.conf.set(REORDER, "true" if reorder else "false")
        df = build(s, pkg)
        out[pkg] = (df, s.optimize(df.plan).tree_string(), s._last_join_order)
    return out


def test_star_reorder_equals_jax(star):
    ss, paths = star
    on = plans_both(ss, lambda s, pkg: three_way(s, pkg, paths))
    assert on["torch"][1] == on["jax"][1]
    assert "[reordered, est~" in on["torch"][1]
    assert on["torch"][2] == on["jax"][2]
    assert on["torch"][2][0]["order"] == ["fact", "dim1", "dim2"]
    reordered = {pkg: sorted_frame(on[pkg][0].to_arrow()) for pkg in PKGS}
    assert ss["torch"]._join_actuals == ss["jax"]._join_actuals
    assert len(ss["torch"]._join_actuals) == 2
    off = plans_both(ss, lambda s, pkg: three_way(s, pkg, paths), reorder=False)
    assert off["torch"][1] == off["jax"][1] and "[reordered" not in off["torch"][1]
    plain = sorted_frame(off["torch"][0].to_arrow())
    off["jax"][0].to_arrow()
    # With reordering off both packages record the text-order joins too.
    assert len(ss["torch"]._join_actuals) == 4
    assert ss["torch"]._join_actuals == ss["jax"]._join_actuals
    assert_frames_close(reordered["torch"], plain)
    assert_frames_close(reordered["torch"], reordered["jax"])


@pytest.mark.parametrize("case", ("greedy", "two_tables", "left_barrier", "csv_member",
                                  "ambiguous_rename"))
def test_reorder_cases_equal_jax(star, tmp_path, monkeypatch, case):
    ss, paths = star
    d = tmp_path / "d2csv"
    d.mkdir()
    pd.DataFrame({"c_key": np.arange(20, dtype=np.int64)}).to_csv(d / "p0.csv", index=False)
    if case == "greedy":
        # The port's DP threshold is a module constant; the JAX package's
        # is a conf key.
        ss["jax"].conf.set("hyperspace.tpu.optimizer.joinReorder.dpThreshold", "0")
        monkeypatch.setattr(tjoin_order, "JOIN_REORDER_DP_THRESHOLD", 0)

    def build(s, pkg):
        col = E(pkg).col
        fact = s.read.parquet(paths["fact"])
        d1 = s.read.parquet(paths["dim1"]).filter(col("d1_cat") == "b")
        d2 = s.read.parquet(paths["dim2"])
        if case == "greedy":
            return three_way(s, pkg, paths)
        if case == "two_tables":
            return fact.join(d1, on=col("f_d1") == col("d1_key"))
        if case == "left_barrier":
            return (fact.join(d2, on=col("f_d2") == col("d2_key"), how="left")
                    .join(d1, on=col("f_d1") == col("d1_key")))
        if case == "csv_member":
            return (fact.join(s.read.csv(str(d)), on=col("f_d2") == col("c_key"))
                    .join(d1, on=col("f_d1") == col("d1_key")))
        return (fact.join(d2.select(col("d2_key"), col("d2_cat").alias("cat")),
                          on=col("f_d2") == col("d2_key"))
                .join(d1, on=col("f_d1") == col("d1_key")).select("cat", "f_val"))

    on = plans_both(ss, build)
    assert on["torch"][1] == on["jax"][1]
    assert on["torch"][2] == on["jax"][2]
    got = {pkg: sorted_frame(on[pkg][0].to_arrow()) for pkg in PKGS}
    assert_frames_close(got["torch"], got["jax"])


@pytest.mark.parametrize("seed", range(6))
def test_enumerations_equal_jax(seed):
    """Greedy and DP orders over random chains (a star, then extra
    edges between dimensions) equal the JAX package's on the same
    estimates."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 10))
    rows = [float(rng.integers(1, 10**6)) for _ in range(n)]
    edges = []
    for t in range(1, n):
        edges.append((0, t, f"f_k{t}", f"d{t}_key"))
    for t in range(2, n, 2):
        edges.append((t - 1, t, f"d{t - 1}_x", f"d{t}_x"))
    ndvs = [dict() for _ in range(n)]
    for a, b, ca, cb in edges:
        ndvs[a][ca] = float(rng.integers(1, int(rows[a]) + 1))
        ndvs[b][cb] = None if rng.random() < 0.2 else float(rng.integers(1, int(rows[b]) + 1))
    for mod in (jjoin_order, tjoin_order):
        ests = [mod._Est(rows[i], dict(ndvs[i])) for i in range(n)]
        if mod is jjoin_order:
            want = (mod._enumerate_greedy(ests, edges), mod._enumerate_dp(ests, edges))
        else:
            got = (mod._enumerate_greedy(ests, edges), mod._enumerate_dp(ests, edges))
    assert got == want
    assert sorted(got[0]) == list(range(n))


def test_random_star_schemas_equal_jax(tmp_path):
    """3-5 table star joins with random dimension filters and FROM orders
    (the JAX package's property test): reordered trees equal, and the
    answers reorder-on equal reorder-off and the JAX package's."""
    rng = np.random.default_rng(20260803)
    n_f, dim_sizes = 1500, [30, 12, 8, 45]
    dim_paths = []
    fact_cols = {"f_val": pa.array(rng.uniform(0, 10, n_f).round(3))}
    for d in range(4):
        fact_cols[f"f_k{d}"] = pa.array(rng.integers(0, dim_sizes[d], n_f).astype(np.int64))
        dim_paths.append(write(tmp_path / f"dim{d}", pa.table({
            f"k{d}": pa.array(np.arange(dim_sizes[d], dtype=np.int64)),
            f"c{d}": pa.array(rng.integers(0, 4, dim_sizes[d]).astype(np.int64))})))
    fact_path = write(tmp_path / "fact", pa.table(fact_cols))
    ss = sessions(tmp_path)
    changed = 0
    for _ in range(6):
        dims = list(rng.permutation(4))[:int(rng.integers(2, 5))]
        filters = [int(rng.integers(0, 4)) if rng.random() < 0.7 else None for _ in dims]

        def build(s, pkg):
            e = E(pkg)
            q = s.read.parquet(fact_path)
            for d, f in zip(dims, filters):
                dim = s.read.parquet(dim_paths[d])
                if f is not None:
                    dim = dim.filter(e.col(f"c{d}") == f)
                q = q.join(dim, on=e.col(f"f_k{d}") == e.col(f"k{d}"))
            return q.agg(e.sum_(e.col("f_val")).alias("total"), e.count(None).alias("n"))

        on = plans_both(ss, build)
        assert on["torch"][1] == on["jax"][1]
        assert on["torch"][2] == on["jax"][2]
        changed += "[reordered" in on["torch"][1]
        got_on = sorted_frame(on["torch"][0].to_arrow())
        off = plans_both(ss, build, reorder=False)
        assert_frames_close(got_on, sorted_frame(off["torch"][0].to_arrow()))
        assert_frames_close(got_on, sorted_frame(on["jax"][0].to_arrow()))
    assert changed > 0


def join_order_section(text: str) -> str:
    return text.split("Join order:", 1)[1] if "Join order:" in text else ""


def test_explain_join_order_section_equals_jax(star):
    ss, paths = star
    texts = {}
    for pkg in PKGS:
        s = ss[pkg]
        s.conf.set(REORDER, "true")
        q = three_way(s, pkg, paths)
        explain = jexplain if pkg == "jax" else texplain
        before = explain(s, q.plan, diagnostics=False)
        q.to_arrow()
        after = explain(s, q.plan, diagnostics=False)
        texts[pkg] = (join_order_section(before), join_order_section(after))
    assert texts["torch"] == texts["jax"]
    before, after = texts["torch"]
    assert "reordered -> [fact, dim1, dim2]" in before and "actual n/a" in before
    assert "actual n/a" not in after and "actual " in after
    ss["torch"].conf.set(REORDER, "false")
    assert "Join order:" not in texplain(ss["torch"], three_way(ss["torch"], "torch",
                                                                paths).plan)


def test_join_actuals_recorded_with_reorder_off(star):
    """An executed inner join's actual rows are recorded whatever the
    reorder flag: after one join with reordering off, the port's session
    holds the JAX session's actuals, key for key and row for row."""
    ss, paths = star
    for pkg in PKGS:
        s = ss[pkg]
        s.conf.set(REORDER, "false")
        col = E(pkg).col
        s.read.parquet(paths["fact"]).join(
            s.read.parquet(paths["dim2"]), on=col("f_d2") == col("d2_key")).to_arrow()
    assert len(ss["jax"]._join_actuals) == 1
    assert ss["torch"]._join_actuals == ss["jax"]._join_actuals


def test_join_actuals_are_bounded(star):
    ss, _ = star
    from hyperspace_tpu_torch.serving import context as tcontext
    s = ss["torch"]
    for i in range(300):
        tcontext.record_join_actual(s, f"k{i}", i)
    assert len(s._join_actuals) == 256 and next(iter(s._join_actuals)) == "k44"


# ---------------------------------------------------------------------------
# On/off parity over the TPC-H texts and a bounded TPC-DS subset.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tpch_reorder")
    ss = sessions(root)
    for name, t in tpch_mod._make_tables(np.random.default_rng(20260731)).items():
        d = write(root / name, t)
        for s in ss.values():
            s.create_temp_view(name, s.read.parquet(d))
    return ss


def on_off_parity(ss, text, execute=True):
    """Reordered trees equal to the JAX package's; an unchanged tree is
    the reorder-off tree; a changed one answers as reorder-off (sorted)."""
    on = plans_both(ss, lambda s, pkg: s.sql(text))
    assert on["torch"][1] == on["jax"][1]
    assert on["torch"][2] == on["jax"][2]
    off = plans_both(ss, lambda s, pkg: s.sql(text), reorder=False)
    assert off["torch"][1] == off["jax"][1]
    changed = on["torch"][1] != off["torch"][1]
    if changed and execute:
        assert_frames_close(sorted_frame(on["torch"][0].to_arrow()),
                            sorted_frame(off["torch"][0].to_arrow()))
    for s in ss.values():
        s.conf.set(REORDER, "false")
    return changed


@pytest.mark.parametrize("name", [c[0] for c in tpch_mod._CASES])
def test_tpch_reorder_parity(tpch, name):
    text = next(c[1] for c in tpch_mod._CASES if c[0] == name)
    on_off_parity(tpch, text)


def test_tpch_reorder_fires(tpch):
    changed = [c[0] for c in tpch_mod._CASES if on_off_parity(tpch, c[1], execute=False)]
    assert changed


@pytest.fixture(scope="module")
def tpcds(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tpcds_reorder")
    ss = sessions(root)
    tpcds_real.register_tables(ss["jax"], str(root / "data"))
    for name in sorted(os.listdir(root / "data")):
        ss["torch"].create_temp_view(name, ss["torch"].read.parquet(str(root / "data" / name)))
    return ss


# The first TPC-DS texts whose tree the reorderer changes are executed,
# as in the JAX package's parity test; the rest are compared as plans.
_TPCDS_EXECUTE = {"n": 4}


@pytest.mark.parametrize("name", tpcds_real.QUERY_NAMES)
def test_tpcds_reorder_parity(tpcds, name):
    execute = _TPCDS_EXECUTE["n"] > 0
    if on_off_parity(tpcds, tpcds_real.QUERY_TEXTS[name], execute=execute) and execute:
        _TPCDS_EXECUTE["n"] -= 1
