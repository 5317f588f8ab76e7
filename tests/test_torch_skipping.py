"""The data-skipping slice -- MinMax and Bloom sketch indexes over TPC-H
orders and the queries they prune -- through both packages on the same
numpy-seeded inputs, compared exactly: the sketch builders per dtype, the
plan-time probes per predicate shape, the sketch tables, the op logs and
every query's result, indexed and scanned.

JAX side: hyperspace_tpu on the CPU, its Pallas kernels in interpret mode
where a test turns them on (``set_mode("on")``). Port side:
hyperspace_tpu_torch on CPU tensors, whose kernel wrappers compute their
plain torch versions.
"""

import datetime
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest
import torch

import bench
import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu import api as japi
from hyperspace_tpu.execution.columnar import Table as JTable
from hyperspace_tpu.index.log_manager import IndexLogManager as JLogManager
from hyperspace_tpu.ops import pallas_kernels
from hyperspace_tpu.ops import sketches as jsk
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.rules import data_skipping_rule as jrule
from hyperspace_tpu_torch.execution.columnar import Table as TTable
from hyperspace_tpu_torch.index.constants import IndexConstants, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager as TLogManager
from hyperspace_tpu_torch.ops import cuda_kernels
from hyperspace_tpu_torch.ops import sketches as tsk
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.rules import data_skipping_rule as trule

SCALE = 0.002  # 3,000 orders in 16 files (and 12,000 lineitem rows).
OD_PARTS = 16

CONF = {
    IndexConstants.INDEX_FILTER_RULE_USE_BUCKET_SPEC: "true",
    # conftest gives JAX 8 virtual devices, which would take its mesh build.
    "hyperspace.tpu.distributed.enabled": "false",
}

EPOCH = datetime.date(1970, 1, 1)


@pytest.fixture()
def pallas_mode(request):
    pallas_kernels.set_mode(request.param)
    yield request.param
    pallas_kernels.set_mode("auto")


# ---------------------------------------------------------------------------
# Sketch builders per dtype.
# ---------------------------------------------------------------------------

def sketch_columns(n: int, seed: int) -> pa.Table:
    """One column per sketched dtype, each with nulls, plus the edge values
    of the float columns (+-0.0, +-inf; NaN in one), an all-null column and
    a column without nulls."""
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.2
    f64 = rng.uniform(-1e6, 1e6, n)
    f64[rng.integers(0, n, 4)] = [0.0, -0.0, np.inf, -np.inf]
    f64_nan = f64.copy()
    f64_nan[rng.integers(0, n)] = np.nan
    f32 = rng.uniform(-1e3, 1e3, n).astype(np.float32)
    f32[rng.integers(0, n, 3)] = [-0.0, 0.0, -np.inf]
    return pa.table({
        "i32": pa.array(rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int32), mask=nulls),
        "i32_full": pa.array(rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int32)),
        "i64": pa.array(rng.integers(-10 ** 12, 10 ** 12, n), mask=nulls),
        "f32": pa.array(f32, mask=nulls),
        "f64": pa.array(f64, mask=nulls),
        "f64_nan": pa.array(f64_nan),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      type=pa.int32(), mask=nulls).cast(pa.date32()),
        "s": pa.array(rng.choice(["ab", "b", "zz", "", "m"], n), mask=nulls),
        "none": pa.array(np.zeros(n, dtype=np.int32), mask=np.ones(n, dtype=bool)),
    })


def both_columns(at: pa.Table, name: str):
    return JTable.from_arrow(at).column(name), TTable.from_arrow(at, "cpu").column(name)


def same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, float):
        return type(a) is type(b) and math.copysign(1, a) == math.copysign(1, b) and a == b
    return type(a) is type(b) and a == b


MINMAX_COLUMNS = ["i32", "i32_full", "i64", "f32", "f64", "f64_nan", "d", "s", "none"]


@pytest.mark.parametrize("pallas_mode", ["on", "off"], indirect=True)
@pytest.mark.parametrize("n", [1, 3, 130, 4099])
@pytest.mark.parametrize("name", MINMAX_COLUMNS)
def test_minmax_values_match(pallas_mode, n, name):
    jc, tc = both_columns(sketch_columns(n, seed=n), name)
    want, got = jsk.minmax_values(jc), tsk.minmax_values(tc)
    assert all(same_value(w, g) for w, g in zip(want, got)), (want, got)


def infinite_column(n: int, value: float, nulls: bool) -> pa.Table:
    """n copies of +-inf as float32, with one null in the middle if asked."""
    data = pa.array(np.full(n, value, dtype=np.float32))
    if nulls:
        mask = np.zeros(n, dtype=bool)
        mask[n // 2] = True
        data = pc.if_else(pa.array(mask), pa.scalar(None, pa.float32()), data)
    return pa.table({"f": data})


@pytest.mark.parametrize("pallas_mode", ["on", "off"], indirect=True)
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("value", [np.inf, -np.inf])
@pytest.mark.parametrize("n", [3, 32768, 65536, 937500])
def test_minmax_values_of_infinite_columns_match(pallas_mode, n, value, nulls):
    """The sentinels enter where the JAX package's do: a column shorter than
    its length class (3 rows pad to 1,024 and 937,500 to 1,048,576), or one
    with a null, gives FLT_MAX for an all-+inf min; 32,768 and 65,536 rows
    without a null give +inf."""
    jc, tc = both_columns(infinite_column(n, value, nulls), "f")
    want, got = jsk.minmax_values(jc), tsk.minmax_values(tc)
    assert all(same_value(w, g) for w, g in zip(want, got)), (want, got)
    assert math.isinf(got[0] if value > 0 else got[1]) == (n in (32768, 65536) and not nulls)


@pytest.mark.parametrize("pallas_mode", ["on"], indirect=True)
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("value", [np.inf, -np.inf])
@pytest.mark.parametrize("n", [5_000_000, 5_013_504])
def test_minmax_values_of_long_infinite_columns_match(pallas_mode, n, value, nulls):
    """Past the exact fallback (4,194,304 rows) a column pads by more than
    a quarter to its next class, so it keeps its own length and only the
    Pallas kernel's block padding, or a null, brings the sentinels in:
    5,000,000 rows (no multiple of 32,768) give FLT_MAX for an all-+inf
    min, 5,013,504 rows (153 x 32,768) without a null give +inf. The port
    follows the kernel (the JAX package's plain path pads nothing here)."""
    jc, tc = both_columns(infinite_column(n, value, nulls), "f")
    want, got = jsk.minmax_values(jc), tsk.minmax_values(tc)
    assert all(same_value(w, g) for w, g in zip(want, got)), (want, got)
    assert math.isinf(got[0] if value > 0 else got[1]) == (n == 5_013_504 and not nulls)


def test_minmax_values_of_an_empty_column():
    at = sketch_columns(5, seed=0).slice(0, 0)
    for name in MINMAX_COLUMNS:
        jc, tc = both_columns(at, name)
        assert jsk.minmax_values(jc) == tsk.minmax_values(tc) == (None, None)


BLOOM_COLUMNS = ["i32", "i32_full", "i64", "f64", "d", "s"]


@pytest.mark.parametrize("n", [3, 130, 4099])
@pytest.mark.parametrize("name", BLOOM_COLUMNS)
@pytest.mark.parametrize("expected,fpp", [(100, 0.01), (1000, 0.2)])
def test_bloom_build_matches(n, name, expected, fpp):
    assert tsk.bloom_parameters(expected, fpp) == jsk.bloom_parameters(expected, fpp)
    num_bits, num_hashes = tsk.bloom_parameters(expected, fpp)
    at = sketch_columns(n, seed=n)
    jc, tc = both_columns(at, name)
    want = jsk.bloom_build(jc, num_bits, num_hashes)
    got = tsk.bloom_build(tc, num_bits, num_hashes)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    dtype = tc.dtype
    present = [v for v in at.column(name).to_pylist() if v is not None][:20]
    absent = {"s": ["nope", "x"], "d": [datetime.date(2100, 1, 1)]}.get(
        name, [10 ** 7 + 1, -(10 ** 7) - 3])
    for v in present + absent:
        hv = v if not isinstance(v, datetime.date) else (v - EPOCH).days
        assert tsk.bloom_might_contain(got, hv, dtype, num_bits, num_hashes) == \
            jsk.bloom_might_contain(want, hv, dtype, num_bits, num_hashes)
    for v in present:
        hv = v if not isinstance(v, datetime.date) else (v - EPOCH).days
        assert tsk.bloom_might_contain(got, hv, dtype, num_bits, num_hashes)


@pytest.mark.parametrize("n", [3, 130, 4099])
@pytest.mark.parametrize("name", BLOOM_COLUMNS + ["none"])
@pytest.mark.parametrize("max_values", [2, 5, 256])
def test_value_list_matches(n, name, max_values):
    jc, tc = both_columns(sketch_columns(n, seed=n), name)
    want, got = jsk.value_list(jc, max_values), tsk.value_list(tc, max_values)
    if want is None:
        assert got is None
    else:
        assert len(got) == len(want) and all(same_value(w, g) for w, g in zip(want, got))


# ---------------------------------------------------------------------------
# Plan-time probes per predicate shape.
# ---------------------------------------------------------------------------

PROBE_FILES = 8


@pytest.fixture(scope="module")
def probe_lake(tmp_path_factory):
    """8 files of sketch_columns, with int32 and date columns that rise
    from file to file (so MinMax prunes), one file whose i32 is all null,
    and the same sketch index built by both packages."""
    root = tmp_path_factory.mktemp("probe")
    data = root / "data"
    os.makedirs(data)
    for i in range(PROBE_FILES):
        t = sketch_columns(50, seed=100 + i)
        rising = (np.arange(50) + 1000 * i).astype(np.int32)
        t = t.set_column(t.schema.get_field_index("i32_full"), "i32_full", pa.array(rising))
        t = t.set_column(t.schema.get_field_index("d"), "d",
                         pa.array(rising, type=pa.int32()).cast(pa.date32()))
        if i == 3:
            t = t.set_column(t.schema.get_field_index("i32"), "i32",
                             pa.nulls(50, type=pa.int32()))
        pq.write_table(t, str(data / f"part{i}.parquet"))
    out = {"root": root, "data": str(data)}
    for pkg, key, api in ((hst, "jax", japi), (ht, "torch", ht)):
        session = pkg.Session(conf=dict(CONF), system_path=str(root / key),
                              **({} if key == "jax" else {"device": "cpu"}))
        df = session.read.parquet(str(data))
        sketches = [api.MinMaxSketch(c) for c in ("i32", "i32_full", "i64", "f64", "f64_nan",
                                                  "f32", "d", "s")]
        sketches += [api.BloomFilterSketch("i64", expected_items=100),
                     api.BloomFilterSketch("s", expected_items=100),
                     api.ValueListSketch("s", max_values=4)]
        # A name no other test file uses: the JAX rule caches sketch tables
        # per process by (index name, log id).
        pkg.Hyperspace(session).create_index(df, api.DataSkippingIndexConfig("probe_sk",
                                                                             sketches))
        out[key] = (session, df.plan.relation)
    return out


def predicates(E):
    c, lit = E.Col, E.Lit
    d0 = datetime.date(1970, 1, 1) + datetime.timedelta(days=2500)
    out = []
    for op in (E.EqualTo, E.LessThan, E.LessThanOrEqual, E.GreaterThan,
               E.GreaterThanOrEqual):
        for column, value in (("i32_full", 2500), ("i32_full", 2500.5), ("i32_full", -3),
                              ("i32_full", 1e30), ("i32_full", -1e30), ("i32_full", 2 ** 70),
                              ("i32_full", float("inf")), ("i32_full", float("nan")),
                              ("i32", 0), ("i64", 10 ** 11), ("f64", 0.0), ("f64", 1e5),
                              ("f64", float("nan")), ("f64", float("inf")),
                              ("f64_nan", 1.0), ("f32", -0.0), ("d", d0), ("s", "m")):
            out.append(op(c(column), lit(value)))
            out.append(op(lit(value), c(column)))  # flipped literal
    out += [
        E.In(c("i64"), [lit(7), lit(-5)]),
        E.In(c("i32_full"), [lit(10), lit(7010)]),
        E.In(c("s"), [lit("m"), lit("zz")]),
        E.In(c("s"), [lit("nope")]),
        E.And(E.GreaterThanOrEqual(c("i32_full"), lit(2000)),
              E.LessThan(c("i32_full"), lit(4000))),
        E.Or(E.LessThan(c("i32_full"), lit(500)), E.GreaterThan(c("d"), lit(d0))),
        E.And(E.EqualTo(c("i64"), lit(3)), E.LessThan(c("i32_full"), lit(10))),
        E.Or(E.LessThan(c("i32_full"), lit(500)), E.GreaterThan(c("f32"), lit(1.5))),
        E.Or(E.EqualTo(c("s"), lit("m")), E.EqualTo(c("i32_full"), lit(1))),
    ]
    return out


N_PREDICATES = len(predicates(TE))


@pytest.mark.parametrize("i", range(N_PREDICATES))
def test_probe_keep_masks_match(probe_lake, i):
    results = []
    for key, E, rule in (("jax", JE, jrule), ("torch", TE, trule)):
        session, relation = probe_lake[key]
        entry = session.index_collection_manager.get_indexes(["ACTIVE"])[0] \
            if key == "torch" else JLogManager(
                os.path.join(probe_lake["root"], "jax", "probe_sk")).get_latest_stable_log()
        cond = predicates(E)[i]
        results.append(rule.evaluate_sketch_predicate(
            entry, cond, relation.all_files(), relation.schema))
    want, got = results
    if want is None:
        assert got is None
    else:
        assert got.dtype == bool and np.array_equal(got, want), (got, want)


def test_probe_prunes_something(probe_lake):
    session, relation = probe_lake["torch"]
    entry = session.index_collection_manager.get_indexes([States.ACTIVE])[0]
    keep = trule.evaluate_sketch_predicate(
        entry, TE.EqualTo(TE.Col("i32_full"), TE.Lit(2010)), relation.all_files(),
        relation.schema)
    assert keep.sum() == 1 and keep[2]


def test_sketch_tables_with_every_kind_equal(probe_lake):
    path = os.path.join("probe_sk", "v__=0", "sketches.parquet")
    want = pq.read_table(os.path.join(probe_lake["root"], "jax", path), partitioning=None)
    got = pq.read_table(os.path.join(probe_lake["root"], "torch", path), partitioning=None)
    assert got.schema.equals(want.schema)
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        assert len(g) == len(w) and all(
            (a is None and b is None) or (a is not None and b is not None and
                                          (same_value(a, b) if not isinstance(a, list)
                                           else a == b))
            for a, b in zip(g, w)), name


# ---------------------------------------------------------------------------
# The slice: od_idx, od_skip and od_bloom over orders, and the two queries.
# ---------------------------------------------------------------------------

def sketch_configs(api, n_od: int):
    return [api.DataSkippingIndexConfig("od_skip", [api.MinMaxSketch("o_orderdate")]),
            api.DataSkippingIndexConfig("od_bloom", [api.BloomFilterSketch(
                "o_orderkey", expected_items=max(n_od // OD_PARTS, 100_000))])]


def build_all(pkg, api, session, od_dir: str, n_od: int) -> None:
    hs = pkg.Hyperspace(session)
    od = session.read.parquet(od_dir)
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    hs.create_index(od, pkg.IndexConfig(
        "od_idx", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_shippriority"]))
    for config in sketch_configs(api, n_od):
        hs.create_index(od, config)


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("skipping")
    _, od_dir, _, _, n_od = bench.make_tpch_like(str(root / "data"), SCALE)
    jax_session = hst.Session(conf=dict(CONF), system_path=str(root / "jax_indexes"))
    torch_session = ht.Session(conf=dict(CONF), system_path=str(root / "torch_indexes"),
                               device="cpu")
    build_all(hst, japi, jax_session, od_dir, n_od)
    build_all(ht, ht, torch_session, od_dir, n_od)
    return {"root": root, "od_dir": od_dir, "n_od": n_od,
            "jax": jax_session, "torch": torch_session}


def queries(E, df, n_od):
    return {
        "skipping": df.filter(E.col("o_orderdate").between(
            datetime.date(1994, 6, 1), datetime.date(1994, 7, 31)))
        .select("o_orderkey", "o_custkey"),
        "bloom": df.filter(E.col("o_orderkey").isin([n_od // 5, n_od // 2, (4 * n_od) // 5]))
        .select("o_orderkey", "o_totalprice"),
    }


def run_query(lake, pkg: str, name: str, indexed: bool):
    session = lake[pkg]
    E = JE if pkg == "jax" else TE
    df = queries(E, session.read.parquet(lake["od_dir"]), lake["n_od"])[name]
    if indexed:
        session.enable_hyperspace()
    try:
        leaves = df.optimized_plan().collect_leaves()
        return df.to_arrow(), leaves
    finally:
        session.disable_hyperspace()


def sketch_file(lake, pkg: str, name: str) -> str:
    return os.path.join(lake["root"], f"{pkg}_indexes", name, "v__=0", "sketches.parquet")


def test_orders_has_16_files(lake):
    assert lake["n_od"] == 3000
    assert len(os.listdir(lake["od_dir"])) == OD_PARTS


@pytest.mark.parametrize("name", ["od_skip", "od_bloom"])
def test_sketch_tables_equal(lake, name):
    want = pq.read_table(sketch_file(lake, "jax", name), partitioning=None)
    got = pq.read_table(sketch_file(lake, "torch", name), partitioning=None)
    assert got.equals(want)
    assert got.num_rows == OD_PARTS


@pytest.mark.parametrize("name", ["od_skip", "od_bloom"])
def test_each_log_manager_reads_the_other(lake, name):
    jentry = JLogManager(os.path.join(lake["root"], "torch_indexes", name)) \
        .get_latest_stable_log()
    tentry = TLogManager(os.path.join(lake["root"], "jax_indexes", name)) \
        .get_latest_stable_log()
    assert jentry.state == "ACTIVE" and tentry.state == States.ACTIVE
    assert jentry.derivedDataset.kind == tentry.derivedDataset.kind == "DataSkippingIndex"
    assert jentry.derivedDataset.to_json_dict() == tentry.derivedDataset.to_json_dict()
    assert jentry.signature.signatures[0].value == tentry.signature.signatures[0].value
    own = TLogManager(os.path.join(lake["root"], "torch_indexes", name)).get_latest_stable_log()
    assert own.derivedDataset.to_json_dict() == tentry.derivedDataset.to_json_dict()
    # The same source description; the provider names differ by package.
    assert [r.to_json_dict() for r in own.source.plan.relations] == \
        [r.to_json_dict() for r in tentry.source.plan.relations]


def kept_files(leaves):
    (leaf,) = leaves
    assert type(leaf).__name__ == "Scan", leaf.simple_string()
    return leaf.relation.all_files(), leaf.skipping_note


@pytest.mark.parametrize("name", ["skipping", "bloom"])
def test_files_kept_match(lake, name):
    _, tleaves = run_query(lake, "torch", name, True)
    _, jleaves = run_query(lake, "jax", name, True)
    got, note = kept_files(tleaves)
    want, jnote = kept_files(jleaves)
    assert got == want and note == jnote
    assert 0 < len(got) < OD_PARTS
    assert note == f"{len(got)}/{OD_PARTS} files after skipping"


def test_minmax_keeps_exactly_the_overlapping_files(lake):
    lo, hi = datetime.date(1994, 6, 1), datetime.date(1994, 7, 31)
    want = []
    for f in sorted(os.listdir(lake["od_dir"])):
        dates = pq.read_table(os.path.join(lake["od_dir"], f), columns=["o_orderdate"])
        dates = dates.column(0).to_pylist()
        if min(dates) <= hi and max(dates) >= lo:
            want.append(os.path.join(lake["od_dir"], f))
    got, _ = kept_files(run_query(lake, "torch", "skipping", True)[1])
    assert got == want


def test_bloom_keeps_every_file_holding_a_key(lake):
    n_od = lake["n_od"]
    keys = {n_od // 5, n_od // 2, (4 * n_od) // 5}
    got, _ = kept_files(run_query(lake, "torch", "bloom", True)[1])
    for f in sorted(os.listdir(lake["od_dir"])):
        path = os.path.join(lake["od_dir"], f)
        held = set(pq.read_table(path, columns=["o_orderkey"]).column(0).to_pylist())
        if held & keys:
            assert path in got


@pytest.mark.parametrize("indexed", [True, False])
@pytest.mark.parametrize("name", ["skipping", "bloom"])
def test_query_results_equal_across_packages(lake, name, indexed):
    got, _ = run_query(lake, "torch", name, indexed)
    want, _ = run_query(lake, "jax", name, indexed)
    assert got.equals(want)
    assert got.num_rows > 0


@pytest.mark.parametrize("name", ["skipping", "bloom"])
def test_indexed_equals_scanned(lake, name):
    indexed, _ = run_query(lake, "torch", name, True)
    scanned, _ = run_query(lake, "torch", name, False)
    keys = [(c, "ascending") for c in indexed.column_names]
    assert indexed.sort_by(keys).equals(scanned.sort_by(keys))


def test_minmax_build_runs_the_kernel_wrapper_once_per_file(lake, tmp_path, monkeypatch):
    calls = []
    real = cuda_kernels.masked_minmax_words
    monkeypatch.setattr(cuda_kernels, "masked_minmax_words",
                        lambda x, valid=None, pad=None:
                        calls.append((x.dtype, valid)) or real(x, valid, pad))
    session = ht.Session(conf=dict(CONF), system_path=str(tmp_path / "ix"), device="cpu")
    ht.Hyperspace(session).create_index(session.read.parquet(lake["od_dir"]),
                                        sketch_configs(ht, lake["n_od"])[0])
    assert calls == [(torch.int32, None)] * OD_PARTS
    # CPU tensors take the plain version: nothing counts as a launch.
    assert cuda_kernels.LAUNCHES["masked_minmax"] == 0


def test_covering_query_still_uses_the_covering_index(lake):
    session = lake["torch"]
    df = session.read.parquet(lake["od_dir"])
    q = df.filter(TE.col("o_orderkey") == 17).select("o_custkey")
    session.enable_hyperspace()
    try:
        leaves = [leaf.simple_string() for leaf in q.optimized_plan().collect_leaves()]
        indexed = q.to_arrow()
    finally:
        session.disable_hyperspace()
    assert any("Name: od_idx," in s for s in leaves), leaves
    assert indexed.equals(q.to_arrow())


def test_deleted_skipping_index_prunes_nothing(lake, tmp_path):
    session = ht.Session(conf=dict(CONF), system_path=str(tmp_path / "ix"), device="cpu")
    hs = ht.Hyperspace(session)
    od = session.read.parquet(lake["od_dir"])
    hs.create_index(od, sketch_configs(ht, lake["n_od"])[0])
    q = queries(TE, od, lake["n_od"])["skipping"]
    session.enable_hyperspace()
    assert "files after skipping" in q.optimized_plan().collect_leaves()[0].simple_string()
    hs.delete_index("od_skip")
    assert "files after skipping" not in q.optimized_plan().collect_leaves()[0].simple_string()
    hs.vacuum_index("od_skip")
    assert hs.index_manager.get_index("od_skip").state == States.DOESNOTEXIST


# ---------------------------------------------------------------------------
# The repair: a system path that holds a data-skipping index written by the
# JAX package no longer breaks the port's covering-index queries.
# ---------------------------------------------------------------------------

def test_port_reads_a_system_path_holding_a_jax_skipping_index(lake, tmp_path):
    system_path = str(tmp_path / "mixed")
    jax_session = hst.Session(conf=dict(CONF), system_path=system_path)
    jax_od = jax_session.read.parquet(lake["od_dir"])
    hst.Hyperspace(jax_session).create_index(
        jax_od, japi.DataSkippingIndexConfig("od_skip", [japi.MinMaxSketch("o_orderdate")]))

    session = ht.Session(conf=dict(CONF), system_path=system_path, device="cpu")
    od = session.read.parquet(lake["od_dir"])
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 8)
    ht.Hyperspace(session).create_index(
        od, ht.IndexConfig("od_idx", ["o_orderkey"], ["o_custkey"]))
    kinds = sorted(e.derivedDataset.kind
                   for e in session.index_collection_manager.get_indexes([States.ACTIVE]))
    assert kinds == ["CoveringIndex", "DataSkippingIndex"]

    q = od.filter(TE.col("o_orderkey") == 1234).select("o_custkey")
    session.enable_hyperspace()
    leaves = [leaf.simple_string() for leaf in q.optimized_plan().collect_leaves()]
    indexed = q.to_arrow()
    session.disable_hyperspace()
    assert any("IndexScan" in s and "Name: od_idx," in s for s in leaves), leaves
    assert indexed.num_rows == 1 and indexed.equals(q.to_arrow())
