"""Source reads through both packages on the same numpy-seeded files,
compared exactly: hive-partitioned directories (partition columns in the
schema, in scans, in pushdown, in builds, and pruned at planning time) and
nested struct columns (leaves read under their dotted names, pushed into
index reads only, indexed and joined on). Schemas, the files a plan keeps,
plan tree strings, index op logs and data files, and ``to_arrow()`` rows
must be equal.

The first tests pin two faults of the port that these reads repair: it
dropped partition columns without an error, and read struct leaves under
their last name or raised on them.
"""

import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import chip_smoke
import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.plan.expr import col as jcol, count as jcount, sum_ as jsum
from hyperspace_tpu_torch.execution import executor as texecutor
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.ops import index_build as tindex_build
from hyperspace_tpu_torch.plan.expr import count as tcount, sum_ as tsum
from hyperspace_tpu_torch.plan.nodes import IndexScan
from hyperspace_tpu_torch.sources import partitions as tpartitions
from test_torch_mutability import data_files, normalized_log

BASE_CONF = {
    # conftest gives JAX 8 virtual devices, which would take its mesh build.
    "hyperspace.tpu.distributed.enabled": "false",
    "hyperspace.tpu.execution.fusion.enabled": "false",
    IndexConstants.INDEX_NUM_BUCKETS: "4",
}
HYBRID = IndexConstants.INDEX_HYBRID_SCAN_ENABLED
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")


class Lake:
    """A JAX session and a port session over the same source directory,
    each with its own system path."""

    def __init__(self, root, src: str, conf=None):
        self.root = root
        self.src = src
        c = dict(BASE_CONF, **(conf or {}))
        self.sessions = {
            "jax": hst.Session(conf=dict(c), system_path=str(root / "sys_jax")),
            "torch": ht.Session(conf=dict(c), system_path=str(root / "sys_torch"),
                                device="cpu")}

    @staticmethod
    def fns(name):
        """(col, sum_, count) of a package."""
        return (jcol, jsum, jcount) if name == "jax" else (ht.col, tsum, tcount)

    def set(self, key, value):
        for s in self.sessions.values():
            s.conf.set(key, value)

    def create(self, name, indexed, included, src=None):
        for n, s in self.sessions.items():
            pkg = hst if n == "jax" else ht
            pkg.Hyperspace(s).create_index(s.read.parquet(src or self.src),
                                           pkg.IndexConfig(name, list(indexed), list(included)))

    def query(self, build, indexed=False, src=None):
        """{package: (optimized plan, arrow result)}; ``build(df, col, sum_,
        count)`` makes the query from a fresh read."""
        out = {}
        for n, s in self.sessions.items():
            df = build(s.read.parquet(src or self.src), *self.fns(n))
            (s.enable_hyperspace if indexed else s.disable_hyperspace)()
            try:
                out[n] = (df.optimized_plan(), df.to_arrow())
            finally:
                s.disable_hyperspace()
        return out

    def assert_index_equal(self, name):
        jsys, tsys = self.root / "sys_jax", self.root / "sys_torch"
        assert normalized_log(tsys, name) == normalized_log(jsys, name)
        got, want = data_files(tsys, name), data_files(jsys, name)
        assert sorted(got) == sorted(want)
        for f in got:
            assert got[f].equals(want[f]), f


def sorted_rows(table: pa.Table) -> pa.Table:
    return table.sort_by([(c, "ascending") for c in table.column_names])


def assert_same(results: dict, sort: bool = False) -> pa.Table:
    """Equal plan strings and equal results (rows in order, or after a
    stable sort on every column where the row order is unspecified)."""
    (jplan, jtable), (tplan, ttable) = results["jax"], results["torch"]
    assert tplan.tree_string() == jplan.tree_string()
    assert ttable.column_names == jtable.column_names
    if sort:
        ttable, jtable = sorted_rows(ttable), sorted_rows(jtable)
    assert ttable.equals(jtable), (ttable.slice(0, 5), jtable.slice(0, 5))
    return ttable


def files_kept(plan) -> list:
    return [len(leaf.relation.all_files()) for leaf in plan.collect_leaves()
            if leaf.node_name == "Scan"]


# ---------------------------------------------------------------------------
# Inputs.
# ---------------------------------------------------------------------------

def write_partitioned(root, name="part_data"):
    """root/region=.../year=.../part0.parquet, 3 regions x 2 years (the
    JAX package's tests/test_partitioned_formats.py lake)."""
    rng = np.random.default_rng(61)
    base = root / name
    for region in ("asia", "emea", "na"):
        for year in (2020, 2021):
            d = base / f"region={region}" / f"year={year}"
            d.mkdir(parents=True)
            pq.write_table(pa.table({
                "id": pa.array(rng.integers(0, 10_000, 400).astype(np.int64)),
                "amount": pa.array(np.round(rng.uniform(0, 500, 400), 2)),
            }), d / "part0.parquet")
    return str(base)


def write_nested(root, n=600, parts=2, seed=3):
    """id plus nested<leaf<cnt>, qty> in ``parts`` files (the JAX
    package's tests/test_nested_columns.py lake)."""
    rng = np.random.default_rng(seed)
    d = root / "nested"
    d.mkdir(parents=True, exist_ok=True)
    leaf = rng.integers(0, 50, n).astype(np.int64)
    qty = rng.integers(1, 100, n).astype(np.int64)
    table = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "nested": pa.array([{"leaf": {"cnt": int(leaf[i])}, "qty": int(qty[i])}
                            for i in range(n)]),
    })
    step = n // parts
    for i in range(parts):
        lo = i * step
        hi = (i + 1) * step if i < parts - 1 else n
        pq.write_table(table.slice(lo, hi - lo), d / f"part{i}.parquet")
    return str(d)


def orders_attrs(rng, n, key0=0):
    """o_orderkey, o_custkey and the struct o_attrs<o_orderdate date32,
    o_totalprice float64>: the smoke run's hive lake, small."""
    keys = np.arange(key0, key0 + n, dtype=np.int64) * 4
    dates = rng.integers(8035, 10591, n).astype(np.int32)
    return pa.table({
        "o_orderkey": pa.array(keys),
        "o_custkey": pa.array(rng.integers(0, 1500, n).astype(np.int64)),
        "o_attrs": pa.StructArray.from_arrays(
            [pa.array(dates, pa.int32()).cast(pa.date32()),
             pa.array(np.round(rng.uniform(900, 500_000, n), 2))],
            ["o_orderdate", "o_totalprice"]),
    })


def write_orders_hive(root, n=2000, files_per_priority=4):
    rng = np.random.default_rng(5)
    base = root / "orders_hive"
    table = orders_attrs(rng, n)
    prio = rng.integers(0, len(PRIORITIES), n)
    for p, name in enumerate(PRIORITIES):
        d = base / f"o_orderpriority={name}"
        d.mkdir(parents=True)
        idx = np.nonzero(prio == p)[0]
        for i, part in enumerate(np.array_split(idx, files_per_priority)):
            pq.write_table(table.take(part), d / f"part-{i:02d}.parquet")
    return str(base)


# ---------------------------------------------------------------------------
# The two faults, on their smallest inputs.
# ---------------------------------------------------------------------------

def test_hive_partition_columns_are_read(tmp_path):
    """src/p=1/a.parquet and src/p=2/a.parquet: the schema is k, p and the
    rows carry p = 1, 1, 2, 2 (the port used to drop p without an error)."""
    for p in (1, 2):
        d = tmp_path / "src" / f"p={p}"
        d.mkdir(parents=True)
        pq.write_table(pa.table({"k": pa.array([10 * p, 10 * p + 1], pa.int64())}),
                       d / "a.parquet")
    lake = Lake(tmp_path, str(tmp_path / "src"))
    df = lake.sessions["torch"].read.parquet(lake.src)
    assert df.schema.names == ["k", "p"]
    assert df.to_arrow().to_pydict() == {"k": [10, 11, 20, 21], "p": [1, 1, 2, 2]}
    assert_same(lake.query(lambda df, c, s, n: df))
    got = assert_same(lake.query(lambda df, c, s, n: df.filter(c("p") == 2)))
    assert got.to_pydict() == {"k": [20, 21], "p": [2, 2]}


NESTED_CASES = {
    "to_arrow": lambda df, c, s, n: df,
    "select": lambda df, c, s, n: df.select("k", "s.x"),
    "filter": lambda df, c, s, n: df.filter(c("s.x") > 5),
    "filter_project": lambda df, c, s, n: df.filter(c("s.y") <= 2.0).select("s.y", "k"),
}


@pytest.mark.parametrize("case", sorted(NESTED_CASES))
def test_struct_leaves_keep_dotted_names(tmp_path, case):
    """k int64 and s struct<x int32, y float64>: the leaves read as s.x and
    s.y (the port used to return x and y, and to raise on select("s.x")
    and on a filter on s.x)."""
    (tmp_path / "n").mkdir()
    pq.write_table(pa.table({
        "k": pa.array(np.arange(10, dtype=np.int64)),
        "s": pa.StructArray.from_arrays(
            [pa.array(np.arange(10, dtype=np.int32)), pa.array(np.arange(10) * 0.5)],
            ["x", "y"])}), tmp_path / "n" / "a.parquet")
    lake = Lake(tmp_path, str(tmp_path / "n"))
    assert lake.sessions["torch"].read.parquet(lake.src).schema.names == ["k", "s.x", "s.y"]
    got = assert_same(lake.query(NESTED_CASES[case]))
    if case == "to_arrow":
        assert got.column_names == ["k", "s.x", "s.y"]
    if case == "filter":
        assert got.column("k").to_pylist() == [6, 7, 8, 9]


def test_index_on_struct_leaf_answers_equality(tmp_path):
    """create_index(IndexConfig("nx", ["s.x"], ["k"])) builds (the port
    used to raise) and answers s.x == 3 from the index."""
    (tmp_path / "n").mkdir()
    pq.write_table(pa.table({
        "k": pa.array(np.arange(10, dtype=np.int64)),
        "s": pa.StructArray.from_arrays(
            [pa.array(np.arange(10, dtype=np.int32)), pa.array(np.arange(10) * 0.5)],
            ["x", "y"])}), tmp_path / "n" / "a.parquet")
    lake = Lake(tmp_path, str(tmp_path / "n"))
    lake.create("nx", ["s.x"], ["k"])
    lake.assert_index_equal("nx")
    got = assert_same(lake.query(lambda df, c, s, n: df.filter(c("s.x") == 3).select("k", "s.x"),
                                 indexed=True))
    assert got.to_pydict() == {"k": [3], "s.x": [3]}
    plan = lake.query(lambda df, c, s, n: df.filter(c("s.x") == 3).select("k"),
                      indexed=True)["torch"][0]
    assert isinstance(plan.collect_leaves()[0], IndexScan)


# ---------------------------------------------------------------------------
# Nested columns (the cases of tests/test_nested_columns.py).
# ---------------------------------------------------------------------------

@pytest.fixture()
def nested(tmp_path):
    return Lake(tmp_path, write_nested(tmp_path))


def test_nested_schema_flattens_struct_leaves(nested):
    for s in nested.sessions.values():
        assert s.read.parquet(nested.src).schema.names == ["id", "nested.leaf.cnt", "nested.qty"]
    assert [f.dtype for f in nested.sessions["torch"].read.parquet(nested.src).schema.fields] \
        == [f.dtype for f in nested.sessions["jax"].read.parquet(nested.src).schema.fields]


NESTED_QUERIES = {
    "filter_on_leaf": lambda df, c, s, n: df.filter(c("nested.leaf.cnt") == 7).select("id"),
    "project_leaf": lambda df, c, s, n: df.select("nested.qty"),
    "range_two_leaves": lambda df, c, s, n: df.filter(
        (c("nested.qty") > 40) & (c("nested.leaf.cnt") < 10)).select("id", "nested.qty"),
    "in_on_leaf": lambda df, c, s, n: df.filter(c("nested.leaf.cnt").isin([1, 2, 3])),
    "group_by_leaf": lambda df, c, s, n: df.group_by("nested.leaf.cnt").agg(
        s(c("nested.qty")).alias("q"), n(None).alias("rows")),
}


@pytest.mark.parametrize("case", sorted(NESTED_QUERIES))
def test_nested_scan_queries(nested, case):
    assert_same(nested.query(NESTED_QUERIES[case]), sort=case == "group_by_leaf")


def test_nested_index_build_and_filter_rewrite(nested):
    nested.create("nidx", ["nested.leaf.cnt"], ["id", "nested.qty"])
    nested.assert_index_equal("nidx")
    entry = nested.sessions["torch"].index_collection_manager.get_index("nidx")
    assert entry.indexed_columns == ["nested.leaf.cnt"]
    q = lambda df, c, s, n: df.filter(c("nested.leaf.cnt") == 7).select("id", "nested.qty")
    indexed = nested.query(q, indexed=True)
    assert isinstance(indexed["torch"][0].collect_leaves()[0], IndexScan)
    got = assert_same(indexed)
    scanned = assert_same(nested.query(q))
    assert sorted_rows(got).equals(sorted_rows(scanned))


def test_nested_join_rewrite(nested, tmp_path):
    dim = tmp_path / "dim"
    dim.mkdir()
    pq.write_table(pa.table({"cnt": pa.array(np.arange(50, dtype=np.int64)),
                             "label": pa.array(np.arange(50, dtype=np.int64) * 10)}),
                   dim / "d.parquet")
    nested.create("fact_idx", ["nested.leaf.cnt"], ["id"])
    nested.create("dim_idx", ["cnt"], ["label"], src=str(dim))

    def q(df, c, s, n, lake=nested):
        session = lake.sessions["jax" if c is jcol else "torch"]
        ddf = session.read.parquet(str(dim))
        return df.join(ddf, on=c("nested.leaf.cnt") == c("cnt")).select("id", "label")

    indexed = nested.query(q, indexed=True)
    scans = [leaf for leaf in indexed["torch"][0].collect_leaves() if isinstance(leaf, IndexScan)]
    assert len(scans) == 2 and all(s.use_bucket_spec for s in scans)
    got = assert_same(indexed, sort=True)
    assert got.equals(assert_same(nested.query(q), sort=True))


def test_nested_incremental_refresh(nested, tmp_path):
    nested.set(IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    nested.create("nidx", ["nested.leaf.cnt"], ["id"])
    pq.write_table(pa.table({
        "id": pa.array(np.arange(10_000, 10_020, dtype=np.int64)),
        "nested": pa.array([{"leaf": {"cnt": 7}, "qty": 1}] * 20),
    }), tmp_path / "nested" / "extra.parquet")
    for n, s in nested.sessions.items():
        (hst if n == "jax" else ht).Hyperspace(s).refresh_index("nidx", "incremental")
    nested.assert_index_equal("nidx")
    q = lambda df, c, s, n: df.filter(c("nested.leaf.cnt") == 7).select("id")
    got = assert_same(nested.query(q, indexed=True), sort=True)
    assert got.equals(assert_same(nested.query(q), sort=True))
    assert sum(i >= 10_000 for i in got.column("id").to_pylist()) == 20


@pytest.mark.parametrize("chunk_rows", [None, 64])
def test_nested_hybrid_scan_over_appended_file(nested, tmp_path, chunk_rows):
    """Appended rows' struct leaves read under their dotted names, in
    memory and (above the budget) through the chunked index scan."""
    nested.create("nidx", ["nested.leaf.cnt"], ["id", "nested.qty"])
    pq.write_table(pa.table({
        "id": pa.array(np.arange(10_000, 10_030, dtype=np.int64)),
        "nested": pa.array([{"leaf": {"cnt": i % 9}, "qty": i} for i in range(30)]),
    }), tmp_path / "nested" / "extra.parquet")
    nested.set(HYBRID, "true")
    if chunk_rows:
        nested.set(IndexConstants.TPU_MAX_CHUNK_ROWS, str(chunk_rows))
    q = lambda df, c, s, n: df.filter(c("nested.leaf.cnt") < 5).select("id", "nested.qty")
    indexed = nested.query(q, indexed=True)
    scan = indexed["torch"][0].collect_leaves()[0]
    assert isinstance(scan, IndexScan) and len(scan.appended_files) == 1
    got = assert_same(indexed, sort=True)
    assert got.equals(sorted_rows(nested.query(q)["torch"][1]))
    assert sum(i >= 10_000 for i in got.column("id").to_pylist()) > 0


# ---------------------------------------------------------------------------
# Hive partitions (the parquet cases of tests/test_partitioned_formats.py).
# ---------------------------------------------------------------------------

@pytest.fixture()
def parts(tmp_path):
    return Lake(tmp_path, write_partitioned(tmp_path))


def test_partition_schema_and_types(parts):
    t = parts.sessions["torch"].read.parquet(parts.src).schema
    j = parts.sessions["jax"].read.parquet(parts.src).schema
    assert t.names == j.names == ["id", "amount", "region", "year"]
    assert [(f.dtype, f.nullable) for f in t.fields] == [(f.dtype, f.nullable) for f in j.fields]
    assert t.field("year").dtype == "int64" and t.field("region").dtype == "string"


PARTITION_QUERIES = {
    # name: (query, files the scanned plan keeps of 6)
    "scan_all": (lambda df, c, s, n: df.select("id", "amount", "region", "year"), 6),
    "equality": (lambda df, c, s, n: df.filter((c("region") == "emea") & (c("year") == 2021))
                 .select("id", "amount"), 1),
    "range_and_in": (lambda df, c, s, n: df.filter(c("region").isin(["asia", "na"])
                                                   & (c("year") > 2020))
                     .select("id", "region", "year"), 2),
    "flipped_literal": (lambda df, c, s, n: df.filter(c("year") <= 2020).select("id", "year"), 3),
    "or_of_partitions": (lambda df, c, s, n: df.filter((c("region") == "na")
                                                       | (c("year") == 2021)).select("id"), 4),
    "fractional_literal": (lambda df, c, s, n: df.filter(c("year") < 2020.5)
                           .select("id", "year"), 3),
    "mixed_conjuncts": (lambda df, c, s, n: df.filter((c("region") == "asia")
                                                      & (c("amount") > 250.0))
                        .select("id", "amount", "region"), 2),
    "partition_only_projection": (lambda df, c, s, n: df.select("region", "year"), 6),
    "group_by_partitions": (lambda df, c, s, n: df.group_by("region", "year").agg(
        s(c("amount")).alias("sa"), n(None).alias("rows")), 6),
}


@pytest.mark.parametrize("case", sorted(PARTITION_QUERIES))
def test_partition_queries_and_pruning(parts, case):
    build, kept = PARTITION_QUERIES[case]
    results = parts.query(build)
    assert files_kept(results["torch"][0]) == files_kept(results["jax"][0]) == [kept]
    got = assert_same(results, sort=case == "group_by_partitions")
    if case == "partition_only_projection":
        assert got.column_names == ["region", "year"] and got.num_rows == 2400


def test_partition_pruning_runs_with_hyperspace_enabled(parts):
    """Pruning is always on and runs after the index rules."""
    results = parts.query(lambda df, c, s, n: df.filter(c("year") == 2020).select("id"),
                          indexed=True)
    assert files_kept(results["torch"][0]) == [3]
    assert_same(results)


def test_index_over_partition_column(parts):
    """A covering index whose included column is a partition column: the
    build reads the values from the paths, the query reads them back."""
    parts.create("pidx", ["id"], ["amount", "region"])
    parts.assert_index_equal("pidx")
    q = lambda df, c, s, n: df.filter(c("id") < 2000).select("id", "amount", "region")
    indexed = parts.query(q, indexed=True)
    assert isinstance(indexed["torch"][0].collect_leaves()[0], IndexScan)
    got = assert_same(indexed)
    assert sorted_rows(got).equals(assert_same(parts.query(q), sort=True))


def test_index_on_partition_column(parts):
    """The partition column as the indexed column: bucketed and sorted by
    the path-derived values."""
    parts.create("ridx", ["region"], ["id", "year"])
    parts.assert_index_equal("ridx")
    q = lambda df, c, s, n: df.filter(c("region") == "na").select("id", "year", "region")
    indexed = parts.query(q, indexed=True)
    assert isinstance(indexed["torch"][0].collect_leaves()[0], IndexScan)
    assert sorted_rows(assert_same(indexed)).equals(assert_same(parts.query(q), sort=True))


def test_index_still_used_with_partition_filter(parts):
    parts.create("bothIdx", ["id"], ["amount", "region", "year"])
    q = lambda df, c, s, n: df.filter((c("id") < 2000) & (c("region") == "emea")) \
        .select("id", "amount", "region")
    indexed = parts.query(q, indexed=True)
    leaves = indexed["torch"][0].collect_leaves()
    assert any(isinstance(leaf, IndexScan) and leaf.index_entry.name == "bothIdx"
               for leaf in leaves)
    assert sorted_rows(assert_same(indexed)).equals(assert_same(parts.query(q), sort=True))


def test_partition_join_rewrite(parts, tmp_path):
    """A join on a covering index of a partitioned source."""
    dim = tmp_path / "dim"
    dim.mkdir()
    pq.write_table(pa.table({"dk": pa.array(np.arange(0, 10_000, 7, dtype=np.int64))}),
                   dim / "d.parquet")
    parts.create("fact_id", ["id"], ["region"])
    parts.create("dim_dk", ["dk"], [], src=str(dim))

    def q(df, c, s, n, lake=parts):
        ddf = lake.sessions["jax" if c is jcol else "torch"].read.parquet(str(dim))
        return df.join(ddf, on=c("id") == c("dk")).select("id", "region")

    indexed = parts.query(q, indexed=True)
    assert sum(isinstance(leaf, IndexScan)
               for leaf in indexed["torch"][0].collect_leaves()) == 2
    assert assert_same(indexed, sort=True).equals(assert_same(parts.query(q), sort=True))


def test_hybrid_scan_partitioned_append(parts, tmp_path):
    """A new partition directory appended after indexing: Hybrid Scan
    merges it and equals the source scan (the JAX package's oracle)."""
    parts.set(HYBRID, "true")
    parts.create("hidx", ["id"], ["amount"])
    d = tmp_path / "part_data" / "region=latam" / "year=2021"
    d.mkdir(parents=True)
    rng = np.random.default_rng(62)
    pq.write_table(pa.table({
        "id": pa.array(rng.integers(0, 10_000, 150).astype(np.int64)),
        "amount": pa.array(np.round(rng.uniform(0, 500, 150), 2))}), d / "part0.parquet")
    q = lambda df, c, s, n: df.filter(c("id") < 3000).select("id", "amount")
    indexed = parts.query(q, indexed=True)
    scan = indexed["torch"][0].collect_leaves()[0]
    assert isinstance(scan, IndexScan) and scan.appended_files
    assert sorted_rows(assert_same(indexed)).equals(assert_same(parts.query(q), sort=True))


@pytest.mark.parametrize("chunk_rows", [None, 100])
def test_hybrid_append_attaches_partition_columns(parts, tmp_path, chunk_rows):
    """An index that includes a partition column, and an appended
    partition: the appended rows get their partition value from the path,
    in memory and through the chunked index scan (the port's only: the
    JAX package's chunked appended read drops the partition column and
    raises, ROADMAP queue C 8, so the port's chunked answer is held to
    the JAX package's in-memory one)."""
    parts.set(HYBRID, "true")
    parts.create("hidx", ["id"], ["amount", "region"])
    d = tmp_path / "part_data" / "region=latam" / "year=2021"
    d.mkdir(parents=True)
    rng = np.random.default_rng(63)
    pq.write_table(pa.table({
        "id": pa.array(rng.integers(0, 10_000, 150).astype(np.int64)),
        "amount": pa.array(np.round(rng.uniform(0, 500, 150), 2))}), d / "part0.parquet")
    if chunk_rows:
        parts.sessions["torch"].conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, str(chunk_rows))
    q = lambda df, c, s, n: df.filter(c("id") < 3000).select("id", "amount", "region")
    chunks = texecutor.CHUNK_SCAN_STATS["chunks"]
    indexed = parts.query(q, indexed=True)
    scan = indexed["torch"][0].collect_leaves()[0]
    assert isinstance(scan, IndexScan) and len(scan.appended_files) == 1
    assert (texecutor.CHUNK_SCAN_STATS["chunks"] > chunks) == bool(chunk_rows)
    got = assert_same(indexed, sort=True)
    assert got.equals(assert_same(parts.query(q), sort=True))
    assert "latam" in got.column("region").to_pylist()
    if chunk_rows:
        js = parts.sessions["jax"]
        js.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, str(chunk_rows))
        js.enable_hyperspace()
        with pytest.raises(pa.ArrowInvalid):
            q(js.read.parquet(parts.src), jcol, jsum, jcount).to_arrow()


def test_partition_value_inference(tmp_path):
    """Date partitions become date32 values, and digits-only ones int64."""
    base = tmp_path / "dated"
    for day, tag in (("2024-01-02", "a"), ("2024-03-04", "a"), ("2024-05-06", "b")):
        d = base / f"day={day}" / f"tag={tag}"
        d.mkdir(parents=True)
        pq.write_table(pa.table({"v": pa.array([1, 2, 3], pa.int64())}), d / "f.parquet")
    lake = Lake(tmp_path, str(base))
    t = lake.sessions["torch"].read.parquet(lake.src).schema
    assert [(f.name, f.dtype) for f in t.fields] == [("v", "int64"), ("day", "date"),
                                                    ("tag", "string")]
    assert_same(lake.query(lambda df, c, s, n: df))
    results = lake.query(lambda df, c, s, n: df.filter(c("day") > datetime.date(2024, 2, 1)))
    assert files_kept(results["torch"][0]) == [2]
    assert_same(results)


def test_hive_default_partition_reads_as_null(tmp_path):
    """tag=a and tag=__HIVE_DEFAULT_PARTITION__: the port reads the second
    as a null tag. The JAX package raises ArrowInvalid (ROADMAP queue C 9:
    its pooled read hands pyarrow the null partition's file alone, whose
    path-inferred partition type pyarrow cannot infer)."""
    for i, tag in enumerate(("a", tpartitions.HIVE_DEFAULT_PARTITION)):
        d = tmp_path / "src" / f"tag={tag}"
        d.mkdir(parents=True)
        pq.write_table(pa.table({"v": pa.array([i, 2], pa.int64())}), d / "f.parquet")
    lake = Lake(tmp_path, str(tmp_path / "src"))
    df = lake.sessions["torch"].read.parquet(lake.src)
    assert [(f.name, f.dtype) for f in df.schema.fields] == [("v", "int64"), ("tag", "string")]
    assert df.to_arrow().to_pydict() == {"v": [1, 2, 0, 2], "tag": [None, None, "a", "a"]}
    assert df.filter(ht.col("tag") == "a").to_arrow().to_pydict() == {"v": [0, 2],
                                                                     "tag": ["a", "a"]}
    with pytest.raises(pa.ArrowInvalid):
        lake.sessions["jax"].read.parquet(lake.src).to_arrow()


# ---------------------------------------------------------------------------
# The chunked routes hand partitioned and nested sources to the in-memory
# reader, as the JAX package does.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["partitioned", "nested"])
def test_chunked_routes_decline_non_physical_columns(tmp_path, source):
    src = write_partitioned(tmp_path) if source == "partitioned" else write_nested(tmp_path)
    lake = Lake(tmp_path, src, {IndexConstants.TPU_MAX_CHUNK_ROWS: "100"})
    col = "region" if source == "partitioned" else "nested.leaf.cnt"
    value = "na" if source == "partitioned" else 7
    scans = texecutor.CHUNK_SCAN_STATS["chunks"]
    builds = tindex_build.CHUNK_STATS.get("chunks", 0)
    lake.create("cidx", ["id"], [col])
    lake.assert_index_equal("cidx")
    results = lake.query(lambda df, c, s, n: df.filter(c(col) == value).select("id", col))
    assert_same(results)
    assert texecutor.CHUNK_SCAN_STATS["chunks"] == scans
    assert tindex_build.CHUNK_STATS.get("chunks", 0) == builds


# ---------------------------------------------------------------------------
# Partitions and struct leaves in one lake (the smoke run's shape).
# ---------------------------------------------------------------------------

HIVE_QUERIES = {
    "urgent_june_july": lambda df, c, s, n: df.filter(
        (c("o_orderpriority") == "1-URGENT")
        & (c("o_attrs.o_orderdate") >= datetime.date(1994, 6, 1))
        & (c("o_attrs.o_orderdate") <= datetime.date(1994, 7, 31))).select(
        "o_orderkey", "o_orderpriority", "o_attrs.o_orderdate", "o_attrs.o_totalprice"),
    "cutoff": lambda df, c, s, n: df.filter(
        c("o_attrs.o_orderdate") > datetime.date(1995, 3, 15)).select(
        "o_orderkey", "o_attrs.o_totalprice"),
    "priority_group_by": lambda df, c, s, n: df.group_by("o_orderpriority").agg(
        n(None).alias("order_count"), s(c("o_attrs.o_totalprice")).alias("total")),
}


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("case", sorted(HIVE_QUERIES))
def test_hive_lake_with_struct_column(tmp_path, case, indexed):
    lake = Lake(tmp_path, write_orders_hive(tmp_path))
    lake.create("ohp_idx", ["o_attrs.o_orderdate"],
                ["o_orderkey", "o_orderpriority", "o_attrs.o_totalprice"])
    lake.assert_index_equal("ohp_idx")
    results = lake.query(HIVE_QUERIES[case], indexed=indexed)
    leaves = results["torch"][0].collect_leaves()
    if case == "urgent_june_july" and not indexed:
        assert files_kept(results["torch"][0]) == [4]
    if case != "priority_group_by":
        assert isinstance(leaves[0], IndexScan) == indexed
    got = assert_same(results, sort=case == "priority_group_by")
    if case == "priority_group_by":
        assert got.column("o_orderpriority").to_pylist() == list(PRIORITIES)


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("query", ["urgent", "after_cutoff", "by_priority"])
def test_smoke_sources_slice_equals_jax(tmp_path, query, indexed):
    """chip_smoke.py's sources path, small: its hive copy of orders, its
    ohp_idx and its three queries give the JAX package's index files,
    plans and rows."""
    _, od_dir, _, _, n_od = chip_smoke.make_tpch(str(tmp_path / "tpch"), 0.002)
    hive = str(tmp_path / "orders_hive")
    assert chip_smoke.make_orders_hive(od_dir, hive) == n_od
    lake = Lake(tmp_path, hive)
    lake.create(chip_smoke.HIVE_INDEX, *chip_smoke.HIVE_INDEX_COLUMNS)
    lake.assert_index_equal(chip_smoke.HIVE_INDEX)
    results = lake.query(lambda df, c, s, n: chip_smoke.sources_queries(df, c, n, s)[query],
                         indexed=indexed)
    got = assert_same(results, sort=query == "by_priority")
    if query == "urgent" and not indexed:
        assert files_kept(results["torch"][0]) == [chip_smoke.HIVE_FILES_PER_PARTITION]
    if query == "by_priority":
        chip_smoke.check_by_priority(got, chip_smoke.sources_reference(hive)[query], "port")
