"""The csv, json, orc, text and avro sources through both packages on the
same numpy-seeded files, compared exactly: schemas (names, types and
nullability), ``to_arrow()`` rows in order, plan tree strings, the files a
plan keeps, and index op logs and data files. Types are pyarrow's
inference in both packages (csv dates read as date32, pandas' json dates
as strings); the port is held to the JAX package's, not to the source's.
Avro files written by the port equal the JAX writer's byte for byte,
under the null and the deflate codec.

Also here: the footer memo (a file rewritten at the same path gets its
new row count; an unchanged file's footer is opened once), and a source
that is not parquet never reaches the chunked scan or the buffer pool.
"""

import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pa_csv
import pyarrow.orc as pa_orc
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.plan.expr import col as jcol, count as jcount, sum_ as jsum
from hyperspace_tpu.rules import data_skipping_rule as jskipping
from hyperspace_tpu.util import avro as javro
from hyperspace_tpu_torch.execution import buffer_pool as tbuffer_pool
from hyperspace_tpu_torch.execution import columnar as tcolumnar
from hyperspace_tpu_torch.execution import executor as texecutor
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.plan.expr import count as tcount, sum_ as tsum
from hyperspace_tpu_torch.util import avro as tavro
from test_torch_mutability import data_files, normalized_log
from test_torch_sources import files_kept

BASE_CONF = {
    "hyperspace.tpu.distributed.enabled": "false",
    "hyperspace.tpu.execution.fusion.enabled": "false",
    IndexConstants.INDEX_NUM_BUCKETS: "4",
}
FORMATS = ("parquet", "csv", "json", "orc", "avro")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")


def orders_part(rng, lo: int, n: int) -> pa.Table:
    return pa.table({
        "o_orderkey": pa.array(np.arange(lo, lo + n, dtype=np.int64)),
        "o_custkey": pa.array(rng.integers(0, 50, n).astype(np.int64)),
        "o_totalprice": pa.array(np.round(rng.uniform(1000, 400000, n), 2)),
        "o_orderdate": pa.array(np.sort(rng.integers(8000, 11000, n)).astype(np.int32),
                                pa.int32()).cast(pa.date32()),
        "o_orderpriority": pa.array(rng.choice(PRIORITIES, n)),
    })


def write_format(table: pa.Table, path: str, fmt: str) -> None:
    if fmt == "parquet":
        pq.write_table(table, path)
    elif fmt == "csv":
        pa_csv.write_csv(table, path)
    elif fmt == "json":
        table.to_pandas().to_json(path, orient="records", lines=True, date_format="iso")
    elif fmt == "orc":
        pa_orc.write_table(table, path)
    else:
        javro.write_avro(table, path)


def write_lake(root, fmt: str, parts: int = 3, rows: int = 200, seed: int = 5) -> str:
    rng = np.random.default_rng(seed)
    d = root / f"orders_{fmt}"
    d.mkdir(parents=True)
    for i in range(parts):
        write_format(orders_part(rng, i * rows, rows), str(d / f"part{i}.{fmt}"), fmt)
    return str(d)


def sessions(root, conf=None):
    c = dict(BASE_CONF, **(conf or {}))
    return {"jax": hst.Session(conf=dict(c), system_path=str(root / "sys_jax")),
            "torch": ht.Session(conf=dict(c), system_path=str(root / "sys_torch"),
                                device="cpu")}


def fns(name):
    return (jcol, jsum, jcount) if name == "jax" else (ht.col, tsum, tcount)


def assert_schema_equal(a, b):
    assert [(f.name, f.dtype, f.nullable) for f in a.fields] == \
        [(f.name, f.dtype, f.nullable) for f in b.fields]


def run_both(ss, read, build=lambda df, col, sum_, count: df, indexed=False):
    """{package: (optimized plan, arrow result)} of ``build`` over
    ``read(session)``."""
    out = {}
    for name, s in ss.items():
        df = build(read(s), *fns(name))
        (s.enable_hyperspace if indexed else s.disable_hyperspace)()
        try:
            out[name] = (df.optimized_plan(), df.to_arrow())
        finally:
            s.disable_hyperspace()
    return out


def assert_same(results, sort=False):
    (jplan, jtable), (tplan, ttable) = results["jax"], results["torch"]
    assert tplan.tree_string() == jplan.tree_string()
    if sort:
        key = [(c, "ascending") for c in jtable.column_names]
        jtable, ttable = jtable.sort_by(key), ttable.sort_by(key)
    assert ttable.schema == jtable.schema
    assert ttable.equals(jtable)
    return ttable


# ---------------------------------------------------------------------------
# Readers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_reader_schema_and_rows_equal_jax(tmp_path, fmt):
    src = write_lake(tmp_path, fmt)
    ss = sessions(tmp_path)
    jdf = getattr(ss["jax"].read, fmt)(src)
    tdf = getattr(ss["torch"].read, fmt)(src)
    assert_schema_equal(tdf.schema, jdf.schema)
    want = jdf.to_arrow()
    assert tdf.to_arrow().equals(want)
    loaded = ss["torch"].read.format(fmt).load(src)
    assert loaded.to_arrow().equals(want)
    assert want.num_rows == 600


def test_json_dates_take_the_jax_packages_type(tmp_path):
    """pandas writes a date32 column's dates as ISO strings, and pyarrow
    reads them back as strings: the port keeps the JAX package's type."""
    src = write_lake(tmp_path, "json", parts=1)
    ss = sessions(tmp_path)
    got = ss["torch"].read.json(src).to_arrow()
    want = ss["jax"].read.json(src).to_arrow()
    assert got.schema.field("o_orderdate").type == want.schema.field("o_orderdate").type
    assert got.equals(want)


@pytest.mark.parametrize("fmt", ("csv", "json", "orc", "avro"))
def test_projection_and_filter_equal_jax(tmp_path, fmt):
    src = write_lake(tmp_path, fmt)
    ss = sessions(tmp_path)
    res = run_both(ss, lambda s: getattr(s.read, fmt)(src),
                   lambda df, col, sum_, count: df.filter(col("o_custkey") < 20)
                   .select("o_orderkey", "o_orderpriority", "o_totalprice"))
    assert_same(res)
    res = run_both(ss, lambda s: getattr(s.read, fmt)(src),
                   lambda df, col, sum_, count: df.group_by("o_orderpriority")
                   .agg(sum_(col("o_totalprice")).alias("t"), count(None).alias("n"))
                   .sort("o_orderpriority"))
    assert_same(res)


def test_text_reader_equals_jax(tmp_path):
    d = tmp_path / "txt"
    d.mkdir()
    (d / "a.txt").write_text("alpha\nbravo\ncharlie\n")
    (d / "b.text").write_text("delta\necho\n")
    (d / "c.csv").write_text("not,text\n")
    ss = sessions(tmp_path)
    res = run_both(ss, lambda s: s.read.text(str(d)))
    got = assert_same(res)
    assert got.column("value").to_pylist() == ["alpha", "bravo", "charlie", "delta", "echo"]
    assert_schema_equal(ss["torch"].read.text(str(d)).schema,
                        ss["jax"].read.text(str(d)).schema)
    res = run_both(ss, lambda s: s.read.text(str(d)),
                   lambda df, col, sum_, count: df.filter(col("value") > "c"))
    assert assert_same(res).column("value").to_pylist() == ["charlie", "delta", "echo"]


def test_text_line_terminators_match_jax(tmp_path):
    """\\n, \\r and \\r\\n end a line; \\x0b stays inside it."""
    d = tmp_path / "txt2"
    d.mkdir()
    (d / "mixed.txt").write_text("one\r\ntwo\rthree\nfo\x0bur\r\n\nlast", newline="")
    ss = sessions(tmp_path)
    got = assert_same(run_both(ss, lambda s: s.read.text(str(d))))
    assert got.column("value").to_pylist() == ["one", "two", "three", "fo\x0bur", "", "last"]


def test_unsupported_format_refused(tmp_path):
    """Both packages refuse a format no provider builds (the JAX package's
    message also lists its delta and iceberg providers, which the port
    does not have yet)."""
    ss = sessions(tmp_path)
    for s in ss.values():
        with pytest.raises(Exception, match="got 0 of") as e:
            s.read.format("delta2").load(str(tmp_path))
        assert "'delta2'" in str(e.value)
    with pytest.raises(ht.HyperspaceException, match="Unsupported format: delta2"):
        tcolumnar.read_format([str(tmp_path / "x")], None, "delta2")


def test_reader_options_travel_with_the_relation(tmp_path):
    src = write_lake(tmp_path, "csv", parts=1)
    ss = sessions(tmp_path)
    rels = [s.read.option("header", True).csv(src).plan.relation for s in ss.values()]
    assert rels[0].options == rels[1].options == {"header": "True"}


# ---------------------------------------------------------------------------
# Partitioned csv and json.
# ---------------------------------------------------------------------------

def write_partitioned_format(root, fmt: str) -> str:
    rng = np.random.default_rng(61)
    base = root / f"part_{fmt}"
    for region in ("asia", "emea", "na"):
        for year in (2020, 2021):
            d = base / f"region={region}" / f"year={year}"
            d.mkdir(parents=True)
            t = pa.table({"id": pa.array(rng.integers(0, 10_000, 150).astype(np.int64)),
                          "amount": pa.array(np.round(rng.uniform(0, 500, 150), 2))})
            write_format(t, str(d / f"part0.{fmt}"), fmt)
    return str(base)


@pytest.mark.parametrize("fmt", ("csv", "json"))
def test_partition_discovery_and_pruning_equal_jax(tmp_path, fmt):
    src = write_partitioned_format(tmp_path, fmt)
    ss = sessions(tmp_path)

    def read(s):
        return getattr(s.read, fmt)(src)

    assert_schema_equal(read(ss["torch"]).schema, read(ss["jax"]).schema)
    assert read(ss["torch"]).schema.names == ["id", "amount", "region", "year"]
    assert_same(run_both(ss, read))
    res = run_both(ss, read, lambda df, col, sum_, count: df.filter(
        (col("region") == "emea") & (col("year") == 2021)).select("id", "amount"))
    assert files_kept(res["torch"][0]) == files_kept(res["jax"][0]) == [1]
    assert_same(res)
    res = run_both(ss, read, lambda df, col, sum_, count: df.filter(
        col("region").isin(["asia", "na"]) & (col("year") > 2020)).select(
        "id", "region", "year"))
    assert files_kept(res["torch"][0]) == [2]
    assert_same(res)
    res = run_both(ss, read, lambda df, col, sum_, count: df.select("region", "year"))
    assert assert_same(res).column_names == ["region", "year"]


# ---------------------------------------------------------------------------
# Indexes over csv, json and orc.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ("csv", "json", "orc"))
def test_covering_and_minmax_indexes_equal_jax(tmp_path, fmt):
    src = write_lake(tmp_path, fmt)
    ss = sessions(tmp_path)
    # The JAX package caches sketch tables by (name, log id) across lakes
    # (ROADMAP queue C 5).
    jskipping._SKETCH_CACHE.clear()
    for name, s in ss.items():
        pkg = hst if name == "jax" else ht
        hs = pkg.Hyperspace(s)
        df = getattr(s.read, fmt)(src)
        hs.create_index(df, pkg.IndexConfig("ok_idx", ["o_orderkey"],
                                            ["o_custkey", "o_totalprice"]))
        hs.create_index(df, pkg.DataSkippingIndexConfig(
            "od_skip", [pkg.MinMaxSketch("o_orderkey")]))
    for name in ("ok_idx", "od_skip"):
        assert normalized_log(tmp_path / "sys_torch", name) == \
            normalized_log(tmp_path / "sys_jax", name)
        got, want = data_files(tmp_path / "sys_torch", name), \
            data_files(tmp_path / "sys_jax", name)
        assert sorted(got) == sorted(want)
        for f in got:
            assert got[f].equals(want[f]), f

    def read(s):
        return getattr(s.read, fmt)(src)

    res = run_both(ss, read, lambda df, col, sum_, count: df.filter(
        col("o_orderkey") == 257).select("o_orderkey", "o_totalprice"), indexed=True)
    assert any(leaf.node_name == "IndexScan" for leaf in res["torch"][0].collect_leaves())
    assert assert_same(res).num_rows == 1
    res = run_both(ss, read, lambda df, col, sum_, count: df.filter(
        (col("o_orderkey") >= 410) & (col("o_orderkey") < 430)).select(
        "o_orderkey", "o_orderpriority"), indexed=True)
    assert files_kept(res["torch"][0]) == [1]
    assert assert_same(res).num_rows == 20


def test_lineage_over_csv_refused_as_jax(tmp_path):
    src = write_lake(tmp_path, "csv", parts=1)
    ss = sessions(tmp_path, {IndexConstants.INDEX_LINEAGE_ENABLED: "true"})
    errors = []
    for name, s in ss.items():
        pkg = hst if name == "jax" else ht
        with pytest.raises(Exception) as e:
            pkg.Hyperspace(s).create_index(s.read.csv(src),
                                           pkg.IndexConfig("lin", ["o_orderkey"], []))
        errors.append(str(e.value))
    assert errors[1] == errors[0] == "Lineage requires parquet sources in this version"


def test_csv_above_the_chunk_budget_is_read_whole(tmp_path):
    src = write_lake(tmp_path, "csv")
    ss = sessions(tmp_path, {IndexConstants.TPU_MAX_CHUNK_ROWS: "100"})
    texecutor.CHUNK_SCAN_STATS.update(max_device_rows=0, chunks=0)
    tbuffer_pool.get_pool().clear()
    tbuffer_pool.get_pool().reset_stats()
    res = run_both(ss, lambda s: s.read.csv(src), lambda df, col, sum_, count: df.filter(
        col("o_custkey") == 7).select("o_orderkey", "o_orderdate"))
    assert_same(res)
    assert texecutor.CHUNK_SCAN_STATS["chunks"] == 0
    assert tbuffer_pool.get_pool().stats()["admissions"] == 0


# ---------------------------------------------------------------------------
# Avro.
# ---------------------------------------------------------------------------

def avro_table(n=300, seed=11) -> pa.Table:
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2
    return pa.table({
        "k": pa.array(rng.integers(-2**40, 2**40, n).astype(np.int64)),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "f": pa.array(rng.standard_normal(n).astype(np.float32)),
        "x": pa.array(rng.standard_normal(n), mask=~valid),
        "b": pa.array(rng.random(n) > 0.5),
        "s": pa.array([f"v{j}é" if valid[j] else None for j in range(n)]),
        "d": pa.array(rng.integers(-400, 20000, n).astype(np.int32), pa.int32()).cast(
            pa.date32()),
        "raw": pa.array([bytes([j % 256, 7]) for j in range(n)], pa.binary()),
    })


@pytest.mark.parametrize("codec", ("null", "deflate"))
def test_avro_bytes_equal_jax_writer(tmp_path, codec):
    table = avro_table()
    jpath, tpath = str(tmp_path / "j.avro"), str(tmp_path / "t.avro")
    javro.write_avro(table, jpath, codec=codec, block_rows=64)
    tavro.write_avro(table, tpath, codec=codec, block_rows=64)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    got = tavro.read_avro(tpath)
    assert got.equals(javro.read_avro(jpath))
    assert got.equals(table)
    assert tavro.read_avro_schema(tpath) == javro.read_avro_schema(jpath)
    assert tavro.read_avro(tpath, ["s", "k"]).equals(javro.read_avro(jpath, ["s", "k"]))


def test_avro_errors_equal_jax(tmp_path):
    bad = tmp_path / "bad.avro"
    bad.write_bytes(b"NotAvro")
    messages = []
    for mod in (javro, tavro):
        with pytest.raises(Exception) as e:
            mod.read_avro(str(bad))
        messages.append(str(e.value))
        with pytest.raises(Exception) as e:
            mod.write_avro(avro_table(5), str(tmp_path / "x.avro"), codec="snappy")
        messages.append(str(e.value))
    assert messages[:2] == messages[2:]


def test_avro_index_and_query_equal_jax(tmp_path):
    src = write_lake(tmp_path, "avro")
    ss = sessions(tmp_path)
    for name, s in ss.items():
        pkg = hst if name == "jax" else ht
        pkg.Hyperspace(s).create_index(s.read.avro(src), pkg.IndexConfig(
            "av_idx", ["o_custkey"], ["o_totalprice"]))
    assert normalized_log(tmp_path / "sys_torch", "av_idx") == \
        normalized_log(tmp_path / "sys_jax", "av_idx")
    res = run_both(ss, lambda s: s.read.avro(src), lambda df, col, sum_, count: df.filter(
        col("o_custkey") == 3).select("o_custkey", "o_totalprice"), indexed=True)
    assert assert_same(res).num_rows > 0


# ---------------------------------------------------------------------------
# The footer memo.
# ---------------------------------------------------------------------------

def test_footer_memo_sees_rewrites_and_opens_each_footer_once(tmp_path, monkeypatch):
    path = str(tmp_path / "f.parquet")
    other = str(tmp_path / "g.parquet")
    pq.write_table(pa.table({"a": np.arange(10)}), path)
    pq.write_table(pa.table({"a": np.arange(3)}), other)
    opens = []
    real = tcolumnar.pq.ParquetFile

    def counting(p, *args, **kwargs):
        opens.append(p)
        return real(p, *args, **kwargs)

    monkeypatch.setattr(tcolumnar.pq, "ParquetFile", counting)
    assert tcolumnar.parquet_row_counts([path, other]) == [10, 3]
    assert tcolumnar.parquet_row_counts([path, other]) == [10, 3]
    assert sorted(opens) == sorted([path, other])
    st = os.stat(path)
    pq.write_table(pa.table({"a": np.arange(25)}), path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))  # same mtime, new size
    assert tcolumnar.parquet_row_counts([path, other]) == [25, 3]
    assert opens.count(path) == 2 and opens.count(other) == 1


def test_date_literal_filter_over_csv(tmp_path):
    src = write_lake(tmp_path, "csv")
    ss = sessions(tmp_path)
    res = run_both(ss, lambda s: s.read.csv(src), lambda df, col, sum_, count: df.filter(
        col("o_orderdate").between(datetime.date(1995, 1, 1), datetime.date(1996, 12, 31)))
        .select("o_orderkey", "o_orderdate"))
    assert assert_same(res).num_rows > 0
