"""The whole slice -- two covering-index builds and three indexed filter
queries over TPC-H lineitem -- through both packages' public entry points
on the same small files, compared exactly: bucket file names and contents,
the op log, and every query's ``to_arrow()``, indexed and scanned.

The lineitem files come from bench.py's generator. chip_smoke.py carries
its own copy of that generator (the port imports nothing of the JAX side),
and a test here holds the copy to the original.
"""

import datetime
import os

import pyarrow.parquet as pq
import pytest

import bench
import chip_smoke
import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.index.log_manager import IndexLogManager as JLogManager
from hyperspace_tpu.plan.expr import col as jcol
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.constants import IndexConstants, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager as TLogManager
from hyperspace_tpu_torch.ops import cuda_kernels

SCALE = 0.002  # 12,000 lineitem rows in 4 files.

INDEXES = {
    "li_idx": (["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"], 32),
    "li_ship_idx": (["l_shipdate"], ["l_orderkey", "l_extendedprice"], 8),
}

CONF = {
    IndexConstants.INDEX_FILTER_RULE_USE_BUCKET_SPEC: "true",
    # conftest gives JAX 8 virtual devices, which would take its mesh build.
    "hyperspace.tpu.distributed.enabled": "false",
}


def build_all(pkg, session, li_dir: str, n_li: int) -> None:
    session.conf.set(IndexConstants.INDEX_ROW_GROUP_SIZE, max(4096, int(n_li / 32 / 8)))
    hs = pkg.Hyperspace(session)
    li = session.read.parquet(li_dir)
    for name, (indexed, included, buckets) in INDEXES.items():
        session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, buckets)
        hs.create_index(li, pkg.IndexConfig(name, indexed, included))


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    li_dir, _, _, n_li, _ = bench.make_tpch_like(str(root / "data"), SCALE)
    jax_session = hst.Session(conf=dict(CONF), system_path=str(root / "jax_indexes"))
    torch_session = ht.Session(conf=dict(CONF), system_path=str(root / "torch_indexes"),
                               device="cpu")
    build_all(hst, jax_session, li_dir, n_li)
    build_all(ht, torch_session, li_dir, n_li)
    key = pq.read_table(os.path.join(li_dir, "part0.parquet")).column("l_orderkey")[7].as_py()
    return {"root": root, "li_dir": li_dir, "n_li": n_li, "key": key,
            "jax": jax_session, "torch": torch_session}


def index_files(system_path, name):
    return sorted(os.listdir(os.path.join(system_path, name, "v__=0")))


@pytest.mark.parametrize("name", sorted(INDEXES))
def test_bucket_files_equal(lake, name):
    jdir = os.path.join(lake["root"], "jax_indexes", name, "v__=0")
    tdir = os.path.join(lake["root"], "torch_indexes", name, "v__=0")
    files = index_files(lake["root"] / "jax_indexes", name)
    assert files == index_files(lake["root"] / "torch_indexes", name)
    assert len(files) == INDEXES[name][2]  # every bucket non-empty at this size
    for f in files:
        want = pq.read_table(os.path.join(jdir, f))
        got = pq.read_table(os.path.join(tdir, f))
        assert got.equals(want), f
        assert pq.ParquetFile(os.path.join(tdir, f)).metadata.num_row_groups == \
            pq.ParquetFile(os.path.join(jdir, f)).metadata.num_row_groups


@pytest.mark.parametrize("name", sorted(INDEXES))
def test_jax_log_manager_reads_port_entry(lake, name):
    path = os.path.join(lake["root"], "torch_indexes", name)
    entry = JLogManager(path).get_latest_stable_log()
    assert entry.state == "ACTIVE" and entry.name == name
    assert entry.derivedDataset.kind == "CoveringIndex"
    assert list(entry.indexed_columns) == INDEXES[name][0]
    assert entry.num_buckets == INDEXES[name][2]
    assert sorted(os.path.basename(f) for f in entry.content.files) == \
        index_files(lake["root"] / "torch_indexes", name)
    # Same source fingerprint as the JAX package computes for the source.
    jentry = JLogManager(os.path.join(lake["root"], "jax_indexes", name)) \
        .get_latest_stable_log()
    assert entry.signature.signatures[0].value == jentry.signature.signatures[0].value
    assert entry.schema == jentry.schema


@pytest.mark.parametrize("name", sorted(INDEXES))
def test_port_reads_jax_log_entry(lake, name):
    entry = TLogManager(os.path.join(lake["root"], "jax_indexes", name)) \
        .get_latest_stable_log()
    assert entry.state == States.ACTIVE and entry.num_buckets == INDEXES[name][2]


def queries(pkg_col, df, key):
    return {
        "range": (df.filter(pkg_col("l_shipdate").between(
            datetime.date(1995, 3, 1), datetime.date(1995, 3, 31)))
            .select("l_orderkey", "l_extendedprice"), "li_ship_idx"),
        "cutoff": (df.filter(pkg_col("l_shipdate") > datetime.date(1995, 3, 15))
                   .select("l_orderkey", "l_extendedprice"), "li_ship_idx"),
        "point": (df.filter(pkg_col("l_orderkey") == key)
                  .select("l_extendedprice", "l_discount"), "li_idx"),
    }


def run_query(lake, pkg: str, name: str, indexed: bool):
    session = lake[pkg]
    col = jcol if pkg == "jax" else ht.col
    df, index_name = queries(col, session.read.parquet(lake["li_dir"]), lake["key"])[name]
    if indexed:
        session.enable_hyperspace()
    try:
        leaves = [leaf.simple_string() for leaf in df.optimized_plan().collect_leaves()]
        return df.to_arrow(), leaves, index_name
    finally:
        session.disable_hyperspace()


@pytest.mark.parametrize("indexed", [True, False])
@pytest.mark.parametrize("name", ["range", "cutoff", "point"])
def test_query_results_equal_across_packages(lake, name, indexed):
    got, leaves, index_name = run_query(lake, "torch", name, indexed)
    want, jleaves, _ = run_query(lake, "jax", name, indexed)
    assert got.equals(want)
    assert got.num_rows > 0
    if indexed:
        assert any(f"Name: {index_name}," in s for s in leaves), leaves
        assert any(f"Name: {index_name}," in s for s in jleaves), jleaves
    else:
        assert not any("IndexScan" in s for s in leaves)


@pytest.mark.parametrize("name", ["range", "cutoff", "point"])
def test_indexed_equals_scanned(lake, name):
    indexed, _, _ = run_query(lake, "torch", name, True)
    scanned, _, _ = run_query(lake, "torch", name, False)
    keys = [(c, "ascending") for c in indexed.column_names]
    assert indexed.sort_by(keys).equals(scanned.sort_by(keys))


def test_point_query_prunes_to_one_bucket(lake, monkeypatch):
    from hyperspace_tpu_torch.execution import executor
    read = []
    real = executor.read_parquet
    monkeypatch.setattr(executor, "read_parquet",
                        lambda files, *a, **k: read.append(list(files)) or real(files, *a, **k))
    run_query(lake, "torch", "point", True)
    assert len(read) == 1 and len(read[0]) == 1
    assert os.path.basename(read[0][0]).startswith("part-")


def test_kernels_take_the_cpu_path(lake):
    cuda_kernels.reset_launches()
    run_query(lake, "torch", "range", True)
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())


def test_chunked_build_is_refused_not_built_in_memory(lake, tmp_path):
    """A source above the device budget is no longer refused: it streams
    through the chunked build (never more rows on the device than the
    budget), and its bucket files equal the JAX package's at that budget."""
    from hyperspace_tpu_torch.ops import index_build
    budget = lake["n_li"] - 1
    index_build.CHUNK_STATS["max_device_rows"] = 0
    for pkg, sub in ((ht, "torch"), (hst, "jax")):
        kw = {"device": "cpu"} if pkg is ht else {}
        session = pkg.Session(conf=dict(CONF), system_path=str(tmp_path / sub), **kw)
        session.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, budget)
        pkg.Hyperspace(session).create_index(session.read.parquet(lake["li_dir"]),
                                             pkg.IndexConfig("big", ["l_orderkey"]))
    assert 0 < index_build.CHUNK_STATS["max_device_rows"] <= budget
    files = sorted(os.listdir(tmp_path / "jax" / "big" / "v__=0"))
    assert files == sorted(os.listdir(tmp_path / "torch" / "big" / "v__=0")) and files
    for f in files:
        assert pq.read_table(tmp_path / "torch" / "big" / "v__=0" / f).equals(
            pq.read_table(tmp_path / "jax" / "big" / "v__=0" / f)), f


def test_delete_and_vacuum(lake, tmp_path):
    session = ht.Session(conf=dict(CONF), system_path=str(tmp_path / "ix"), device="cpu")
    hs = ht.Hyperspace(session)
    li = session.read.parquet(lake["li_dir"])
    hs.create_index(li, ht.IndexConfig("tmp_idx", ["l_shipdate"], ["l_orderkey"]))
    with pytest.raises(HyperspaceException, match="already exists"):
        hs.create_index(li, ht.IndexConfig("tmp_idx", ["l_shipdate"]))
    hs.delete_index("tmp_idx")
    assert hs.index_manager.get_index("tmp_idx").state == States.DELETED
    session.enable_hyperspace()
    df = li.filter(ht.col("l_shipdate") > datetime.date(1995, 3, 15)).select("l_orderkey")
    assert not any("IndexScan" in leaf.simple_string()
                   for leaf in df.optimized_plan().collect_leaves())
    hs.vacuum_index("tmp_idx")
    assert hs.index_manager.get_index("tmp_idx").state == States.DOESNOTEXIST
    assert not os.path.exists(tmp_path / "ix" / "tmp_idx" / "v__=0")


def test_chip_smoke_generator_matches_bench(lake, tmp_path):
    li_dir, od_dir, pt_dir, n_li, n_od = chip_smoke.make_tpch(str(tmp_path), SCALE)
    assert n_li == lake["n_li"] and n_od == n_li // 4
    bench_dir = os.path.dirname(lake["li_dir"])
    for got_dir, want_dir, n_files in ((li_dir, lake["li_dir"], 4),
                                       (od_dir, os.path.join(bench_dir, "orders"),
                                        chip_smoke.ORDERS_PARTS),
                                       (pt_dir, os.path.join(bench_dir, "part"), 1)):
        names = sorted(os.listdir(want_dir))
        assert names == sorted(os.listdir(got_dir)) and len(names) == n_files
        for f in names:
            assert pq.read_table(os.path.join(got_dir, f)).equals(
                pq.read_table(os.path.join(want_dir, f))), f


def test_chip_smoke_append_matches_bench(lake, tmp_path):
    """chip_smoke.py's copy of BASELINE config #5's append equals bench.py's."""
    for sub, fn in (("bench", bench.append_lineitem_files),
                    ("smoke", chip_smoke.append_lineitem_files)):
        os.makedirs(tmp_path / sub)
        assert fn(str(tmp_path / sub), lake["n_li"]) == max(lake["n_li"] // 20, 1000)
    got = pq.read_table(tmp_path / "smoke" / "part-appended.parquet")
    assert got.equals(pq.read_table(tmp_path / "bench" / "part-appended.parquet"))
    assert got.num_rows == 1000
