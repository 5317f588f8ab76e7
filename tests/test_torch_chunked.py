"""The chunked routes against the JAX package's and against the port's own
in-memory routes, on the same numpy-seeded files, exactly:

- the chunked covering build (budgets 97, 1000 and above the source;
  lineage on and off; 1, 4 and 7 buckets; a string included column with
  nulls): bucket files equal the JAX package's chunked files and the
  port's in-memory build, and no chunk holds more rows than the budget;
- the chunked filtered scan and the chunked filtered index scan (Hybrid
  Scan with appended and deleted files too): results equal the in-memory
  route and the JAX package's, row for row.
"""

import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import executor as jexecutor
from hyperspace_tpu.plan.expr import col as jcol
from hyperspace_tpu_torch.execution import executor as texecutor
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.ops import index_build

CONF = {
    # conftest gives JAX 8 virtual devices, which would take its mesh build.
    "hyperspace.tpu.distributed.enabled": "false",
    IndexConstants.INDEX_ROW_GROUP_SIZE: "64",
}
FILES, ROWS = 4, 150  # 600 source rows.


def write_source(src: str, i: int, rows: int = ROWS) -> str:
    """Source file i: int64 keys with repeats, a float, a string with
    nulls and a date; small row groups so the chunk stream crosses them."""
    rng = np.random.default_rng(100 + i)
    os.makedirs(src, exist_ok=True)
    path = os.path.join(src, f"f{i:02d}.parquet")
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(-50, 200, rows).astype(np.int64)),
        "v": pa.array(np.round(rng.uniform(-100, 100, rows), 3)),
        "s": pa.array(rng.choice(["ab", "c", "", "zz", "q"], rows),
                      mask=rng.random(rows) < 0.1),
        "d": pa.array(rng.integers(9000, 9200, rows).astype(np.int32),
                      type=pa.int32()).cast(pa.date32()),
    }), path, row_group_size=40)
    return path


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("chunked") / "src")
    for i in range(FILES):
        write_source(src, i)
    return src


def session_pair(root, conf):
    jax_s = hst.Session(conf=dict(CONF, **conf), system_path=str(root / "sys_jax"))
    torch_s = ht.Session(conf=dict(CONF, **conf), system_path=str(root / "sys_torch"),
                         device="cpu")
    return jax_s, torch_s


def index_dir_tables(system_path, name, version=0) -> dict:
    d = os.path.join(system_path, name, f"v__={version}")
    return {f: pq.ParquetFile(os.path.join(d, f)).read() for f in sorted(os.listdir(d))}


def assert_same_files(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b) and a
    for f in a:
        assert a[f].equals(b[f]), f


@pytest.mark.parametrize("buckets", [1, 4, 7])
@pytest.mark.parametrize("lineage", [False, True])
@pytest.mark.parametrize("budget", [97, 1000, FILES * ROWS + 1])
def test_chunked_build_matches(source, tmp_path, budget, lineage, buckets):
    conf = {IndexConstants.TPU_MAX_CHUNK_ROWS: budget,
            IndexConstants.INDEX_NUM_BUCKETS: buckets,
            IndexConstants.INDEX_LINEAGE_ENABLED: str(lineage).lower()}
    jax_s, torch_s = session_pair(tmp_path, conf)
    index_build.CHUNK_STATS.update(max_device_rows=0, chunks=0)
    for pkg, s in ((hst, jax_s), (ht, torch_s)):
        pkg.Hyperspace(s).create_index(s.read.parquet(source),
                                       pkg.IndexConfig("ix", ["k"], ["s", "v"]))
    got = index_dir_tables(tmp_path / "sys_torch", "ix")
    assert_same_files(got, index_dir_tables(tmp_path / "sys_jax", "ix"))
    chunked = budget < FILES * ROWS
    assert index_build.CHUNK_STATS["chunks"] == (-(-FILES * ROWS // budget) if chunked else 0)
    # A batch packs whole buckets up to the budget; a bucket larger than
    # the budget is a batch alone (as in the JAX package).
    largest_bucket = max(t.num_rows for t in got.values())
    assert index_build.CHUNK_STATS["max_device_rows"] <= max(budget, largest_bucket)
    if largest_bucket <= budget:
        assert index_build.CHUNK_STATS["max_device_rows"] <= budget
    # The port's in-memory build writes the same files.
    mem = ht.Session(conf=dict(CONF, **conf), system_path=str(tmp_path / "sys_mem"),
                     device="cpu")
    mem.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, FILES * ROWS)
    ht.Hyperspace(mem).create_index(mem.read.parquet(source),
                                    ht.IndexConfig("ix", ["k"], ["s", "v"]))
    assert_same_files(got, index_dir_tables(tmp_path / "sys_mem", "ix"))
    names = got[sorted(got)[0]].column_names
    assert names == (["k", "s", "v", IndexConstants.DATA_FILE_NAME_ID] if lineage
                     else ["k", "s", "v"])
    assert sum(t.num_rows for t in got.values()) == FILES * ROWS


def test_chunked_build_two_indexed_columns_and_dates(source, tmp_path):
    conf = {IndexConstants.TPU_MAX_CHUNK_ROWS: 130, IndexConstants.INDEX_NUM_BUCKETS: 5}
    jax_s, torch_s = session_pair(tmp_path, conf)
    for pkg, s in ((hst, jax_s), (ht, torch_s)):
        pkg.Hyperspace(s).create_index(s.read.parquet(source),
                                       pkg.IndexConfig("ix", ["d", "s"], ["k"]))
    assert_same_files(index_dir_tables(tmp_path / "sys_torch", "ix"),
                      index_dir_tables(tmp_path / "sys_jax", "ix"))


def test_spill_directory_removed_on_failure(source, tmp_path, monkeypatch):
    made = []
    real = index_build.tempfile.mkdtemp

    def mkdtemp(**kw):
        made.append(real(**kw))
        return made[-1]

    def broken(*a, **k):
        raise RuntimeError("write failed")

    monkeypatch.setattr(index_build.tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(index_build, "_write_batch", broken)
    s = ht.Session(conf=dict(CONF, **{IndexConstants.TPU_MAX_CHUNK_ROWS: 100}),
                   system_path=str(tmp_path / "sys"), device="cpu")
    with pytest.raises(RuntimeError, match="write failed"):
        ht.Hyperspace(s).create_index(s.read.parquet(source), ht.IndexConfig("ix", ["k"]))
    assert len(made) == 1 and not os.path.exists(made[0])


# ---------------------------------------------------------------------------
# Chunked scans.
# ---------------------------------------------------------------------------

def query(pkg, session, source, kind: str):
    c = jcol if pkg is hst else ht.col
    df = session.read.parquet(source)
    if kind == "range":
        return df.filter(c("d").between(datetime.date(1994, 9, 1),
                                        datetime.date(1995, 1, 10))).select("k", "s", "d")
    if kind == "point":
        return df.filter(c("k") == 7).select("k", "s")
    return df.filter(c("k") > 120).select("k", "v")


def run(pkg, session, source, kind, indexed):
    df = query(pkg, session, source, kind)
    (session.enable_hyperspace if indexed else session.disable_hyperspace)()
    try:
        return df.optimized_plan().tree_string(), df.to_arrow()
    finally:
        session.disable_hyperspace()


@pytest.fixture(scope="module")
def scan_lake(tmp_path_factory):
    """Two covering indexes with lineage over six files, then one file
    deleted and two appended (within both Hybrid Scan thresholds): under
    Hybrid Scan the index scans carry both changes."""
    root = tmp_path_factory.mktemp("scans")
    src = str(root / "src")
    for i in range(6):
        write_source(src, i, 120)
    conf = {IndexConstants.INDEX_LINEAGE_ENABLED: "true", IndexConstants.INDEX_NUM_BUCKETS: 4,
            IndexConstants.INDEX_FILTER_RULE_USE_BUCKET_SPEC: "true"}
    jax_s, torch_s = session_pair(root, conf)
    for pkg, s in ((hst, jax_s), (ht, torch_s)):
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(src), pkg.IndexConfig("k_idx", ["k"], ["s", "v", "d"]))
        hs.create_index(s.read.parquet(src), pkg.IndexConfig("d_idx", ["d"], ["k", "s"]))
    os.remove(os.path.join(src, "f01.parquet"))
    write_source(src, 7, 60)
    write_source(src, 8, 50)
    return {"src": src, "jax": jax_s, "torch": torch_s}


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("kind", ["range", "point", "cutoff"])
def test_chunked_scans_match(scan_lake, kind, indexed, hybrid):
    src = scan_lake["src"]
    results = {}
    for budget in (73, 10_000):
        for name in ("jax", "torch"):
            s = scan_lake[name]
            s.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, budget)
            s.conf.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, str(hybrid).lower())
            results[(budget, name)] = run(hst if name == "jax" else ht, s, src, kind, indexed)
    texecutor.CHUNK_SCAN_STATS.update(max_device_rows=0, chunks=0)
    scan_lake["torch"].conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, 73)
    run(ht, scan_lake["torch"], src, kind, indexed)
    if indexed and not hybrid:
        # The source changed: without Hybrid Scan no index applies.
        assert "IndexScan" not in results[(73, "torch")][0]
    if indexed and hybrid:
        assert "hybrid(+2 appended, -1 deleted files)" in results[(73, "torch")][0]
    assert texecutor.CHUNK_SCAN_STATS["chunks"] >= 1
    assert 0 < texecutor.CHUNK_SCAN_STATS["max_device_rows"] <= 73
    chunked_plan, chunked = results[(73, "torch")]
    assert chunked.num_rows > 0
    for key in ((10_000, "torch"), (73, "jax"), (10_000, "jax")):
        plan, table = results[key]
        assert plan == chunked_plan, key
        assert table.equals(chunked), key


def test_chunked_index_scan_keeps_bucket_order_for_the_merge(scan_lake):
    """The hybrid index scan's appended survivors merge into the chunked
    stream's bucket order, as in the JAX package."""
    s = scan_lake["torch"]
    s.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, 73)
    s.conf.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    js = scan_lake["jax"]
    js.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, 73)
    js.conf.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    before = (texecutor.HYBRID_MERGE_COUNT, jexecutor.HYBRID_MERGE_COUNT)
    _, got = run(ht, s, scan_lake["src"], "cutoff", True)
    _, want = run(hst, js, scan_lake["src"], "cutoff", True)
    assert got.equals(want)
    assert texecutor.HYBRID_MERGE_COUNT - before[0] == 1
    assert jexecutor.HYBRID_MERGE_COUNT - before[1] == 1


def test_chunk_stats_keep_every_update_under_threads():
    """Concurrent builds and scans update the footprint counters under a
    lock: eight threads with a short switch interval lose no update."""
    import sys
    import threading

    index_build.CHUNK_STATS.update(max_device_rows=0, chunks=0, spill_bytes=0)
    texecutor.CHUNK_SCAN_STATS.update(max_device_rows=0, chunks=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(t):
        for i in range(2000):
            index_build._bump_chunk_stat("chunks", 1)
            index_build._note_device_rows(t * 10_000 + i)
            texecutor._note_chunk_scan(t * 10_000 + i)

    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert index_build.CHUNK_STATS["chunks"] == 16_000
    assert texecutor.CHUNK_SCAN_STATS["chunks"] == 16_000
    assert index_build.CHUNK_STATS["max_device_rows"] == 71_999
    assert texecutor.CHUNK_SCAN_STATS["max_device_rows"] == 71_999
