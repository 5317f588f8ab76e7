"""Index mutability through both packages' public entry points, on the
same numpy-seeded files, compared exactly: the op log (every entry, with
the index directory's name and the index files' mtimes normalized), every
index data file, plan tree strings and ``to_arrow()`` results, row for row.

Covered: lineage hidden from query columns; full, incremental and quick
refresh over appends, deletes and both, with and without lineage (and
their errors and no-op); optimize quick and full; the data-skipping
refreshes; restore and cancel; Hybrid Scan within and over each threshold;
the order-preserving merge of appended rows and its decline at keys that
do not fit 32 bits; the shuffle-free join after appends; each package
querying indexes the other created and refreshed.
"""

import datetime
import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings, strategies as st

import hyperspace_tpu as hst
from hyperspace_tpu import api as jax_api
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import executor as jexecutor
from hyperspace_tpu.plan.expr import col as jcol
from hyperspace_tpu.rules import data_skipping_rule as jax_skipping_rule
from hyperspace_tpu_torch.actions.refresh import RefreshIncrementalAction
from hyperspace_tpu_torch.execution import executor as texecutor
from hyperspace_tpu_torch.index.constants import IndexConstants, States
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_manager import IndexLogManager

BASE_CONF = {
    # conftest gives JAX 8 virtual devices, which would take its mesh build.
    "hyperspace.tpu.distributed.enabled": "false",
    # The JAX package's fused path executes a bucket-ordered IndexScan and
    # then falls back to the staged one, which the port's executor is:
    # off, its merge and fast-join counters count each query once.
    "hyperspace.tpu.execution.fusion.enabled": "false",
    IndexConstants.INDEX_NUM_BUCKETS: "4",
    IndexConstants.INDEX_ROW_GROUP_SIZE: "64",
}
LINEAGE = {IndexConstants.INDEX_LINEAGE_ENABLED: "true"}
HYBRID = IndexConstants.INDEX_HYBRID_SCAN_ENABLED


def write_source(src: str, i: int, rows: int = 100, keys=None) -> str:
    """Source file i: int64 key with repeats (or the given keys), a float,
    a string with nulls and a date in a range of its own (so MinMax
    sketches prune files)."""
    rng = np.random.default_rng(200 + i)
    os.makedirs(src, exist_ok=True)
    k = np.asarray(keys, np.int64) if keys is not None else \
        rng.integers(0, 120, rows).astype(np.int64)
    n = len(k)
    path = os.path.join(src, f"f{i:02d}.parquet")
    pq.write_table(pa.table({
        "k": pa.array(k),
        "v": pa.array(np.round(rng.uniform(-100, 100, n), 3)),
        "s": pa.array(rng.choice(["ab", "c", "", "zz"], n), mask=rng.random(n) < 0.1),
        "d": pa.array(rng.integers(9000 + 30 * i, 9030 + 30 * i, n).astype(np.int32),
                      type=pa.int32()).cast(pa.date32()),
    }), path)
    return path


class Pair:
    """One JAX session and one port session over the same source files,
    each with its own system path."""

    def __init__(self, root, conf=None, files=4):
        self.root = root
        self.src = str(root / "src")
        if files:
            for i in range(files):
                write_source(self.src, i)
        c = dict(BASE_CONF, **(conf or {}))
        self.sessions = {
            "jax": hst.Session(conf=dict(c), system_path=str(root / "sys_jax")),
            "torch": ht.Session(conf=dict(c), system_path=str(root / "sys_torch"),
                                device="cpu")}

    def pkg(self, name):
        return hst if name == "jax" else ht

    def hs(self, name):
        return self.pkg(name).Hyperspace(self.sessions[name])

    def each(self, fn):
        """fn(pkg, session, hyperspace) in both packages; the results."""
        return {n: fn(self.pkg(n), s, self.hs(n)) for n, s in self.sessions.items()}

    def set(self, key, value):
        for s in self.sessions.values():
            s.conf.set(key, value)

    def create(self, name="ix", indexed=("k",), included=("s", "v")):
        self.each(lambda pkg, s, hs: hs.create_index(
            s.read.parquet(self.src), pkg.IndexConfig(name, list(indexed), list(included))))

    def query(self, build, hybrid=False, indexed=True):
        """(plan tree string, arrow result) per package."""
        def run(pkg, s, hs):
            s.conf.set(HYBRID, str(hybrid).lower())
            df = build(s.read.parquet(self.src), jcol if pkg is hst else ht.col)
            (s.enable_hyperspace if indexed else s.disable_hyperspace)()
            try:
                return df.optimized_plan().tree_string(), df.to_arrow()
            finally:
                s.disable_hyperspace()
                s.conf.set(HYBRID, "false")
        return self.each(run)


def normalized_log(system_path, name) -> list:
    """Every op-log entry of an index, with the system path's own name, the
    signature provider's module (each package names its own) and the index
    files' mtimes and entry timestamps (which differ between two builds)
    normalized."""
    log_dir = os.path.join(system_path, name, IndexConstants.HYPERSPACE_LOG)
    ids = sorted(int(f) for f in os.listdir(log_dir) if f.isdigit())
    out = []
    for i in ids:
        with open(os.path.join(log_dir, str(i))) as f:
            entry = json.load(f)
        entry["timestamp"] = 0

        def walk(node):
            if isinstance(node, dict):
                if "modifiedTime" in node and (str(node.get("name", "")).startswith("part-")
                                               or node.get("name") == "sketches.parquet"):
                    node["modifiedTime"] = 0
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)
        walk(entry)
        out.append(json.dumps(entry, sort_keys=False)
                   .replace(os.path.basename(str(system_path)), "SYS")
                   .replace('"hyperspace_tpu_torch.index.', '"hyperspace_tpu.index.'))
    return out


def data_files(system_path, name) -> dict:
    base = os.path.join(system_path, name)
    out = {}
    for d in sorted(os.listdir(base)):
        if d.startswith("v__="):
            for f in sorted(os.listdir(os.path.join(base, d))):
                out[f"{d}/{f}"] = pq.ParquetFile(os.path.join(base, d, f)).read()
    return out


def assert_index_equal(pair: Pair, name="ix") -> None:
    jsys, tsys = pair.root / "sys_jax", pair.root / "sys_torch"
    assert normalized_log(tsys, name) == normalized_log(jsys, name)
    got, want = data_files(tsys, name), data_files(jsys, name)
    assert sorted(got) == sorted(want)
    for f in got:
        assert got[f].equals(want[f]), f


def assert_queries_equal(results: dict) -> None:
    (jplan, jtable), (tplan, ttable) = results["jax"], results["torch"]
    assert tplan == jplan
    assert ttable.column_names == jtable.column_names
    assert ttable.equals(jtable)


def point(df, c):
    return df.filter(c("k") == 7).select("k", "s", "v")


def cutoff(df, c):
    return df.filter(c("k") > 60).select("k", "s", "v")


def wide(df, c):
    return df.filter(c("k") != 3).select("k", "s", "v")


# ---------------------------------------------------------------------------
# F1: the lineage column stays out of query results.
# ---------------------------------------------------------------------------

def test_lineage_column_hidden_from_query(tmp_path):
    """The JAX package builds with lineage and refreshes twice; the port,
    querying the same system path, returns the JAX package's columns,
    values and row order (it used to add ``_data_file_id``)."""
    pair = Pair(tmp_path, LINEAGE)
    jhs = pair.hs("jax")
    jhs.create_index(pair.sessions["jax"].read.parquet(pair.src),
                     hst.IndexConfig("ix", ["k"], ["v", "s", "d"]))
    # The port's session caches its index list as the JAX package's does;
    # expiring it at once lets the port see the JAX session's refreshes.
    port = ht.Session(conf=dict(BASE_CONF,
                                **{IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS: "0"}),
                      system_path=str(tmp_path / "sys_jax"), device="cpu")

    def both():
        out = {}
        for name, s, pkg in (("jax", pair.sessions["jax"], hst), ("torch", port, ht)):
            df = s.read.parquet(pair.src).filter((jcol if pkg is hst else ht.col)("k") == 5)
            s.enable_hyperspace()
            out[name] = (df.optimized_plan().tree_string(), df.to_arrow())
            s.disable_hyperspace()
        return out

    res = both()
    assert res["torch"][1].column_names == ["k", "v", "s", "d"]
    assert_queries_equal(res)
    for i in (10, 11):
        write_source(pair.src, i, 40)
        jhs.refresh_index("ix", "incremental")
    res = both()
    assert "IndexScan" in res["torch"][0] and res["torch"][1].num_rows > 0
    assert_queries_equal(res)


# ---------------------------------------------------------------------------
# Refresh.
# ---------------------------------------------------------------------------

def apply_change(pair: Pair, change: str) -> None:
    if change in ("deletes", "both"):
        os.remove(os.path.join(pair.src, "f01.parquet"))
    if change in ("appends", "both"):
        write_source(pair.src, 10, 30)
        write_source(pair.src, 11, 20)


@pytest.mark.parametrize("lineage", [True, False])
@pytest.mark.parametrize("change", ["appends", "deletes", "both"])
@pytest.mark.parametrize("mode", ["full", "incremental", "quick"])
def test_refresh_matches(tmp_path, mode, change, lineage):
    # One file of six deleted stays within the Hybrid Scan threshold.
    pair = Pair(tmp_path, LINEAGE if lineage else {}, files=6)
    pair.create()
    apply_change(pair, change)
    if change != "appends" and mode != "full" and not lineage:
        errors = {}
        for name in ("jax", "torch"):
            with pytest.raises(Exception, match="only supported on an index with lineage") \
                    as info:
                pair.hs(name).refresh_index("ix", mode)
            errors[name] = str(info.value)
        assert errors["torch"] == errors["jax"]
        assert isinstance(info.value, ht.HyperspaceException)
        assert_index_equal(pair)
        return
    pair.each(lambda pkg, s, hs: hs.refresh_index("ix", mode))
    assert_index_equal(pair)
    entry = IndexLogManager(str(tmp_path / "sys_torch" / "ix")).get_latest_stable_log()
    assert entry.state == States.ACTIVE
    if mode == "quick":
        assert len(IndexDataManager(str(tmp_path / "sys_torch" / "ix"))
                   .get_all_version_ids()) == 1
        assert bool(entry.appended_files) == (change != "deletes")
        assert bool(entry.deleted_files) == (change != "appends")
    for hybrid in (False, True):
        for build in (point, cutoff):
            res = pair.query(build, hybrid=hybrid)
            assert_queries_equal(res)
            if mode != "quick" or hybrid:
                assert "IndexScan" in res["torch"][0]
    scanned = pair.query(wide, indexed=False)["torch"][1]
    indexed = pair.query(wide, hybrid=True)["torch"][1]
    assert indexed.sort_by([("k", "ascending"), ("v", "ascending")]).equals(
        scanned.sort_by([("k", "ascending"), ("v", "ascending")]))


def test_refresh_without_changes_is_a_no_op(tmp_path):
    pair = Pair(tmp_path, LINEAGE)
    pair.create()
    pair.each(lambda pkg, s, hs: hs.create_index(
        s.read.parquet(pair.src), pkg.DataSkippingIndexConfig("sk", [pkg.MinMaxSketch("d")])))
    before = {n: normalized_log(tmp_path / "sys_torch", n) for n in ("ix", "sk")}
    for mode in ("full", "incremental", "quick"):
        pair.each(lambda pkg, s, hs: hs.refresh_index("ix", mode))
    for mode in ("full", "incremental"):
        pair.each(lambda pkg, s, hs: hs.refresh_index("sk", mode))
    assert {n: normalized_log(tmp_path / "sys_torch", n) for n in ("ix", "sk")} == before
    assert_index_equal(pair)
    assert_index_equal(pair, "sk")


def test_refresh_mode_validation(tmp_path):
    pair = Pair(tmp_path)
    pair.create()
    pair.each(lambda pkg, s, hs: hs.create_index(
        s.read.parquet(pair.src), pkg.DataSkippingIndexConfig("sk", [pkg.MinMaxSketch("d")])))
    for index, mode, message in (("ix", "sideways", "Unsupported refresh mode"),
                                 ("sk", "quick", "Quick refresh is not supported")):
        errors = {}
        for name in ("jax", "torch"):
            with pytest.raises(Exception, match=message) as info:
                pair.hs(name).refresh_index(index, mode)
            errors[name] = str(info.value)
        assert errors["torch"] == errors["jax"]
    errors = {}
    for name in ("jax", "torch"):
        with pytest.raises(Exception, match="Unsupported optimize mode") as info:
            pair.hs(name).optimize_index("ix", "sideways")
        errors[name] = str(info.value)
    assert errors["torch"] == errors["jax"]


# ---------------------------------------------------------------------------
# Optimize.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["quick", "full"])
def test_optimize_matches(tmp_path, mode):
    pair = Pair(tmp_path, LINEAGE)
    pair.create()
    for i in (10, 11):
        write_source(pair.src, i, 25)
        pair.each(lambda pkg, s, hs: hs.refresh_index("ix", "incremental"))
    entry = IndexLogManager(str(tmp_path / "sys_torch" / "ix")).get_latest_stable_log()
    assert len(entry.content.files) == 12  # three files in each of four buckets.
    assert_queries_equal(pair.query(cutoff))
    pair.each(lambda pkg, s, hs: hs.optimize_index("ix", mode))
    assert_index_equal(pair)
    entry = IndexLogManager(str(tmp_path / "sys_torch" / "ix")).get_latest_stable_log()
    assert len(entry.content.files) == 4
    assert_queries_equal(pair.query(cutoff))
    # Nothing left to merge: a no-op in both.
    pair.each(lambda pkg, s, hs: hs.optimize_index("ix", mode))
    assert_index_equal(pair)


def test_quick_optimize_skips_files_over_the_threshold(tmp_path):
    pair = Pair(tmp_path, {IndexConstants.OPTIMIZE_FILE_SIZE_THRESHOLD: "1"})
    pair.create()
    write_source(pair.src, 10, 25)
    pair.each(lambda pkg, s, hs: hs.refresh_index("ix", "incremental"))
    pair.each(lambda pkg, s, hs: hs.optimize_index("ix", "quick"))
    assert_index_equal(pair)  # no file under 1 byte: nothing done.
    pair.each(lambda pkg, s, hs: hs.optimize_index("ix", "full"))
    assert_index_equal(pair)
    assert len(IndexLogManager(str(tmp_path / "sys_torch" / "ix"))
               .get_latest_stable_log().content.files) == 4


# ---------------------------------------------------------------------------
# Data-skipping refreshes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_skipping_refresh_matches(tmp_path, mode):
    # The JAX package caches sketch tables by (index name, log id), across
    # system paths (ROADMAP queue C): an earlier case's "sk" would answer.
    jax_skipping_rule._SKETCH_CACHE.clear()
    pair = Pair(tmp_path, files=6)
    def create(pkg, s, hs):
        api = jax_api if pkg is hst else ht
        hs.create_index(s.read.parquet(pair.src), api.DataSkippingIndexConfig(
            "sk", [api.MinMaxSketch("d"), api.BloomFilterSketch("k", expected_items=1000),
                   api.ValueListSketch("s")]))

    pair.each(create)
    apply_change(pair, "both")
    pair.each(lambda pkg, s, hs: hs.refresh_index("sk", mode))
    assert_index_equal(pair, "sk")
    table = data_files(tmp_path / "sys_torch", "sk")
    sketch = table[sorted(table)[-1]]
    assert sorted(sketch.column("_file").to_pylist()) == sorted(
        os.path.join(pair.src, f) for f in os.listdir(pair.src))

    def skipping(df, c):
        return df.filter(c("d").between(datetime.date(1994, 10, 25),
                                        datetime.date(1994, 10, 30))).select("k", "d")

    def bloom(df, c):
        return df.filter(c("k").isin([3, 77])).select("k", "v")

    res = pair.query(skipping)
    assert "1/7 files after skipping" in res["torch"][0]
    assert_queries_equal(res)
    assert_queries_equal(pair.query(bloom))


def test_sketch_tables_are_read_per_system_path(tmp_path):
    """Two lakes, each with a MinMax index named "sk" at the same log id:
    the port reads each lake's own sketch table. The JAX package caches the
    table by (index name, log id) alone, so the second lake's query reads
    the first lake's sketches, finds no row for its files and keeps them
    all (ROADMAP queue C)."""
    jax_skipping_rule._SKETCH_CACHE.clear()
    answers = {}
    for lake, offset in (("a", 0), ("b", 5)):
        pair = Pair(tmp_path / lake, files=0)
        for i in range(4):
            write_source(pair.src, i + offset)

        def create(pkg, s, hs):
            hs.create_index(s.read.parquet(pair.src), pkg.DataSkippingIndexConfig(
                "sk", [pkg.MinMaxSketch("d")]))

        pair.each(create)
        res = pair.query(lambda df, c: df.filter(c("d").between(
            datetime.date(1994, 10, 25), datetime.date(1994, 10, 30))).select("k", "d"))
        scanned = pair.query(lambda df, c: df.filter(c("d").between(
            datetime.date(1994, 10, 25), datetime.date(1994, 10, 30))).select("k", "d"),
            indexed=False)["torch"][1]
        answers[lake] = (res, scanned)
    for lake in ("a", "b"):
        res, scanned = answers[lake]
        assert res["torch"][1].equals(scanned)
    (res_a, _), (res_b, scanned_b) = answers["a"], answers["b"]
    assert_queries_equal(res_a)
    assert "1/4 files after skipping" in res_a["torch"][0]
    # Lake b's files hold no such date: the port prunes all four, the JAX
    # package none.
    assert "0/4 files after skipping" in res_b["torch"][0]
    assert "files after skipping" not in res_b["jax"][0]
    assert scanned_b.num_rows == 0 and res_b["jax"][1].equals(scanned_b)


# ---------------------------------------------------------------------------
# Restore and cancel.
# ---------------------------------------------------------------------------

def test_restore_matches(tmp_path):
    pair = Pair(tmp_path)
    pair.create()
    errors = {}
    for name in ("jax", "torch"):
        with pytest.raises(Exception, match="only supported in states") as info:
            pair.hs(name).restore_index("ix")
        errors[name] = str(info.value)
    assert errors["torch"] == errors["jax"]
    pair.each(lambda pkg, s, hs: hs.delete_index("ix"))
    assert "IndexScan" not in pair.query(point)["torch"][0]
    pair.each(lambda pkg, s, hs: hs.restore_index("ix"))
    assert_index_equal(pair)
    res = pair.query(point)
    assert "IndexScan" in res["torch"][0]
    assert_queries_equal(res)


def _begin_refresh(session, system_path):
    """A refresh that died after writing REFRESHING: validate and begin,
    no op and no end."""
    from hyperspace_tpu.actions.refresh import RefreshIncrementalAction as JRefresh
    from hyperspace_tpu.index.data_manager import IndexDataManager as JData
    from hyperspace_tpu.index.log_manager import IndexLogManager as JLog
    path = os.path.join(system_path, "ix")
    if isinstance(session, ht.Session):
        action = RefreshIncrementalAction(session, IndexLogManager(path),
                                          IndexDataManager(path))
    else:
        action = JRefresh(session, JLog(path), JData(path))
    action.validate()
    action._begin()


def test_cancel_rolls_back_a_dead_refresh(tmp_path):
    pair = Pair(tmp_path, LINEAGE)
    pair.create()
    write_source(pair.src, 10, 30)
    for name in ("jax", "torch"):
        _begin_refresh(pair.sessions[name], str(tmp_path / f"sys_{name}"))
    assert IndexLogManager(str(tmp_path / "sys_torch" / "ix")).get_latest_log().state == \
        States.REFRESHING
    for name in ("jax", "torch"):
        with pytest.raises(Exception, match="Refresh is only supported in ACTIVE state"):
            pair.hs(name).refresh_index("ix", "incremental")
    pair.each(lambda pkg, s, hs: hs.cancel("ix"))
    assert_index_equal(pair)
    assert IndexLogManager(str(tmp_path / "sys_torch" / "ix")).get_latest_log().state == \
        States.ACTIVE
    errors = {}
    for name in ("jax", "torch"):
        with pytest.raises(Exception, match="Cancel is not needed") as info:
            pair.hs(name).cancel("ix")
        errors[name] = str(info.value)
    assert errors["torch"] == errors["jax"]
    # The refresh runs to its end after the rollback.
    pair.each(lambda pkg, s, hs: hs.refresh_index("ix", "incremental"))
    assert_index_equal(pair)
    assert_queries_equal(pair.query(cutoff))


def test_cancel_of_an_uncommitted_create(tmp_path):
    from hyperspace_tpu.actions.create import CreateAction as JCreate
    from hyperspace_tpu.index.data_manager import IndexDataManager as JData
    from hyperspace_tpu.index.log_manager import IndexLogManager as JLog
    from hyperspace_tpu_torch.actions.create import CreateAction
    pair = Pair(tmp_path)
    for name in ("jax", "torch"):
        s = pair.sessions[name]
        path = str(tmp_path / f"sys_{name}" / "ix")
        pkg = pair.pkg(name)
        cls, logs, data = (JCreate, JLog, JData) if name == "jax" else \
            (CreateAction, IndexLogManager, IndexDataManager)
        action = cls(s, s.read.parquet(pair.src), pkg.IndexConfig("ix", ["k"], ["v"]),
                     logs(path), data(path))
        action.validate()
        action._begin()
    pair.each(lambda pkg, s, hs: hs.cancel("ix"))
    assert_index_equal(pair)
    assert IndexLogManager(str(tmp_path / "sys_torch" / "ix")).get_latest_log().state == \
        States.DOESNOTEXIST


# ---------------------------------------------------------------------------
# Hybrid Scan.
# ---------------------------------------------------------------------------

HYBRID_CASES = {
    # name: (lineage, files appended (rows), files deleted, expected plan suffix)
    "append_within": (False, [40], [], "hybrid(+1 appended, -0 deleted files)"),
    "append_over": (False, [200, 200], [], None),
    "delete_within": (True, [], ["f01"], "hybrid(+0 appended, -1 deleted files)"),
    "delete_over": (True, [], ["f01", "f02"], None),
    "delete_without_lineage": (False, [], ["f01"], None),
    "both_within": (True, [30], ["f02"], "hybrid(+1 appended, -1 deleted files)"),
}


@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_hybrid_scan_thresholds(tmp_path, case):
    lineage, appended, deleted, suffix = HYBRID_CASES[case]
    pair = Pair(tmp_path, LINEAGE if lineage else {}, files=6)
    pair.create()
    for j, rows in enumerate(appended):
        write_source(pair.src, 10 + j, rows)
    for f in deleted:
        os.remove(os.path.join(pair.src, f + ".parquet"))
    for build in (point, cutoff, wide):
        res = pair.query(build, hybrid=True)
        assert_queries_equal(res)
        plan = res["torch"][0]
        if suffix is None:
            assert "IndexScan" not in plan, plan
        else:
            assert suffix in plan, plan
        scanned = pair.query(build, indexed=False)["torch"][1]
        assert res["torch"][1].sort_by([("k", "ascending"), ("v", "ascending")]).equals(
            scanned.sort_by([("k", "ascending"), ("v", "ascending")]))


@pytest.mark.parametrize("key", [2 ** 31 - 1, -(2 ** 31 - 1), 2 ** 31, -2 ** 31, -2 ** 63])
def test_hybrid_merge_declines_keys_outside_32_bits(tmp_path, key):
    """The merge packs (bucket, key) into one int64 and needs every key in
    (-2**31, 2**31); else both packages concatenate instead (dropping the
    bucket order). For -2**63 among other keys the JAX package's check
    (the largest |key|, which wraps for -2**63) passes and merges with the
    key packed as 0: the port declines (ROADMAP queue C), the rows are the
    same and only their order differs."""
    pair = Pair(tmp_path, files=3)
    pair.create(included=("v",))
    write_source(pair.src, 10, keys=[5, key, 60, 7])
    before = {"jax": jexecutor.HYBRID_MERGE_COUNT, "torch": texecutor.HYBRID_MERGE_COUNT}
    res = pair.query(lambda df, c: df.filter(c("k") != 3).select("k", "v"), hybrid=True)
    moved = {"jax": jexecutor.HYBRID_MERGE_COUNT - before["jax"],
             "torch": texecutor.HYBRID_MERGE_COUNT - before["torch"]}
    fits = -2 ** 31 < key < 2 ** 31
    assert moved["torch"] == int(fits)
    assert res["torch"][0] == res["jax"][0]
    got, want = res["torch"][1], res["jax"][1]
    if key == -2 ** 63:
        assert moved["jax"] == 1
        order = [("k", "ascending"), ("v", "ascending")]
        assert got.sort_by(order).equals(want.sort_by(order))
        assert not got.equals(want)
    else:
        assert moved["jax"] == moved["torch"]
        assert got.equals(want)
    assert key in got.column("k").to_pylist()


def test_hybrid_join_keeps_the_fast_path(tmp_path):
    """A join of two covering indexes on k, one side with an appended file:
    the appended rows merge into the bucket order and the join still takes
    the shuffle-free path, in both packages alike."""
    pair = Pair(tmp_path, files=3)
    other = str(tmp_path / "other")
    for i in range(3):
        write_source(other, 20 + i, 60)
    pair.create(included=("v",))
    pair.each(lambda pkg, s, hs: hs.create_index(s.read.parquet(other), pkg.IndexConfig(
        "ox", ["k"], ["d"])))
    write_source(pair.src, 10, 30)
    counts = lambda: (jexecutor.HYBRID_MERGE_COUNT, jexecutor.FAST_JOIN_COUNT,  # noqa: E731
                      texecutor.HYBRID_MERGE_COUNT, texecutor.FAST_JOIN_COUNT)
    before = counts()

    def join(df, c):
        s = pair.sessions["jax" if c is jcol else "torch"]
        o = s.read.parquet(other).select(c("k").alias("ok"), "d")
        return df.select("k", "v").join(o, on=c("k") == c("ok")).select("k", "v", "d")

    res = pair.query(join, hybrid=True)
    after = counts()
    assert_queries_equal(res)
    assert "hybrid(+1 appended, -0 deleted files)" in res["torch"][0]
    assert res["torch"][1].num_rows > 0
    assert after[2] - before[2] == after[0] - before[0] == 1
    assert after[3] - before[3] == after[1] - before[1] == 1


def test_hybrid_empty_appended_file_keeps_the_bucket_order(tmp_path):
    """An appended file without rows merges nothing: the hybrid IndexScan's
    rows keep their bucket order (for a join or group-by on the key), in
    both packages."""
    pair = Pair(tmp_path, files=3)
    pair.create(included=("v",))
    write_source(pair.src, 10, keys=[])
    out = {}
    for name, s in pair.sessions.items():
        s.conf.set(HYBRID, "true")
        s.enable_hyperspace()
        df = s.read.parquet(pair.src).filter(
            (jcol if name == "jax" else ht.col)("k") != 3).select("k", "v")
        leaf = df.optimized_plan().collect_leaves()[0]
        s.disable_hyperspace()
        assert "hybrid(+1 appended, -0 deleted files)" in leaf.simple_string()
        table = (jexecutor if name == "jax" else texecutor).execute(leaf, s)
        out[name] = (table.bucket_order, table.to_arrow())
    assert out["torch"][0] == out["jax"][0] == (4, ("k",))
    assert out["torch"][1].equals(out["jax"][1])


# ---------------------------------------------------------------------------
# Across packages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_one_package_refreshes_the_other_queries(tmp_path, writer):
    """One package creates, refreshes incrementally and quick-refreshes an
    index with lineage; the other reads the entries and queries the index
    (Hybrid Scan on), equal to the writer's own answers."""
    pair = Pair(tmp_path, LINEAGE, files=6)
    reader = "torch" if writer == "jax" else "jax"
    ws = pair.sessions[writer]
    whs = pair.hs(writer)
    wpkg = pair.pkg(writer)
    whs.create_index(ws.read.parquet(pair.src), wpkg.IndexConfig("ix", ["k"], ["s", "v"]))
    write_source(pair.src, 10, 30)
    whs.refresh_index("ix", "incremental")
    os.remove(os.path.join(pair.src, "f02.parquet"))
    write_source(pair.src, 11, 20)
    whs.refresh_index("ix", "quick")
    rpkg = pair.pkg(reader)
    rs = rpkg.Session(conf=dict(BASE_CONF), system_path=str(tmp_path / f"sys_{writer}"),
                      **({"device": "cpu"} if reader == "torch" else {}))
    pair.sessions[reader] = rs
    for build in (point, cutoff, wide):
        res = pair.query(build, hybrid=True)
        assert "hybrid(+1 appended, -1 deleted files)" in res[reader][0]
        assert_queries_equal(res)
    entry = rpkg.Hyperspace(rs).index_manager.get_index("ix")
    assert entry.state == "ACTIVE" and len(entry.content.files) == 8  # 4 buckets, 2 versions


# ---------------------------------------------------------------------------
# A random sequence of changes: the indexed answer is the scanned one.
# ---------------------------------------------------------------------------

STEPS = st.lists(st.sampled_from(["append", "delete", "full", "incremental", "quick",
                                  "optimize"]), min_size=1, max_size=5)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(steps=STEPS)
def test_random_changes_keep_indexed_equal_to_scanned(tmp_path_factory, steps):
    root = tmp_path_factory.mktemp("random")
    src = str(root / "src")
    for i in range(3):
        write_source(src, i, 40)
    s = ht.Session(conf=dict(BASE_CONF, **LINEAGE), system_path=str(root / "sys"),
                   device="cpu")
    hs = ht.Hyperspace(s)
    hs.create_index(s.read.parquet(src), ht.IndexConfig("ix", ["k"], ["s", "v"]))
    nxt = 10
    for step in steps:
        files = sorted(os.listdir(src))
        if step == "append":
            write_source(src, nxt, 15)
            nxt += 1
        elif step == "delete" and len(files) > 1:
            os.remove(os.path.join(src, files[0]))
        elif step in ("full", "incremental", "quick"):
            hs.refresh_index("ix", step)
        elif step == "optimize":
            hs.optimize_index("ix", "quick")
    s.conf.set(HYBRID, "true")
    s.conf.set(IndexConstants.INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD, "0.9")
    s.conf.set(IndexConstants.INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD, "0.9")
    order = [("k", "ascending"), ("v", "ascending")]
    df = wide(s.read.parquet(src), ht.col)
    s.enable_hyperspace()
    indexed = df.to_arrow().sort_by(order)
    s.disable_hyperspace()
    assert indexed.equals(df.to_arrow().sort_by(order))
    shutil.rmtree(root)
