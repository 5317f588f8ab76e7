"""The streaming tier (``hyperspace_tpu_torch/streaming/``) against the JAX
package's, on the same numpy-seeded batches. The oracle is the JAX
package's ``tests/test_streaming.py``: each sequence runs through the JAX
package in a lake directory, which is then moved aside, and through the port
in a lake at the same path, with ``uuid.uuid4`` drawn from one seeded
sequence in both, so batch ids, staged names, delta file names and every
path in the op logs are equal. Compared exactly: commit summaries, each
op-log entry (entry timestamps, file mtimes and the provider signatures
over them normalized), every index data file and sketch table as a table,
plan tree strings, answers bit for bit with Hyperspace on and off,
``streaming_stats()`` counters, compaction and recover summaries (the
port's ``artifacts`` value is ``{"enabled": False}``).
"""

import contextlib
import glob
import json
import os
import random
import threading
import time
import types
import uuid

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.plan.expr import col as jcol
from hyperspace_tpu.rules import data_skipping_rule as jax_skipping_rule
from hyperspace_tpu.serving import frontend as jfrontend
from hyperspace_tpu.streaming import ingest as jingest
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.constants import IndexConstants, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.serving import frontend as tfrontend
from hyperspace_tpu_torch.streaming import ingest as tingest
from hyperspace_tpu_torch.streaming.constants import StreamingConstants as SC

BASE_CONF = {
    # conftest gives JAX 8 virtual devices, which would take its mesh path.
    "hyperspace.tpu.distributed.enabled": "false",
    # The JAX package's fused path runs an IndexScan, then the staged one,
    # which is the port's executor.
    "hyperspace.tpu.execution.fusion.enabled": "false",
    IndexConstants.INDEX_NUM_BUCKETS: "4",
    IndexConstants.INDEX_LINEAGE_ENABLED: "true",
}
PKGS = {"jax": (hst, jcol, jingest, jfrontend), "torch": (ht, ht.col, tingest, tfrontend)}
STAT_KEYS = ("appends", "commits", "batches_committed", "rows_staged", "rows_committed",
             "covering_deltas", "sketch_deltas", "commit_conflicts", "subscription_fires")


def rng_of(seed=17):
    return np.random.default_rng(seed)


def frame(rng, n):
    return pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int64),
                         "v": rng.integers(0, 9, n).astype(np.int64)})


def write_base(d, rng, n=2000):
    os.makedirs(d, exist_ok=True)
    pq.write_table(pa.Table.from_pandas(frame(rng, n)), os.path.join(d, "p0.parquet"))


@contextlib.contextmanager
def seeded_uuids(ingest_mod, seed=1234):
    """``uuid.uuid4`` in the ingest module drawn from a seeded sequence."""
    rnd = random.Random(seed)
    fake = types.SimpleNamespace(uuid4=lambda: uuid.UUID(int=rnd.getrandbits(128), version=4))
    real = ingest_mod.uuid
    ingest_mod.uuid = fake
    try:
        yield
    finally:
        ingest_mod.uuid = real


class Side:
    """One package's session, Hyperspace facade and lake under ``root``."""

    def __init__(self, pkg, root, conf=None, base=True, indexes=("cx", "sx")):
        self.pkg = pkg
        self.mod, self.col, self.ingest, self.frontend = PKGS[pkg]
        self.root = str(root)
        self.data = os.path.join(self.root, "tbl")
        self.sys = os.path.join(self.root, "indexes")
        full = dict(BASE_CONF, **(conf or {}))
        if pkg == "torch":
            self.session = ht.Session(conf=full, system_path=self.sys, device="cpu")
        else:
            jax_skipping_rule._SKETCH_CACHE.clear()
            self.session = hst.Session(conf=full, system_path=self.sys)
        self.hs = self.mod.Hyperspace(self.session)
        if base:
            write_base(self.data, rng_of())
            t = self.session.read.parquet(self.data)
            if "cx" in indexes:
                self.hs.create_index(t, self.mod.IndexConfig("cx", ["k"], ["v"]))
            if "sx" in indexes:
                self.hs.create_index(t, self.mod.DataSkippingIndexConfig(
                    "sx", [self.mod.MinMaxSketch("k"),
                           self.mod.BloomFilterSketch("v", expected_items=4096)]))

    def query(self, build=None, indexed=True):
        """(optimized plan string, sorted arrow answer) over a fresh listing."""
        build = build or (lambda t, c: t.filter(c("k") == 7).select("k", "v"))
        q = build(self.session.read.parquet(self.data), self.col)
        (self.session.enable_hyperspace if indexed else self.session.disable_hyperspace)()
        try:
            plan = self.session.optimize(q.plan, diagnostic=True).tree_string()
            table = q.to_arrow()
        finally:
            self.session.disable_hyperspace()
        return plan, table.sort_by([(n, "ascending") for n in table.column_names])

    def answers(self, build=None):
        """(plan, indexed answer, scanned answer); the two answers equal."""
        plan, a = self.query(build, True)
        _, b = self.query(build, False)
        assert a.equals(b), (self.pkg, a.num_rows, b.num_rows)
        return plan, a

    def stats(self):
        st = self.hs.streaming_stats()
        return {k: st[k] for k in STAT_KEYS}


def run_both(tmp_path, scenario, conf=None, **side_kw):
    """``scenario(side)`` through the JAX package, then the port, in a lake at
    the same path (the JAX lake moved aside in between); the observations of
    each."""
    out = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / "lake"
        with seeded_uuids(PKGS[pkg][2]):
            side = Side(pkg, root, conf, **side_kw)
            before = side.stats()
            obs = scenario(side)
            after = side.stats()
            obs["stats"] = {k: after[k] - before[k] for k in STAT_KEYS}
            out[pkg] = obs
        os.rename(root, tmp_path / pkg)
    return out


def summary_of(res):
    """A commit summary without its seconds."""
    return {k: v for k, v in res.items() if k != "seconds"}


def normalized_log(log_root) -> list:
    """Every op-log entry under ``log_root``: entry timestamps, file mtimes
    and the provider signatures over them set to 0, and the signature
    provider's module named as the JAX package's."""
    log_dir = os.path.join(log_root, IndexConstants.HYPERSPACE_LOG)
    out = []
    for i in sorted(int(f) for f in os.listdir(log_dir) if f.isdigit()):
        with open(os.path.join(log_dir, str(i))) as f:
            entry = json.load(f)
        entry["timestamp"] = 0

        def walk(node):
            if isinstance(node, dict):
                if "modifiedTime" in node:
                    node["modifiedTime"] = 0
                if "provider" in node and "IndexSignatureProvider" in str(node["provider"]):
                    node["value"] = 0
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)
        walk(entry)
        out.append(json.dumps(entry).replace('"hyperspace_tpu_torch.index.',
                                             '"hyperspace_tpu.index.'))
    return out


def lake_logs(side) -> dict:
    """The normalized op log of every index and streaming table log."""
    out = {}
    for name in sorted(os.listdir(side.sys)):
        path = os.path.join(side.sys, name)
        if os.path.isdir(os.path.join(path, IndexConstants.HYPERSPACE_LOG)):
            out[name] = normalized_log(path)
    sroot = os.path.join(side.sys, SC.STREAMING_DIR)
    if os.path.isdir(sroot):
        for name in sorted(os.listdir(sroot)):
            path = os.path.join(sroot, name)
            if os.path.isdir(os.path.join(path, IndexConstants.HYPERSPACE_LOG)):
                out[f"streaming:{name}"] = normalized_log(path)
    return out


def lake_files(side) -> dict:
    """Every index data file and every table file, as a table."""
    out = {}
    for path in sorted(glob.glob(os.path.join(side.sys, "*", "v__=*", "*.parquet"))
                       + glob.glob(os.path.join(side.data, "*.parquet"))):
        out[os.path.relpath(path, side.root)] = pq.read_table(path, partitioning=None)
    return out


def content_files(side, name) -> list:
    entry = side.session.index_collection_manager.get_index(name)
    return sorted(os.path.relpath(f, side.root) for f in entry.content.files)


def assert_same(out, *keys):
    """The observations under ``keys`` (all when none) equal in both packages;
    arrow tables by value and float bits."""
    j, t = out["jax"], out["torch"]
    for k in keys or sorted(j):
        _assert_equal(t[k], j[k], k)


def _assert_equal(got, want, where):
    if isinstance(want, pa.Table):
        assert isinstance(got, pa.Table), where
        assert got.schema.equals(want.schema), (where, got.schema, want.schema)
        assert got.equals(want), where
        for c in want.column_names:
            if pa.types.is_floating(want.schema.field(c).type):
                gv = got.column(c).to_numpy(zero_copy_only=False)
                wv = want.column(c).to_numpy(zero_copy_only=False)
                assert gv.tobytes() == wv.tobytes(), (where, c)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (where, got, want)
        for k in want:
            _assert_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


# ---------------------------------------------------------------------------
# Freshness: commit, then query, with no refresh pass.
# ---------------------------------------------------------------------------

def test_commit_then_query_matches(tmp_path):
    """Three append/commit rounds: summaries, exact IndexScans on a fresh
    listing, answers, the op logs of both indexes and the table, every data
    file, and the counters, equal to the JAX package's; the warm lake
    answers as a cold rebuild over the same files does."""

    def scenario(side):
        rng = rng_of(23)
        obs = {"commits": [], "plans": [], "answers": []}
        for i in range(3):
            a = side.hs.append(side.data, frame(rng, 400 + 50 * i))
            assert a["covering_deltas"] == 1 and a["sketch_deltas"] == 1
            out = side.hs.commit(side.data)
            obs["commits"].append(summary_of(out))
            plan, ans = side.answers()
            assert "IndexScan" in plan and "hybrid(" not in plan, plan
            obs["plans"].append(plan)
            obs["answers"].append(ans)
        obs["logs"] = lake_logs(side)
        obs["files"] = lake_files(side)
        obs["cx_content"] = content_files(side, "cx")
        return obs

    out = run_both(tmp_path, scenario)
    assert [c["indexes_updated"] for c in out["torch"]["commits"]] == [["cx", "sx"]] * 3
    assert_same(out)
    assert out["torch"]["stats"]["covering_deltas"] == 3

    # A cold rebuild over the final files answers as the warm lake does.
    cold = ht.Session(conf=dict(BASE_CONF), system_path=str(tmp_path / "cold"), device="cpu")
    data = str(tmp_path / "torch" / "tbl")
    ht.Hyperspace(cold).create_index(cold.read.parquet(data), ht.IndexConfig("cx", ["k"], ["v"]))
    cold.enable_hyperspace()
    got = cold.read.parquet(data).filter(ht.col("k") == 7).select("k", "v").to_arrow()
    got = got.sort_by([("k", "ascending"), ("v", "ascending")])
    assert got.equals(out["torch"]["answers"][-1])


def test_sketches_fresh_per_commit(tmp_path):
    """The sketch table covers every file after two commits, equal to the
    JAX package's, and prunes every file for a predicate outside all
    ranges."""

    def scenario(side):
        rng = rng_of(5)
        for _ in range(2):
            side.hs.append(side.data, frame(rng, 300))
            side.hs.commit(side.data)
        entry = side.session.index_collection_manager.get_index("sx")
        sketch = [f for f in entry.content.files if f.endswith("sketches.parquet")]
        assert len(sketch) == 1
        table = pq.read_table(sketch[0], partitioning=None)
        assert sorted(table.column("_file").to_pylist()) == \
            sorted(side.session.read.parquet(side.data).plan.relation.all_files())
        side.session.enable_hyperspace()
        q = side.session.read.parquet(side.data).filter(side.col("k") >= 1000)
        leaves = [leaf for leaf in q.optimized_plan().collect_leaves()
                  if getattr(leaf, "relation", None) is not None]
        kept = min((len(leaf.relation.all_files()) for leaf in leaves), default=0)
        side.session.disable_hyperspace()
        return {"sketch": table.drop(["_file"]), "kept": kept,
                "files": [os.path.relpath(f, side.root) for f in table.column("_file").to_pylist()]}

    out = run_both(tmp_path, scenario)
    assert out["torch"]["kept"] == 0
    assert_same(out)


def test_layout_drift_between_append_and_commit_skips_delta(tmp_path):
    """A delete and recreate at another bucket count between append and
    commit: the staged delta is skipped, the index log stays clean."""

    def scenario(side):
        side.hs.append(side.data, frame(rng_of(121), 300))
        side.hs.delete_index("cx")
        side.hs.vacuum_index("cx")
        side.session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 8)
        side.hs.create_index(side.session.read.parquet(side.data),
                             side.mod.IndexConfig("cx", ["k"], ["v"]))
        out = summary_of(side.hs.commit(side.data))
        assert out["indexes_skipped"] == ["cx"] and out["indexes_updated"] == [], out
        entry = side.session.index_collection_manager.get_index("cx")
        assert entry.num_buckets == 8
        return {"commit": out, "answer": side.answers(), "logs": lake_logs(side)}

    assert_same(run_both(tmp_path, scenario, indexes=("cx",)))


def test_load_time_indexing_off_falls_back(tmp_path):
    def scenario(side):
        side.session.conf.set(SC.LOAD_TIME_INDEXING, "false")
        side.hs.append(side.data, frame(rng_of(9), 200))
        out = summary_of(side.hs.commit(side.data))
        assert out["indexes_updated"] == []
        files = side.session.read.parquet(side.data).plan.relation.all_files()
        return {"commit": out, "answer": side.answers(), "files": len(files)}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["files"] == 2
    assert_same(out)


def test_never_committed_staging_swept_by_recover(tmp_path):
    """A table whose appender never committed: recover() finds its staging
    through the staged-table marker, and a different first schema is then
    accepted."""

    def scenario(side):
        data = os.path.join(side.root, "orphan")
        side.hs.append(data, frame(rng_of(93), 60))
        staging = os.path.join(data, SC.STAGING_DIR)
        assert len(os.listdir(staging)) == 1
        summary = side.hs.recover()
        summary.pop("artifacts")
        assert not os.path.isdir(staging)
        assert side.ingest.get_queue().staged_count(os.path.abspath(data)) == 0
        side.hs.append(data, pd.DataFrame({"x": np.asarray([1, 2], np.int64)}))
        assert side.hs.commit(data)["committed_batches"] == 1
        return {"recover": summary, "columns": side.session.read.parquet(data).columns}

    out = run_both(tmp_path, scenario, base=False)
    assert out["torch"]["recover"]["streaming"]["staging_swept"] >= 1
    assert out["torch"]["columns"] == ["x"]
    assert_same(out)


def test_failed_staging_write_leaves_no_file_or_memo(tmp_path, monkeypatch):
    def scenario(side):
        data = os.path.join(side.root, "newt")
        real = pq.write_table

        def boom(*a, **k):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(pq, "write_table", boom)
        with pytest.raises(OSError):
            side.hs.append(data, pd.DataFrame({"a": np.asarray([1, 2], np.int64)}))
        monkeypatch.setattr(pq, "write_table", real)
        staging = os.path.join(data, SC.STAGING_DIR)
        assert not os.path.isdir(staging) or not os.listdir(staging)
        side.hs.append(data, pd.DataFrame({"x": np.asarray([3], np.int64)}))
        assert side.hs.commit(data)["committed_batches"] == 1
        return {"columns": side.session.read.parquet(data).columns}

    out = run_both(tmp_path, scenario, base=False)
    assert out["torch"]["columns"] == ["x"]
    assert_same(out)


def test_failed_prebuild_write_cleans_index_staging(tmp_path, monkeypatch):
    """A covering delta's bucket write that dies removes its partial staging
    directory."""
    from hyperspace_tpu_torch.actions import create as create_mod
    side = Side("torch", tmp_path, indexes=("cx",))

    def boom(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(create_mod, "write_bucket_files", boom)
    with pytest.raises(OSError):
        side.hs.append(side.data, frame(rng_of(61), 100))
    assert glob.glob(str(tmp_path / "**" / SC.STAGING_DIR / "*"), recursive=True) == []
    assert tingest.get_queue().staged_count(os.path.abspath(side.data)) == 0


def test_commit_already_covered_by_racing_refresh_skips(tmp_path):
    """A landing whose batch a racing refresh already indexed refuses before
    begin and removes its dead staged files."""
    from hyperspace_tpu_torch.index.data_manager import IndexDataManager
    from hyperspace_tpu_torch.index.path_resolver import PathResolver
    side = Side("torch", tmp_path, indexes=("cx",))
    side.hs.append(side.data, frame(rng_of(67), 100))
    side.hs.commit(side.data)
    entry = side.session.index_collection_manager.get_index("cx")
    batch_file = next(f.name for f in entry.source_file_info_set
                      if SC.INGEST_FILE_PREFIX in os.path.basename(f.name))
    index_path = PathResolver(side.session.hs_conf).get_index_path("cx")
    staged_dir = os.path.join(tingest._staging_dir(index_path), "ghost")
    os.makedirs(staged_dir)
    with open(os.path.join(staged_dir, "junk"), "w") as f:
        f.write("x")
    batch = tingest.StagedBatch("ghost", os.path.abspath(side.data), "", batch_file, 100, 1, 1,
                                None)
    delta = tingest._CoveringDelta("cx", index_path, staged_dir, None,
                                   tingest._covering_layout(entry))
    action = tingest._LandCoveringDeltas(side.session, IndexLogManager(index_path),
                                         IndexDataManager(index_path),
                                         os.path.abspath(side.data), [(batch, delta)])
    with pytest.raises(HyperspaceException, match="already covers"):
        action.validate()
    assert not os.path.isdir(staged_dir)


def test_commit_does_not_walk_table_dir(tmp_path, monkeypatch):
    from hyperspace_tpu_torch.util import file_utils as fu
    side = Side("torch", tmp_path)
    side.hs.append(side.data, frame(rng_of(71), 100))
    walked = []
    real = fu.list_leaf_files

    def spy(path, *a, **k):
        walked.append(os.path.abspath(str(path)))
        return real(path, *a, **k)

    monkeypatch.setattr(fu, "list_leaf_files", spy)
    side.hs.commit(side.data)
    assert os.path.abspath(side.data) not in walked


def test_bootstrap_table_from_appends_alone(tmp_path):
    def scenario(side):
        rng = rng_of(47)
        side.hs.append(side.data, frame(rng, 120))
        side.hs.append(side.data, frame(rng, 80))
        out = summary_of(side.hs.commit(side.data))
        n1 = side.session.read.parquet(side.data).count()
        mgr = IndexLogManager(side.ingest.table_log_dir(side.session, side.data))
        assert mgr.get_latest_stable_log().state == States.ACTIVE
        side.hs.append(side.data, frame(rng, 30))
        side.hs.commit(side.data)
        return {"commit": out, "counts": [n1, side.session.read.parquet(side.data).count()],
                "logs": lake_logs(side), "files": lake_files(side)}

    out = run_both(tmp_path, scenario, base=False)
    assert out["torch"]["counts"] == [200, 230]
    assert_same(out)


def test_append_backpressure_and_schema_checks(tmp_path):
    def scenario(side):
        side.session.conf.set(SC.MAX_STAGED_BATCHES, "2")
        rng = rng_of(3)
        errors = []
        for bad in (pd.DataFrame({"other": [1, 2]}),
                    pd.DataFrame({"k": ["a", "b"], "v": np.asarray([1, 2], np.int64)}),
                    pd.DataFrame({"k": [], "v": []})):
            with pytest.raises(Exception) as e:
                side.hs.append(side.data, bad)
            errors.append(str(e.value))
        side.hs.append(side.data, frame(rng, 50))
        side.hs.append(side.data, frame(rng, 50))
        with pytest.raises(Exception, match="maxStagedBatches") as e:
            side.hs.append(side.data, frame(rng, 50))
        errors.append(str(e.value))
        staged = len(os.listdir(os.path.join(side.data, SC.STAGING_DIR)))
        visible = len(side.session.read.parquet(side.data).plan.relation.all_files())
        side.hs.commit(side.data)
        after = len(side.session.read.parquet(side.data).plan.relation.all_files())
        return {"errors": errors, "files": [staged, visible, after]}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["files"] == [2, 1, 3]
    assert "schema mismatch" in out["torch"]["errors"][0]
    assert "type fork" in out["torch"]["errors"][1]
    assert "empty batch" in out["torch"]["errors"][2]
    assert_same(out)


def test_result_cache_invalidates_per_commit(tmp_path):
    """A commit changes every index's latest entry, so a query after it never
    gets a result cached before it."""

    def scenario(side):
        for k, v in (("serving.result_cache.enabled", "true"),
                     ("serving.result_cache.minComputeSeconds", "0"),
                     ("serving.result_cache.minInputBytes", "0")):
            side.session.conf.set(k, v)
        side.session.enable_hyperspace()
        counts = []
        t = side.session.read.parquet(side.data)
        counts += [t.count(), t.count()]
        assert side.session.result_cache is not None
        for n in (123, 7):
            side.hs.append(side.data, frame(rng_of(31 + n), n))
            side.hs.commit(side.data)
            counts.append(side.session.read.parquet(side.data).count())
        side.session.disable_hyperspace()
        return {"counts": counts}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["counts"] == [2000, 2000, 2123, 2130]
    assert_same(out)


# ---------------------------------------------------------------------------
# Crash safety in process: redo, requeue, lineage drift, torn tips.
# ---------------------------------------------------------------------------

def _recover_summary(side):
    summary = side.hs.recover()
    summary.pop("artifacts")
    return summary


def _wreck_after_publication(side, seed):
    """A commit whose op ran (files published, deltas landed) and whose final
    entry was never written."""
    side.hs.append(side.data, frame(rng_of(seed), 150))
    batches = side.ingest.get_queue().pop_all(os.path.abspath(side.data))
    log_mgr = side.mod.index.log_manager.IndexLogManager(
        side.ingest.table_log_dir(side.session, side.data))
    action = side.ingest._StreamingCommitAction(side.session, log_mgr,
                                               os.path.abspath(side.data), batches)
    action.validate()
    action._begin()
    action.op()
    assert log_mgr.get_latest_log().state == States.REFRESHING
    return log_mgr


def test_redo_when_publication_completed(tmp_path):
    def scenario(side):
        side.hs.append(side.data, frame(rng_of(51), 150))
        side.hs.commit(side.data)
        log_mgr = _wreck_after_publication(side, 52)
        summary = _recover_summary(side)
        assert log_mgr.get_latest_log().state == States.ACTIVE
        return {"recover": summary, "answer": side.answers(), "logs": lake_logs(side),
                "files": len(side.session.read.parquet(side.data).plan.relation.all_files())}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["recover"]["streaming"]["completed"]
    assert out["torch"]["files"] == 3
    assert_same(out)


def test_torn_end_entry_redoes_in_one_pass(tmp_path):
    def scenario(side):
        side.hs.append(side.data, frame(rng_of(66), 100))
        side.hs.commit(side.data)
        log_mgr = _wreck_after_publication(side, 67)
        torn_id = log_mgr.get_latest_id() + 1
        log_dir = os.path.join(side.ingest.table_log_dir(side.session, side.data),
                               IndexConstants.HYPERSPACE_LOG)
        with open(os.path.join(log_dir, str(torn_id)), "w") as f:
            f.write("{torn end")
        summary = _recover_summary(side)
        assert log_mgr.get_latest_log().state == States.ACTIVE
        side.hs.append(side.data, frame(rng_of(68), 50))
        assert side.hs.commit(side.data)["committed_batches"] == 1
        return {"recover": summary, "answer": side.answers(),
                "count": side.session.read.parquet(side.data).count()}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["recover"]["streaming"]["torn_entries"] == 1
    assert out["torch"]["count"] == 2000 + 100 + 150 + 50
    assert_same(out)


def test_torn_streaming_log_tip_recovers(tmp_path):
    def scenario(side):
        side.hs.append(side.data, frame(rng_of(59), 80))
        side.hs.commit(side.data)
        log_dir = os.path.join(side.ingest.table_log_dir(side.session, side.data),
                               IndexConstants.HYPERSPACE_LOG)
        mgr = IndexLogManager(side.ingest.table_log_dir(side.session, side.data))
        torn_id = mgr.get_latest_id() + 1
        with open(os.path.join(log_dir, str(torn_id)), "w") as f:
            f.write("{not json")
        side.hs.append(side.data, frame(rng_of(60), 80))
        with pytest.raises(Exception, match="recover") as e:
            side.hs.commit(side.data)
        summary = _recover_summary(side)
        assert not os.path.exists(os.path.join(log_dir, str(torn_id)))
        side.hs.append(side.data, frame(rng_of(64), 80))
        assert side.hs.commit(side.data)["committed_batches"] == 1
        return {"error": str(e.value), "recover": summary, "answer": side.answers()}

    assert_same(run_both(tmp_path, scenario, indexes=("cx",)))


def test_commit_conflict_requeues(tmp_path):
    """A foreign writer takes the next table-log id: the commit raises and
    re-queues its batches; recover() clears the squatter and sweeps all
    staged state."""

    def scenario(side):
        side.hs.append(side.data, frame(rng_of(61), 100))
        side.hs.commit(side.data)
        side.hs.append(side.data, frame(rng_of(62), 100))
        entry_mod = side.mod.index.log_entry
        log_mgr = side.mod.index.log_manager.IndexLogManager(
            side.ingest.table_log_dir(side.session, side.data))
        latest = log_mgr.get_latest_log()
        squatter = entry_mod.IndexLogEntry.from_json(latest.to_json())
        squatter.state = States.REFRESHING
        assert log_mgr.write_log(latest.id + 1, squatter)
        queue = side.ingest.get_queue()
        table = os.path.abspath(side.data)
        staged = [queue.staged_count(table)]
        with pytest.raises(Exception):
            side.hs.commit(side.data)
        staged.append(queue.staged_count(table))
        summary = _recover_summary(side)
        staged.append(queue.staged_count(table))
        side.hs.append(side.data, frame(rng_of(63), 100))
        assert side.hs.commit(side.data)["committed_batches"] == 1
        return {"staged": staged, "recover": summary, "answer": side.answers(),
                "logs": lake_logs(side)}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["staged"] == [1, 1, 0]
    assert out["torch"]["stats"]["commit_conflicts"] == 1
    assert_same(out)


def test_lineage_drift_repaired_at_commit(tmp_path):
    """A wrong lineage prediction (the staged delta's files carry an id a
    racing writer made stale) is repaired in place at commit: the landed
    rows carry the committed file id."""

    def scenario(side):
        side.hs.append(side.data, frame(rng_of(53), 180))
        queue = side.ingest.get_queue()
        with queue._lock:
            delta = queue._staged[os.path.abspath(side.data)][0].covering[0]
            assert delta.lineage_id is not None
            delta.lineage_id += 7
        side.ingest._rewrite_lineage(delta.staged_dir, delta.lineage_id,
                                     side.session.hs_conf.index_row_group_size())
        side.hs.commit(side.data)
        entry = side.session.index_collection_manager.get_index("cx")
        info = next(f for f in entry.relation.data.content.file_infos
                    if SC.INGEST_FILE_PREFIX in f.name)
        ids = set()
        for f in entry.content.files:
            if "v__=1" in f:
                ids.update(pq.read_table(f, partitioning=None).column(
                    IndexConstants.DATA_FILE_NAME_ID).to_pylist())
        assert ids == {info.id}
        return {"answer": side.answers(), "files": lake_files(side)}

    assert_same(run_both(tmp_path, scenario, indexes=("cx",)))


def test_mid_protocol_failure_abandons_inflight(tmp_path):
    """An error at ingest.publish (after op started) leaves no batch counted
    in flight; recover() resolves the wreck."""

    def scenario(side):
        side.hs.append(side.data, frame(rng_of(57), 90))
        key = "hyperspace.tpu.robustness.faults.ingest.publish"
        side.session.conf.set(key, "error:nth=1,exc=OSError")
        with pytest.raises(OSError) as e:
            side.hs.commit(side.data)
        side.session.conf.unset(key)
        assert side.ingest.get_queue().staged_count(os.path.abspath(side.data)) == 0
        summary = _recover_summary(side)
        side.hs.append(side.data, frame(rng_of(58), 90))
        assert side.hs.commit(side.data)["committed_batches"] == 1
        return {"error": str(e.value), "recover": summary, "answer": side.answers(),
                "logs": lake_logs(side)}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["recover"]["streaming"]["rolled_back"]
    assert_same(out)


# ---------------------------------------------------------------------------
# Standing queries through the serving frontend.
# ---------------------------------------------------------------------------

def fresh_frontend(side, **conf):
    """A frontend made the process default (commits notify every live
    frontend)."""
    fe_mod = side.frontend
    with fe_mod._DEFAULT_LOCK:
        fe_mod._DEFAULT = None
    side.session.conf.set("hyperspace.tpu.serving.maxConcurrency", "8")
    side.session.conf.set("hyperspace.tpu.serving.queueDepth", "64")
    for k, v in conf.items():
        side.session.conf.set(k, v)
    return fe_mod.ServingFrontend(side.session)


@pytest.fixture(autouse=True)
def _close_frontends(monkeypatch):
    """Each test's frontends stay its own: the process-wide default and the
    live set start empty."""
    import weakref
    for fe_mod in (jfrontend, tfrontend):
        monkeypatch.setattr(fe_mod, "_DEFAULT", None)
        monkeypatch.setattr(fe_mod, "_ALL_FRONTENDS", weakref.WeakSet())
    yield


def delivery_table(d):
    t = d.result.to_arrow()
    return t.sort_by([(n, "ascending") for n in t.column_names])


def test_subscription_delivers_per_commit(tmp_path):
    def scenario(side):
        front = fresh_frontend(side)
        sub = front.subscribe(side.session.read.parquet(side.data)
                              .filter(side.col("k") == 7).select("k", "v"))
        rng = rng_of(81)
        fired, expected = [], []
        for _ in range(3):
            side.hs.append(side.data, frame(rng, 150))
            fired.append(side.hs.commit(side.data)["subscriptions_fired"])
            expected.append(side.query(indexed=False)[1])
        deliveries = sub.wait_for(3, timeout=120.0)
        got = [delivery_table(d) for d in sorted(deliveries, key=lambda d: d.seq)]
        for g, e in zip(got, expected):
            assert g.equals(e)
        assert sub.unsubscribe()
        side.hs.append(side.data, frame(rng, 50))
        fired.append(side.hs.commit(side.data)["subscriptions_fired"])
        front.drain()
        return {"fired": fired, "deliveries": got,
                "subs": {k: v for k, v in front.stats()["subscriptions"].items()}}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["fired"] == [1, 1, 1, 0]
    assert [d.num_rows for d in out["torch"]["deliveries"]] == \
        sorted(d.num_rows for d in out["torch"]["deliveries"])
    assert out["torch"]["stats"]["subscription_fires"] == 3
    assert_same(out)


def test_unrelated_table_commit_does_not_fire(tmp_path):
    def scenario(side):
        front = fresh_frontend(side)
        sub = front.subscribe(side.session.read.parquet(side.data).select("k"))
        assert sub.tables
        other = os.path.join(side.root, "other")
        side.hs.append(other, frame(rng_of(85), 40))
        fired = [side.hs.commit(other)["subscriptions_fired"]]
        side.hs.append(side.data, frame(rng_of(86), 40))
        fired.append(side.hs.commit(side.data)["subscriptions_fired"])
        assert sub.wait_for(1, timeout=60.0)
        front.drain()
        return {"fired": fired}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["fired"] == [0, 1]
    assert_same(out)


def test_latest_is_max_by_seq_not_completion_order():
    from hyperspace_tpu_torch.streaming.subscriptions import SubscriptionRegistry
    reg = SubscriptionRegistry()
    sub = reg.subscribe(None, object(), None, "c", None, 8, 16)
    s1, s2 = sub._next_seq(), sub._next_seq()
    sub._deliver(s2, "t", result="new")
    sub._deliver(s1, "t", result="old")
    d = sub.latest(timeout=1.0)
    assert d.seq == s2 and d.result == "new"


def test_subscription_limit_and_history(tmp_path):
    from hyperspace_tpu_torch.streaming.subscriptions import SubscriptionRegistry
    reg = SubscriptionRegistry()
    subs = [reg.subscribe(None, object(), None, "", None, 2, 3) for _ in range(2)]
    with pytest.raises(HyperspaceException, match="subscriptions.max"):
        reg.subscribe(None, object(), None, "", None, 2, 3)
    for i in range(5):
        subs[0]._deliver(subs[0]._next_seq(), "t", result=i)
    assert [d.result for d in subs[0].deliveries()] == [2, 3, 4]
    assert subs[0].delivered_total == 5 and subs[1].client == "standing:2"
    assert reg.stats()["live"] == 2


def test_unsubscribe_wakes_blocked_waiter(tmp_path):
    side = Side("torch", tmp_path, indexes=())
    front = fresh_frontend(side)
    sub = front.subscribe(side.session.read.parquet(side.data).select("k"))
    caught = []
    started = threading.Event()

    def waiter():
        started.set()
        try:
            sub.wait_for(1, timeout=300.0)
        except Exception as e:
            caught.append(e)

    th = threading.Thread(target=waiter)
    th.start()
    started.wait(10.0)
    time.sleep(0.05)
    assert sub.unsubscribe()
    th.join(10.0)
    assert not th.is_alive()
    assert caught and isinstance(caught[0], HyperspaceException) and "closed" in str(caught[0])


def test_submit_crash_never_escapes_commit(tmp_path):
    side = Side("torch", tmp_path, indexes=("cx",))
    front = fresh_frontend(side)
    t = side.session.read.parquet(side.data)
    bad = front.subscribe(t.select("k"))
    bad.plan = object()  # fresh_plan keeps it; submit() fails
    good = front.subscribe(t.select("v"))
    side.hs.append(side.data, frame(rng_of(87), 40))
    assert side.hs.commit(side.data)["committed_batches"] == 1
    assert not bad.latest(timeout=30.0).ok
    assert good.wait_for(1, timeout=60.0)[0].ok


def test_rejected_fire_delivers_error(tmp_path):
    """A fire the frontend sheds is delivered as that fire's error, as in the
    JAX package."""

    def scenario(side):
        front = fresh_frontend(side)
        sub = front.subscribe(side.session.read.parquet(side.data).select("k"))
        side.session.conf.set("hyperspace.tpu.serving.queueDepth", "1")
        front._queue.extend([object()])
        try:
            fired = front.notify_commit(side.session, side.data)
        finally:
            front._queue.clear()
        d = sub.latest(timeout=10.0)
        assert not d.ok
        return {"fired": fired, "error": type(d.error).__name__,
                "subs": front.stats()["subscriptions"]}

    out = run_both(tmp_path, scenario, indexes=())
    assert out["torch"]["fired"] == 0
    assert_same(out)


# ---------------------------------------------------------------------------
# Compaction and the op-log lookup cache.
# ---------------------------------------------------------------------------

def _count_log_files(path):
    log = os.path.join(path, IndexConstants.HYPERSPACE_LOG)
    return len([n for n in os.listdir(log) if n.isdigit()])


def test_compaction_matches(tmp_path):
    """Five commits, then compact(): summaries, entry counts, the
    checkpoint's properties, answers before and after, recover() a no-op,
    a second compact() folds nothing, and a later commit carries the
    generation; all equal to the JAX package's."""

    def scenario(side):
        rng = rng_of(13)
        for _ in range(5):
            side.hs.append(side.data, frame(rng, 80))
            side.hs.commit(side.data)
        cx = os.path.join(side.sys, "cx")
        before = _count_log_files(cx)
        ans = side.answers()
        first = side.hs.compact(None)
        first.pop("artifacts")
        after = _count_log_files(cx)
        assert side.answers() == ans
        rec = _recover_summary(side)
        second = side.hs.compact(None)
        second.pop("artifacts")
        tip = IndexLogManager(cx).get_latest_stable_log()
        side.hs.append(side.data, frame(rng, 60))
        side.hs.commit(side.data)
        tip2 = IndexLogManager(cx).get_latest_stable_log()
        return {"entries": [before, after], "compact": first, "recover": rec,
                "again": second, "props": [tip.properties[SC.COMPACTION_GENERATION_PROPERTY],
                                           tip.properties[SC.COMPACTED_THROUGH_PROPERTY],
                                           tip2.properties[SC.COMPACTION_GENERATION_PROPERTY]],
                "answer": side.answers(), "logs": lake_logs(side), "files": lake_files(side),
                "vdirs": sorted(os.path.relpath(p, side.root)
                                for p in glob.glob(os.path.join(side.sys, "*", "v__=*")))}

    out = run_both(tmp_path, scenario)
    t = out["torch"]
    assert t["entries"][0] >= 12 and t["entries"][1] == 1
    assert t["compact"]["compacted"]["sx"]["versions_vacuumed"] == 5
    assert not t["again"]["compacted"] and t["props"][0] == t["props"][2] == "1"
    assert not t["recover"]["cancelled"] and not t["recover"]["vacuumed"]
    assert_same(out)


def test_compaction_skips_transient_tip(tmp_path):
    def scenario(side):
        rng = rng_of(29)
        for _ in range(3):
            side.hs.append(side.data, frame(rng, 50))
            side.hs.commit(side.data)
        mgr = side.mod.index.log_manager.IndexLogManager(os.path.join(side.sys, "cx"))
        latest = mgr.get_latest_log()
        wreck = side.mod.index.log_entry.IndexLogEntry.from_json(latest.to_json())
        wreck.state = States.REFRESHING
        assert mgr.write_log(latest.id + 1, wreck)
        out = side.hs.compact(["cx"])
        out.pop("artifacts")
        return {"compact": out}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert "transient" in out["torch"]["compact"]["skipped"]["cx"]
    assert_same(out)


def test_compaction_drops_pooled_reads_of_vacuumed_files(tmp_path):
    """Reads cached by the buffer pool and the index-table cache name no file
    the vacuum deleted, and answers stay equal."""
    from hyperspace_tpu_torch.execution import buffer_pool
    side = Side("torch", tmp_path)
    rng = rng_of(19)
    for _ in range(3):
        side.hs.append(side.data, frame(rng, 90))
        side.hs.commit(side.data)
    before = side.answers()
    pool = buffer_pool.get_pool()
    assert pool.stats()["admissions"] > 0
    out = side.hs.compact(None)
    assert out["compacted"]["sx"]["versions_vacuumed"] == 3
    with pool._lock:
        keys = list(pool._device) + list(pool._host)
    named = {p for k in keys for p in _paths_in(k)}
    assert not [p for p in named if not os.path.exists(p)]
    assert side.answers() == before


def _paths_in(obj):
    if isinstance(obj, str):
        return [obj] if obj.startswith(os.sep) else []
    if isinstance(obj, (tuple, list)):
        return [p for o in obj for p in _paths_in(o)]
    return []


def test_repeat_queries_stop_rereading_logs(tmp_path, monkeypatch):
    from hyperspace_tpu_torch.index import log_store
    from hyperspace_tpu_torch.index.log_manager import LogLookupCache, get_lookup_cache
    monkeypatch.setattr(LogLookupCache, "_RACY_WINDOW_NS", 0)
    side = Side("torch", tmp_path, indexes=("cx",))
    rng = rng_of(37)
    for _ in range(3):
        side.hs.append(side.data, frame(rng, 70))
        side.hs.commit(side.data)
    counts = {"read": 0, "list": 0}
    real_read = log_store.LocalFsLogStore.read
    real_list = log_store.LocalFsLogStore.list_numeric_ids

    def counting_read(self, path):
        counts["read"] += 1
        return real_read(self, path)

    def counting_list(self, path):
        counts["list"] += 1
        return real_list(self, path)

    monkeypatch.setattr(log_store.LocalFsLogStore, "read", counting_read)
    monkeypatch.setattr(log_store.LocalFsLogStore, "list_numeric_ids", counting_list)
    manager = side.session.index_collection_manager
    ids = manager.latest_log_ids()
    warm = dict(counts)
    for _ in range(5):
        assert manager.latest_log_ids() == ids
    assert counts == warm
    side.hs.append(side.data, frame(rng, 40))
    side.hs.commit(side.data)
    assert manager.latest_log_ids() != ids
    st = side.hs.streaming_stats()["oplog_cache"]
    assert st["hits"] > 0 and st["invalidations"] > 0
    assert st == get_lookup_cache().stats()


def test_cross_process_writes_invalidate_by_mtime(tmp_path):
    from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
    side = Side("torch", tmp_path, indexes=("cx",))
    idx_path = os.path.join(side.sys, "cx")
    mgr = IndexLogManager(idx_path)
    fp1 = mgr.latest_entry_fingerprint()
    assert mgr.latest_entry_fingerprint() == fp1
    latest = mgr.get_latest_log()
    foreign = IndexLogEntry.from_json(latest.to_json())
    foreign.state = States.DELETED
    foreign.id = latest.id + 1
    time.sleep(0.01)
    with open(os.path.join(idx_path, IndexConstants.HYPERSPACE_LOG, str(latest.id + 1)), "w") as f:
        f.write(foreign.to_json())
    fp2 = mgr.latest_entry_fingerprint()
    assert fp2 != fp1 and fp2[0] == latest.id + 1


def test_streaming_disabled_refuses(tmp_path):
    side = Side("torch", tmp_path, conf={SC.ENABLED: "false"}, indexes=())
    for call in (lambda: side.hs.append(side.data, frame(rng_of(1), 5)),
                 lambda: side.hs.commit(side.data)):
        with pytest.raises(HyperspaceException, match="streaming.enabled"):
            call()
