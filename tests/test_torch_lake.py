"""The lake tier through both packages: every scenario of
``tests/test_delta_lake.py`` and ``tests/test_iceberg.py`` run side by side
on the same numpy-seeded tables.

The storage layers are held to each other by cross-reading: part-file names
carry uuids and commits carry timestamps, so a table written by one
package's ``lake/`` is read by the other's, and the snapshots, file infos,
schemas, ``signature()`` and ``describe()`` strings must be equal, as must
the committed actions once uuids, ids, timestamps and mtimes are taken out.
Index scenarios build the same index in each package over one table (each
with its own system path) and compare the op logs entry by entry
(``test_torch_mutability.normalized_log``), the plans' IndexScans and log
versions, the explain text and the ``to_arrow()`` answers byte for byte.
"""

import json
import os
import re

import numpy as np
import pyarrow as pa
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.lake import delta as jdelta
from hyperspace_tpu.lake import iceberg as jiceberg
from hyperspace_tpu.plan.expr import col as jcol
from hyperspace_tpu.plan.nodes import IndexScan as JIndexScan
from hyperspace_tpu.plananalysis.explain import explain_string as jax_explain_string
from hyperspace_tpu.sources import delta as jsdelta
from hyperspace_tpu.sources import iceberg as jsiceberg
from hyperspace_tpu.util.file_utils import file_info_triple as jax_file_info_triple
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.lake import delta as tdelta
from hyperspace_tpu_torch.lake import iceberg as ticeberg
from hyperspace_tpu_torch.plan.nodes import IndexScan as TIndexScan
from hyperspace_tpu_torch.sources import delta as tsdelta
from hyperspace_tpu_torch.sources import iceberg as tsiceberg
from hyperspace_tpu_torch.util.file_utils import file_info_triple
from test_torch_introspection import fresh_io_counters, normalize
from test_torch_mutability import BASE_CONF, normalized_log

PKGS = ("jax", "torch")
DELTA = {"jax": jdelta, "torch": tdelta}
ICEBERG = {"jax": jiceberg, "torch": ticeberg}
DELTA_REL = {"jax": jsdelta.DeltaLakeRelation, "torch": tsdelta.DeltaLakeRelation}
ICEBERG_REL = {"jax": jsiceberg.IcebergRelation, "torch": tsiceberg.IcebergRelation}
OTHER = {"jax": "torch", "torch": "jax"}
WRITERS = pytest.mark.parametrize("writer", PKGS)


def arrow(lo, hi, groups=13, seed=0):
    """Rows lo..hi: an int64 key, a group of ``groups`` values and a float
    (the JAX tests' tables)."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(np.arange(lo, hi, dtype=np.int64)),
        "grp": pa.array((np.arange(lo, hi) % groups).astype(np.int64)),
        "v": pa.array(rng.uniform(0, 1, hi - lo)),
    })


def sorted_rows(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


class Lake:
    """One JAX session and one port session, each with its own system path,
    over tables under ``root``."""

    def __init__(self, root, conf=None):
        self.root = root
        c = dict(BASE_CONF, **(conf or {}))
        self.sessions = {
            "jax": hst.Session(conf=dict(c), system_path=str(root / "sys_jax")),
            "torch": ht.Session(conf=dict(c), system_path=str(root / "sys_torch"),
                                device="cpu")}

    def path(self, name="t"):
        return str(self.root / name)

    def hs(self, n):
        return (hst if n == "jax" else ht).Hyperspace(self.sessions[n])

    def set(self, key, value):
        for s in self.sessions.values():
            s.conf.set(key, value)

    def create(self, reader, name, indexed, included):
        """``reader(session)`` gives the DataFrame to index in each package."""
        for n, s in self.sessions.items():
            pkg = hst if n == "jax" else ht
            self.hs(n).create_index(reader(s), pkg.IndexConfig(name, indexed, included))

    def each(self, fn):
        return {n: fn(n, s) for n, s in self.sessions.items()}

    def query(self, reader, build, indexed=True):
        """(IndexScan leaves, arrow answer) per package of
        ``build(reader(session), col)``."""
        def run(n, s):
            df = build(reader(s), jcol if n == "jax" else ht.col)
            (s.enable_hyperspace if indexed else s.disable_hyperspace)()
            try:
                kind = JIndexScan if n == "jax" else TIndexScan
                leaves = [leaf for leaf in df.optimized_plan().collect_leaves()
                          if isinstance(leaf, kind)]
                return leaves, sorted_rows(df.to_arrow())
            finally:
                s.disable_hyperspace()
        return self.each(run)

    def assert_logs_equal(self, name):
        assert normalized_log(self.root / "sys_torch", name) == \
            normalized_log(self.root / "sys_jax", name)

    def entry(self, n, name):
        return self.sessions[n].index_collection_manager.get_index(name)


def assert_answers(lake, reader, build, expect_index=True):
    """Indexed answers equal between the packages and equal the scanned
    answer; returns the IndexScan leaves per package."""
    on = lake.query(reader, build)
    off = lake.query(reader, build, indexed=False)
    assert on["torch"][1].equals(on["jax"][1])
    assert on["torch"][1].equals(off["torch"][1])
    assert off["torch"][1].equals(off["jax"][1])
    assert bool(on["torch"][0]) == bool(on["jax"][0]) == expect_index
    return {n: on[n][0] for n in PKGS}


_UUID = re.compile(r"[0-9a-f]{32}")


def normalized_actions(table_path) -> list:
    """Each commit file's actions with uuids (part names, metadata ids)
    numbered in order of appearance and timestamps and mtimes taken out.
    The removes of one commit are sorted by path, that is by uuid, so each
    commit's actions are compared as a sorted list."""
    log_dir = os.path.join(table_path, "_delta_log")
    names = {}
    out = []
    for f in sorted(os.listdir(log_dir)):
        commit = []
        with open(os.path.join(log_dir, f)) as fh:
            for line in fh:
                if not line.strip():
                    continue
                text = _UUID.sub(lambda m: names.setdefault(m.group(0), f"U{len(names)}"),
                                 line)
                action = json.loads(text)
                for body in action.values():
                    for key in ("timestamp", "modificationTime", "deletionTimestamp"):
                        body.pop(key, None)
                commit.append(json.dumps(action, sort_keys=True))
        out.append(sorted(commit))
    return out


def normalized_iceberg(table) -> list:
    """Every metadata version with the snapshots' manifests inlined,
    snapshot ids numbered by the order of the snapshot list, part uuids by
    appearance, and the location, timestamps and mtimes taken out."""
    names = {}
    out = []
    meta_dir = os.path.join(table.path, "metadata")
    for v in range(1, table._latest_metadata_version() + 1):
        with open(os.path.join(meta_dir, f"v{v}.metadata.json")) as f:
            meta = json.load(f)
        ids = {s["snapshotId"]: f"S{i}" for i, s in enumerate(meta["snapshots"])}
        ids[None] = None
        meta["currentSnapshotId"] = ids[meta["currentSnapshotId"]]
        meta.pop("location")
        for snap in meta["snapshots"]:
            snap.pop("timestampMs")
            snap["snapshotId"] = ids[snap["snapshotId"]]
            snap["parentSnapshotId"] = ids[snap["parentSnapshotId"]]
            with open(os.path.join(table.path, snap["manifest"])) as f:
                snap["manifest"] = json.load(f)
            for part in snap["manifest"]["files"]:
                part.pop("modificationTime")
        text = _UUID.sub(lambda m: names.setdefault(m.group(0), f"U{len(names)}"),
                         json.dumps(meta, sort_keys=True))
        out.append(json.loads(text))
    return out


def snapshot_view(snap):
    return (snap.file_paths, snap.file_infos, snap.arrow_schema())


def first_part(table):
    """Version 0's first-written part (its add action comes first), so two
    writers remove the same rows."""
    return os.path.join(table.path, next(iter(table.snapshot(0)._files)))


# ---------------------------------------------------------------------------
# The commit-log table.
# ---------------------------------------------------------------------------

@WRITERS
def test_delta_create_append_remove_time_travel(tmp_path, writer):
    t = DELTA[writer].DeltaTable(str(tmp_path / "t"))
    assert t.create(arrow(0, 100), max_rows_per_file=40) == 0
    assert t.append(arrow(100, 150)) == 1
    victim = first_part(t)
    assert t.remove_files([victim]) == 2
    reader = DELTA[OTHER[writer]].DeltaTable(str(tmp_path / "t"))
    for v in range(3):
        assert snapshot_view(reader.snapshot(v)) == snapshot_view(t.snapshot(v))
    assert [len(reader.snapshot(v).file_paths) for v in range(3)] == [3, 4, 3]
    assert victim not in reader.snapshot(2).file_paths
    assert victim in reader.snapshot(0).file_paths  # history is immutable.
    assert [h["operation"] for h in reader.history()] == ["WRITE", "APPEND", "DELETE"]
    assert reader.history() == t.history()
    # The other package's writer commits the same actions.
    u = DELTA[OTHER[writer]].DeltaTable(str(tmp_path / "u"))
    u.create(arrow(0, 100), max_rows_per_file=40)
    u.append(arrow(100, 150))
    u.remove_files([first_part(u)])
    assert normalized_actions(u.path) == normalized_actions(t.path)


@pytest.mark.parametrize("first", PKGS)
def test_delta_concurrent_commit_conflicts(tmp_path, first):
    """The second package's writer loses version 1 to the first's."""
    DELTA[first].DeltaTable(str(tmp_path / "t")).create(arrow(0, 10))
    DELTA[first].DeltaTable(str(tmp_path / "t"))._write_commit(
        1, [{"commitInfo": {"operation": "APPEND"}}])
    second = DELTA[OTHER[first]]
    with pytest.raises(second.DeltaConcurrentModificationException):
        second.DeltaTable(str(tmp_path / "t"))._write_commit(
            1, [{"commitInfo": {"operation": "APPEND"}}])
    assert second.DeltaTable(str(tmp_path / "t")).latest_version() == 1


@WRITERS
def test_delta_overwrite_resets_files(tmp_path, writer):
    t = DELTA[writer].DeltaTable(str(tmp_path / "t"))
    t.create(arrow(0, 50), max_rows_per_file=25)
    t.overwrite(arrow(0, 10))
    reader = DELTA[OTHER[writer]].DeltaTable(str(tmp_path / "t"))
    assert len(reader.snapshot().file_paths) == 1
    assert len(reader.snapshot(0).file_paths) == 2
    assert snapshot_view(reader.snapshot()) == snapshot_view(t.snapshot())
    u = DELTA[OTHER[writer]].DeltaTable(str(tmp_path / "u"))
    u.create(arrow(0, 50), max_rows_per_file=25)
    u.overwrite(arrow(0, 10))
    assert normalized_actions(u.path) == normalized_actions(t.path)


# ---------------------------------------------------------------------------
# Indexes over commit-log tables.
# ---------------------------------------------------------------------------

def delta_reader(lake, version=None):
    return lambda s: s.read.delta(lake.path(), version_as_of=version)


def group_query(g, *cols):
    return lambda df, c: df.filter(c("grp") == g).select(*cols)


@WRITERS
def test_delta_index_used_and_answers_match(tmp_path, writer):
    lake = Lake(tmp_path)
    DELTA[writer].DeltaTable(lake.path()).create(arrow(0, 500))
    lake.create(delta_reader(lake), "dix", ["grp"], ["k", "v"])
    lake.assert_logs_equal("dix")
    assert_answers(lake, delta_reader(lake), group_query(5, "k", "v"))


def test_delta_version_signature_and_hybrid_scan(tmp_path):
    lake = Lake(tmp_path)
    table = jdelta.DeltaTable(lake.path())
    table.create(arrow(0, 400))
    lake.create(delta_reader(lake), "dix", ["grp"], ["k"])
    table.append(arrow(400, 430))
    # A new version's files: the index is unused without Hybrid Scan.
    assert_answers(lake, delta_reader(lake), group_query(3, "k"), expect_index=False)
    lake.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    leaves = assert_answers(lake, delta_reader(lake), group_query(3, "k"))
    assert leaves["torch"][0].appended_files == leaves["jax"][0].appended_files
    assert len(leaves["torch"][0].appended_files) == 1


def test_delta_hybrid_scan_deleted_files(tmp_path):
    lake = Lake(tmp_path, {IndexConstants.INDEX_LINEAGE_ENABLED: "true",
                           IndexConstants.INDEX_HYBRID_SCAN_ENABLED: "true",
                           # 1 of 3 equal files is ~0.33 of the bytes, above
                           # the 0.2 default: lift it so the delete rides
                           # Hybrid Scan.
                           IndexConstants.INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD: "0.5"})
    table = jdelta.DeltaTable(lake.path())
    table.create(arrow(0, 300), max_rows_per_file=100)
    lake.create(delta_reader(lake), "dix", ["grp"], ["k"])
    lake.assert_logs_equal("dix")
    table.remove_files([table.snapshot().file_paths[0]])
    leaves = assert_answers(lake, delta_reader(lake), group_query(1, "k"))
    assert leaves["torch"][0].deleted_file_ids == leaves["jax"][0].deleted_file_ids
    assert leaves["torch"][0].deleted_file_ids


def test_delta_version_history_accumulates(tmp_path):
    lake = Lake(tmp_path)
    table = jdelta.DeltaTable(lake.path())
    table.create(arrow(0, 200))
    lake.create(delta_reader(lake), "dix", ["grp"], ["k"])
    prop = tsdelta.DELTA_VERSION_HISTORY_PROPERTY

    def history():
        props = {n: lake.entry(n, "dix").derivedDataset.properties for n in PKGS}
        assert props["torch"][prop] == props["jax"][prop]
        return tsdelta.DeltaLakeRelation.parse_version_history(props["torch"])

    assert history() == [(1, 0)]  # create commits at log id 1, delta v0.
    table.append(arrow(200, 260))
    for n in PKGS:
        lake.hs(n).refresh_index("dix", "incremental")
    assert history() == [(1, 0), (3, 1)]
    for n in PKGS:
        lake.hs(n).optimize_index("dix", "full")
    assert history() == [(1, 0), (3, 1)]  # optimize keeps the latest entry's.
    lake.assert_logs_equal("dix")


def test_delta_closest_index_time_travel(tmp_path):
    lake = Lake(tmp_path)
    table = jdelta.DeltaTable(lake.path())
    table.create(arrow(0, 200))
    lake.create(delta_reader(lake), "dix", ["grp"], ["k"])
    table.append(arrow(200, 260))
    for n in PKGS:
        lake.hs(n).refresh_index("dix", "incremental")  # log 3 <-> delta v1.
    # A scan of v0 takes log version 1 (its source matches exactly), the
    # latest scan the refreshed entry.
    for version, log_id in ((0, 1), (None, 3)):
        leaves = assert_answers(lake, delta_reader(lake, version), group_query(2, "k"))
        assert leaves["jax"][0].index_entry.id == leaves["torch"][0].index_entry.id == log_id


def test_delta_refresh_unpins_time_traveled_create(tmp_path):
    lake = Lake(tmp_path)
    table = jdelta.DeltaTable(lake.path())
    table.create(arrow(0, 200))
    table.append(arrow(200, 260))
    lake.create(delta_reader(lake, 0), "dix", ["grp"], ["k"])
    for n in PKGS:
        lake.hs(n).refresh_index("dix", "incremental")  # must see v1's appends.
    lake.assert_logs_equal("dix")
    leaves = assert_answers(lake, delta_reader(lake), group_query(2, "k"))
    assert not leaves["torch"][0].appended_files and not leaves["jax"][0].appended_files


def test_delta_optimize_keeps_latest_entry(tmp_path):
    lake = Lake(tmp_path)
    table = jdelta.DeltaTable(lake.path())
    table.create(arrow(0, 200))
    lake.create(delta_reader(lake), "dix", ["grp"], ["k"])
    table.append(arrow(200, 260))
    for n in PKGS:
        lake.hs(n).refresh_index("dix", "incremental")  # log 3: multi-file buckets.
        lake.hs(n).optimize_index("dix", "full")        # log 5: compacted.
    lake.assert_logs_equal("dix")
    leaves = assert_answers(lake, delta_reader(lake), group_query(2, "k"))
    assert leaves["jax"][0].index_entry.id == leaves["torch"][0].index_entry.id == 5


def explain_texts(lake, reader, build):
    texts = {}
    for n, s in lake.sessions.items():
        df = build(reader(s), jcol if n == "jax" else ht.col)
        s.enable_hyperspace()
        fresh_io_counters()
        texts[n] = jax_explain_string(s, df.plan, diagnostics=False) if n == "jax" \
            else lake.hs(n).explain(df)
        s.disable_hyperspace()
    return texts


def test_delta_explain_mentions_index(tmp_path):
    lake = Lake(tmp_path)
    jdelta.DeltaTable(lake.path()).create(arrow(0, 100))
    lake.create(delta_reader(lake), "dix", ["grp"], ["k"])
    texts = explain_texts(lake, delta_reader(lake), group_query(1, "k"))
    assert "dix" in texts["torch"]
    assert normalize(texts["torch"], tmp_path) == normalize(texts["jax"], tmp_path)


@pytest.mark.parametrize("version,history,want", [
    (0, "1:0,3:2", 1), (1, "1:0,3:2", 1),
    # The latest pair covers the scanned version: None keeps the current
    # entry, even when its log id is newer (after optimize).
    (2, "1:0,3:2", None),
    (0, "5:1,7:2", 5),  # nothing at or before: the nearest overall.
    (0, "", None)])
def test_delta_closest_prefers_at_or_before_then_nearest(tmp_path, version, history, want):
    t = jdelta.DeltaTable(str(tmp_path / "t"))
    t.create(arrow(0, 10))
    t.append(arrow(10, 20))
    t.append(arrow(20, 30))
    props = {tsdelta.DELTA_VERSION_HISTORY_PROPERTY: history} if history else {}
    got = {n: DELTA_REL[n](str(tmp_path / "t"), {"versionAsOf": str(version)})
           .closest_index_log_version(props) for n in PKGS}
    assert got == {"jax": want, "torch": want}


@WRITERS
def test_delta_signature_is_version_based(tmp_path, writer):
    path = str(tmp_path / "t")
    t = DELTA[writer].DeltaTable(path)
    t.create(arrow(0, 50))

    def rels(options=None):
        out = {n: DELTA_REL[n](path, options) for n in PKGS}
        assert out["torch"].signature() == out["jax"].signature()
        assert out["torch"].describe() == out["jax"].describe()
        return out["torch"]

    sig0 = rels().signature()
    t.append(arrow(50, 60))
    assert rels().signature() != sig0
    # Time travel back to v0 gives the first signature again.
    assert rels({"versionAsOf": "0"}).signature() == sig0


@WRITERS
def test_delta_file_infos_from_log_match_stat(tmp_path, writer):
    DELTA[writer].DeltaTable(str(tmp_path / "t")).create(arrow(0, 50), max_rows_per_file=20)
    rels = {n: DELTA_REL[n](str(tmp_path / "t")) for n in PKGS}
    infos = rels["torch"].all_file_infos()
    assert infos == rels["jax"].all_file_infos()
    assert infos == [file_info_triple(p) for p in rels["torch"].all_files()]
    assert infos == [jax_file_info_triple(p) for p in rels["jax"].all_files()]
    assert rels["torch"].schema.names == rels["jax"].schema.names == ["k", "grp", "v"]
    assert [f.dtype for f in rels["torch"].schema.fields] == \
        [f.dtype for f in rels["jax"].schema.fields]


# ---------------------------------------------------------------------------
# The snapshot/manifest table.
# ---------------------------------------------------------------------------

def iceberg_view(table, snap_id):
    snap = table.snapshot(snap_id)
    return (snap.file_paths, snap.file_infos, snap.arrow_schema(), snap._manifest)


@WRITERS
def test_iceberg_create_append_remove_snapshots(tmp_path, writer):
    t = ICEBERG[writer].IcebergTable(str(tmp_path / "t"))
    s0 = t.create(arrow(0, 100, 7), max_rows_per_file=50)
    assert t.current_snapshot_id() == s0
    s1 = t.append(arrow(100, 130, 7))
    # The first-written part, so that both writers remove the same rows.
    victim = os.path.join(t.path, t.snapshot(s0)._manifest["files"][0]["path"])
    s2 = t.remove_files([victim])
    reader = ICEBERG[OTHER[writer]].IcebergTable(str(tmp_path / "t"))
    assert reader.current_snapshot_id() == s2
    assert reader.snapshot_ids() == [s0, s1, s2]
    for sid in (s0, s1, s2):
        assert iceberg_view(reader, sid) == iceberg_view(t, sid)
    assert [len(reader.snapshot(s).file_paths) for s in (s0, s1, s2)] == [2, 3, 2]
    assert victim not in reader.snapshot(s2).file_paths
    assert victim in reader.snapshot(s0).file_paths  # snapshots are immutable.
    # The other package's writer commits the same metadata and manifests.
    u = ICEBERG[OTHER[writer]].IcebergTable(str(tmp_path / "u"))
    u0 = u.create(arrow(0, 100, 7), max_rows_per_file=50)
    u.append(arrow(100, 130, 7))
    u.remove_files([os.path.join(u.path, u.snapshot(u0)._manifest["files"][0]["path"])])
    assert normalized_iceberg(u) == normalized_iceberg(t)


@pytest.mark.parametrize("first", PKGS)
def test_iceberg_concurrent_metadata_conflict(tmp_path, first):
    """The second package's commit of a metadata version loses to the
    first's."""
    t = ICEBERG[first].IcebergTable(str(tmp_path / "t"))
    t.create(arrow(0, 10, 7))
    meta = t._read_metadata()
    racer = dict(meta, metadataVersion=meta["metadataVersion"] + 1)
    t._commit_metadata(racer)
    second = ICEBERG[OTHER[first]]
    with pytest.raises(second.IcebergConcurrentModificationException):
        second.IcebergTable(str(tmp_path / "t"))._commit_metadata(dict(racer))


@WRITERS
def test_iceberg_record_counts_in_manifest(tmp_path, writer):
    ICEBERG[writer].IcebergTable(str(tmp_path / "t")).create(arrow(0, 95, 7),
                                                            max_rows_per_file=50)
    snap = ICEBERG[OTHER[writer]].IcebergTable(str(tmp_path / "t")).snapshot()
    assert sorted(f["recordCount"] for f in snap._manifest["files"]) == [45, 50]


def iceberg_reader(lake, snapshot_id=None):
    return lambda s: s.read.iceberg(lake.path(), snapshot_id=snapshot_id)


@WRITERS
def test_iceberg_index_used_and_answers_match(tmp_path, writer):
    lake = Lake(tmp_path)
    ICEBERG[writer].IcebergTable(lake.path()).create(arrow(0, 400, 7))
    lake.create(iceberg_reader(lake), "iix", ["grp"], ["k", "v"])
    lake.assert_logs_equal("iix")
    assert_answers(lake, iceberg_reader(lake), group_query(2, "k", "v"))


def test_iceberg_snapshot_signature_and_hybrid_scan(tmp_path):
    lake = Lake(tmp_path)
    table = jiceberg.IcebergTable(lake.path())
    s0 = table.create(arrow(0, 400, 7))
    lake.create(iceberg_reader(lake), "iix", ["grp"], ["k"])
    table.append(arrow(400, 430, 7))
    # A new snapshot: the signature differs.
    assert_answers(lake, iceberg_reader(lake), group_query(3, "k"), expect_index=False)
    lake.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    leaves = assert_answers(lake, iceberg_reader(lake), group_query(3, "k"))
    assert leaves["torch"][0].appended_files == leaves["jax"][0].appended_files
    assert leaves["torch"][0].appended_files
    # Time travel to the indexed snapshot: an exact match again.
    leaves = assert_answers(lake, iceberg_reader(lake, s0), group_query(3, "k"))
    assert not leaves["torch"][0].appended_files and not leaves["jax"][0].appended_files


def test_iceberg_explain_mentions_index(tmp_path):
    lake = Lake(tmp_path)
    jiceberg.IcebergTable(lake.path()).create(arrow(0, 100, 7))
    lake.create(iceberg_reader(lake), "iix", ["grp"], ["k"])
    texts = explain_texts(lake, iceberg_reader(lake), group_query(1, "k"))
    assert "iix" in texts["torch"]
    assert normalize(texts["torch"], tmp_path) == normalize(texts["jax"], tmp_path)


@WRITERS
def test_iceberg_signature_snapshot_based(tmp_path, writer):
    path = str(tmp_path / "t")
    t = ICEBERG[writer].IcebergTable(path)
    s0 = t.create(arrow(0, 50, 7))

    def rels(options=None):
        out = {n: ICEBERG_REL[n](path, options) for n in PKGS}
        assert out["torch"].signature() == out["jax"].signature()
        assert out["torch"].describe() == out["jax"].describe()
        return out["torch"]

    sig0 = rels().signature()
    t.append(arrow(50, 60, 7))
    assert rels().signature() != sig0
    assert rels({"snapshotId": str(s0)}).signature() == sig0


@WRITERS
def test_iceberg_file_infos_match_stat(tmp_path, writer):
    ICEBERG[writer].IcebergTable(str(tmp_path / "t")).create(arrow(0, 50, 7),
                                                            max_rows_per_file=20)
    rels = {n: ICEBERG_REL[n](str(tmp_path / "t")) for n in PKGS}
    infos = rels["torch"].all_file_infos()
    assert infos == rels["jax"].all_file_infos()
    assert infos == [file_info_triple(p) for p in rels["torch"].all_files()]
    assert infos == [jax_file_info_triple(p) for p in rels["jax"].all_files()]
    assert rels["torch"].schema.names == rels["jax"].schema.names


def test_format_option_load_equals_the_readers(tmp_path):
    """``option(...).format("delta"|"iceberg").load(path)`` is the reader
    methods' relation, in both packages."""
    lake = Lake(tmp_path)
    t = jdelta.DeltaTable(lake.path("d"))
    t.create(arrow(0, 30))
    t.append(arrow(30, 40))
    ib = jiceberg.IcebergTable(lake.path("i"))
    s0 = ib.create(arrow(0, 30, 7))
    ib.append(arrow(30, 40, 7))
    for n, s in lake.sessions.items():
        d = s.read.option("versionAsOf", 0).format("delta").load(lake.path("d"))
        i = s.read.option("snapshotId", s0).format("iceberg").load(lake.path("i"))
        assert d.plan.relation.describe() == \
            s.read.delta(lake.path("d"), version_as_of=0).plan.relation.describe()
        assert i.plan.relation.describe() == \
            s.read.iceberg(lake.path("i"), snapshot_id=s0).plan.relation.describe()
        assert d.to_arrow().num_rows == i.to_arrow().num_rows == 30
