"""Index logs and index data on an object store, through both packages:
every scenario of ``tests/test_log_store.py`` and
``tests/test_object_store_residency.py`` side by side.

The op-log protocol runs over each package's ``InMemoryObjectStore`` (a flat
key space with a conditional put and no rename), and the two stores must
hold the same objects after the same steps. The residency lifecycle
(create, query, incremental refresh, optimize, delete, restore, vacuum)
runs on the local filesystem and on the built-in ``hsmem://`` store: the
answers, the op-log entries (timestamps and index files' mtimes
normalized) and the index data files must equal the JAX package's. Both
packages register ``hsmem://`` on the one process-global fsspec memory
filesystem, so each package gets a path root of its own in every test.
"""

import json
import os
import threading
import uuid

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.exceptions import HyperspaceException as JaxHyperspaceException
from hyperspace_tpu.index import data_store as jdata_store
from hyperspace_tpu.index import log_manager as jlog_manager
from hyperspace_tpu.index import log_store as jlog_store
from hyperspace_tpu.index.constants import States
from hyperspace_tpu.plan.expr import col as jcol
from hyperspace_tpu.plan.expr import sum_ as jsum
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index import data_store as tdata_store
from hyperspace_tpu_torch.index import log_entry as tlog_entry
from hyperspace_tpu_torch.index import log_manager as tlog_manager
from hyperspace_tpu_torch.index import log_store as tlog_store
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.util import file_utils as tfile_utils
from test_log_entry import make_entry
from test_torch_mutability import BASE_CONF

PKGS = ("jax", "torch")
LOG_STORE = {"jax": jlog_store, "torch": tlog_store}
LOG_MANAGER = {"jax": jlog_manager.IndexLogManager, "torch": tlog_manager.IndexLogManager}
DATA_STORE = {"jax": jdata_store, "torch": tdata_store}
ERRORS = {"jax": JaxHyperspaceException, "torch": HyperspaceException}


def entry(pkg: str, state: str):
    """test_log_entry's entry in ``state``, as the package's own class."""
    e = make_entry(state=state)
    return e if pkg == "jax" else tlog_entry.IndexLogEntry.from_json(e.to_json())


def managers(path="s3://bucket/indexes/idx"):
    """(manager, store) per package, each over its own in-memory store."""
    out = {}
    for n in PKGS:
        store = LOG_STORE[n].InMemoryObjectStore()
        out[n] = (LOG_MANAGER[n](path, store=store), store)
    return out


def assert_same_objects(pair) -> None:
    assert pair["torch"][1]._objects == pair["jax"][1]._objects


# ---------------------------------------------------------------------------
# The op-log protocol over a conditional-put object store.
# ---------------------------------------------------------------------------

def test_lifecycle_and_latest_stable():
    pair = managers()
    for n, (mgr, _) in pair.items():
        assert mgr.write_log(0, entry(n, States.CREATING))
        assert mgr.write_log(1, entry(n, States.ACTIVE))
        assert not mgr.write_log(1, entry(n, States.ACTIVE)), \
            "the conditional put must refuse an existing id"
        assert mgr.create_latest_stable_log(1)
        got = mgr.get_latest_stable_log()
        assert got is not None and got.state == States.ACTIVE
    assert_same_objects(pair)


def test_backward_scan_past_transient_tail():
    pair = managers()
    for n, (mgr, _) in pair.items():
        mgr.write_log(0, entry(n, States.CREATING))
        mgr.write_log(1, entry(n, States.ACTIVE))
        mgr.create_latest_stable_log(1)
        mgr.write_log(2, entry(n, States.REFRESHING))
        mgr.delete_latest_stable_log()
        got = mgr.get_latest_stable_log()
        assert got is not None and got.state == States.ACTIVE and got.id == 1
    assert_same_objects(pair)


def test_torn_tail_recovers():
    pair = managers("s3://b/idx")
    for n, (mgr, store) in pair.items():
        mgr.write_log(0, entry(n, States.CREATING))
        mgr.write_log(1, entry(n, States.ACTIVE))
        mgr.write_log(2, entry(n, States.REFRESHING))
        # A crash mid-upload leaves the tail object truncated.
        store.corrupt(mgr._path_from_id(2))
        got = mgr.get_latest_stable_log()
        assert got is not None and got.id == 1
    assert_same_objects(pair)


@pytest.mark.parametrize("pkg", PKGS)
def test_race_exactly_one_winner(pkg):
    mgr = LOG_MANAGER[pkg]("s3://b/idx", store=LOG_STORE[pkg].InMemoryObjectStore())
    wins = []
    barrier = threading.Barrier(16)

    def contend(i):
        barrier.wait()
        if mgr.write_log(5, entry(pkg, States.CREATING)):
            wins.append(i)

    threads = [threading.Thread(target=contend, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1, f"winners: {wins}"


def test_latest_id_lists_only_numeric_keys():
    pair = managers()
    for n, (mgr, _) in pair.items():
        mgr.write_log(0, entry(n, States.CREATING))
        mgr.write_log(1, entry(n, States.ACTIVE))
        mgr.create_latest_stable_log(1)  # writes the latestStable key too
        assert mgr.get_latest_id() == 1
    assert_same_objects(pair)


# ---------------------------------------------------------------------------
# Which store a path takes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_plain_path_is_local(tmp_path, pkg):
    mod = LOG_STORE[pkg]
    assert isinstance(mod.store_for_path(str(tmp_path)), mod.LocalFsLogStore)
    assert isinstance(mod.store_for_path(f"file://{tmp_path}"), mod.LocalFsLogStore)


@pytest.mark.parametrize("writer", PKGS)
def test_file_uri_addresses_the_real_path(tmp_path, writer):
    """A file:// URI is stripped to the filesystem path, and the other
    package reads the log through the plain path."""
    mgr = LOG_MANAGER[writer](f"file://{tmp_path}/idx")
    assert mgr.write_log(0, entry(writer, States.CREATING))
    assert os.path.isfile(str(tmp_path / "idx" / "_hyperspace_log" / "0"))
    for n in PKGS:
        assert LOG_MANAGER[n](str(tmp_path / "idx")).get_latest_id() == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_unregistered_scheme_is_a_clear_error(pkg):
    with pytest.raises(ERRORS[pkg], match="register_scheme"):
        LOG_STORE[pkg].store_for_path("abfss://container/path")
    with pytest.raises(ERRORS[pkg], match="register_scheme"):
        DATA_STORE[pkg].store_for_path("abfss://container/path")


@pytest.mark.parametrize("pkg", PKGS)
def test_registered_scheme_wins(pkg):
    mem = LOG_STORE[pkg].InMemoryObjectStore()
    scheme = f"testmem{pkg}"
    LOG_STORE[pkg].register_scheme(scheme, lambda p: mem)
    assert LOG_STORE[pkg].store_for_path(f"{scheme}://x/y") is mem
    # A manager over such a path writes its log there.
    mgr = LOG_MANAGER[pkg](f"{scheme}://x/idx")
    assert mgr.write_log(0, entry(pkg, States.CREATING))
    assert list(mem._objects) == [f"{scheme}://x/idx/_hyperspace_log/0"]


# ---------------------------------------------------------------------------
# A whole index on an object store.
# ---------------------------------------------------------------------------

def _source_frame(seed, n):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 200, n).astype(np.int64),
                         "v": rng.integers(0, 1000, n).astype(np.int64),
                         "s": rng.choice(["a", "b", "c"], n)})


@pytest.fixture(params=["local", "hsmem"])
def env(request, tmp_path):
    df = _source_frame(8, 2500)
    src = tmp_path / "src"
    src.mkdir()
    n = len(df)
    for i in range(4):
        pq.write_table(pa.Table.from_pandas(
            df.iloc[i * (n // 4):(i + 1) * (n // 4)].reset_index(drop=True)),
            src / f"part{i}.parquet")
    root = str(tmp_path) if request.param == "local" else f"hsmem://it-{uuid.uuid4().hex}"
    system_paths = {n: f"{root}/sys_{n}" for n in PKGS}
    conf = dict(BASE_CONF, **{IndexConstants.INDEX_LINEAGE_ENABLED: "true"})
    sessions = {"jax": hst.Session(conf=dict(conf), system_path=system_paths["jax"]),
                "torch": ht.Session(conf=dict(conf), system_path=system_paths["torch"],
                                    device="cpu")}
    return dict(sessions=sessions, df=df, src=str(src), tmp=tmp_path, kind=request.param,
                system_paths=system_paths)


def _hs(env, n):
    return (hst if n == "jax" else ht).Hyperspace(env["sessions"][n])


def _query(session, src, n):
    col, sum_ = (jcol, jsum) if n == "jax" else (ht.col, ht.sum_)
    return (session.read.parquet(src).filter(col("k").between(20, 120))
            .group_by("k").agg(sum_(col("v")).alias("sv")))


def _oracle(df):
    m = df[df.k.between(20, 120)]
    return m.groupby("k").agg(sv=("v", "sum")).reset_index()


def _assert_matches(env, extra=None):
    """The indexed query in both packages: an IndexScan over the store's
    index, equal answers, and the pandas oracle's."""
    df = env["df"] if extra is None else pd.concat([env["df"], extra], ignore_index=True)
    exp = _oracle(df).sort_values("k").reset_index(drop=True)
    got = {}
    for n, s in env["sessions"].items():
        s.enable_hyperspace()
        q = _query(s, env["src"], n)
        assert any("IndexScan" in leaf.simple_string()
                   for leaf in q.optimized_plan().collect_leaves()), \
            f"{n}: the query did not use the store-resident index"
        got[n] = q.to_arrow()
        s.disable_hyperspace()
        pd.testing.assert_frame_equal(
            got[n].to_pandas().sort_values("k").reset_index(drop=True), exp,
            check_dtype=False)
    assert got["torch"].equals(got["jax"])


def _store_log(env, n, name) -> list:
    """The index's op-log entries read through its store, with timestamps,
    index files' mtimes and the system path normalized."""
    path = f"{env['system_paths'][n]}/{name}"
    mgr = tlog_manager.IndexLogManager(path)
    out = []
    for i in sorted(mgr.get_all_ids()):
        e = json.loads(mgr._store.read(mgr._path_from_id(i)))
        e["timestamp"] = 0

        def walk(node):
            if isinstance(node, dict):
                if "modifiedTime" in node and str(node.get("name", "")).startswith("part-"):
                    node["modifiedTime"] = 0
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)
        walk(e)
        out.append(json.dumps(e).replace(f"sys_{n}", "SYS")
                   .replace('"hyperspace_tpu_torch.index.', '"hyperspace_tpu.index.'))
    return out


def _data_files(env, n, name) -> dict:
    entry_ = env["sessions"][n].index_collection_manager.get_index(name)
    out = {}
    for f in entry_.content.files:
        fs, norm = tdata_store.fs_and_path(f)
        out[f.split(f"sys_{n}", 1)[1]] = pq.read_table(norm, filesystem=fs, partitioning=None)
    return out


def _assert_index_equal(env, name):
    assert _store_log(env, "torch", name) == _store_log(env, "jax", name)
    got, want = _data_files(env, "torch", name), _data_files(env, "jax", name)
    assert sorted(got) == sorted(want)
    for f in got:
        assert got[f].equals(want[f]), f


def _each(env, fn):
    for n in PKGS:
        fn(_hs(env, n), env["sessions"][n])


def test_full_lifecycle(env):
    _each(env, lambda hs, s: hs.create_index(
        s.read.parquet(env["src"]),
        (hst if isinstance(s, hst.Session) else ht).IndexConfig("resIdx", ["k"], ["v", "s"])))
    _assert_index_equal(env, "resIdx")
    _assert_matches(env)

    # Incremental refresh over an appended source file.
    extra = _source_frame(77, 300)
    pq.write_table(pa.Table.from_pandas(extra), env["tmp"] / "src" / "extra.parquet")
    _each(env, lambda hs, s: hs.refresh_index("resIdx", "incremental"))
    _assert_matches(env, extra)

    # Optimize: every bucket's files compacted.
    _each(env, lambda hs, s: hs.optimize_index("resIdx", "full"))
    _assert_index_equal(env, "resIdx")
    _assert_matches(env, extra)

    # Delete (soft), restore, delete, vacuum (hard).
    for n in PKGS:
        hs = _hs(env, n)
        hs.delete_index("resIdx")
        assert hs.index("resIdx")["state"].iloc[0] == "DELETED"
        hs.restore_index("resIdx")
        assert hs.index("resIdx")["state"].iloc[0] == "ACTIVE"
    _assert_matches(env, extra)
    for n in PKGS:
        hs = _hs(env, n)
        hs.delete_index("resIdx")
        hs.vacuum_index("resIdx")
        rows = hs.indexes()
        row = rows[rows["name"] == "resIdx"]
        assert len(row) == 0 or row.iloc[0]["state"] == "DOESNOTEXIST"
    assert _store_log(env, "torch", "resIdx") == _store_log(env, "jax", "resIdx")


def test_listing_and_stats_through_store(env):
    _each(env, lambda hs, s: hs.create_index(
        s.read.parquet(env["src"]),
        (hst if isinstance(s, hst.Session) else ht).IndexConfig("resIdx2", ["k"], ["v"])))
    rows, stats = {}, {}
    for n in PKGS:
        hs = _hs(env, n)
        rows[n] = hs.indexes()
        stats[n] = hs.index("resIdx2")
        assert "resIdx2" in set(rows[n]["name"])
        assert stats[n]["state"].iloc[0] == "ACTIVE"
        assert int(stats[n]["indexFileCount"].iloc[0]) > 0
    for c in ("name", "indexedColumns", "includedColumns", "numBuckets", "state"):
        assert list(rows["torch"][c]) == list(rows["jax"][c]), c
    for c in ("indexFileCount", "indexSizeBytes", "numBuckets"):
        assert stats["torch"][c].iloc[0] == stats["jax"][c].iloc[0], c


def test_no_rename_needed_on_object_store(env, monkeypatch):
    """On hsmem:// the index's files are the store's, and the whole
    lifecycle runs with every rename made to fail (the store has none, and
    no local file takes part); on the local filesystem they lie under the
    system path."""
    if env["kind"] == "hsmem":
        import fsspec.implementations.memory as memory

        def refuse(*args, **kwargs):
            raise AssertionError("a rename on the object-store path")

        for name in ("mv", "move", "rename"):
            monkeypatch.setattr(memory.MemoryFileSystem, name, refuse)
        monkeypatch.setattr(os, "rename", refuse)
        monkeypatch.setattr(os, "replace", refuse)
    for n in PKGS:
        hs, s = _hs(env, n), env["sessions"][n]
        hs.create_index(s.read.parquet(env["src"]),
                        (hst if n == "jax" else ht).IndexConfig("resIdx3", ["k"], ["v"]))
        files = list(s.index_collection_manager.get_index("resIdx3").content.files)
        assert files and all(f.startswith(env["system_paths"][n] + "/resIdx3/")
                             for f in files), files
        if env["kind"] == "hsmem":
            assert all(f.startswith("hsmem://") for f in files)
            assert not os.path.exists(str(env["tmp"] / f"sys_{n}"))
    _assert_index_equal(env, "resIdx3")
    for n in PKGS:
        hs = _hs(env, n)
        hs.delete_index("resIdx3")
        hs.vacuum_index("resIdx3")
        assert not tfile_utils.is_dir(env["system_paths"][n] + "/resIdx3/v__=0")
