"""The artifact store (``hyperspace_tpu_torch/artifacts/``) against the JAX
package's (``hyperspace_tpu/artifacts/``), on the CPU.

The store contract is held to the reference store's with opaque payloads
(the reference's executable codec replaced by the identity with
monkeypatch): layout, header, usage sidecar, eviction order, the
put-if-absent race, corrupt-blob quarantine, the ``artifacts.write`` crash
and the vacuum after it, and one root shared by both packages' stores.
The manager loads a library through the store into ``ctypes`` (a small
library g++ builds in ``tmp_path``; the CUDA kernel libraries need nvcc
and are held on the card by ``chip_smoke.py``), and the kernel build's
seam fetches instead of building. ``warmup()``, ``artifact_stats()``,
``recover()`` and ``compact()`` answer with the reference's keys, with
the store on and off.
"""

import ctypes
import json
import os
import subprocess
import sys
import threading

import pytest

import hyperspace_tpu as hj
import hyperspace_tpu_torch as ht
from hyperspace_tpu.artifacts import manager as jmanager
from hyperspace_tpu.artifacts import store as jstore
from hyperspace_tpu.robustness import faults as jfaults
from hyperspace_tpu_torch.artifacts import manager as tmanager
from hyperspace_tpu_torch.artifacts import store as tstore
from hyperspace_tpu_torch.artifacts.constants import ArtifactConstants as AC
from hyperspace_tpu_torch.ops import cuda_kernels
from hyperspace_tpu_torch.robustness import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TENV = {"torch": "2.x", "cuda": "12.8", "nvcc": "V12.8", "arch": "sm_90"}


@pytest.fixture()
def stores(monkeypatch):
    """Store factories of both packages over opaque payloads, with fixed
    runtime environments, and fresh manager registries."""
    monkeypatch.setattr(jstore, "_serialize_compiled", lambda c: bytes(c))
    monkeypatch.setattr(jstore, "_deserialize_compiled", lambda p: bytes(p))
    monkeypatch.setattr(tstore, "runtime_env", lambda: dict(TENV))
    monkeypatch.setattr(jmanager, "_REGISTRY", None)
    tmanager.reset_for_tests()

    def make(pkg, root, max_bytes=1 << 20):
        mod = jstore if pkg == "jax" else tstore
        return mod.ArtifactStore(str(root), max_bytes, usage_flush_ms=0.0)

    def fields(pkg, name):
        if pkg == "jax":
            return jstore.key_fields("bank", repr(("fused-predicate", name)), "sig")
        return tstore.key_fields(name, "src-digest", TENV)
    return make, fields


def _read_blob(path):
    with open(path, "rb") as f:
        head, _, payload = f.read().partition(b"\n")
    return json.loads(head), payload


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_layout_header_and_usage(stores, tmp_path, pkg):
    make, fields = stores
    store = make(pkg, tmp_path / pkg)
    f = fields(pkg, "hash_bucket")
    payload = b"\x7fELF" + bytes(range(200))
    assert store.publish(f, payload) is True
    assert store.publish(f, payload) is False  # already resident
    digest = (jstore if pkg == "jax" else tstore).key_digest(f)
    vdir = os.path.join(str(tmp_path / pkg), "v1") + ("/kernel" if pkg == "torch" else "")
    assert store.version_dir == vdir
    assert sorted(os.listdir(vdir)) == [digest + ".hsa"]
    header, body = _read_blob(os.path.join(vdir, digest + ".hsa"))
    assert body == payload and header["nbytes"] == len(payload)
    from hyperspace_tpu_torch.util import hashing
    assert header["md5"] == hashing.md5_hex(payload)
    assert {k: str(header[k]) for k in f} == f  # the full key rides in the header
    assert len(digest) == 24 and header["format"] == "1"
    store.record_use(digest)
    store.record_use(digest)
    with open(os.path.join(vdir, "usage.json")) as fh:
        usage = json.load(fh)
    assert usage["version"] == 1 and usage["tallies"][digest][0] == 2
    assert store.stats() == {"hits": 0, "misses": 0, "corrupt": 0, "persists": 1,
                             "persist_bytes": len(payload), "evictions": 0, "tallies": 1,
                             "blobs": 1, "resident_bytes": os.path.getsize(
                                 os.path.join(vdir, digest + ".hsa"))}


def test_eviction_order_equals_jax(stores, tmp_path):
    """Three blobs of ~1 KB under a budget of two: the coldest by usage
    tally goes, then ties by recency, in both packages."""
    make, fields = stores
    order = {}
    for pkg in ("jax", "torch"):
        mod = jstore if pkg == "jax" else tstore
        store = make(pkg, tmp_path / pkg, max_bytes=2500)
        names = ["a", "b", "c"]
        digests = [mod.key_digest(fields(pkg, n)) for n in names]
        store.publish(fields(pkg, "a"), b"x" * 1000)
        store.publish(fields(pkg, "b"), b"y" * 1000)
        for d in (digests[0], digests[0], digests[1]):
            store.record_use(d)
        store.publish(fields(pkg, "c"), b"z" * 1000)  # over budget: evict coldest
        left = {d for d, _n in store._list_blobs()}
        order[pkg] = ([names[i] for i, d in enumerate(digests) if d in left],
                      store.stats()["evictions"], [names[digests.index(d)]
                                                   for d in store.usage_order()])
    assert order["torch"] == order["jax"]
    assert order["torch"][:2] == (["a", "b"], 1)


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_put_if_absent_race(stores, tmp_path, rounds):
    """Two threads publish one key at once: one wins, the other's loss is
    success too, and the blob is whole. (The port's temps are per thread;
    the JAX package's are per process, so two of its threads can share a
    temp: its race is held in processes by its own tests.)"""
    make, fields = stores
    store = make("torch", tmp_path / f"r{rounds}")
    f = fields("torch", "compare_mask")
    barrier = threading.Barrier(2)
    won = []

    def publish():
        barrier.wait()
        won.append(store.publish(f, b"same bytes" * 100))
    threads = [threading.Thread(target=publish) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(won) == [False, True]
    assert store.stats()["persists"] == 1 and store.stats()["blobs"] == 1
    assert store.load(f) == b"same bytes" * 100
    assert not [n for n in os.listdir(store.version_dir) if n.startswith(".tmp-")]


@pytest.mark.parametrize("damage", ["payload", "header", "truncated"])
def test_corrupt_blob_is_quarantined_as_jax(stores, tmp_path, damage):
    make, fields = stores
    seen = {}
    for pkg, faults in (("jax", jfaults), ("torch", tfaults)):
        mod = jstore if pkg == "jax" else tstore
        store = make(pkg, tmp_path / pkg)
        f = fields(pkg, "range_mask")
        store.publish(f, b"good payload bytes")
        path = store.blob_path(mod.key_digest(f))
        with open(path, "rb") as fh:
            data = fh.read()
        if damage == "payload":
            data = data[:-1] + b"!"
        elif damage == "header":
            data = b"{not json" + data[data.index(b"\n"):]
        else:
            data = data[:10]
        with open(path, "wb") as fh:
            fh.write(data)
        before = faults.stats()["artifact_corruptions"]
        got = store.load(f)
        seen[pkg] = (got, os.path.exists(path), store.stats()["corrupt"],
                     store.stats()["misses"], faults.stats()["artifact_corruptions"] - before)
    assert seen["torch"] == seen["jax"] == (None, False, 1, 1, 1)


def test_write_fault_keeps_only_whole_blobs_and_vacuum_sweeps_a_crash(stores, tmp_path):
    """An armed ``artifacts.write`` error costs the publication only (no
    blob, no temp); a publisher killed there leaves a temp that vacuum
    sweeps, in both packages."""
    make, fields = stores
    seen = {}
    for pkg, faults in (("jax", jfaults), ("torch", tfaults)):
        store = make(pkg, tmp_path / pkg)
        f = fields(pkg, "masked_minmax")
        reg = faults.FaultRegistry.from_conf_specs({"artifacts.write": "error:nth=1"})
        with faults.scope(reg):
            assert store.publish(f, b"bytes") is False
        assert store.stats()["blobs"] == 0 and os.listdir(store.version_dir) == []
        # What a publisher killed at the point leaves behind.
        with open(os.path.join(store.version_dir, ".tmp-99999-deadbeef"), "wb") as fh:
            fh.write(b"{}\nhalf")
        assert store.load(f) is None
        seen[pkg] = store.vacuum()
        assert os.listdir(store.version_dir) == ["usage.json"]
    assert seen["torch"] == seen["jax"] == {"tmp_removed": 1, "stale_removed": 0,
                                            "corrupt_removed": 0, "evicted": 0}


def test_killed_publisher_leaves_a_temp_that_compact_sweeps(tmp_path):
    """kill:nth=1 at ``artifacts.write`` in a child process (a real
    SIGKILL between the temp write and the link): no blob, one temp; the
    parent's ``compact()`` sweeps it."""
    lake = tmp_path / "lake"
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import hyperspace_tpu_torch as ht
from hyperspace_tpu_torch.artifacts import manager, store
store.runtime_env = lambda: {TENV!r}
s = ht.Session(system_path={str(lake)!r}, device="cpu", conf={{
    "hyperspace.tpu.artifacts.enabled": "true",
    "hyperspace.tpu.robustness.faults.artifacts.write": "kill:nth=1"}})
from hyperspace_tpu_torch.robustness import faults
with faults.scope_for(s.hs_conf):
    manager.manager_for(s).store.publish(store.key_fields("k", "src", {TENV!r}), b"abc")
print("survived")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == -9 and "survived" not in p.stdout, p.stderr
    vdir = lake / "_hst_artifacts" / "v1" / "kernel"
    names = os.listdir(vdir)
    assert len(names) == 1 and names[0].startswith(".tmp-")
    s = ht.Session(system_path=str(lake), device="cpu",
                   conf={AC.ENABLED: "true"})
    out = ht.Hyperspace(s).compact()["artifacts"]
    assert out["enabled"] is True and out["tmp_removed"] == 1
    assert not os.listdir(vdir) or os.listdir(vdir) == ["usage.json"]


def test_one_root_shared_by_both_packages(stores, tmp_path):
    """Both packages' stores on one root keep their blobs apart: each loads
    its own, neither quarantines nor vacuums the other's, and a JAX blob
    copied into the port's kind directory is foreign there (never a hit,
    never removed)."""
    make, fields = stores
    root = tmp_path / "shared"
    js, ts = make("jax", root), make("torch", root)
    jf, tf = fields("jax", "x"), fields("torch", "hash_bucket")
    assert js.publish(jf, b"jax executable") and ts.publish(tf, b"torch library")
    for _ in range(2):
        assert js.vacuum()["stale_removed"] == 0 and ts.vacuum()["stale_removed"] == 0
    assert js.load(jf) == b"jax executable" and ts.load(tf) == b"torch library"
    assert js.stats()["blobs"] == ts.stats()["blobs"] == 1
    # A JAX blob in the port's directory: foreign.
    jblob = js.blob_path(jstore.key_digest(jf))
    foreign = os.path.join(ts.version_dir, os.path.basename(jblob))
    with open(jblob, "rb") as a, open(foreign, "wb") as b:
        b.write(a.read())
    digest = os.path.basename(foreign)[:-4]
    assert ts.load_by_digest(digest) is None
    summary = ts.vacuum()
    assert os.path.exists(foreign) and summary == {"tmp_removed": 0, "stale_removed": 0,
                                                   "corrupt_removed": 0, "evicted": 0}
    assert ts.stats()["corrupt"] == 0
    out = tmanager.ArtifactManager(ts).preload(5000.0, 1 << 20)
    assert out["loaded"] == 0 and os.path.exists(foreign)


def test_stale_runtime_is_a_silent_miss_then_vacuumed(stores, tmp_path, monkeypatch):
    make, fields = stores
    store = make("torch", tmp_path / "t")
    f = fields("torch", "bucket_histogram")
    store.publish(f, b"library")
    other = dict(TENV, arch="sm_80")
    monkeypatch.setattr(tstore, "runtime_env", lambda: dict(other))
    f2 = tstore.key_fields("bucket_histogram", "src-digest", other)
    assert store.load(f2) is None and store.stats()["corrupt"] == 0
    assert store.vacuum()["stale_removed"] == 1 and store.stats()["blobs"] == 0


# ---------------------------------------------------------------------------
# The manager: load-through into ctypes, and the kernel build's seam.
# ---------------------------------------------------------------------------

@pytest.fixture()
def tiny_library(tmp_path):
    src = tmp_path / "tiny.c"
    src.write_text("int hs_answer(void) { return 42; }\n")
    so = tmp_path / "libtiny.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-x", "c", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=120)
    return str(so)


def test_manager_loads_a_library_through_the_store(stores, tmp_path, tiny_library):
    make, _ = stores
    f = tstore.key_fields("tiny", "src", TENV)
    first = tmanager.ArtifactManager(make("torch", tmp_path / "lake"))
    assert first.put(f, tiny_library) is True
    fresh = tmanager.ArtifactManager(make("torch", tmp_path / "lake"))
    dest = str(tmp_path / "build" / "libtiny.so")
    assert fresh.fetch(f, dest) is True
    assert ctypes.CDLL(dest).hs_answer() == 42
    assert fresh.fetch(f, dest) is True  # the warm record
    st = fresh.stats()
    assert (st["hits"], st["warm_hits"], st["loaded_in_memory"]) == (1, 1, 1)


def test_build_fetches_from_the_store_instead_of_nvcc(stores, tmp_path, monkeypatch,
                                                      tiny_library):
    """With a manager, ``cuda_kernels.build`` writes a missing library from
    the store (no nvcc: this machine has none) and counts a store load; a
    corrupt blob is quarantined and the build then needs nvcc, which
    raises here: nothing falls back."""
    make, _ = stores
    monkeypatch.setattr(cuda_kernels, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(cuda_kernels, "runtime_env", lambda: dict(TENV))
    monkeypatch.setattr(cuda_kernels, "BUILD_STATS",
                        {"builds": 0, "build_seconds": 0.0, "store_loads": 0})
    mgr = tmanager.ArtifactManager(make("torch", tmp_path / "lake"))
    with open(tiny_library, "rb") as fh:
        payload = fh.read()
    for name in ("hash_bucket", "range_mask"):
        assert mgr.store.publish(cuda_kernels.artifact_fields(name), payload)
    paths = cuda_kernels.build(["hash_bucket"], manager=mgr)
    assert ctypes.CDLL(paths["hash_bucket"]).hs_answer() == 42
    assert cuda_kernels.BUILD_STATS == {"builds": 0, "build_seconds": 0.0, "store_loads": 1}
    blob = mgr.store.blob_path(tstore.key_digest(cuda_kernels.artifact_fields("range_mask")))
    with open(blob, "r+b") as fh:
        fh.seek(-1, 2)
        fh.write(b"\x00" if payload[-1:] != b"\x00" else b"\x01")
    with pytest.raises(cuda_kernels.KernelError, match="nvcc"):
        cuda_kernels.build(["range_mask"], manager=mgr)
    assert not os.path.exists(blob) and mgr.stats()["corrupt"] == 1


def test_a_library_that_does_not_load_is_quarantined(stores, tmp_path, monkeypatch):
    make, _ = stores
    monkeypatch.setattr(cuda_kernels, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(cuda_kernels, "runtime_env", lambda: dict(TENV))
    monkeypatch.setattr(cuda_kernels, "_ENTRIES", {})
    mgr = tmanager.ArtifactManager(make("torch", tmp_path / "lake"))
    fields = cuda_kernels.artifact_fields("masked_minmax")
    assert mgr.store.publish(fields, b"not a shared object")
    out = mgr.preload(5000.0, 1 << 20)
    assert (out["loaded"], out["skipped"]) == (0, 1)
    assert mgr.stats()["blobs"] == 0 and mgr.stats()["corrupt"] == 1
    assert not os.path.exists(cuda_kernels.library_path("masked_minmax"))


# ---------------------------------------------------------------------------
# The API surfaces.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enabled", [False, True])
def test_api_summaries_have_the_reference_keys(stores, tmp_path, enabled):
    conf = {AC.ENABLED: "true" if enabled else "false"}
    out = {}
    for pkg, mod in (("jax", hj), ("torch", ht)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        s = mod.Session(conf=dict(conf), system_path=str(tmp_path / pkg), **kw)
        hs = mod.Hyperspace(s)
        out[pkg] = [sorted(hs.warmup()), sorted(hs.artifact_stats()),
                    sorted(hs.recover()["artifacts"]), sorted(hs.compact()["artifacts"])]
    assert out["torch"] == out["jax"]
    if enabled:
        assert "budget_hit" in out["torch"][0] and "resident_bytes" in out["torch"][1]
        assert "tmp_removed" in out["torch"][2]
    else:
        assert out["torch"][1] == ["enabled"]


@pytest.mark.parametrize("key,value,want", [
    (AC.MAX_BYTES, "-5", 0), (AC.PRELOAD_MAX_MS, "-1", 0.0), (AC.PRELOAD_MAX_BYTES, "7", 7),
    (AC.USAGE_FLUSH_MS, "-3", 0.0), (AC.DIR, "  /x/y  ", "/x/y")])
def test_conf_keys_and_clamps_equal_jax(tmp_path, key, value, want):
    getter = {AC.MAX_BYTES: "artifacts_max_bytes", AC.PRELOAD_MAX_MS: "artifacts_preload_max_ms",
              AC.PRELOAD_MAX_BYTES: "artifacts_preload_max_bytes",
              AC.USAGE_FLUSH_MS: "artifacts_usage_flush_ms", AC.DIR: "artifacts_dir"}[key]
    got = []
    for mod, kw in ((hj, {}), (ht, {"device": "cpu"})):
        s = mod.Session(conf={key: value}, system_path=str(tmp_path), **kw)
        got.append(getattr(s.hs_conf, getter)())
    assert got == [want, want]
    from hyperspace_tpu.artifacts.constants import ArtifactConstants as JAC
    assert {k: v for k, v in vars(AC).items() if k.isupper()} == \
        {k: v for k, v in vars(JAC).items() if k.isupper()}


def test_preload_at_session_creation(stores, tmp_path, monkeypatch):
    """``artifacts.preload.enabled`` preloads at Session creation: a library
    that binds is loaded (and tallied), one without its entry point is
    skipped and quarantined."""
    monkeypatch.setattr(cuda_kernels, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(cuda_kernels, "runtime_env", lambda: dict(TENV))
    monkeypatch.setattr(cuda_kernels, "_ENTRIES", {})
    monkeypatch.setattr(cuda_kernels, "BUILD_STATS",
                        {"builds": 0, "build_seconds": 0.0, "store_loads": 0})
    libs = {}
    for name, symbol in (("bucket_histogram", "hs_bucket_histogram"),
                         ("masked_minmax", "not_its_entry_point")):
        src = tmp_path / f"{name}.c"
        src.write_text(f"int {symbol}(void) {{ return 0; }}\n")
        so = tmp_path / f"lib{name}.so"
        subprocess.run(["g++", "-shared", "-fPIC", "-x", "c", str(src), "-o", str(so)],
                       check=True, capture_output=True, timeout=120)
        libs[name] = so.read_bytes()
    conf = {AC.ENABLED: "true", AC.PRELOAD_ENABLED: "true"}
    lake = tmp_path / "lake"
    s = ht.Session(conf=dict(conf, **{AC.PRELOAD_ENABLED: "false"}), system_path=str(lake),
                   device="cpu")
    mgr = tmanager.manager_for(s)
    for name, payload in libs.items():
        assert mgr.store.publish(cuda_kernels.artifact_fields(name), payload)
    tmanager.reset_for_tests()
    s2 = ht.Session(conf=conf, system_path=str(lake), device="cpu")
    st = ht.Hyperspace(s2).artifact_stats()
    assert (st["preloaded"], st["corrupt"], st["blobs"], st["tallies"]) == (1, 1, 1, 1)
    assert "bucket_histogram" in cuda_kernels._ENTRIES
    assert cuda_kernels.BUILD_STATS["store_loads"] == 1
    assert ht.Hyperspace(s2).warmup()["loaded"] == 0  # already in this process


class EventSink:
    """The event logger the sessions below load by dotted name."""

    events = []

    def log_event(self, event):
        EventSink.events.append(event)


def test_compilation_section_and_compile_event_follow_the_builds(tmp_path, monkeypatch):
    """Explain's "Compilation:" section renders once a library was built or
    loaded (its shape-bucketing line is the JAX package's), and an
    execution that built libraries emits one KernelCompileEvent."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    from hyperspace_tpu_torch.execution import executor
    monkeypatch.setattr(cuda_kernels, "BUILD_STATS",
                        {"builds": 0, "build_seconds": 0.0, "store_loads": 0})
    d = tmp_path / "d"
    d.mkdir()
    pq.write_table(pa.table({"k": np.arange(50, dtype=np.int64)}), str(d / "p.parquet"))
    conf = {"hyperspace.eventLoggerClass": f"{__name__}.EventSink"}
    s = ht.Session(conf=conf, system_path=str(tmp_path / "ix"), device="cpu")
    js = hj.Session(conf=conf, system_path=str(tmp_path / "jx"))
    df = s.read.parquet(str(d)).filter(ht.col("k") > 3)
    assert "Compilation:" not in ht.Hyperspace(s).explain(df)
    inner = executor._execute

    def building(plan, needed, session):
        cuda_kernels.BUILD_STATS["builds"] += 2
        cuda_kernels.BUILD_STATS["build_seconds"] += 1.5
        return inner(plan, needed, session)
    monkeypatch.setattr(executor, "_execute", building)
    start = len(EventSink.events)
    df.to_arrow()
    compiles = [e for e in EventSink.events[start:] if type(e).__name__ == "KernelCompileEvent"]
    assert [(e.count, e.seconds, e.total) for e in compiles] == [(2, 1.5, 2)]
    text = ht.Hyperspace(s).explain(df)
    section = text[text.index("Compilation:"):].splitlines()
    assert section[2] == "kernel builds: total=2 seconds=1.50 store_loads=0"
    from hyperspace_tpu.plananalysis.explain import explain_string
    jdf = js.read.parquet(str(d)).filter(hj.plan.expr.col("k") > 3)
    jdf.to_arrow()  # the JAX package compiles: its section renders
    jtext = explain_string(js, jdf.plan)
    jsection = jtext[jtext.index("Compilation:"):].splitlines()
    assert section[3] == jsection[3] and section[3].startswith("shape bucketing: on")
