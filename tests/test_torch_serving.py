"""The serving tier's context, keys and result cache
(``hyperspace_tpu_torch/serving/{context,fingerprint,result_cache}.py``,
``Session.execute``, ``Session.result_cache``, the SQL plan memo and the
"Result cache:" section of explain) against the JAX package's, on the same
numpy-seeded files.

Each case runs one sequence through both packages: the answers must be
equal bit for bit, and the cache's hit, miss, admission, demotion and
eviction counts equal for the same sequence. The oracles are the JAX
package's ``tests/test_result_cache.py`` and
``tests/test_result_cache_concurrency.py``; the spill tier's corrupt and
torn files follow ``tests/test_robustness.py::TestSpillTier``.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import buffer_pool as jbuffer_pool
from hyperspace_tpu.execution.columnar import Table as JTable
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.serving import fingerprint as jfp
from hyperspace_tpu.serving import result_cache as jrc
from hyperspace_tpu_torch.execution import buffer_pool as tbuffer_pool
from hyperspace_tpu_torch.execution.columnar import Table as TTable
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.parallel import io as tio
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.serving import fingerprint as tfp
from hyperspace_tpu_torch.serving import result_cache as trc
from hyperspace_tpu_torch.serving.constants import ServingConstants as SC
from hyperspace_tpu_torch.serving.context import QueryContext, active_context

# One conf for both packages (the conf hash then agrees); conftest gives
# JAX 8 virtual devices, which would take its mesh build.
BASE_CONF = {"hyperspace.tpu.distributed.enabled": "false",
             "hyperspace.tpu.execution.fusion.enabled": "false",
             IndexConstants.INDEX_NUM_BUCKETS: "4"}
CACHE_ON = {SC.RESULT_CACHE_ENABLED: "true", SC.RESULT_CACHE_MIN_COMPUTE_SECONDS: "0"}
PKGS = {"jax": (hst, JE), "torch": (ht, TE)}
COUNTERS = ("hits", "device_hits", "host_hits", "spill_hits", "misses", "admissions",
            "rejections", "demotions", "evictions", "spill_corruptions", "device_entries",
            "host_entries", "spill_entries")


def _write(d, n=4000, seed=7, name="p0.parquet", k_mod=50):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"k": rng.integers(0, k_mod, n).astype(np.int64),
                       "v": rng.integers(0, 9, n).astype(np.int64)})
    os.makedirs(str(d), exist_ok=True)
    pq.write_table(pa.Table.from_pandas(df), os.path.join(str(d), name))
    return df


def _session(pkg, system_path, enabled=True, **conf):
    mod = PKGS[pkg][0]
    full = dict(BASE_CONF, **(CACHE_ON if enabled else {}), **conf)
    if pkg == "torch":
        return mod.Session(conf=full, system_path=str(system_path), device="cpu")
    return mod.Session(conf=full, system_path=str(system_path))


def _both(tmp_path, enabled=True, shared_path=False, **conf):
    """(jax session, torch session); with ``shared_path`` they share one
    system path (for cases that build no index), so their confs match."""
    return {pkg: _session(pkg, tmp_path / ("ix" if shared_path else f"ix_{pkg}"), enabled,
                          **conf) for pkg in PKGS}


def _counts(cache) -> dict:
    s = cache.stats()
    return {k: s[k] for k in COUNTERS}


def fresh_pools():
    for bp in (jbuffer_pool, tbuffer_pool):
        bp.get_pool().clear()
        bp.get_pool().reset_stats()


# ---------------------------------------------------------------------------
# The cache alone: the same sequence gives the same tiers and counts.
# ---------------------------------------------------------------------------

def _small_table(pkg, n=64, fill=1):
    t = pa.table({"x": pa.array(np.full(n, fill, np.int64))})
    return JTable.from_arrow(t) if pkg == "jax" else TTable.from_arrow(t, "cpu")


def _key(pkg, tag):
    return (jfp if pkg == "jax" else tfp).ResultCacheKey(f"plan-{tag}", f"src-{tag}", (),
                                                         "conf")


def _cache(pkg, *args, **kwargs):
    return (jrc if pkg == "jax" else trc).ResultCache(*args, **kwargs)


def _nbytes(pkg, table):
    return (jrc if pkg == "jax" else trc).table_nbytes(table)


def _lru_sequence(pkg):
    t = _small_table(pkg)
    n = _nbytes(pkg, t)
    evicted = []
    cache = _cache(pkg, 2 * n, 2 * n, on_evict=lambda *a: evicted.append((a[0], a[2])))
    tiers = [cache.put(_key(pkg, i), t) for i in range(1, 4)]
    tiers.append(cache.peek(_key(pkg, 1)))
    tiers += [cache.put(_key(pkg, i), t) for i in (4, 5)]
    s = cache.stats()
    assert s["device_nbytes"] <= cache.device_bytes and s["host_nbytes"] <= cache.host_bytes
    return tiers, _counts(cache), evicted


def _recency_sequence(pkg):
    t = _small_table(pkg)
    cache = _cache(pkg, 2 * _nbytes(pkg, t), 10 * _nbytes(pkg, t))
    cache.put(_key(pkg, "a"), t)
    cache.put(_key(pkg, "b"), t)
    out = [cache.get(_key(pkg, "a"))[1]]
    cache.put(_key(pkg, "c"), t)
    out += [cache.peek(_key(pkg, "a")), cache.peek(_key(pkg, "b")),
            cache.get(_key(pkg, "b"))[1], cache.get(_key(pkg, "zzz"))]
    return out, _counts(cache)


def _no_host_room_sequence(pkg):
    t = _small_table(pkg)
    n = _nbytes(pkg, t)
    evicted = []
    cache = _cache(pkg, 2 * n, 0, on_evict=lambda *a: evicted.append((a[0], a[2])))
    for i in range(1, 4):
        cache.put(_key(pkg, i), t)
    return _counts(cache), evicted


def _oversized_sequence(pkg):
    cache = _cache(pkg, 16, 16)
    return cache.put(_key(pkg, "big"), _small_table(pkg, n=4096)), _counts(cache)


def _clear_sequence(pkg):
    t = _small_table(pkg)
    cache = _cache(pkg, 10 * _nbytes(pkg, t), 10 * _nbytes(pkg, t))
    cache.put(_key(pkg, 1), t)
    cache.clear()
    s = cache.stats()
    return _counts(cache), s["device_nbytes"], s["host_nbytes"]


@pytest.mark.parametrize("sequence", [_lru_sequence, _recency_sequence,
                                      _no_host_room_sequence, _oversized_sequence,
                                      _clear_sequence])
def test_cache_sequence_equals_jax(sequence):
    """TestResultCacheUnit's sequences: the tiers each put and probe lands
    in, the eviction callbacks and every counter are the JAX package's."""
    assert sequence("torch") == sequence("jax")


def test_lru_demotes_then_evicts():
    tiers, counts, evicted = _lru_sequence("torch")
    assert tiers[:4] == ["device", "device", "device", "host"]
    assert counts["demotions"] >= 1 and counts["evictions"] >= 1
    assert ("host", False) in evicted and ("device", True) in evicted


def _spill_sequence(pkg, tmp_path, corrupt=None):
    t = _small_table(pkg, n=32, fill=3)
    n = _nbytes(pkg, t)
    cache = _cache(pkg, 0, n, spill_dir=str(tmp_path / f"spill_{pkg}"), spill_bytes=10 * n)
    out = [cache.put("a", t), cache.put("b", t), cache.peek("a"), cache.peek("b")]
    if corrupt is not None:
        path = cache._spill["a"][0]
        corrupt(path)
        out += [cache.get("a"), os.path.exists(path)]
    else:
        got, tier = cache.get("a")
        out += [tier, got.to_arrow().equals(t.to_arrow()), cache.peek("a"), cache.peek("b"),
                cache.get("a")[1]]
    return out, _counts(cache)


def _garbage(path):
    with open(path, "wb") as f:
        f.write(b"garbage bytes, definitely not a spilled table")


def _torn(path):
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])


@pytest.mark.parametrize("corrupt", [None, _garbage, _torn], ids=["read_back", "garbage",
                                                                    "torn"])
def test_spill_tier_equals_jax(tmp_path, corrupt):
    """Host victims spill to length-framed files and read back (a hit comes
    back to the host tier); a garbage or torn file is a miss that drops the
    entry and its file, never an error."""
    got = _spill_sequence("torch", tmp_path, corrupt)
    assert got == _spill_sequence("jax", tmp_path, corrupt)
    if corrupt is not None:
        assert got[0][4:] == [None, False] and got[1]["spill_corruptions"] == 1
    else:
        assert got[0][4:] == ["spill", True, "host", "spill", "host"]


def test_device_tier_holds_the_sessions_device(tmp_path):
    """A device-tier entry is moved onto the cache's device; a host-tier
    entry is a CPU copy."""
    t = _small_table("torch")
    cache = trc.ResultCache(10 * trc.table_nbytes(t), 10 * trc.table_nbytes(t), device="cpu")
    cache.put("k", t)
    table, tier = cache.get("k")
    assert tier == "device" and table.device.type == "cpu"


def test_concurrent_get_put_under_pressure():
    """12 threads share one small cache: no errors, budgets hold and the
    counters reconcile (tests/test_result_cache_concurrency.py)."""
    tables = [TTable.from_arrow(pa.table({"x": pa.array(np.full(256, i, np.int64))}), "cpu")
              for i in range(8)]
    nbytes = trc.table_nbytes(tables[0])
    cache = trc.ResultCache(3 * nbytes, 3 * nbytes)
    errors = []

    def worker(tid):
        try:
            rng = np.random.default_rng(tid)
            for _ in range(40):
                key = tfp.ResultCacheKey(f"p{int(rng.integers(0, 8))}", "s", (), "c")
                if cache.get(key) is None:
                    cache.put(key, tables[int(rng.integers(0, 8))])
                cache.get(tfp.ResultCacheKey(f"p{int(rng.integers(0, 8))}", "s", (), "c"))
        except Exception as e:  # pragma: no cover - the failure channel
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often, to expose lost updates
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    s = cache.stats()
    assert s["device_nbytes"] <= cache.device_bytes and s["host_nbytes"] <= cache.host_bytes
    assert s["hits"] + s["misses"] == 12 * 40 * 2
    assert s["device_nbytes"] == sum(n for _, n in cache._device.values())
    assert s["host_nbytes"] == sum(n for _, n in cache._host.values())


# ---------------------------------------------------------------------------
# Keys.
# ---------------------------------------------------------------------------

def _df(session, d):
    return session.read.parquet(str(d))


def test_plan_fingerprint_equals_jax(tmp_path):
    """The plan reprs are the JAX package's, so the fingerprint of the same
    plan is too; with one conf, so is the whole key."""
    _write(tmp_path / "d")
    ss = _both(tmp_path, shared_path=True)
    keys = {}
    for pkg, s in ss.items():
        E = PKGS[pkg][1]
        r = _df(s, tmp_path / "d")
        plans = [r.filter(E.col("k") == 3).select("k", "v").plan,
                 r.filter((E.col("k") < 10) & (E.col("v") >= 2)).group_by("k")
                 .agg(E.sum_(E.col("v")).alias("sv")).sort("k").plan,
                 r.select("k").limit(5).plan]
        fp = tfp if pkg == "torch" else jfp
        keys[pkg] = [fp.compute_key(s, p) for p in plans]
        assert all(k is not None for k in keys[pkg])
    assert [k.plan_fingerprint for k in keys["torch"]] == \
        [k.plan_fingerprint for k in keys["jax"]]
    assert [dataclasses.astuple(k) for k in keys["torch"]] == \
        [dataclasses.astuple(k) for k in keys["jax"]]
    assert [k.digest() for k in keys["torch"]] == [k.digest() for k in keys["jax"]]


def test_key_derivation(tmp_path):
    """TestKeyDerivation: syntactic variants share a key, predicates differ,
    the switch and the conf flip it, an in-place file change flips the
    source signature, an unknown node is not cacheable."""
    _write(tmp_path / "d")
    s = _session("torch", tmp_path / "ix")
    df = _df(s, tmp_path / "d")
    a = df.filter(TE.col("k") == 3).select("k", "v")
    b = df.select("k", "v").filter(TE.col("k") == 3)
    assert tfp.compute_key(s, a.plan) == tfp.compute_key(s, b.plan) is not None
    assert tfp.compute_key(s, df.filter(TE.col("k") == 3).plan) != \
        tfp.compute_key(s, df.filter(TE.col("k") == 4).plan)
    k1 = tfp.compute_key(s, df.plan)
    s.enable_hyperspace()
    k2 = tfp.compute_key(s, df.plan)
    assert k1 != k2
    s.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 8)
    assert tfp.compute_key(s, df.plan) != k2
    # The serving knobs are not hashed: tuning them keeps warm keys.
    s.conf.set(SC.RESULT_CACHE_MIN_COMPUTE_SECONDS, "9")
    assert tfp.compute_key(s, df.plan).config_hash == tfp.compute_key(s, df.plan).config_hash
    before = tfp.compute_key(s, df.plan).source_signature
    _write(tmp_path / "d", n=4100, seed=8)
    assert tfp.compute_key(s, df.plan).source_signature != before

    from hyperspace_tpu_torch.plan.nodes import LogicalPlan
    from hyperspace_tpu_torch.schema import Schema

    class Odd(LogicalPlan):
        @property
        def schema(self):
            return Schema([])

    assert tfp.compute_key(s, Odd()) is None


def test_estimate_recompute_bytes_equals_jax(tmp_path):
    _write(tmp_path / "d")
    ss = _both(tmp_path)
    est = {}
    for pkg, s in ss.items():
        E = PKGS[pkg][1]
        fp = tfp if pkg == "torch" else jfp
        est[pkg] = fp.estimate_recompute_bytes(
            fp.normalize(_df(s, tmp_path / "d").filter(E.col("k") < 3).plan))
    assert est["torch"] == est["jax"] > 0


# ---------------------------------------------------------------------------
# Through the session.
# ---------------------------------------------------------------------------

def _query(pkg, s, d, k=1):
    E = PKGS[pkg][1]
    return _df(s, d).filter(E.col("k") == k).select("k", "v")


def _run_both(tmp_path, steps, enabled=True, **conf):
    """Run ``steps(pkg, session)`` -> list of arrow tables through both
    packages; return ({pkg: tables}, {pkg: session})."""
    ss = _both(tmp_path, enabled=enabled, **conf)
    return {pkg: steps(pkg, s) for pkg, s in ss.items()}, ss


def test_off_by_default_and_identical_answers(tmp_path):
    _write(tmp_path / "d")

    def steps(pkg, s):
        assert s.result_cache is None
        q = _df(s, tmp_path / "d").filter(PKGS[pkg][1].col("k") < 10).select("k", "v")
        off = q.to_arrow()
        s.conf.set(SC.RESULT_CACHE_ENABLED, "true")
        s.conf.set(SC.RESULT_CACHE_MIN_COMPUTE_SECONDS, "0")
        assert s.result_cache is not None
        out = [off, q.to_arrow(), q.to_arrow()]
        assert out[0].equals(out[1]) and out[0].equals(out[2])
        return out, _counts(s.result_cache)

    got, _ = _run_both(tmp_path, steps, enabled=False)
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][1]["hits"] == 1 and got["torch"][1]["misses"] == 1
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert a.equals(b)


def test_hit_is_the_same_bytes(tmp_path):
    _write(tmp_path / "d")

    def steps(pkg, s):
        q = _query(pkg, s, tmp_path / "d")
        return [q.to_arrow(), q.to_arrow()], _counts(s.result_cache)

    got, ss = _run_both(tmp_path, steps)
    assert got["torch"][0][0].equals(got["torch"][0][1])
    assert got["torch"][0][1].equals(got["jax"][0][1])
    assert got["torch"][1] == got["jax"][1] and got["torch"][1]["device_hits"] == 1


def test_admission_floors(tmp_path):
    _write(tmp_path / "d")

    def steps(pkg, s):
        s.conf.set(SC.RESULT_CACHE_MIN_COMPUTE_SECONDS, "1e6")
        q = _df(s, tmp_path / "d").filter(PKGS[pkg][1].col("k") == 1)
        q.to_arrow()
        first = _counts(s.result_cache)
        s.conf.set(SC.RESULT_CACHE_MIN_COMPUTE_SECONDS, "0")
        s.conf.set(SC.RESULT_CACHE_MIN_INPUT_BYTES, str(1 << 50))
        q.to_arrow()
        return first, _counts(s.result_cache)

    got, _ = _run_both(tmp_path, steps)
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["admissions"] == 0 and got["torch"][1]["rejections"] == 2


def test_served_from_host_tier_after_demotion(tmp_path):
    _write(tmp_path / "d")

    def steps(pkg, s):
        E = PKGS[pkg][1]
        q1 = _df(s, tmp_path / "d").filter(E.col("k") == 1)
        one = q1.to_arrow()
        nbytes = s.result_cache.stats()["device_nbytes"]
        s.conf.set(SC.RESULT_CACHE_DEVICE_BYTES, str(nbytes))  # rebuilds the cache
        cache = s.result_cache
        q1.to_arrow()
        q2 = _df(s, tmp_path / "d").filter(E.col("k") == 1).select("v", "k")
        q2.to_arrow()  # an equal-sized second entry demotes the first
        served = q1.to_arrow()
        assert served.equals(one)
        return served, _counts(cache)

    got, _ = _run_both(tmp_path, steps)
    assert got["torch"][0].equals(got["jax"][0])
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][1]["demotions"] == 1 and got["torch"][1]["host_hits"] == 1


def test_floors_are_live_and_budgets_rebuild(tmp_path):
    """Tuning an admission floor keeps the instance and its warm entries;
    a budget change builds a new cache."""
    _write(tmp_path / "d")
    s = _session("torch", tmp_path / "ix")
    q = _query("torch", s, tmp_path / "d")
    q.to_arrow()
    cache = s.result_cache
    s.conf.set(SC.RESULT_CACHE_MIN_COMPUTE_SECONDS, "999")
    assert s.result_cache is cache
    q.to_arrow()
    assert cache.stats()["hits"] == 1
    s.conf.set(SC.RESULT_CACHE_DEVICE_BYTES, str(1 << 20))
    assert s.result_cache is not cache


def _append(d, seed, n=300):
    _write(d, n=n, seed=seed, name=f"extra{seed}.parquet")


def test_invalidation_on_every_mutation(tmp_path):
    """A cached query after each mutation: create, a no-op refresh, a real
    full refresh, incremental refresh, optimize, delete and restore, and a
    source append read through a fresh relation. Every answer equals the
    JAX package's and a cache-off run's, and the hit and miss counts after
    each step are the JAX package's."""
    def steps(pkg, s):
        mod, E = PKGS[pkg]
        d = tmp_path / f"d_{pkg}"
        _write(d, seed=5, k_mod=60)
        hs = mod.Hyperspace(s)
        s.conf.set(IndexConstants.INDEX_LINEAGE_ENABLED, "true")
        trace = []

        def check(tag):
            q = _df(s, d).filter(E.col("k") == 7).select("k", "v")
            a1, a2 = q.to_arrow(), q.to_arrow()
            assert a1.equals(a2), tag
            s.conf.set(SC.RESULT_CACHE_ENABLED, "false")
            oracle = q.to_arrow()
            s.conf.set(SC.RESULT_CACHE_ENABLED, "true")
            assert a1.sort_by([("v", "ascending")]).equals(
                oracle.sort_by([("v", "ascending")])), tag
            c = s.result_cache.stats()
            trace.append((tag, a1.sort_by([("v", "ascending")]), c["hits"], c["misses"]))

        check("baseline")
        hs.create_index(_df(s, d), mod.IndexConfig("rcIdx", ["k"], ["v"]))
        s.enable_hyperspace()
        check("create")
        hs.refresh_index("rcIdx", "full")  # no source change: a recorded no-op
        check("no-op refresh")
        _append(d, 11)
        hs.refresh_index("rcIdx", "full")
        check("full refresh")
        _append(d, 12)
        hs.refresh_index("rcIdx", "incremental")
        check("incremental refresh")
        hs.optimize_index("rcIdx", "quick")
        check("optimize")
        hs.delete_index("rcIdx")
        check("delete")
        hs.restore_index("rcIdx")
        check("restore")
        return trace

    # Turning the cache off and on again rebuilds it: the counts are those
    # of each step's fresh cache.
    got, _ = _run_both(tmp_path, steps)
    for t_step, j_step in zip(got["torch"], got["jax"]):
        assert t_step[0] == j_step[0]
        assert t_step[1].equals(j_step[1]), t_step[0]
        assert t_step[2:] == j_step[2:], (t_step[0], t_step[2:], j_step[2:])


def test_mutation_between_runs_misses(tmp_path):
    """Within one cache instance: a real refresh, an optimize, a create of
    another index, a delete and a restore each make the next run miss; a
    no-op refresh keeps it a hit (the JAX package's counts)."""
    def steps(pkg, s):
        mod, E = PKGS[pkg]
        d = tmp_path / f"d_{pkg}"
        _write(d, seed=6)
        hs = mod.Hyperspace(s)
        hs.create_index(_df(s, d), mod.IndexConfig("mIdx", ["k"], ["v"]))
        s.enable_hyperspace()
        q = _df(s, d).filter(E.col("k") == 3).select("k", "v")
        out = [q.to_arrow(), q.to_arrow()]
        trace = [_counts(s.result_cache)]
        for step in ("noop", "refresh", "optimize", "create", "delete", "restore"):
            if step == "noop":
                hs.refresh_index("mIdx", "full")
            elif step == "refresh":
                _append(d, 21)
                hs.refresh_index("mIdx", "full")
            elif step == "optimize":
                _append(d, 22)
                hs.refresh_index("mIdx", "incremental")
                hs.optimize_index("mIdx", "full")
            elif step == "create":
                hs.create_index(_df(s, d), mod.IndexConfig("vIdx", ["v"], ["k"]))
            elif step == "delete":
                hs.delete_index("mIdx")
            else:
                hs.restore_index("mIdx")
            out.append(q.to_arrow())
            trace.append((step, _counts(s.result_cache)))
        return out, trace

    got, _ = _run_both(tmp_path, steps)
    assert got["torch"][1] == got["jax"][1]
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert a.sort_by([("v", "ascending")]).equals(b.sort_by([("v", "ascending")]))
    counts = dict(got["torch"][1][1:])
    assert counts["noop"]["hits"] == 2 and counts["refresh"]["misses"] == 2
    for step, prev in (("optimize", "refresh"), ("create", "optimize"),
                       ("delete", "create"), ("restore", "delete")):
        assert counts[step]["misses"] == counts[prev]["misses"] + 1, step


def test_source_append_with_fresh_relation_misses(tmp_path):
    def steps(pkg, s):
        E = PKGS[pkg][1]
        d = tmp_path / f"d_{pkg}"
        base = _write(d)
        q = _df(s, d).filter(E.col("k") == 3).select("k", "v")
        assert q.to_arrow().num_rows == int((base.k == 3).sum())
        _write(d, n=200, seed=9, name="extra.parquet", k_mod=4)
        fresh = _df(s, d).filter(E.col("k") == 3).select("k", "v").to_arrow()
        assert fresh.num_rows > int((base.k == 3).sum())
        return fresh, _counts(s.result_cache)

    got, _ = _run_both(tmp_path, steps)
    assert got["torch"][0].equals(got["jax"][0])
    assert got["torch"][1] == got["jax"][1] and got["torch"][1]["hits"] == 0


def test_uncacheable_plan_executes(tmp_path, monkeypatch):
    """A plan the key writer does not know runs as if there were no cache."""
    from hyperspace_tpu_torch.serving import result_cache
    _write(tmp_path / "d")
    s = _session("torch", tmp_path / "ix")
    monkeypatch.setattr(result_cache, "compute_key", lambda *a, **k: None)
    got = _query("torch", s, tmp_path / "d").to_arrow()
    off = _session("torch", tmp_path / "ix", enabled=False)
    assert got.equals(_query("torch", off, tmp_path / "d").to_arrow())
    assert s.result_cache.stats()["misses"] == 0


# ---------------------------------------------------------------------------
# The query context.
# ---------------------------------------------------------------------------

def test_execute_activates_a_context(tmp_path):
    _write(tmp_path / "d")
    s = _session("torch", tmp_path / "ix", enabled=False)
    seen = {}
    orig = s._run_optimized

    def spy(optimized):
        seen["ctx"] = active_context()
        return orig(optimized)

    s._run_optimized = spy
    _df(s, tmp_path / "d").filter(TE.col("k") < 5).count()
    assert isinstance(seen["ctx"], QueryContext) and seen["ctx"].session is s
    assert active_context() is None


def test_explicit_context_pins_the_result_cache(tmp_path):
    """A context's cache overrides the session's own (the frontend's
    sharing), with the JAX package's counts."""
    _write(tmp_path / "d")

    def steps(pkg, s):
        ctx_mod = __import__(f"hyperspace_tpu{'' if pkg == 'jax' else '_torch'}.serving.context",
                             fromlist=["QueryContext"])
        shared = _cache(pkg, 1 << 24, 1 << 24)
        plan = _df(s, tmp_path / "d").filter(PKGS[pkg][1].col("k") < 9).plan
        t1 = s.execute(plan, context=ctx_mod.QueryContext(s, result_cache=shared))
        assert s.result_cache is None
        t2 = s.execute(plan, context=ctx_mod.QueryContext(s, result_cache=shared))
        assert t1.to_arrow().equals(t2.to_arrow())
        return t2.to_arrow(), _counts(shared)

    got, _ = _run_both(tmp_path, steps, enabled=False,
                       **{SC.RESULT_CACHE_MIN_COMPUTE_SECONDS: "0"})
    assert got["torch"][0].equals(got["jax"][0])
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][1]["misses"] == 1 and got["torch"][1]["hits"] == 1


def test_reads_are_charged_to_the_context(tmp_path):
    """The io counters the pool and the buffer pool note reach the active
    context, and the process-wide counters are those of a run without one
    (io_stats() is unchanged by the attribution)."""
    for i in range(4):
        _write(tmp_path / "d", n=1000, seed=60 + i, name=f"p{i}.parquet")
    s = _session("torch", tmp_path / "ix", enabled=False,
                 **{IndexConstants.TPU_IO_THREADS: "4"})
    plan = _df(s, tmp_path / "d").filter(TE.col("k") < 7).plan
    fresh_pools()
    tio.reset_stats()
    ctx = QueryContext.for_session(s)
    s.execute(plan, context=ctx)
    with_ctx = tio.pool_stats()
    io = ctx.io_stats()
    assert io["read_tasks"] == with_ctx["read_tasks"] == 4
    assert io["read_bytes"] == with_ctx["read_bytes"] > 0
    assert io["pool_misses"] >= 1
    ctx2 = QueryContext.for_session(s)
    s.execute(plan, context=ctx2)
    assert ctx2.io_stats()["pool_hits"] >= 1 and ctx2.io_stats()["read_tasks"] == 0


def test_deadline_cancels_at_a_stage_boundary(tmp_path):
    import time

    from hyperspace_tpu_torch.exceptions import QueryDeadlineError
    _write(tmp_path / "d")
    s = _session("torch", tmp_path / "ix", enabled=False)
    plan = _query("torch", s, tmp_path / "d").plan
    ctx = QueryContext(s, deadline_s=time.perf_counter() - 1.0)
    with pytest.raises(QueryDeadlineError):
        s.execute(plan, context=ctx)
    ok = QueryContext(s, deadline_s=time.perf_counter() + 600.0)
    assert s.execute(plan, context=ok).num_rows > 0


# ---------------------------------------------------------------------------
# The SQL plan memo.
# ---------------------------------------------------------------------------

def test_sql_plan_memo_equals_jax(tmp_path):
    _write(tmp_path / "d")
    text = "SELECT k, COUNT(*) AS n FROM t GROUP BY k ORDER BY k"

    def steps(pkg, s):
        s.create_temp_view("t", _df(s, tmp_path / "d"))
        a = s.sql(text).to_arrow()
        b = s.sql(text).to_arrow()
        assert a.equals(b)
        first = dict(s._sql_plan_stats)
        s.create_temp_view("t", _df(s, tmp_path / "d"), replace=True)
        s.sql(text)
        return a, first, dict(s._sql_plan_stats)

    got, _ = _run_both(tmp_path, steps)
    assert got["torch"][0].equals(got["jax"][0])
    assert got["torch"][1:] == got["jax"][1:]
    assert got["torch"][1] == {"hits": 1, "misses": 1} and got["torch"][2]["misses"] == 2


def test_sql_plan_memo_off_without_result_cache(tmp_path):
    _write(tmp_path / "d")

    def steps(pkg, s):
        s.create_temp_view("t", _df(s, tmp_path / "d"))
        s.sql("SELECT k FROM t")
        s.sql("SELECT k FROM t")
        return dict(s._sql_plan_stats)

    got, _ = _run_both(tmp_path, steps, enabled=False)
    assert got["torch"] == got["jax"] == {"hits": 0, "misses": 0}


def test_sql_plan_memo_is_bounded(tmp_path):
    _write(tmp_path / "d")
    s = _session("torch", tmp_path / "ix", **{SC.RESULT_CACHE_PLAN_CACHE_SIZE: "2"})
    s.create_temp_view("t", _df(s, tmp_path / "d"))
    for i in range(4):
        s.sql(f"SELECT k FROM t WHERE k < {i}")
    assert len(s._sql_plan_cache) == 2
    s.sql("SELECT k FROM t WHERE k < 3")
    assert s._sql_plan_stats == {"hits": 1, "misses": 4}


# ---------------------------------------------------------------------------
# Observability.
# ---------------------------------------------------------------------------

def _section(text: str, title: str) -> str:
    lines = text.splitlines()
    start = lines.index(title) - 1
    end = start + 3
    while end < len(lines) and lines[end] and not lines[end].startswith("====="):
        end += 1
    return "\n".join(lines[start:end])


def test_explain_result_cache_section_equals_jax(tmp_path):
    """Off: no section. On: the miss line, then after a run the device-tier
    hit line, with the key digest, the counters and the index-table line
    as the JAX package writes them."""
    _write(tmp_path / "d")
    texts = {}
    for pkg, s in _both(tmp_path, shared_path=True).items():
        mod, E = PKGS[pkg]
        fresh_pools()
        q = _df(s, tmp_path / "d").filter(E.col("k") == 1)
        hs = mod.Hyperspace(s)
        off = _session(pkg, tmp_path / "ix", enabled=False)
        assert "Result cache:" not in mod.Hyperspace(off).explain(
            _df(off, tmp_path / "d").filter(E.col("k") == 1))
        before = _section(hs.explain(q), "Result cache:")
        q.to_arrow()
        texts[pkg] = (before, _section(hs.explain(q), "Result cache:"))
    assert "miss - result will be computed" in texts["torch"][0]
    assert "result served from cache (device tier" in texts["torch"][1]
    assert texts["torch"] == texts["jax"]


def test_stats_facade_and_clear(tmp_path):
    _write(tmp_path / "d")

    def steps(pkg, s):
        hs = PKGS[pkg][0].Hyperspace(s)
        q = _df(s, tmp_path / "d").filter(PKGS[pkg][1].col("k") == 1)
        q.to_arrow()
        q.to_arrow()
        stats = hs.result_cache_stats()
        hs.clear_result_cache()
        after = hs.result_cache_stats()
        return ({k: stats["result_cache"][k] for k in COUNTERS}, stats["sql_plan_cache"],
                sorted(stats), after["result_cache"]["device_entries"])

    got, _ = _run_both(tmp_path, steps)
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["hits"] == 1 and got["torch"][3] == 0
