"""Index metadata caching and the introspection API through both packages
on the same numpy-seeded files, compared exactly.

Covered: the session's caching index manager (hits, expiry, cleared by
each of the seven mutations), the process-wide op-log lookup cache (hits,
the racy-mtime guard, invalidation by a write in this process and by a
directory change from elsewhere), ``indexes()`` and ``index()`` rows (paths
normalized), ``explain`` text in every display mode and verbose (against
the JAX package's ``explain_string(..., diagnostics=False)``, with temp
paths and log versions normalized as the plan-stability goldens are),
``why_not`` text on the cases of the JAX package's whyNot tests, and the
usage count, which only real rewrite passes move.
"""

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.api import (BloomFilterSketch as JBloom,
                                DataSkippingIndexConfig as JSkipping,
                                MinMaxSketch as JMinMax)
from hyperspace_tpu.execution import buffer_pool as jbuffer_pool
from hyperspace_tpu.execution import spmd as jspmd
from hyperspace_tpu.parallel import distributed_build as jdistributed_build
from hyperspace_tpu.parallel import io as jio
from hyperspace_tpu.plan.expr import col as jcol, sum_ as jsum
from hyperspace_tpu.plananalysis.explain import explain_string as jax_explain_string
from hyperspace_tpu.rules import data_skipping_rule as jax_skipping_rule
from hyperspace_tpu_torch.execution import buffer_pool as tbuffer_pool
from hyperspace_tpu_torch.execution import spmd as tspmd
from hyperspace_tpu_torch.index import cache as tcache
from hyperspace_tpu_torch.index.constants import IndexConstants, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager, get_lookup_cache
from hyperspace_tpu_torch.index.manager import IndexCollectionManager
from hyperspace_tpu_torch.index.statistics import IndexStatistics
from hyperspace_tpu_torch.parallel import distributed_build as tdistributed_build
from hyperspace_tpu_torch.parallel import io as tio
from hyperspace_tpu_torch.plan.expr import sum_ as tsum
from test_torch_mutability import _begin_refresh
from test_torch_tracing import fresh_telemetry_state

BASE_CONF = {
    # conftest gives JAX 8 virtual devices, which would take its mesh build.
    "hyperspace.tpu.distributed.enabled": "false",
    "hyperspace.tpu.execution.fusion.enabled": "false",
    IndexConstants.INDEX_NUM_BUCKETS: "4",
}


class Pair:
    """A JAX session and a port session over the same source files (fact
    in two key-ordered parts, dim in one), each with its own system path."""

    def __init__(self, root, conf=None):
        self.root = root
        self.fact = root / "fact"
        self.dim = root / "dim"
        self.fact.mkdir()
        self.dim.mkdir()
        rng = np.random.default_rng(11)
        ks = np.sort(rng.integers(0, 100, 800)).astype(np.int64)
        t = pa.table({"k": pa.array(ks),
                      "v": pa.array(rng.integers(0, 9, 800).astype(np.int64)),
                      "w": pa.array(rng.integers(0, 9, 800).astype(np.int64))})
        pq.write_table(t.slice(0, 400), self.fact / "p0.parquet")
        pq.write_table(t.slice(400, 400), self.fact / "p1.parquet")
        pq.write_table(pa.table({"dk": pa.array(np.arange(100, dtype=np.int64)),
                                 "dv": pa.array(np.arange(100, dtype=np.int64))}),
                       self.dim / "p0.parquet")
        c = dict(BASE_CONF, **(conf or {}))
        self.sessions = {
            "jax": hst.Session(conf=dict(c), system_path=str(root / "sys_jax")),
            "torch": ht.Session(conf=dict(c), system_path=str(root / "sys_torch"),
                                device="cpu")}
        # Sketch tables are cached by index name across system paths in the
        # JAX package (ROADMAP queue C 5).
        jax_skipping_rule._SKETCH_CACHE.clear()

    @staticmethod
    def pkg(name):
        return hst if name == "jax" else ht

    def hs(self, name):
        return self.pkg(name).Hyperspace(self.sessions[name])

    def each(self, fn):
        """{package: fn(name, pkg, session, hyperspace)}."""
        return {n: fn(n, self.pkg(n), s, self.hs(n)) for n, s in self.sessions.items()}

    def covering(self, name, indexed, included, table="fact"):
        self.each(lambda n, pkg, s, hs: hs.create_index(
            s.read.parquet(str(getattr(self, table))),
            pkg.IndexConfig(name, list(indexed), list(included))))

    def skipping(self, name, kind, column):
        sketch = {"minmax": (JMinMax, ht.MinMaxSketch),
                  "bloom": (JBloom, ht.BloomFilterSketch)}[kind]
        self.each(lambda n, pkg, s, hs: hs.create_index(
            s.read.parquet(str(self.fact)),
            (JSkipping if n == "jax" else ht.DataSkippingIndexConfig)(
                name, [sketch[0 if n == "jax" else 1](column)])))

    def df(self, name, table="fact"):
        return self.sessions[name].read.parquet(str(getattr(self, table)))

    def enable(self):
        for s in self.sessions.values():
            s.enable_hyperspace()


def col_of(name):
    return jcol if name == "jax" else ht.col


def normalize(text: str, root) -> str:
    """Temp paths and log versions out (tests/test_plan_stability.py's
    normalization, with each package's system path under one name)."""
    text = text.replace(str(root / "sys_jax"), "<sys>").replace(str(root / "sys_torch"), "<sys>")
    text = re.sub(r"(?:/[\w.\-]+)*/(?:data|indexes)/", "<root>/", text)
    return re.sub(r"LogVersion: \d+", "LogVersion: <v>", text)


# ---------------------------------------------------------------------------
# The session's caching index manager.
# ---------------------------------------------------------------------------

@pytest.fixture()
def listings(monkeypatch):
    """Counts the uncached listings (the base manager's get_indexes)."""
    calls = []
    base = IndexCollectionManager.get_indexes

    def counting(self, states=None):
        calls.append(states)
        return base(self, states)

    monkeypatch.setattr(IndexCollectionManager, "get_indexes", counting)
    return calls


def test_index_list_is_cached_across_queries(tmp_path, listings):
    pair = Pair(tmp_path)
    pair.covering("kv", ["k"], ["v"])
    pair.enable()
    s = pair.sessions["torch"]
    q = pair.df("torch").filter(ht.col("k") > 50).select("k", "v")
    listings.clear()
    for _ in range(3):
        q.to_arrow()
    assert listings == [None]


def test_index_list_expires(tmp_path, listings, monkeypatch):
    pair = Pair(tmp_path, {IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS: "10"})
    pair.covering("kv", ["k"], ["v"])
    now = [1000.0]
    monkeypatch.setattr(tcache.time, "time", lambda: now[0])
    mgr = pair.sessions["torch"].index_collection_manager
    listings.clear()
    mgr.get_indexes([States.ACTIVE])
    now[0] += 10.0
    mgr.get_indexes([States.ACTIVE])
    assert len(listings) == 1
    now[0] += 0.5
    assert [e.name for e in mgr.get_indexes([States.ACTIVE])] == ["kv"]
    assert len(listings) == 2
    # The expiry follows the live conf.
    pair.sessions["torch"].conf.set(IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS, "100")
    now[0] += 50.0
    mgr.get_indexes([States.ACTIVE])
    assert len(listings) == 2


def _mutations():
    """(name, set-up, mutation) for each of the seven mutations; each runs
    through the package's Hyperspace facade."""
    def refresh_setup(pair):
        pq.write_table(pa.table({"k": pa.array([500], pa.int64()),
                                 "v": pa.array([1], pa.int64()),
                                 "w": pa.array([1], pa.int64())}), pair.fact / "p2.parquet")

    def cancel_setup(pair):
        refresh_setup(pair)
        for n, s in pair.sessions.items():
            _begin_refresh(s, str(pair.root / f"sys_{n}"))

    def deleted(pair):
        pair.each(lambda n, pkg, s, hs: hs.delete_index("ix"))

    return {
        "create": (None, lambda hs, pkg, pair, n: hs.create_index(
            pair.df(n), pkg.IndexConfig("other", ["v"], ["k"]))),
        "delete": (None, lambda hs, pkg, pair, n: hs.delete_index("ix")),
        "restore": (deleted, lambda hs, pkg, pair, n: hs.restore_index("ix")),
        "vacuum": (deleted, lambda hs, pkg, pair, n: hs.vacuum_index("ix")),
        "refresh": (refresh_setup, lambda hs, pkg, pair, n: hs.refresh_index("ix", "full")),
        "optimize": (refresh_setup, lambda hs, pkg, pair, n: hs.optimize_index("ix", "full")),
        "cancel": (cancel_setup, lambda hs, pkg, pair, n: hs.cancel("ix")),
    }


MUTATIONS = _mutations()


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_every_mutation_clears_the_index_list(tmp_path, mutation):
    """The cached list is primed, the mutation runs through the facade,
    and the next listing shows its effect, as the JAX package's does."""
    pair = Pair(tmp_path, {IndexConstants.INDEX_LINEAGE_ENABLED: "true"})
    pair.covering("ix", ["k"], ["v"])
    setup, mutate = MUTATIONS[mutation]
    if setup is not None:
        setup(pair)
    if mutation == "optimize":
        pair.each(lambda n, pkg, s, hs: hs.refresh_index("ix", "incremental"))
    everything = [States.ACTIVE, States.DELETED, States.REFRESHING, States.DOESNOTEXIST]

    def listing(n, pkg, s, hs):
        return [(e.name, e.state, e.id) for e in
                s.index_collection_manager.get_indexes(everything)]

    before = pair.each(listing)
    assert before["torch"] == before["jax"]
    pair.each(lambda n, pkg, s, hs: mutate(hs, pkg, pair, n))
    assert pair.sessions["torch"].index_collection_manager._cache.get() is None
    after = pair.each(listing)
    assert after["torch"] == after["jax"]
    assert after["torch"] != before["torch"]


# ---------------------------------------------------------------------------
# The op-log lookup cache.
# ---------------------------------------------------------------------------

def _age(log_dir: str, seconds: int = 60) -> None:
    """Move the log directory's mtime out of the racy window."""
    t = os.stat(log_dir).st_mtime - seconds
    os.utime(log_dir, (t, t))


def test_log_lookups_hit_once_the_log_is_quiet(tmp_path):
    pair = Pair(tmp_path)
    pair.covering("ix", ["k"], ["v"])
    path = str(tmp_path / "sys_torch" / "ix")
    log_dir = os.path.join(path, IndexConstants.HYPERSPACE_LOG)
    lookups = get_lookup_cache()
    lm = IndexLogManager(path)
    # Written just now: served, not stored (the racy-mtime guard).
    hits = lookups.stats()["hits"]
    assert lm.get_latest_id() == lm.get_latest_id() == 1
    assert lookups.stats()["hits"] == hits
    _age(log_dir)
    lm.get_latest_id()
    stable = lm.get_latest_stable_log()
    assert lm.get_latest_id() == 1
    again = lm.get_latest_stable_log()
    assert lookups.stats()["hits"] == hits + 2
    # Entries are parsed per hit: a caller may mutate its own copy.
    assert again is not stable and again.to_json() == stable.to_json()


def test_log_lookups_invalidated_by_a_write_in_this_process(tmp_path):
    pair = Pair(tmp_path)
    pair.covering("ix", ["k"], ["v"])
    path = str(tmp_path / "sys_torch" / "ix")
    log_dir = os.path.join(path, IndexConstants.HYPERSPACE_LOG)
    _age(log_dir)
    lookups = get_lookup_cache()
    lm = IndexLogManager(path)
    assert lm.get_latest_id() == 1
    assert lm.get_latest_stable_log().state == States.ACTIVE
    invalidations = lookups.stats()["invalidations"]
    pair.hs("torch").delete_index("ix")
    assert lookups.stats()["invalidations"] > invalidations
    assert lm.get_latest_id() == 3
    assert lm.get_latest_stable_log().state == States.DELETED
    # A write that leaves the directory's mtime where it was (a coarse
    # filesystem) is still seen: the writer invalidated.
    _age(log_dir)
    lm.get_latest_id()
    stamp = os.stat(log_dir).st_mtime_ns
    pair.hs("torch").restore_index("ix")
    os.utime(log_dir, ns=(stamp, stamp))
    assert lm.get_latest_id() == 5
    assert lm.get_latest_stable_log().state == States.ACTIVE


def test_log_lookups_follow_a_change_from_elsewhere(tmp_path):
    """A write the lookup cache was not told of (another process) moves
    the directory's token."""
    pair = Pair(tmp_path)
    pair.covering("ix", ["k"], ["v"])
    path = str(tmp_path / "sys_torch" / "ix")
    log_dir = os.path.join(path, IndexConstants.HYPERSPACE_LOG)
    _age(log_dir)
    lm = IndexLogManager(path)
    assert lm.get_latest_id() == 1
    entry = lm.get_latest_stable_log()
    with open(os.path.join(log_dir, "2"), "w") as f:
        f.write(entry.to_json())
    assert lm.get_latest_id() == 2


# ---------------------------------------------------------------------------
# indexes() and index().
# ---------------------------------------------------------------------------

def _rows(frame, root) -> list:
    out = []
    for row in frame.to_dict("records"):
        out.append({k: normalize(str(v), root) if isinstance(v, str) else
                    [normalize(x, root) for x in v] if isinstance(v, list) else v
                    for k, v in row.items()})
    return out


def test_indexes_and_index_rows_equal_the_jax_package(tmp_path):
    pair = Pair(tmp_path, {IndexConstants.INDEX_LINEAGE_ENABLED: "true",
                           IndexConstants.INDEX_HYBRID_SCAN_ENABLED: "true"})
    pair.covering("kv", ["k"], ["v"])
    pair.covering("dim_idx", ["dk"], ["dv"], table="dim")
    pair.skipping("skip_k", "minmax", "k")
    pair.covering("gone", ["v"], ["w"])
    pair.each(lambda n, pkg, s, hs: hs.delete_index("gone"))
    pq.write_table(pa.table({"k": pa.array([500], pa.int64()),
                             "v": pa.array([1], pa.int64()),
                             "w": pa.array([1], pa.int64())}), pair.fact / "p2.parquet")
    pair.each(lambda n, pkg, s, hs: hs.refresh_index("kv", "quick"))
    pair.enable()
    for n in pair.sessions:
        pair.df(n).filter(col_of(n)("k") > 90).select("k", "v").to_arrow()
    summary = pair.each(lambda n, pkg, s, hs: _rows(hs.indexes(), tmp_path))
    assert list(pair.hs("torch").indexes().columns) == IndexStatistics.SUMMARY_COLUMNS
    assert summary["torch"] == summary["jax"]
    assert [r["name"] for r in summary["torch"]] == ["dim_idx", "gone", "kv", "skip_k"]
    for name in ("kv", "dim_idx", "skip_k", "gone"):
        ext = pair.each(lambda n, pkg, s, hs: _rows(hs.index(name), tmp_path))
        assert ext["torch"] == ext["jax"], name
    kv = pair.hs("torch").index("kv").iloc[0]
    assert kv["appendedFileCount"] == 1 and kv["lineageEnabled"]
    assert kv["usageCount"] == 1
    errors = {}
    for n in pair.sessions:
        with pytest.raises(Exception) as info:
            pair.hs(n).index("ghost")
        errors[n] = str(info.value)
    assert errors["torch"] == errors["jax"]


# ---------------------------------------------------------------------------
# explain.
# ---------------------------------------------------------------------------

def _queries():
    def filter_k(pair, n, c, s):
        return pair.df(n).filter(c("k") == 5).select("k", "v")

    def no_rewrite(pair, n, c, s):
        return pair.df(n).filter(c("w") > 3).select("k", "w")

    def join(pair, n, c, s):
        return pair.df(n).join(pair.df(n, "dim"), on=c("k") == c("dk")).select("k", "v", "dv")

    def group_by(pair, n, c, s):
        return pair.df(n).group_by("k").agg(s(c("v")).alias("sv"))

    def skipping(pair, n, c, s):
        return pair.df(n).filter(c("w") > 95).select("w", "v")

    def select_then_filter(pair, n, c, s):
        return pair.df(n).select("k", "v").filter(c("k") < 10)

    def sort_limit(pair, n, c, s):
        return pair.df(n).filter(c("k") > 3).group_by("k").agg(s(c("v")).alias("sv")) \
            .sort(("sv", False), "k").limit(5)

    def in_or_between(pair, n, c, s):
        return pair.df(n).filter(c("k").isin([1, 2, 70]) | c("v").between(1, 3)) \
            .select("k", (c("v") * 2).alias("v2"))

    return {"filter": filter_k, "no_rewrite": no_rewrite, "join": join,
            "group_by": group_by, "skipping": skipping,
            "select_then_filter": select_then_filter, "sort_limit": sort_limit,
            "in_or_between": in_or_between}


QUERIES = _queries()


def fresh_bank_state() -> None:
    """Start both packages' program banks and artifact registries anew and
    zero the port's kernel-build tallies: explain's "program bank:" line,
    the bank events' running totals and the "Compilation:" section read
    them."""
    from hyperspace_tpu.artifacts import manager as jartifacts
    from hyperspace_tpu.serving import program_bank as jbank
    from hyperspace_tpu_torch.artifacts import manager as tartifacts
    from hyperspace_tpu_torch.ops import cuda_kernels
    from hyperspace_tpu_torch.serving import program_bank as tbank
    jbank._BANK = None
    tbank.reset_for_tests()
    if jartifacts._REGISTRY is not None:
        with jartifacts._REGISTRY._lock:
            jartifacts._REGISTRY._by_root.clear()
    tartifacts.reset_for_tests()
    cuda_kernels.BUILD_STATS.update(builds=0, build_seconds=0.0, store_loads=0)


def fresh_io_counters() -> None:
    """Zero both packages' process-wide reader-pool counters, empty their
    buffer pools, start their SLO monitors anew and zero their dispatch
    counts: explain's I/O, SLO and "Distributed:" sections render from
    them once any read has been pooled, any query run, or any SPMD
    program or mesh build dispatched, in the process. Banks, artifact
    registries and build tallies start anew too (fresh_bank_state), and
    so do the robustness counters, whose section renders once any moved,
    and the process-default serving frontends, whose "Serving:" section
    renders once one took a query."""
    from hyperspace_tpu.robustness import faults as jfaults
    from hyperspace_tpu.serving import frontend as jfrontend
    from hyperspace_tpu_torch.robustness import faults as tfaults
    from hyperspace_tpu_torch.serving import frontend as tfrontend
    jfrontend._DEFAULT = None
    tfrontend._DEFAULT = None
    for io_mod, bp in ((jio, jbuffer_pool), (tio, tbuffer_pool)):
        io_mod.reset_stats()
        bp.get_pool().clear()
    jfaults.reset_stats()
    tfaults.reset_stats()
    for spmd_mod, build_mod in ((jspmd, jdistributed_build), (tspmd, tdistributed_build)):
        spmd_mod.DISPATCH_COUNT = spmd_mod.SORT_DISPATCH_COUNT = 0
        build_mod.DISPATCH_COUNT = 0
    fresh_telemetry_state()
    fresh_bank_state()


@pytest.fixture()
def explained(tmp_path):
    pair = Pair(tmp_path)
    pair.covering("kv", ["k"], ["v"])
    pair.covering("dim_idx", ["dk"], ["dv"], table="dim")
    pair.skipping("skip_w", "minmax", "w")
    return pair


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("mode", ["plaintext", "console", "html"])
@pytest.mark.parametrize("query", list(QUERIES))
def test_explain_equals_the_jax_package(explained, tmp_path, query, mode, verbose):
    pair = explained
    texts = {}
    for n, s in pair.sessions.items():
        df = QUERIES[query](pair, n, col_of(n), jsum if n == "jax" else tsum)
        fresh_io_counters()
        if n == "jax":
            texts[n] = jax_explain_string(s, df.plan, verbose=verbose, mode=mode,
                                          diagnostics=False)
        else:
            texts[n] = pair.hs(n).explain(df, verbose=verbose, mode=mode)
    assert normalize(texts["torch"], tmp_path) == normalize(texts["jax"], tmp_path)
    if query in ("filter", "join", "group_by"):
        assert "<none>" not in texts["torch"]


@pytest.mark.parametrize("enabled", [False, True])
def test_dataframe_explain_equals_the_jax_package(explained, tmp_path, enabled):
    pair = explained
    if enabled:
        pair.enable()
    texts = {n: QUERIES["join"](pair, n, col_of(n), None).explain()
             for n in pair.sessions}
    assert normalize(texts["torch"], tmp_path) == normalize(texts["jax"], tmp_path)
    assert ("== Optimized (hyperspace) ==" in texts["torch"]) == enabled
    assert pair.sessions["torch"]._index_usage_counts == {}


def test_explain_redirect_and_unknown_mode(explained):
    captured = []
    df = QUERIES["filter"](explained, "torch", ht.col, tsum)
    out = explained.hs("torch").explain(df, verbose=True, redirect_func=captured.append)
    assert captured == [out] and "IndexScan: 0 -> 1" in out
    with pytest.raises(ValueError):
        explained.hs("torch").explain(df, mode="nope")


# ---------------------------------------------------------------------------
# why_not.
# ---------------------------------------------------------------------------

def _whynot_cases():
    """(set-up, query, index name) per case of the JAX package's
    tests/test_whynot_statistics.py and tests/test_whynot_rules.py."""
    def other_table(pair):
        for n in ("jax", "torch"):
            d = pair.root / f"other_{n}"
            d.mkdir(exist_ok=True)
            pq.write_table(pa.table({"x": pa.array(np.arange(10, dtype=np.int64))}),
                           d / "p0.parquet")

    def append(pair):
        pq.write_table(pa.table({"k": pa.array([100], pa.int64()),
                                 "v": pa.array([1], pa.int64()),
                                 "w": pa.array([1], pa.int64())}), pair.fact / "p2.parquet")

    cases = {
        "no_index_at_all": ([], lambda p, n, c: p.df(n).filter(c("k") > 3).select("k", "v"),
                            None),
        "named_index_missing": ([], lambda p, n, c: p.df(n).filter(c("k") > 3)
                                .select("k", "v"), "ghost"),
        "col_schema_mismatch": ([("cov", "kv", ["k"], ["v"]), ("call", other_table)],
                                lambda p, n, c: p.sessions[n].read.parquet(
                                    str(p.root / f"other_{n}")).filter(c("x") > 3).select("x"),
                                None),
        "no_first_indexed_col": ([("cov", "kv2", ["k"], ["v"])],
                                 lambda p, n, c: p.df(n).filter(c("v") > 3).select("k", "v"),
                                 None),
        "signature_mismatch": ([("cov", "kv3", ["k"], ["v"]), ("call", append)],
                               lambda p, n, c: p.df(n).filter(c("k") > 3).select("k", "v"),
                               None),
        "outscored_on_tie": ([("cov", "wide", ["k"], ["v", "w"]), ("cov", "slim", ["k"], ["v"])],
                             lambda p, n, c: p.df(n).filter(c("k") > 3).select("k", "v"), None),
        "join_no_compatible_pair": ([("cov", "fact_kv", ["k", "v"], ["w"]),
                                     ("cov_dim", "dim_vd", ["dv", "dk"], [])],
                                    lambda p, n, c: p.df(n).join(
                                        p.df(n, "dim"),
                                        on=(c("k") == c("dk")) & (c("v") == c("dv")))
                                    .select("k", "v", "dk", "dv", "w"), None),
        "filtered_to_one_index": ([("cov", "aa", ["k"], ["v"]), ("cov", "bb", ["v"], ["w"])],
                                  lambda p, n, c: p.df(n).filter(c("w") > 3).select("w"), "bb"),
        "applied_index": ([("cov", "used", ["k"], ["v"])],
                          lambda p, n, c: p.df(n).filter(c("k") > 3).select("k", "v"), None),
        "applied_index_named": ([("cov", "used", ["k"], ["v"])],
                                lambda p, n, c: p.df(n).filter(c("k") > 3).select("k", "v"),
                                "used"),
        "missing_required_column": ([("cov", "kv", ["k"], ["v"])],
                                    lambda p, n, c: p.df(n).filter(c("k") > 3).select("k", "w"),
                                    None),
        "join_one_side_unindexed": ([("cov", "f_k", ["k"], ["v"])],
                                    lambda p, n, c: p.df(n).join(p.df(n, "dim"),
                                                                 on=c("k") == c("dk"))
                                    .select("k", "v", "dv"), None),
        "join_wrong_indexed_columns": ([("cov", "f_wrong", ["v"], ["k"]),
                                        ("cov_dim", "d_ok", ["dk"], ["dv"])],
                                       lambda p, n, c: p.df(n).join(p.df(n, "dim"),
                                                                    on=c("k") == c("dk"))
                                       .select("k", "v", "dv"), None),
        "join_applied_with_loser": ([("cov", "f_k", ["k"], ["v"]),
                                     ("cov", "f_k2", ["k"], ["v", "w"]),
                                     ("cov_dim", "d_ok", ["dk"], ["dv"])],
                                    lambda p, n, c: p.df(n).join(p.df(n, "dim"),
                                                                 on=c("k") == c("dk"))
                                    .select("k", "v", "dv"), None),
        "wrong_column_sketch": ([("skip", "skip_v", "minmax", "v")],
                                lambda p, n, c: p.df(n).filter(c("k") > 3).select("k", "v", "w"),
                                None),
        "unsupported_predicate_shape": ([("skip", "skip_b", "bloom", "k")],
                                        lambda p, n, c: p.df(n).filter(c("k") > 3)
                                        .select("k", "v", "w"), None),
        "stale_sketch": ([("skip", "skip_k", "minmax", "k"), ("call", append)],
                         lambda p, n, c: p.df(n).filter(c("k") > 990).select("k", "v", "w"), None),
        "applied_sketch": ([("skip", "skip_k", "minmax", "k")],
                           lambda p, n, c: p.df(n).filter(c("k") > 95).select("k", "v", "w"),
                           None),
    }
    return cases


WHYNOT = _whynot_cases()


@pytest.mark.parametrize("case", list(WHYNOT))
def test_why_not_equals_the_jax_package(tmp_path, case):
    steps, query, index_name = WHYNOT[case]
    pair = Pair(tmp_path)
    for step in steps:
        if step[0] == "cov":
            pair.covering(*step[1:])
        elif step[0] == "cov_dim":
            pair.covering(*step[1:], table="dim")
        elif step[0] == "skip":
            pair.skipping(*step[1:])
        else:
            step[1](pair)
    pair.enable()
    out = pair.each(lambda n, pkg, s, hs: hs.why_not(query(pair, n, col_of(n)),
                                                     index_name=index_name))
    assert out["torch"] == out["jax"]
    expected = {
        "no_index_at_all": "No reason recorded.",
        "named_index_missing": "No reasons recorded for index 'ghost'.",
        "applied_index_named": "Index 'used' was applied.",
    }
    if case in expected:
        assert out["torch"] == expected[case]
    if case == "outscored_on_tie":
        assert "[wide] OUTSCORED" in out["torch"] and "tie" in out["torch"]
    if case == "join_applied_with_loser":
        assert "ANOTHER_INDEX_APPLIED" in out["torch"]


def test_filter_reasons_only_when_enabled(tmp_path):
    """A disabled collector (a query's own pass) builds no reasons; an
    enabled one (why_not's) builds them."""
    from hyperspace_tpu_torch.rules.apply_hyperspace import apply_hyperspace
    from hyperspace_tpu_torch.rules.index_filters import ReasonCollector
    pair = Pair(tmp_path)
    pair.covering("kv2", ["k"], ["v"])
    s = pair.sessions["torch"]
    plan = pair.df("torch").filter(ht.col("v") > 3).select("k", "v").plan
    off = ReasonCollector(enabled=False)
    apply_hyperspace(s, plan, off)
    assert off.reasons == []
    on = ReasonCollector(enabled=True)
    apply_hyperspace(s, plan, on)
    assert [r.code for r in on.reasons] == ["NO_FIRST_INDEXED_COL_COND"]
    assert on.for_index("kv2") == on.reasons and on.for_index("other") == []


# ---------------------------------------------------------------------------
# usageCount.
# ---------------------------------------------------------------------------

def test_usage_count_moves_only_on_real_passes(tmp_path):
    pair = Pair(tmp_path)
    pair.covering("kv", ["k"], ["v"])
    pair.covering("dim_idx", ["dk"], ["dv"], table="dim")
    pair.skipping("skip_k", "minmax", "k")
    pair.enable()

    def counts():
        return pair.each(lambda n, pkg, s, hs: dict(s._index_usage_counts))

    def run(fn):
        for n in pair.sessions:
            fn(n, col_of(n), jsum if n == "jax" else tsum)

    queries = [QUERIES["filter"], QUERIES["join"], QUERIES["group_by"],
               lambda p, n, c, s: p.df(n).filter(c("k") > 95).select("k", "v", "w")]
    for q in queries:
        run(lambda n, c, s: pair.hs(n).explain(q(pair, n, c, s)))
        run(lambda n, c, s: pair.hs(n).why_not(q(pair, n, c, s)))
    assert counts() == {"jax": {}, "torch": {}}
    for q in queries:
        run(lambda n, c, s: q(pair, n, c, s).to_arrow())
    after_runs = counts()
    assert after_runs["torch"] == after_runs["jax"]
    assert set(after_runs["torch"]) == {"kv", "dim_idx", "skip_k"}
    run(lambda n, c, s: QUERIES["filter"](pair, n, c, s).optimized_plan())
    for q in queries:
        run(lambda n, c, s: pair.hs(n).explain(q(pair, n, c, s), verbose=True))
    final = counts()
    assert final["torch"] == final["jax"]
    assert final["torch"]["kv"] == after_runs["torch"]["kv"] + 1
    rows = pair.each(lambda n, pkg, s, hs: dict(zip(hs.indexes()["name"],
                                                    hs.indexes()["usageCount"])))
    assert rows["torch"] == rows["jax"]


def test_explain_of_a_hybrid_scan_equals_the_jax_package(tmp_path):
    """The IndexScan's hybrid(...) suffix and the appended file, rendered
    the same way."""
    pair = Pair(tmp_path, {IndexConstants.INDEX_HYBRID_SCAN_ENABLED: "true"})
    pair.covering("kv", ["k"], ["v"])
    pq.write_table(pa.table({"k": pa.array([5, 7], pa.int64()),
                             "v": pa.array([1, 2], pa.int64()),
                             "w": pa.array([1, 2], pa.int64())}), pair.fact / "p2.parquet")
    texts = {}
    for n, s in pair.sessions.items():
        df = QUERIES["filter"](pair, n, col_of(n), None)
        fresh_io_counters()
        texts[n] = jax_explain_string(s, df.plan, verbose=True, diagnostics=False) \
            if n == "jax" else pair.hs(n).explain(df, verbose=True)
    assert "hybrid(+1 appended, -0 deleted files)" in texts["torch"]
    assert normalize(texts["torch"], tmp_path) == normalize(texts["jax"], tmp_path)
