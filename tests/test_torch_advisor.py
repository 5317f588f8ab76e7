"""The advisor (workload capture, candidates, what-if, recommendations,
usage counts) through both packages on the same numpy-seeded tables.

Every scenario of tests/test_advisor.py runs here through the JAX package
and the port, each with its own system path. Equal, exactly: workload
rows (latency left out), shapes and fingerprints; candidate specs and
names; what-if outcomes and their ``explain()`` text;
``AdvisorReport.explain()``; recommendation names, order, costs and
predicted benefits; the system path's bytes before and after what-if and
recommend; the advisor events' fields; explain's "Advisor:" section;
``to_arrow()`` answers. A record's latency is the one thing a run
measures, so before ``recommend`` both logs get the same latencies
(``pin_latencies``): the benefit is latency times a byte ratio, and the
ratios are what the test holds equal. The JAX package runs on the CPU
with its distributed tier and fusion off.
"""

import dataclasses
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.advisor import candidates as jcandidates
from hyperspace_tpu.advisor.constants import AdvisorConstants
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plananalysis.explain import explain_string as jexplain
from hyperspace_tpu_torch.advisor import candidates as tcandidates
from hyperspace_tpu_torch.advisor import constants as tadvisor_constants
from hyperspace_tpu_torch.advisor.constants import AdvisorConstants as TAdvisorConstants
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.plananalysis.explain import explain_string as texplain

PKGS = ("jax", "torch")
MODS = {"jax": hst, "torch": ht}
CONF = {"hyperspace.tpu.distributed.enabled": "false",
        "hyperspace.tpu.execution.fusion.enabled": "false",
        IndexConstants.INDEX_NUM_BUCKETS: "4"}
CAPTURE = AdvisorConstants.CAPTURE_ENABLED
LOGGER = "tests.conftest.CaptureLogger"


def test_conf_keys_equal_jax():
    """The same keys, defaults and property names as the JAX package's; the
    bound on candidates evaluated is a module constant with its default."""
    jkeys = {k: v for k, v in vars(AdvisorConstants).items() if not k.startswith("_")}
    tkeys = {k: v for k, v in vars(TAdvisorConstants).items() if not k.startswith("_")}
    assert tkeys == {k: v for k, v in jkeys.items() if k in tkeys}
    assert set(jkeys) - set(tkeys) == {"MAX_CANDIDATES", "MAX_CANDIDATES_DEFAULT"}
    assert tadvisor_constants.MAX_CANDIDATES == int(jkeys["MAX_CANDIDATES_DEFAULT"])


def E(pkg):
    return JE if pkg == "jax" else TE


def dir_state(path):
    """{path under ``path``: bytes} of every file below it."""
    out = {}
    for r, _dirs, files in os.walk(path):
        for f in files:
            p = os.path.join(r, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


def sink():
    import importlib
    return importlib.import_module("tests.conftest").CaptureLogger


def event_fields(event) -> dict:
    """An event's fields without its times, app id and trace ids."""
    d = dataclasses.asdict(event)
    for k in ("app_id", "emitted_on_ms", "trace_id", "span_id"):
        d.pop(k, None)
    return d


def section(text: str, title: str) -> str:
    """One explain section's lines (after its header, up to the next)."""
    lines = text.splitlines()
    try:
        start = lines.index(title) + 2
    except ValueError:
        return ""
    out = []
    for line in lines[start:]:
        if line.startswith("=" * 60):
            break
        out.append(line)
    return "\n".join(out).strip()


@pytest.fixture()
def env(tmp_path):
    fact_dir = tmp_path / "fact"
    fact_dir.mkdir()
    rng = np.random.default_rng(3)
    # Two time-ordered files (MinMax-prunable).
    ks = np.sort(rng.integers(0, 100, 4000)).astype(np.int64)
    t = pa.table({
        "k": pa.array(ks),
        "v": pa.array(rng.integers(0, 9, 4000).astype(np.int64)),
        "w": pa.array(np.round(rng.uniform(0, 1, 4000), 3)),
        "pad": pa.array(rng.integers(0, 5, 4000).astype(np.int64)),
    })
    pq.write_table(t.slice(0, 2000), fact_dir / "p0.parquet")
    pq.write_table(t.slice(2000, 2000), fact_dir / "p1.parquet")
    dim_dir = tmp_path / "dim"
    dim_dir.mkdir()
    pq.write_table(pa.table({
        "dk": pa.array(np.arange(100, dtype=np.int64)),
        "dv": pa.array(rng.integers(0, 5, 100).astype(np.int64)),
    }), dim_dir / "p0.parquet")
    out = {"fact": str(fact_dir), "dim": str(dim_dir), "tmp": tmp_path}
    for pkg in PKGS:
        kw = {} if pkg == "jax" else {"device": "cpu"}
        system_path = str(tmp_path / f"indexes_{pkg}")
        session = MODS[pkg].Session(conf=dict(CONF), system_path=system_path, **kw)
        session.enable_hyperspace()
        out[pkg] = {"session": session, "hs": MODS[pkg].Hyperspace(session),
                    "system_path": system_path}
    return out


def capture(session, *queries):
    session.conf.set(CAPTURE, "true")
    tables = [q.to_arrow() for q in queries]
    session.conf.set(CAPTURE, "false")
    return tables


def pin_latencies(session):
    for i, r in enumerate(session._workload_log.snapshot()):
        r.latency_s = 0.125 * (i + 1)


def q_filter(env, pkg):
    col = E(pkg).col
    return env[pkg]["session"].read.parquet(env["fact"]).filter(col("k") > 50).select("k", "v")


def q_join(env, pkg):
    col, sum_ = E(pkg).col, E(pkg).sum_
    s = env[pkg]["session"]
    return (s.read.parquet(env["fact"]).join(s.read.parquet(env["dim"]),
                                             on=col("k") == col("dk"))
            .group_by("dv").agg(sum_(col("v")).alias("sv")))


def records(env, pkg):
    return env[pkg]["session"]._workload_log.snapshot()


def shape_rows(env, pkg):
    return [(r.fingerprint, [dataclasses.astuple(s) for s in r.scan_shapes],
             [dataclasses.astuple(j) for j in r.join_shapes], r.applied_indexes,
             r.rules_fired) for r in records(env, pkg)]


def workload_rows(env, pkg):
    df = env[pkg]["hs"].workload()
    return list(df.columns), df.drop(columns=["latency_s"]).to_dict("records")


def report_rows(report):
    return [(r.rank, r.kind, r.names, [dataclasses.astuple(c) for c in r.configs], r.tables,
             r.predicted_benefit_s, r.predicted_speedup, r.support, r.queries_matched,
             r.record_indices) for r in report.recommendations]


def outcome_rows(out):
    return (out.applied, out.applied_existing, out.cost_before_bytes, out.cost_after_bytes,
            out.plan_before, out.plan_after, out.sketch_applicable, out.rewritten,
            out.predicted_speedup, out.explain())


class TestWorkloadCapture:
    def test_disabled_by_default(self, env):
        for pkg in PKGS:
            q_filter(env, pkg).to_arrow()
            assert len(env[pkg]["hs"].workload()) == 0

    def test_record_contents(self, env):
        answers = {pkg: capture(env[pkg]["session"], q_filter(env, pkg)) for pkg in PKGS}
        assert answers["torch"][0].equals(answers["jax"][0])
        assert shape_rows(env, "torch") == shape_rows(env, "jax")
        (r,) = records(env, "torch")
        assert r.fingerprint is not None and r.latency_s > 0
        assert r.applied_indexes == ()
        (shape,) = r.scan_shapes
        assert shape.root_paths == (env["fact"],)
        assert shape.filter_cols == ("k",) and set(shape.project_cols) == {"k", "v"}
        assert shape.range_cols == ("k",) and shape.equality_cols == ()
        assert workload_rows(env, "torch") == workload_rows(env, "jax")

    def test_capture_records_applied_indexes(self, env):
        for pkg in PKGS:
            s, hs = env[pkg]["session"], env[pkg]["hs"]
            hs.create_index(s.read.parquet(env["fact"]), MODS[pkg].IndexConfig("kv", ["k"], ["v"]))
            capture(s, q_filter(env, pkg))
        assert shape_rows(env, "torch") == shape_rows(env, "jax")
        (r,) = records(env, "torch")
        assert r.applied_indexes == ("kv",) and r.rules_fired == ("CoveringIndexRules",)

    def test_join_shape_extraction(self, env):
        answers = {pkg: capture(env[pkg]["session"], q_join(env, pkg))[0] for pkg in PKGS}
        assert answers["torch"].sort_by("dv").equals(answers["jax"].sort_by("dv"))
        assert shape_rows(env, "torch") == shape_rows(env, "jax")
        (r,) = records(env, "torch")
        (js,) = r.join_shapes
        assert js.left.join_cols == ("k",) and js.right.join_cols == ("dk",)
        assert "v" in js.left.referenced_cols and "dv" in js.right.referenced_cols

    def test_max_entries_bound(self, env):
        for pkg in PKGS:
            s = env[pkg]["session"]
            s.conf.set(AdvisorConstants.CAPTURE_MAX_ENTRIES, 3)
            q = s.read.parquet(env["fact"]).filter(E(pkg).col("k") > 10).select("k")
            capture(s, q, q, q, q, q)
            log = s._workload_log
            assert len(log) == 3 and log.dropped == 2
        assert shape_rows(env, "torch") == shape_rows(env, "jax")

    def test_workload_dataframe(self, env):
        for pkg in PKGS:
            s = env[pkg]["session"]
            capture(s, s.read.parquet(env["fact"]).filter(E(pkg).col("k") > 1).select("k"))
        cols, rows = workload_rows(env, "torch")
        assert cols == ["fingerprint", "tables", "latency_s", "appliedIndexes", "rulesFired"]
        assert len(rows) == 1
        assert (cols, rows) == workload_rows(env, "jax")

    def test_candidates_equal_jax(self, env):
        for pkg in PKGS:
            capture(env[pkg]["session"], q_filter(env, pkg), q_join(env, pkg))
        groups = {}
        for pkg, mod in (("jax", jcandidates), ("torch", tcandidates)):
            gs = mod.generate(env[pkg]["session"], records(env, pkg))
            groups[pkg] = [(g.key, g.kind, g.support,
                            [(dataclasses.astuple(s.config), s.root_paths, s.file_format)
                             for s in g.specs]) for g in gs]
        assert groups["torch"] == groups["jax"]
        assert {g[1] for g in groups["torch"]} == {"filter", "join", "sketch"}


class TestWhatIf:
    def whatif_both(self, env, build, configs):
        outs, states = {}, {}
        for pkg in PKGS:
            hs = env[pkg]["hs"]
            before = dir_state(env[pkg]["system_path"])
            outs[pkg] = hs.what_if(build(env, pkg), configs(MODS[pkg]))
            states[pkg] = (before, dir_state(env[pkg]["system_path"]))
            assert states[pkg][0] == states[pkg][1]
        assert outcome_rows(outs["torch"]) == outcome_rows(outs["jax"])
        return outs["torch"], states

    def test_filter_rewrite_confirmed_without_build(self, env):
        out, states = self.whatif_both(env, q_filter,
                                       lambda m: [m.IndexConfig("hypo", ["k"], ["v"])])
        assert out.rewritten and out.applied == ("hypo",)
        assert "IndexScan" in out.plan_after and "IndexScan" not in out.plan_before
        assert out.cost_after_bytes < out.cost_before_bytes and out.predicted_speedup > 1.0
        assert "What-If" in out.explain()
        assert states["torch"] == states["jax"]

    def test_wrong_column_config_does_not_rewrite(self, env):
        out, _ = self.whatif_both(env, q_filter,
                                  lambda m: [m.IndexConfig("bad", ["w"], ["k", "v"])])
        assert not out.rewritten and out.cost_after_bytes == out.cost_before_bytes

    def test_join_pair_rewrite(self, env):
        out, _ = self.whatif_both(env, q_join, lambda m: [m.IndexConfig("h_l", ["k"], ["v"]),
                                                          m.IndexConfig("h_r", ["dk"], ["dv"])])
        assert set(out.applied) == {"h_l", "h_r"}

    def test_join_needs_both_sides(self, env):
        def both_sides(env, pkg):
            col = E(pkg).col
            s = env[pkg]["session"]
            return s.read.parquet(env["fact"]).join(
                s.read.parquet(env["dim"]), on=col("k") == col("dk")).select("k", "v", "dk", "dv")
        out, _ = self.whatif_both(env, both_sides, lambda m: [m.IndexConfig("h_l", ["k"], ["v"])])
        assert not out.rewritten

    def test_sketch_static_applicability(self, env):
        out, _ = self.whatif_both(env, q_filter, lambda m: [
            m.DataSkippingIndexConfig("sk_ok", [m.MinMaxSketch("k")]),
            m.DataSkippingIndexConfig("sk_wrong", [m.BloomFilterSketch("v")])])
        assert out.sketch_applicable == {"sk_ok": True, "sk_wrong": False}

    def test_what_if_sees_existing_indexes(self, env):
        for pkg in PKGS:
            s, hs = env[pkg]["session"], env[pkg]["hs"]
            hs.create_index(s.read.parquet(env["fact"]),
                            MODS[pkg].IndexConfig("real_kv", ["k"], ["v"]))
        # A hypothetical wider than the real index loses the size tie-break.
        out, states = self.whatif_both(env, q_filter, lambda m: [
            m.IndexConfig("hypo_wide", ["k"], ["v", "w", "pad"])])
        assert not out.rewritten and out.applied_existing == ("real_kv",)
        assert set(states["torch"][0]) == set(states["jax"][0])

    def test_what_if_emits_telemetry(self, env):
        fields = {}
        for pkg in PKGS:
            sink().events = []
            env[pkg]["session"].conf.set(IndexConstants.EVENT_LOGGER_CLASS, LOGGER)
            env[pkg]["hs"].what_if(q_filter(env, pkg),
                                   [MODS[pkg].IndexConfig("hypo", ["k"], ["v"])])
            evs = [e for e in sink().events if type(e).__name__ == "AdvisorWhatIfEvent"]
            assert len(evs) == 1 and evs[0].applied_names == ["hypo"]
            fields[pkg] = event_fields(evs[0])
        assert fields["torch"] == fields["jax"]


class TestRecommend:
    def workload(self, env):
        for pkg in PKGS:
            capture(env[pkg]["session"], q_filter(env, pkg), q_join(env, pkg))
            pin_latencies(env[pkg]["session"])

    def recommend_both(self, env, top_k):
        reports = {pkg: env[pkg]["hs"].recommend(top_k=top_k) for pkg in PKGS}
        assert report_rows(reports["torch"]) == report_rows(reports["jax"])
        assert reports["torch"].explain() == reports["jax"].explain()
        assert (reports["torch"].candidates_evaluated, reports["torch"].records_considered) == \
            (reports["jax"].candidates_evaluated, reports["jax"].records_considered)
        return reports["torch"]

    def test_recommends_known_good_ahead_of_worse(self, env):
        self.workload(env)
        report = self.recommend_both(env, 10)
        assert report.records_considered == 2 and report.recommendations
        top = report.recommendations[0]
        covering = [r for r in report.recommendations if r.kind in ("filter", "join")]
        assert covering and all(r.queries_matched > 0 for r in covering)
        assert top.kind in ("filter", "join") and top.predicted_benefit_s > 0
        flat = [list(c.indexed_columns) + sorted(c.included_columns)
                for r in covering for c in r.configs]
        assert ["k", "v"] in flat
        for s in (r for r in report.recommendations if r.kind == "sketch"):
            assert s.predicted_benefit_s == 0.0 and s.rank > top.rank
        assert "Index Recommendations" in report.explain()

    def test_deterministic(self, env):
        self.workload(env)
        r1 = self.recommend_both(env, 5)
        r2 = self.recommend_both(env, 5)
        assert report_rows(r1) == report_rows(r2)

    def test_log_store_bytes_unchanged(self, env):
        for pkg in PKGS:
            s, hs = env[pkg]["session"], env[pkg]["hs"]
            hs.create_index(s.read.parquet(env["fact"]),
                            MODS[pkg].IndexConfig("pre", ["pad"], ["w"]))
        self.workload(env)
        before = {pkg: dir_state(env[pkg]["system_path"]) for pkg in PKGS}
        self.recommend_both(env, 5)
        for pkg in PKGS:
            assert dir_state(env[pkg]["system_path"]) == before[pkg]
        assert set(before["torch"]) == set(before["jax"])

    def test_existing_index_not_reproposed(self, env):
        for pkg in PKGS:
            s, hs = env[pkg]["session"], env[pkg]["hs"]
            capture(s, q_filter(env, pkg))
            pin_latencies(s)
            hs.create_index(s.read.parquet(env["fact"]), MODS[pkg].IndexConfig("kv", ["k"], ["v"]))
        report = self.recommend_both(env, 5)
        for r in report.recommendations:
            for cfg in r.configs:
                if hasattr(cfg, "indexed_columns"):
                    assert not (list(cfg.indexed_columns) == ["k"]
                                and set(cfg.included_columns) <= {"v"})

    def test_build_recommendation_then_rewrite_fires(self, env):
        self.workload(env)
        top = self.recommend_both(env, 3).recommendations[0]
        plans, answers = {}, {}
        for pkg in PKGS:
            hs = env[pkg]["hs"]
            rec = hs.recommend(top_k=3).recommendations[0]
            assert rec.names == top.names
            hs.build_recommendation(rec)
            assert set(top.names) <= set(hs.indexes()["name"])
            qs = (q_filter(env, pkg), q_join(env, pkg))
            plans[pkg] = [q.optimized_plan().tree_string() for q in qs]
            answers[pkg] = [qs[0].to_arrow().sort_by("k"), qs[1].to_arrow().sort_by("dv")]
        assert any("IndexScan" in p for p in plans["torch"])
        assert plans["torch"] == plans["jax"]
        for a, b in zip(answers["torch"], answers["jax"]):
            assert a.equals(b)

    def test_candidates_pinned_to_their_table(self, env):
        clone_dir = env["tmp"] / "fact_clone"
        clone_dir.mkdir()
        rng = np.random.default_rng(5)
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 100, 1000).astype(np.int64)),
            "v": pa.array(rng.integers(0, 9, 1000).astype(np.int64)),
            "w": pa.array(np.round(rng.uniform(0, 1, 1000), 3)),
            "pad": pa.array(rng.integers(0, 5, 1000).astype(np.int64)),
        }), clone_dir / "p0.parquet")
        for pkg in PKGS:
            s, col = env[pkg]["session"], E(pkg).col
            capture(s, q_filter(env, pkg),
                    s.read.parquet(str(clone_dir)).filter(col("k") > 50).select("k", "v"))
            pin_latencies(s)
        report = self.recommend_both(env, 10)
        filters = [r for r in report.recommendations if r.kind == "filter"]
        assert len(filters) == 2 and all(r.queries_matched == 1 for r in filters)

    def test_min_support_filters(self, env):
        for pkg in PKGS:
            env[pkg]["session"].conf.set(AdvisorConstants.MIN_SUPPORT, 2)
            capture(env[pkg]["session"], q_filter(env, pkg))
            pin_latencies(env[pkg]["session"])
        assert self.recommend_both(env, 5).recommendations == []
        for pkg in PKGS:
            capture(env[pkg]["session"], q_filter(env, pkg))
            pin_latencies(env[pkg]["session"])
        assert self.recommend_both(env, 5).recommendations

    def test_recommend_emits_telemetry(self, env):
        self.workload(env)
        fields = {}
        for pkg in PKGS:
            sink().events = []
            env[pkg]["session"].conf.set(IndexConstants.EVENT_LOGGER_CLASS, LOGGER)
            report = env[pkg]["hs"].recommend(top_k=2)
            evs = [e for e in sink().events if type(e).__name__ == "AdvisorRecommendationEvent"]
            assert len(evs) == 1 and evs[0].records_considered == 2
            assert set(evs[0].recommended) == {n for r in report.recommendations for n in r.names}
            fields[pkg] = event_fields(evs[0])
        assert fields["torch"] == fields["jax"]


class TestUsageCounts:
    def hot_index(self, env, *extra):
        for pkg in PKGS:
            s, hs = env[pkg]["session"], env[pkg]["hs"]
            hs.create_index(s.read.parquet(env["fact"]), MODS[pkg].IndexConfig("hot", ["k"], ["v"]))
            for name, indexed, included in extra:
                hs.create_index(s.read.parquet(env["fact"]),
                                MODS[pkg].IndexConfig(name, indexed, included))

    def usage(self, env, pkg):
        t = env[pkg]["hs"].indexes().set_index("name")
        return dict(t["usageCount"])

    def test_usage_counts_surface(self, env):
        self.hot_index(env, ("dead", ["pad"], ["w"]))
        for pkg in PKGS:
            q = q_filter(env, pkg)
            q.to_arrow()
            q.to_arrow()
            hs = env[pkg]["hs"]
            assert hs.index("hot").iloc[0]["usageCount"] == 2
            assert hs.index("dead").iloc[0]["usageCount"] == 0
        assert self.usage(env, "torch") == self.usage(env, "jax") == {"hot": 2, "dead": 0}

    def test_explain_advisor_section(self, env):
        self.hot_index(env)
        sections = {}
        for pkg in PKGS:
            s = env[pkg]["session"]
            q = q_filter(env, pkg)
            explain = jexplain if pkg == "jax" else texplain
            before = explain(s, q.plan, diagnostics=False)
            assert "Advisor:" not in before and "Advisor:" not in env[pkg]["hs"].explain(q)
            capture(s, q)
            out = env[pkg]["hs"].explain(q)
            sections[pkg] = section(out, "Advisor:")
            assert sections[pkg] == section(explain(s, q.plan, diagnostics=False), "Advisor:")
        assert "workload capture: off (1 record(s)" in sections["torch"]
        assert "index 'hot' applied" in sections["torch"]
        assert sections["torch"] == sections["jax"]

    def test_explain_does_not_count_usage(self, env):
        self.hot_index(env)
        for pkg in PKGS:
            q = q_filter(env, pkg)
            env[pkg]["hs"].explain(q)
            q.explain()
        assert self.usage(env, "torch") == self.usage(env, "jax") == {"hot": 0}

    def test_why_not_does_not_count_usage(self, env):
        self.hot_index(env)
        for pkg in PKGS:
            env[pkg]["hs"].why_not(q_filter(env, pkg))
        assert self.usage(env, "torch") == self.usage(env, "jax") == {"hot": 0}

    def test_what_if_does_not_count_usage(self, env):
        self.hot_index(env)
        for pkg in PKGS:
            env[pkg]["hs"].what_if(q_filter(env, pkg),
                                   [MODS[pkg].IndexConfig("hypo", ["pad"], ["w"])])
        assert self.usage(env, "torch") == self.usage(env, "jax") == {"hot": 0}
