"""The adaptive control plane (feedback-corrected planning, mid-query
re-planning, the budgeted builder, SLO admission, the master switch)
through both packages on the same numpy-seeded tables.

Every scenario of tests/test_adaptive.py runs here through the JAX
package and the port, each with its own system path and its own
process-wide stores (each package has its own correction store,
admission controller, builder ledger and SLO monitor). Equal, exactly:
each run's q-error, the correction store's counters, the sequence of
AdaptiveActionEvent and ReplanEvent fields (times, app and trace ids left
out), builder summaries and ledger stats (bytes included), approximate
answers bit for bit and their bound dicts, the admission counters, and
every ``to_arrow()`` answer (rows sorted where a re-plan may reorder
them). The JAX package runs on the CPU with its distributed tier and
fusion off: its staged executor owns the join boundaries, as the port's
executor does.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.adaptive import admission as jadmission
from hyperspace_tpu.adaptive import builder as jbuilder
from hyperspace_tpu.adaptive import feedback as jfeedback
from hyperspace_tpu.adaptive.constants import AdaptiveConstants
from hyperspace_tpu.advisor.constants import AdvisorConstants
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.serving.frontend import ServingFrontend as JFrontend
from hyperspace_tpu_torch.adaptive import admission as tadmission
from hyperspace_tpu_torch.adaptive import builder as tbuilder
from hyperspace_tpu_torch.adaptive import constants as tadaptive_constants
from hyperspace_tpu_torch.adaptive import feedback as tfeedback
from hyperspace_tpu_torch.adaptive.constants import AdaptiveConstants as TAdaptiveConstants
from hyperspace_tpu_torch.exceptions import ServingRejectedError as TRejected
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.optimizer.constants import OptimizerConstants
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.serving.frontend import ServingFrontend as TFrontend
from hyperspace_tpu_torch.telemetry.constants import TelemetryConstants

from hyperspace_tpu.exceptions import ServingRejectedError as JRejected

PKGS = ("jax", "torch")
MODS = {"jax": hst, "torch": ht}
EXPR = {"jax": JE, "torch": TE}
FEEDBACK = {"jax": jfeedback, "torch": tfeedback}
BUILDER = {"jax": jbuilder, "torch": tbuilder}
ADMISSION = {"jax": jadmission, "torch": tadmission}
FRONTEND = {"jax": JFrontend, "torch": TFrontend}
REJECTED = {"jax": JRejected, "torch": TRejected}
CONF = {"hyperspace.tpu.distributed.enabled": "false",
        "hyperspace.tpu.execution.fusion.enabled": "false",
        IndexConstants.INDEX_NUM_BUCKETS: "4"}
ADAPTIVE_ON = {AdaptiveConstants.ENABLED: "true",
               OptimizerConstants.JOIN_REORDER_ENABLED: "true"}
LOGGER = "tests.conftest.CaptureLogger"


def test_conf_keys_equal_jax():
    """The port keeps the JAX package's keys and defaults for the knobs an
    operator sets; the rest are module constants with the JAX defaults,
    and feedback and admission follow the master switch (their JAX
    switches default to on)."""
    jkeys = {k: v for k, v in vars(AdaptiveConstants).items() if not k.startswith("_")}
    tkeys = {k: v for k, v in vars(TAdaptiveConstants).items() if not k.startswith("_")}
    assert tkeys == {k: v for k, v in jkeys.items() if k in tkeys}
    fixed = {"FEEDBACK_MAX_ENTRIES": int, "FEEDBACK_ALPHA": float,
             "REPLAN_ERROR_THRESHOLD": float, "BUILDER_INTERVAL_MS": float,
             "ADMISSION_SAMPLE_FRACTION": float}
    for name, kind in fixed.items():
        assert getattr(tadaptive_constants, name) == kind(jkeys[name + "_DEFAULT"]), name
    assert jkeys["FEEDBACK_ENABLED_DEFAULT"] == jkeys["ADMISSION_ENABLED_DEFAULT"] == "true"
    assert set(jkeys) - set(tkeys) == {
        key for name in [*fixed, "FEEDBACK_ENABLED", "ADMISSION_ENABLED"]
        for key in (name, name + "_DEFAULT")}


def sink():
    return importlib.import_module("tests.conftest").CaptureLogger


def session(pkg, tmp_path, **conf):
    kw = {} if pkg == "jax" else {"device": "cpu"}
    c = dict(CONF, **conf)
    return MODS[pkg].Session(conf=c, system_path=str(tmp_path / f"indexes_{pkg}"), **kw)


def write(dirpath, table, parts=1):
    os.makedirs(dirpath, exist_ok=True)
    n = table.num_rows // parts
    for i in range(parts):
        length = n if i < parts - 1 else table.num_rows - i * n
        pq.write_table(table.slice(i * n, length), os.path.join(dirpath, f"p{i}.parquet"))
    return str(dirpath)


def sorted_rows(table: pa.Table) -> pa.Table:
    return table.sort_by([(c, "ascending") for c in table.column_names])


def adaptive_events(kinds=("AdaptiveActionEvent", "ReplanEvent")) -> list:
    out = []
    for e in sink().events:
        if type(e).__name__ in kinds:
            d = dataclasses.asdict(e)
            for k in ("app_id", "emitted_on_ms", "trace_id", "span_id"):
                d.pop(k, None)
            out.append((type(e).__name__, d))
    return out


def clear_stores():
    for pkg in PKGS:
        FEEDBACK[pkg].get_store().clear()


@pytest.fixture()
def skew_star(tmp_path):
    """~95% of fact rows hit ONE dim1 key, which the selective dim1
    category picks: the uniform-NDV estimate of fact x filtered dim1 is
    about 9.5x under the actual, past the default re-plan threshold of 8."""
    rng = np.random.default_rng(11)
    n_f, n_d1, n_d2 = 4000, 50, 20
    f_d1 = np.zeros(n_f, dtype=np.int64)
    f_d1[:200] = np.arange(200) % (n_d1 - 1) + 1
    rng.shuffle(f_d1)
    fact = pa.table({
        "f_d1": pa.array(f_d1),
        "f_d2": pa.array(rng.integers(0, n_d2, n_f).astype(np.int64)),
        "f_val": pa.array(np.round(rng.uniform(0, 100, n_f), 3)),
    })
    d1_cat = np.array([f"c{i % 9}" for i in range(n_d1)], dtype=object)
    d1_cat[0] = "b"
    dim1 = pa.table({"d1_key": pa.array(np.arange(n_d1, dtype=np.int64)),
                     "d1_cat": pa.array(d1_cat)})
    dim2 = pa.table({"d2_key": pa.array(np.arange(n_d2, dtype=np.int64)),
                     "d2_cat": pa.array(rng.choice(["x", "y"], n_d2))})
    return {"fact": write(tmp_path / "fact", fact), "dim1": write(tmp_path / "dim1", dim1),
            "dim2": write(tmp_path / "dim2", dim2)}


def three_way(s, pkg, paths):
    col = EXPR[pkg].col
    fact = s.read.parquet(paths["fact"])
    d1 = s.read.parquet(paths["dim1"]).filter(col("d1_cat") == "b")
    d2 = s.read.parquet(paths["dim2"])
    return (fact.join(d2, on=col("f_d2") == col("d2_key"))
            .join(d1, on=col("f_d1") == col("d1_key"))
            .select("d1_cat", "d2_cat", "f_val"))


def run_q_error(s, pkg, paths):
    """Run the 3-way once: (its answer, the worst q-error of the reordered
    chain's steps; 1.0 when the text order was kept)."""
    table = three_way(s, pkg, paths).to_arrow()
    qs = []
    for s_ in (st for r in (s._last_join_order or []) for st in r["steps"]):
        actual = s._join_actuals.get(s_["key"])
        if actual is None:
            continue
        est, act = max(float(s_["est_rows"]), 1.0), max(float(actual), 1.0)
        qs.append(max(est / act, act / est))
    return table, (max(qs) if qs else 1.0)


class TestJoinActualKeying:
    def test_same_condition_text_two_table_pairs_no_collision(self, tmp_path):
        a1 = write(tmp_path / "a1", pa.table({"k": pa.array([0, 0, 0, 1, 2], type=pa.int64())}))
        a2 = write(tmp_path / "a2", pa.table({"k2": pa.array([0], type=pa.int64())}))
        b1 = write(tmp_path / "b1", pa.table({"k": pa.array([5, 5, 5, 5, 6, 7],
                                                            type=pa.int64())}))
        b2 = write(tmp_path / "b2", pa.table({"k2": pa.array([5, 5], type=pa.int64())}))
        actuals = {}
        for pkg in PKGS:
            s, col = session(pkg, tmp_path), EXPR[pkg].col
            s.read.parquet(a1).join(s.read.parquet(a2), on=col("k") == col("k2")).to_arrow()
            s.read.parquet(b1).join(s.read.parquet(b2), on=col("k") == col("k2")).to_arrow()
            actuals[pkg] = s._join_actuals
            parsed = {}
            for key, rows in s._join_actuals.items():
                hit = FEEDBACK[pkg].parse_key(key)
                assert hit is not None, key
                cond, lsig, rsig = hit
                parsed.setdefault(cond, []).append((lsig, rsig, rows))
            entries = parsed[repr(col("k") == col("k2"))]
            assert len(entries) == 2 and entries[0][:2] != entries[1][:2]
            assert sorted(e[2] for e in entries) == [3, 8]
        assert actuals["torch"] == actuals["jax"]


class TestFeedbackQError:
    RUNS = 8

    def test_qerror_second_half_beats_first_half(self, tmp_path, skew_star):
        qs, stats = {}, {}
        clear_stores()
        for pkg in PKGS:
            s = session(pkg, tmp_path, **ADAPTIVE_ON)
            # Re-planning would fix run 1 in flight: the loop alone here.
            s.conf.set(AdaptiveConstants.REPLAN_ENABLED, "false")
            qs[pkg] = [run_q_error(s, pkg, skew_star)[1] for _ in range(self.RUNS)]
            stats[pkg] = FEEDBACK[pkg].get_store().stats()
        assert qs["torch"] == qs["jax"]
        assert stats["torch"] == stats["jax"]
        q = qs["torch"]
        half = self.RUNS // 2
        first, second = sum(q[:half]) / half, sum(q[half:]) / half
        assert first > 2.0 and second < first * 0.5 and second < 2.0, q
        assert stats["torch"]["observed"] > 0 and stats["torch"]["paired"] > 0

    def test_qerror_flat_with_adaptive_off(self, tmp_path, skew_star):
        qs = {}
        clear_stores()
        for pkg in PKGS:
            s = session(pkg, tmp_path, **{OptimizerConstants.JOIN_REORDER_ENABLED: "true"})
            qs[pkg] = [run_q_error(s, pkg, skew_star)[1] for _ in range(self.RUNS)]
            assert FEEDBACK[pkg].get_store().stats()["observed"] == 0
        assert qs["torch"] == qs["jax"]
        assert max(qs["torch"]) - min(qs["torch"]) < 1e-9 and qs["torch"][0] > 2.0

    def test_feedback_changes_no_answers(self, tmp_path, skew_star):
        clear_stores()
        baseline = sorted_rows(three_way(session("jax", tmp_path), "jax", skew_star).to_arrow())
        for pkg in PKGS:
            s = session(pkg, tmp_path, **ADAPTIVE_ON)
            for _ in range(3):
                assert sorted_rows(three_way(s, pkg, skew_star).to_arrow()).equals(baseline)


class TestReplan:
    def wired(self, pkg, tmp_path):
        s = session(pkg, tmp_path, **ADAPTIVE_ON)
        s.conf.set(IndexConstants.EVENT_LOGGER_CLASS, LOGGER)
        return s

    def test_misestimate_triggers_one_replan_same_answer(self, tmp_path, skew_star):
        baseline = sorted_rows(three_way(session("jax", tmp_path), "jax", skew_star).to_arrow())
        clear_stores()
        events, stats = {}, {}
        for pkg in PKGS:
            s = self.wired(pkg, tmp_path)
            sink().events.clear()
            assert sorted_rows(three_way(s, pkg, skew_star).to_arrow()).equals(baseline)
            assert FEEDBACK[pkg].get_store().stats()["replans"] == 1
            replans = [e for e in sink().events if type(e).__name__ == "ReplanEvent"]
            assert len(replans) == 1
            ev = replans[0]
            assert ev.threshold == pytest.approx(8.0) and ev.actual_rows > ev.est_rows * 8
            assert " @ " in ev.key and " >< " in ev.key
            # The store holds the correction now: the next run re-plans no more.
            assert sorted_rows(three_way(s, pkg, skew_star).to_arrow()).equals(baseline)
            assert FEEDBACK[pkg].get_store().stats()["replans"] == 1
            events[pkg] = adaptive_events()
            stats[pkg] = FEEDBACK[pkg].get_store().stats()
        assert events["torch"] == events["jax"]
        assert stats["torch"] == stats["jax"]

    def test_replan_disabled_no_trigger(self, tmp_path, skew_star):
        clear_stores()
        for pkg in PKGS:
            s = self.wired(pkg, tmp_path)
            s.conf.set(AdaptiveConstants.REPLAN_ENABLED, "false")
            sink().events.clear()
            three_way(s, pkg, skew_star).to_arrow()
            assert FEEDBACK[pkg].get_store().stats()["replans"] == 0
            assert not adaptive_events(("ReplanEvent",))


@pytest.fixture()
def served(tmp_path):
    """A 2-file fact (MinMax-prunable), a dim, one captured filter query
    and an adaptive session with the capture sink, in each package."""
    rng = np.random.default_rng(3)
    ks = np.sort(rng.integers(0, 100, 4000)).astype(np.int64)
    fact = pa.table({
        "k": pa.array(ks),
        "v": pa.array(rng.integers(0, 9, 4000).astype(np.int64)),
        "w": pa.array(np.round(rng.uniform(0, 1, 4000), 3)),
        "pad": pa.array(rng.integers(0, 5, 4000).astype(np.int64)),
    })
    dim = pa.table({"dk": pa.array(np.arange(100, dtype=np.int64)),
                    "dv": pa.array(rng.integers(0, 5, 100).astype(np.int64))})
    paths = {"fact": write(tmp_path / "fact", fact, parts=2), "dim": write(tmp_path / "dim", dim)}
    out = {"paths": paths}
    for pkg in PKGS:
        s = session(pkg, tmp_path, **ADAPTIVE_ON)
        s.conf.set(IndexConstants.EVENT_LOGGER_CLASS, LOGGER)
        s.enable_hyperspace()
        s.conf.set(AdvisorConstants.CAPTURE_ENABLED, "true")
        q = s.read.parquet(paths["fact"]).filter(EXPR[pkg].col("k") > 50).select("k", "v")
        q.to_arrow()
        s.conf.set(AdvisorConstants.CAPTURE_ENABLED, "false")
        # One latency for both logs: the benefit that ranks is latency x ratio.
        for r in s._workload_log.snapshot():
            r.latency_s = 0.25
        out[pkg] = {"session": s, "hs": MODS[pkg].Hyperspace(s), "q_filter": q}
    return out


class TestBuilder:
    def test_builds_top_recommendation_and_query_uses_it(self, served):
        seen = {}
        for pkg in PKGS:
            s, hs = served[pkg]["session"], served[pkg]["hs"]
            sink().events.clear()
            ledger = BUILDER[pkg].BuilderLedger()
            builder = BUILDER[pkg].AdaptiveBuilder(hs, ledger=ledger)
            out = builder.run_once(force=True)
            assert out["ran"] and out["built"], out
            assert set(out["built"]) <= set(hs.indexes()["name"])
            assert ledger.stats()["bytes_spent"] > 0 and ledger.stats()["in_progress"] == []
            builds = [e for e in sink().events if type(e).__name__ == "AdaptiveActionEvent"
                      and e.action == "builder.build"]
            assert {e.subject for e in builds} == set(out["built"])
            answer = served[pkg]["q_filter"].to_arrow()
            assert sum(s._index_usage_counts.get(n, 0) for n in out["built"]) > 0
            again = builder.run_once(force=True)
            assert not set(again["built"]) & set(out["built"])
            seen[pkg] = (out, ledger.stats(), again, adaptive_events(), answer.sort_by("k"))
        assert seen["torch"][:4] == seen["jax"][:4]
        assert seen["torch"][4].equals(seen["jax"][4])

    def test_budget_retire_and_gating(self, served):
        seen = {}
        for pkg in PKGS:
            s, hs = served[pkg]["session"], served[pkg]["hs"]
            sink().events.clear()
            ledger = BUILDER[pkg].BuilderLedger()
            builder = BUILDER[pkg].AdaptiveBuilder(hs, ledger=ledger)
            first = builder.run_once(force=True)
            assert first["built"]
            served[pkg]["q_filter"].to_arrow()  # the built index is used
            s.conf.set(AdaptiveConstants.BUILDER_MAX_BYTES, "1")
            hs.create_index(s.read.parquet(served["paths"]["dim"]),
                            MODS[pkg].IndexConfig("cold_dim", ["dk"], ["dv"]))
            s.conf.set(AdaptiveConstants.BUILDER_RETIRE_MIN_QUERIES, "1")
            pass_a = builder.run_once(force=True)
            assert pass_a["built"] == [] and "cold_dim" not in pass_a["retired"]
            served[pkg]["q_filter"].to_arrow()  # one completed query since seen
            pass_b = builder.run_once(force=True)
            assert "cold_dim" in pass_b["retired"]
            listed = hs.indexes()
            by_name = dict(zip(listed["name"], listed["state"]))
            assert by_name["cold_dim"] == "DELETED" and by_name[first["built"][0]] == "ACTIVE"
            retires = [e.subject for e in sink().events if type(e).__name__ ==
                       "AdaptiveActionEvent" and e.action == "builder.retire"]
            assert retires == ["cold_dim"]
            s.conf.set(AdaptiveConstants.BUILDER_IDLE_MS, "60000")
            ledger.note_activity()
            warming = builder.run_once(force=False)
            assert not warming["ran"] and warming["reason"] == "idle window still warming"
            builder._serving_busy = lambda: True
            busy = builder.run_once(force=True)
            assert not busy["ran"] and busy["reason"] == "serving busy"
            del builder._serving_busy
            s.conf.set(AdaptiveConstants.BUILDER_ENABLED, "false")
            disabled = builder.run_once(force=True)
            assert disabled["reason"] == "disabled"
            seen[pkg] = (first, pass_a, pass_b, warming, busy, disabled, ledger.stats(),
                         adaptive_events(), by_name)
        assert seen["torch"] == seen["jax"]


ORDERS_WINDOWS = ((datetime.date(1993, 1, 1), datetime.date(1993, 1, 31)),
                  (datetime.date(1994, 6, 1), datetime.date(1994, 7, 31)),
                  (datetime.date(1995, 3, 1), datetime.date(1995, 3, 31)),
                  (datetime.date(1996, 9, 1), datetime.date(1996, 9, 30)))
ORDERS_POINT = datetime.date(1995, 3, 15)
ORDERS_SUM_WINDOW = (datetime.date(1992, 7, 1), datetime.date(1993, 4, 30))


@pytest.fixture()
def orders_workload(tmp_path):
    """chip_smoke.py's advisor workload at a small size: orders in 16
    time-ordered files (o_orderkey follows o_orderdate), four date windows
    selecting o_orderkey and o_totalprice, two o_orderkey IN lookups of
    five keys selecting o_orderdate, one date point count and one window
    sum. Returns (orders dir, {pkg: [query builder(session)]})."""
    rng = np.random.default_rng(5)
    n = 4000
    base = (datetime.date(1992, 1, 1) - datetime.date(1970, 1, 1)).days
    orders = pa.table({
        "o_orderkey": pa.array(np.arange(n, dtype=np.int64)),
        "o_custkey": pa.array(rng.integers(0, n // 10, n).astype(np.int64)),
        "o_orderdate": pa.array(np.sort(rng.integers(0, 2400, n) + base).astype(np.int32),
                                type=pa.int32()).cast(pa.date32()),
        "o_totalprice": pa.array(np.round(rng.uniform(1000, 400000, n), 2)),
    })
    path = str(tmp_path / "orders")
    os.makedirs(path)
    for i in range(16):  # part00 ... part15: the sorted listing is time order
        pq.write_table(orders.slice(i * (n // 16), n // 16),
                       os.path.join(path, f"part{i:02d}.parquet"))
    keys = [[(n * (7 * j + i)) // 40 for i in range(5)] for j in (1, 3)]

    def queries(s, pkg):
        e, df = EXPR[pkg], s.read.parquet(path)
        qs = [df.filter(e.col("o_orderdate").between(lo, hi)).select("o_orderkey", "o_totalprice")
              for lo, hi in ORDERS_WINDOWS]
        qs += [df.filter(e.col("o_orderkey").isin(k)).select("o_orderdate") for k in keys]
        qs.append(df.filter(e.col("o_orderdate") == ORDERS_POINT).agg(e.count().alias("n")))
        qs.append(df.filter(e.col("o_orderdate").between(*ORDERS_SUM_WINDOW)).agg(
            e.sum_(e.col("o_totalprice")).alias("revenue")))
        return qs

    return queries


class TestBuilderOnOrdersWorkload:
    PASSES = 4

    def test_passes_build_the_same_unread_bloom_sketch_as_jax(self, tmp_path, orders_workload):
        """Every pass builds (the advisor always ranks one more candidate),
        and the fourth builds a Bloom sketch on o_orderkey that no query
        reads, since the covering o_orderkey index answers the IN lookups:
        the JAX builder does the same on the same workload."""
        seen = {}
        for pkg in PKGS:
            s = session(pkg, tmp_path, **ADAPTIVE_ON)
            s.enable_hyperspace()
            hs = MODS[pkg].Hyperspace(s)
            qs = orders_workload(s, pkg)
            s.conf.set(AdvisorConstants.CAPTURE_ENABLED, "true")
            for q in qs:
                q.to_arrow()
            s.conf.set(AdvisorConstants.CAPTURE_ENABLED, "false")
            # One latency for both logs: the benefit that ranks is latency x ratio.
            for r in s._workload_log.snapshot():
                r.latency_s = 0.25
            ledger = BUILDER[pkg].BuilderLedger()
            builder = BUILDER[pkg].AdaptiveBuilder(hs, ledger=ledger)
            passes = [builder.run_once(force=True)["built"] for _ in range(self.PASSES)]
            built = [name for p in passes for name in p]
            shapes = []
            for name in built:
                dd = hs.index_manager.get_index(name).derivedDataset
                shapes.append((dd.kind, [(sk.kind, sk.column) for sk in dd.sketches]
                               if dd.kind == "DataSkippingIndex" else list(dd.indexed_columns)))
            before = dict(s._index_usage_counts)
            answers = [q.to_arrow() for q in qs]
            usage = [s._index_usage_counts.get(n, 0) - before.get(n, 0) for n in built]
            report = hs.recommend(top_k=3).explain()
            seen[pkg] = (passes, shapes, usage, ledger.stats(), report, answers)
        passes, shapes, usage = seen["torch"][:3]
        assert all(len(p) == 1 for p in passes)
        assert shapes == [("CoveringIndex", ["o_orderdate"]), ("CoveringIndex", ["o_orderkey"]),
                          ("DataSkippingIndex", [("MinMax", "o_orderdate")]),
                          ("DataSkippingIndex", [("BloomFilter", "o_orderkey")])]
        assert usage == [5, 2, 1, 0]
        assert "#1 [filter]" in seen["torch"][4]
        assert seen["torch"][:5] == seen["jax"][:5]
        for got, want in zip(seen["torch"][5], seen["jax"][5]):
            assert got.equals(want)


class TestAdmission:
    @pytest.fixture()
    def overload(self, tmp_path):
        """A 4-file table, an armed p99 objective no query meets, and a
        clean controller, in each package."""
        rng = np.random.default_rng(5)
        v = rng.integers(0, 1000, 4000).astype(np.int64)
        path = write(tmp_path / "wide", pa.table({"k": pa.array(np.arange(4000, dtype=np.int64)),
                                                  "v": pa.array(v)}), parts=4)
        out = {"path": path, "v": v}
        for pkg in PKGS:
            s = session(pkg, tmp_path, **ADAPTIVE_ON)
            s.conf.set(IndexConstants.EVENT_LOGGER_CLASS, LOGGER)
            s.conf.set(TelemetryConstants.SLO_P99_MS, "0.001")
            s.conf.set(TelemetryConstants.SLO_MIN_COUNT, "1")
            ADMISSION[pkg].get_controller().reset()
            # The monitor's window holds at least one sample.
            s.read.parquet(path).filter(EXPR[pkg].col("k") < 10).to_arrow()
            out[pkg] = {"session": s, "controller": ADMISSION[pkg].get_controller()}
        yield out
        for pkg in PKGS:
            ADMISSION[pkg].get_controller().reset()

    def agg(self, overload, pkg):
        e = EXPR[pkg]
        return overload[pkg]["session"].read.parquet(overload["path"]).agg(
            e.sum_(e.col("v")).alias("sv"), e.count().alias("n"))

    def test_degrade_to_approximate_with_stated_bound(self, overload):
        seen = {}
        for pkg in PKGS:
            sink().events.clear()
            fe = FRONTEND[pkg](overload[pkg]["session"])
            table = fe.submit(self.agg(overload, pkg)).result(timeout=300)
            bound = getattr(table, "approx_error_bound", None)
            assert bound is not None, "a breached SLO did not degrade"
            assert bound["kind"] == "relative" and bound["confidence"] == 0.95
            assert 0.0 < bound["sample_fraction"] < 1.0 and 0.0 <= bound["bound"] <= 1.0
            assert set(bound["scaled"]) == {"sv", "n"}
            files = sorted(os.path.join(overload["path"], f)
                           for f in os.listdir(overload["path"]))
            scale = sum(os.path.getsize(f) for f in files) / os.path.getsize(files[0])
            arrow = table.to_arrow()
            row = arrow.to_pylist()[0]
            assert row["n"] == pytest.approx(1000 * scale)
            assert row["sv"] == pytest.approx(float(overload["v"][:1000].sum()) * scale)
            assert overload[pkg]["controller"].stats()["degrades"] >= 1
            engaged = [e for e in sink().events if type(e).__name__ == "AdaptiveActionEvent"
                       and e.action == "admission.engage"]
            assert engaged and engaged[0].subject == "degrade"
            seen[pkg] = (arrow, bound, overload[pkg]["controller"].stats(), adaptive_events())
        assert seen["torch"][0].equals(seen["jax"][0])
        assert seen["torch"][0].column("sv").to_pylist() == seen["jax"][0].column("sv").to_pylist()
        assert seen["torch"][1:] == seen["jax"][1:]

    def test_prefix_sample_of_time_ordered_files_misses_its_stated_bound_as_jax(
            self, tmp_path, orders_workload):
        """The degraded sum reads a prefix of the sorted file listing. Over
        time-ordered files a window that lies in that prefix is scaled by
        total over kept bytes, about 4x the exact sum, far outside the 95%
        bound the answer states. The JAX package answers the same, bit for
        bit (ROADMAP queue C item 18)."""
        seen = {}
        for pkg in PKGS:
            s = session(pkg, tmp_path, **ADAPTIVE_ON)
            window_sum = orders_workload(s, pkg)[-1]
            exact = window_sum.to_arrow().column("revenue")[0].as_py()
            s.conf.set(TelemetryConstants.SLO_P99_MS, "0.001")
            s.conf.set(TelemetryConstants.SLO_MIN_COUNT, "1")
            ADMISSION[pkg].get_controller().reset()
            window_sum.to_arrow()  # the monitor's window holds a sample
            try:
                table = FRONTEND[pkg](s).submit(window_sum).result(timeout=300)
            finally:
                ADMISSION[pkg].get_controller().reset()
            bound = table.approx_error_bound
            approx = table.to_arrow().column("revenue")[0].as_py()
            assert bound["confidence"] == 0.95 and bound["bound"] < 1.0
            assert 3.5 < approx / exact < 4.5
            assert abs(approx - exact) / exact > bound["bound"]
            seen[pkg] = (approx, exact, bound)
        assert seen["torch"] == seen["jax"]

    def test_ineligible_plan_runs_exact_under_breach(self, overload):
        seen = {}
        for pkg in PKGS:
            s = overload[pkg]["session"]
            q = s.read.parquet(overload["path"]).filter(EXPR[pkg].col("k") < 100).select("k", "v")
            exact = sorted_rows(q.to_arrow())
            table = FRONTEND[pkg](s).submit(q).result(timeout=300)
            assert getattr(table, "approx_error_bound", None) is None
            seen[pkg] = sorted_rows(table.to_arrow())
            assert seen[pkg].equals(exact)
        assert seen["torch"].equals(seen["jax"])

    def test_shed_mode_rejects_typed(self, overload):
        seen = {}
        for pkg in PKGS:
            s = overload[pkg]["session"]
            s.conf.set(AdaptiveConstants.ADMISSION_MODE, "shed")
            fe = FRONTEND[pkg](s)
            e = EXPR[pkg]
            with pytest.raises(REJECTED[pkg], match="slo breach"):
                fe.submit(s.read.parquet(overload["path"]).agg(e.count().alias("n")))
            assert overload[pkg]["controller"].stats()["sheds"] >= 1
            st = fe.stats()
            seen[pkg] = (overload[pkg]["controller"].stats(), st["submitted"], st["rejected"])
        assert seen["torch"] == seen["jax"]

    def test_recovery_restores_exact_answers(self, overload):
        seen = {}
        for pkg in PKGS:
            s, controller = overload[pkg]["session"], overload[pkg]["controller"]
            sink().events.clear()
            fe = FRONTEND[pkg](s)
            degraded = fe.submit(self.agg(overload, pkg)).result(timeout=300)
            assert getattr(degraded, "approx_error_bound", None) is not None
            s.conf.set(TelemetryConstants.SLO_P99_MS, "0")
            assert controller.refresh(s, force=True) is False
            table = fe.submit(self.agg(overload, pkg)).result(timeout=300)
            assert getattr(table, "approx_error_bound", None) is None
            row = table.to_arrow().to_pylist()[0]
            assert row["n"] == 4000 and row["sv"] == overload["v"].sum()
            stats = controller.stats()
            assert stats["recoveries"] >= 1 and not stats["overloaded"]
            assert [e for e in sink().events if type(e).__name__ == "AdaptiveActionEvent"
                    and e.action == "admission.recover"]
            seen[pkg] = (degraded.to_arrow(), table.to_arrow(), stats, adaptive_events())
        for a, b in zip(seen["torch"][:2], seen["jax"][:2]):
            assert a.equals(b)
        assert seen["torch"][2:] == seen["jax"][2:]

    def test_explain_slo_section_equals_jax(self, overload):
        """explain's "SLO:" section with the admission line, from both
        packages' monitors started anew over the same sequence."""
        from test_torch_tracing import fresh_telemetry_state
        from test_torch_advisor import section
        from hyperspace_tpu.plananalysis.explain import explain_string as jexplain
        from hyperspace_tpu_torch.plananalysis.explain import explain_string as texplain
        fresh_telemetry_state(overload["jax"]["session"], overload["torch"]["session"])
        texts = {}
        for pkg, explain in (("jax", jexplain), ("torch", texplain)):
            s = overload[pkg]["session"]
            s.conf.set(TelemetryConstants.TRACE_ENABLED, "false")
            s.conf.set(TelemetryConstants.SLO_P99_MS, "0")
            overload[pkg]["controller"].reset()
            for _ in range(3):
                s.read.parquet(overload["path"]).filter(EXPR[pkg].col("k") < 10).to_arrow()
            overload[pkg]["controller"].refresh(s, force=True)
            texts[pkg] = section(explain(s, self.agg(overload, pkg).plan), "SLO:")
        assert texts["torch"] == texts["jax"]
        assert "admission (degrade): admitting breaches=0" in texts["torch"]


class TestMasterSwitchOff:
    def test_everything_inert_by_default(self, tmp_path, skew_star):
        seen = {}
        clear_stores()
        for pkg in PKGS:
            s = session(pkg, tmp_path, **{OptimizerConstants.JOIN_REORDER_ENABLED: "true"})
            conf = s.hs_conf
            # The port's feedback and admission follow the master switch.
            assert not (conf.adaptive_enabled() or conf.adaptive_replan_enabled()
                        or conf.adaptive_builder_enabled())
            if pkg == "jax":
                assert not (conf.adaptive_feedback_enabled() or conf.adaptive_admission_enabled())
            a = three_way(s, pkg, skew_star).to_arrow()
            b = three_way(s, pkg, skew_star).to_arrow()
            assert a.equals(b)
            stats = FEEDBACK[pkg].get_store().stats()
            assert stats["observed"] == 0 and stats["replans"] == 0
            s.enable_hyperspace()
            hs = MODS[pkg].Hyperspace(s)
            out = BUILDER[pkg].AdaptiveBuilder(hs, ledger=BUILDER[pkg].BuilderLedger()) \
                .run_once(force=True)
            assert out == {"ran": False, "built": [], "retired": [], "maintained": [],
                           "reason": "disabled"}
            controller = ADMISSION[pkg].get_controller()
            controller.reset()
            assert controller.decide(s) == "admit"
            e = EXPR[pkg]
            table = FRONTEND[pkg](s).submit(s.read.parquet(skew_star["fact"])
                                            .agg(e.count().alias("n"))).result(timeout=300)
            assert getattr(table, "approx_error_bound", None) is None
            assert table.to_arrow().column("n").to_pylist() == [4000]
            controller.reset()
            seen[pkg] = (a, stats, controller.stats())
        assert seen["torch"][0].equals(seen["jax"][0])
        assert seen["torch"][1:] == seen["jax"][1:]
