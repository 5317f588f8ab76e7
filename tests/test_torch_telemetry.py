"""The port's telemetry surfaces held against the JAX package's
(``hyperspace_tpu_torch/telemetry/`` against ``hyperspace_tpu/telemetry/``):
typed events, the metrics registry and its OpenMetrics text, the SLO
monitors, the flight recorder and ``explain_analyze``.

Each case runs the same steps, on numpy-seeded files, through both
packages: the JAX package on the CPU with its staged path (fusion and the
distributed tier off), the port with ``device="cpu"``. Structure is
compared with no tolerance; time fields are replaced by a placeholder and
never compared. Events of tiers the port does not have are left out of
the JAX stream, and so is ``KernelCompileEvent``, which counts XLA
compiles there and nvcc builds here (none on the CPU). Both packages'
program banks start fresh, so the bank events' running totals compare.
"""

import dataclasses
import importlib
import json
import os
import re
import sys
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.telemetry import slo as jslo
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.telemetry import events as tevents
from hyperspace_tpu_torch.telemetry import exposition, flight_recorder
from hyperspace_tpu_torch.telemetry import metric_names as MN
from hyperspace_tpu_torch.telemetry import slo as tslo
from hyperspace_tpu_torch.telemetry.constants import TelemetryConstants as TC
from test_torch_tracing import normalize_timeline

PKGS = {"jax": hst, "torch": ht}
LOGGER = f"{__name__}.RecordingLogger"
CONF = {
    IndexConstants.INDEX_NUM_BUCKETS: "4",
    "hyperspace.tpu.distributed.enabled": "false",
    "hyperspace.tpu.execution.fusion.enabled": "false",
    IndexConstants.TPU_IO_THREADS: "4",
    IndexConstants.EVENT_LOGGER_CLASS: LOGGER,
    "hyperspace.index.lineage.enabled": "true",
    TC.TRACE_SAMPLE_RATE: "1.0",
}
TIME_FIELDS = ("seconds", "wait_seconds", "read_seconds", "elapsed_ms")
ID_FIELDS = ("emitted_on_ms", "app_id", "trace_id", "span_id")


class RecordingLogger:
    """The event sink both packages load by dotted name."""

    events = []

    def log_event(self, event):
        RecordingLogger.events.append(event)


def recorded() -> list:
    # get_logger imports this module by name, which may be another module
    # object than the one pytest runs: read the list that one fills.
    return importlib.import_module(__name__).RecordingLogger.events


def expr_module(pkg: str):
    if pkg == "jax":
        from hyperspace_tpu.plan import expr
    else:
        from hyperspace_tpu_torch.plan import expr
    return expr


def write_part(d: str, name: str, rng, n: int) -> None:
    pq.write_table(pa.table({"k": rng.integers(0, 60, n).astype(np.int64),
                             "v": rng.integers(0, 9, n).astype(np.int64)}),
                   os.path.join(d, name))


def make_pair(root: str, pkg: str, conf=None):
    """One session over its own copy of a seeded two-file table."""
    d = os.path.join(root, pkg, "data")
    os.makedirs(d)
    rng = np.random.default_rng(3)
    for i in range(2):
        write_part(d, f"p{i}.parquet", rng, 500)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    session = PKGS[pkg].Session(conf=dict(conf or CONF),
                                system_path=os.path.join(root, pkg, "ix"), **kw)
    return session, d


def normalized_events(events) -> list:
    """(event name, fields) with times as placeholders, ids and app ids
    dropped, the IndexConfig as its repr and each cache key as the order in
    which it first appeared."""
    keys = {}
    out = []
    for e in events:
        if not hasattr(tevents, type(e).__name__) or type(e).__name__ == "KernelCompileEvent":
            continue  # a tier the port does not have, or another count
        fields = {}
        for f in dataclasses.fields(e):
            if f.name in ID_FIELDS:
                continue
            v = getattr(e, f.name)
            if f.name in TIME_FIELDS:
                v = "<t>"
            elif f.name == "index_config":
                v = repr(v)
            elif f.name == "key_digest":
                v = keys.setdefault(v, f"<key{len(keys)}>")
            fields[f.name] = v
        out.append((type(e).__name__, fields))
    return out


def event_steps(root: str, pkg: str) -> list:
    """Create, refresh incrementally, delete, restore, a result-cache miss
    and hit, and a delete whose log write is retried once."""
    from test_torch_introspection import fresh_bank_state
    mod = PKGS[pkg]
    session, d = make_pair(root, pkg)
    hs = mod.Hyperspace(session)
    e = expr_module(pkg)
    fresh_bank_state()
    start = len(recorded())
    hs.create_index(session.read.parquet(d), mod.IndexConfig("kIdx", ["k"], ["v"]))
    write_part(d, "p9.parquet", np.random.default_rng(9), 100)
    hs.refresh_index("kIdx", "incremental")
    hs.delete_index("kIdx")
    hs.restore_index("kIdx")
    session.conf.set("serving.result_cache.enabled", "true")
    session.conf.set("serving.result_cache.minComputeSeconds", "0")
    session.enable_hyperspace()
    q = session.read.parquet(d).filter(e.col("k") == 7).select("v")
    answers = [q.to_arrow(), q.to_arrow()]
    session.conf.set("serving.result_cache.enabled", "false")
    session.conf.set("hyperspace.tpu.robustness.faults.log.write", "error:nth=1,exc=OSError")
    hs.delete_index("kIdx")
    session.conf.unset("hyperspace.tpu.robustness.faults.log.write")
    return answers, normalized_events(recorded()[start:])


def test_event_sequence_equals_jax(tmp_path):
    got_answers, got = event_steps(str(tmp_path), "torch")
    want_answers, want = event_steps(str(tmp_path), "jax")
    assert [a.equals(b) for a, b in zip(got_answers, want_answers)] == [True, True]
    assert got == want
    names = [n for n, _ in got]
    for expected in ("CreateActionEvent", "RefreshIncrementalActionEvent",
                     "DeleteActionEvent", "RestoreActionEvent", "ResultCacheMissEvent",
                     "ResultCacheAdmitEvent", "ResultCacheHitEvent", "RetryEvent",
                     "HyperspaceIndexUsageEvent", "IoReadEvent"):
        assert expected in names
    retry = [f for n, f in got if n == "RetryEvent"]
    assert retry == [{"message": "retry at 'log.write': 2 attempt(s), recovered",
                      "where": "log.write", "attempts": 2, "succeeded": True,
                      "error": "OSError: injected fault at 'log.write'"}]


def test_events_carry_the_active_trace_ids(tmp_path):
    session, d = make_pair(str(tmp_path), "torch")
    hs = ht.Hyperspace(session)
    hs.create_index(session.read.parquet(d), ht.IndexConfig("kIdx", ["k"], ["v"]))
    session.enable_hyperspace()
    start = len(recorded())
    session.read.parquet(d).filter(ht.col("k") == 7).to_arrow()
    tr = hs.last_trace()
    usage = [e for e in recorded()[start:] if type(e).__name__ == "HyperspaceIndexUsageEvent"]
    assert len(usage) == 1 and usage[0].trace_id == tr.trace_id
    rewrite = tr.find("rewrite.index_rules")[0]
    assert usage[0].span_id == rewrite.span_id
    # Outside a trace, events carry no ids.
    assert tevents.HyperspaceEvent().trace_id == ""


def test_failed_action_emits_its_failure_event(tmp_path):
    session, d = make_pair(str(tmp_path), "torch")
    hs = ht.Hyperspace(session)
    start = len(recorded())
    with pytest.raises(Exception):
        hs.create_index(session.read.parquet(d), ht.IndexConfig("bad", ["nope"], []))
    evs = recorded()[start:]
    assert [type(e).__name__ for e in evs] == ["CreateActionEvent", "CreateActionEvent"]
    assert evs[-1].message.startswith("Operation failed:")


def metric_steps(root: str, pkg: str, rate: str):
    """Three queries at ``rate``; the registry's counter delta."""
    conf = dict(CONF, **{TC.TRACE_SAMPLE_RATE: rate})
    session, d = make_pair(root, pkg, conf)
    hs = PKGS[pkg].Hyperspace(session)
    e = expr_module(pkg)
    before = hs.metrics()
    for i in range(3):
        session.read.parquet(d).filter(e.col("k") == i).select("v").to_arrow()
    after = hs.metrics()
    return before, after, hs.metrics_delta(before, after)


PORTED_COLLECTORS = {MN.COLLECTOR_IO, MN.COLLECTOR_SERVING, MN.COLLECTOR_ROBUSTNESS,
                     MN.COLLECTOR_STREAMING, MN.COLLECTOR_FLIGHT_RECORDER,
                     MN.COLLECTOR_BUFFER_POOL, "result_cache"}


@pytest.mark.parametrize("rate", ["1.0", "0.0"])
def test_metrics_keys_and_trace_counters_equal_jax(tmp_path, rate):
    from hyperspace_tpu_torch.streaming.ingest import get_queue
    get_queue()  # the streaming collector registers on first use, as in JAX
    importlib.import_module("hyperspace_tpu.streaming.ingest").get_queue()
    out = {pkg: metric_steps(str(tmp_path / rate), pkg, rate) for pkg in PKGS}
    (_, t_after, t_delta), (_, j_after, j_delta) = out["torch"], out["jax"]
    for part in ("counters", "gauges", "histograms", "collectors"):
        assert part in t_after
    assert set(t_after["histograms"]) >= {MN.QUERY_LATENCY_MS}
    assert PORTED_COLLECTORS <= set(t_after["collectors"])
    assert PORTED_COLLECTORS <= set(j_after["collectors"])
    for name in PORTED_COLLECTORS - {MN.COLLECTOR_SERVING, "result_cache"}:
        assert isinstance(t_after["collectors"][name], dict)
    for name in (MN.TRACE_SAMPLED, MN.TRACE_TAIL_KEPT, MN.TRACE_DISCARDED):
        key = f"counters.{name}"
        assert t_delta.get(key, 0.0) == j_delta.get(key, 0.0)
    kept = "trace.sampled" if rate == "1.0" else "trace.discarded"
    assert t_delta[f"counters.{kept}"] == 3.0
    assert t_delta["histograms.query.latency_ms.total_count"] == 3.0
    assert t_delta == {k: v for k, v in t_delta.items() if v != 0.0}


def test_io_and_buffer_pool_stats_read_through_the_registry(tmp_path, monkeypatch):
    from hyperspace_tpu_torch.telemetry.metrics import get_registry
    session, _ = make_pair(str(tmp_path), "torch")
    hs = ht.Hyperspace(session)
    monkeypatch.setitem(get_registry()._collectors, MN.COLLECTOR_IO, lambda: {"from": 1})
    monkeypatch.setitem(get_registry()._collectors, MN.COLLECTOR_BUFFER_POOL,
                        lambda: {"from": 2})
    assert hs.io_stats() == {"from": 1}
    assert hs.buffer_pool_stats() == {"from": 2}


def test_metrics_text_names_equal_jax_and_parse_strictly(tmp_path, monkeypatch):
    from prometheus_client.openmetrics.parser import text_string_to_metric_families

    from hyperspace_tpu.robustness import faults as jfaults
    from hyperspace_tpu_torch.robustness import faults as tfaults
    # The robustness counters are process-wide and take keys that appear
    # once moved: start both packages' anew, so a counter an earlier test
    # moved in one package only is not read as a name the other lacks.
    monkeypatch.setattr(jfaults, "_STATS", jfaults._Stats())
    monkeypatch.setattr(tfaults, "_STATS", tfaults._Stats())
    families = {}
    for pkg in PKGS:
        session, d = make_pair(str(tmp_path), pkg)
        session.read.parquet(d).filter(expr_module(pkg).col("k") == 1).to_arrow()
        text = PKGS[pkg].Hyperspace(session).metrics_text()
        assert text.endswith("# EOF\n")
        families[pkg] = {f.name: f for f in text_string_to_metric_families(text)}
    t, j = families["torch"], families["jax"]
    assert t["hst_trace_sampled"].type == "counter"
    assert t["hst_trace_sampled"].samples[0].value >= 1
    for prefix in ("hst_query_latency_ms_", "hst_io_", "hst_robustness_",
                   "hst_flight_recorder_", "hst_buffer_pool_"):
        ported = {n for n in t if n.startswith(prefix)}
        assert ported, prefix
        assert ported <= set(j), (prefix, sorted(ported - set(j)))
    # Counters exist once bumped in the process: each is a name of the JAX
    # package's registry.
    from hyperspace_tpu.telemetry.metric_names import METRIC_NAMES as JAX_NAMES
    counters = {n for n, f in t.items() if f.type == "counter"}
    assert counters and counters <= {exposition._sanitize(n) for n in JAX_NAMES}


def test_render_text_prefers_the_registry_instrument():
    text = exposition.render_text({"counters": {"serving.sweep": 2},
                                   "collectors": {"serving": {"sweep": 5}}})
    assert text.count("# TYPE hst_serving_sweep ") == 1
    assert "hst_serving_sweep_total 2" in text


def test_http_endpoint_serves_metrics_and_404s(tmp_path):
    session, d = make_pair(str(tmp_path), "torch")
    hs = ht.Hyperspace(session)
    with pytest.raises(Exception):
        hs.serve_metrics()  # the conf port is 0: off
    port = hs.serve_metrics(0)
    try:
        assert hs.serve_metrics(0) == port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"].startswith("application/openmetrics-text")
        assert body.endswith("# EOF\n") and "hst_io_read_tasks" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
    finally:
        hs.stop_serving_metrics()


LATENCIES = [12.0, 40.0, 7.0, 300.0, 25.0, 18.0, 950.0, 33.0]
ERRORS = [False, False, True, False, False, True, False, False]


@pytest.mark.parametrize("p99_ms", ["100", "5000"])
def test_health_equals_jax_over_the_same_latencies(tmp_path, monkeypatch, p99_ms):
    monkeypatch.setattr(jslo, "_MONITOR", None)
    monkeypatch.setattr(tslo, "_MONITOR", None)
    verdicts, breaches = {}, {}
    for pkg, slo in (("torch", tslo), ("jax", jslo)):
        conf = dict(CONF, **{TC.SLO_P99_MS: p99_ms, TC.SLO_ERROR_RATE: "0.1",
                             TC.SLO_MIN_COUNT: "5"})
        session, _ = make_pair(str(tmp_path), pkg, conf)
        start = len(recorded())
        for ms, err in zip(LATENCIES, ERRORS):
            slo.observe_query(session, ms, error=err)
        verdicts[pkg] = PKGS[pkg].Hyperspace(session).health()
        breaches[pkg] = [(e.objective, e.threshold, e.observed, e.count)
                         for e in recorded()[start:] if type(e).__name__ == "SloBreachEvent"]
    # The port has no degrade-rate key: its objective is the JAX
    # package's disarmed one, left out of the port's verdict.
    jax_degrade = verdicts["jax"]["objectives"].pop("degrade_rate")
    assert jax_degrade == {"armed": False, "threshold": None, "observed": 0.0,
                           "breached": False}
    assert verdicts["torch"] == verdicts["jax"]
    assert breaches["torch"] == breaches["jax"]
    v = verdicts["torch"]
    assert v["count"] == 8 and v["errors"] == 2
    assert v["objectives"]["error_rate"]["breached"] is True
    assert v["objectives"]["p99_latency_ms"]["breached"] is (p99_ms == "100")
    assert v["healthy"] is False


def test_slo_section_of_explain_equals_jax(tmp_path, monkeypatch):
    from hyperspace_tpu.plananalysis.explain import explain_string as jexplain
    from hyperspace_tpu_torch.plananalysis.explain import explain_string as texplain
    monkeypatch.setattr(jslo, "_MONITOR", None)
    monkeypatch.setattr(tslo, "_MONITOR", None)
    sections = {}
    for pkg, slo, fn in (("torch", tslo, texplain), ("jax", jslo, jexplain)):
        conf = dict(CONF, **{TC.SLO_P99_MS: "100", TC.SLO_MIN_COUNT: "1"})
        session, d = make_pair(str(tmp_path), pkg, conf)
        for ms, err in zip(LATENCIES, ERRORS):
            slo.observe_query(session, ms, error=err)
        text = fn(session, session.read.parquet(d).plan)
        sections[pkg] = text[text.index("SLO:"):].split("\n\n")[0]
    assert sections["torch"] == sections["jax"]
    assert "p99_latency_ms: observed 950 objective 100 BREACHED" in sections["torch"]


def test_flight_recorder_dump_keys_equal_jax(tmp_path):
    docs = {}
    for pkg in PKGS:
        session, d = make_pair(str(tmp_path), pkg)
        session.read.parquet(d).filter(expr_module(pkg).col("k") == 1).to_arrow()
        path = str(tmp_path / f"{pkg}_fr.json")
        text = PKGS[pkg].Hyperspace(session).dump_flight_recorder(path)
        with open(path) as f:
            assert f.read() == text
        docs[pkg] = json.loads(text)
    t, j = docs["torch"], docs["jax"]
    assert set(t) == set(j)
    assert set(t["otherData"]) == set(j["otherData"])
    assert set(t["otherData"]["stats"]) == set(j["otherData"]["stats"])
    spans = [e for e in t["traceEvents"] if e["ph"] == "X"]
    assert spans and all("trace_id" in e["args"] for e in spans)
    assert {e["ph"] for e in t["traceEvents"]} <= {"X", "i"}


def test_anomaly_marks_the_trace_and_counts(tmp_path):
    from hyperspace_tpu_torch.telemetry import trace as ttrace
    from hyperspace_tpu_torch.telemetry.metrics import get_registry
    session, _ = make_pair(str(tmp_path), "torch")
    before = get_registry().snapshot()["counters"].get(MN.FLIGHT_ANOMALIES, 0)
    total = flight_recorder.get_recorder().stats()["anomaly_total"]
    with ttrace.maintenance_trace(session, "a") as tr:
        flight_recorder.note_anomaly("unit.test", "detail")
    assert tr.keep_reasons == ["unit.test"]
    assert get_registry().snapshot()["counters"][MN.FLIGHT_ANOMALIES] == before + 1
    assert flight_recorder.get_recorder().stats()["anomaly_total"] == total + 1
    assert flight_recorder.get_recorder().anomalies()[-1]["trace_id"] == tr.trace_id


def test_rings_are_bounded():
    rec = flight_recorder.FlightRecorder(max_traces=2)
    for i in range(600):
        rec.note_event("E", str(i), "", "")
    for i in range(5):
        rec.note_trace(object())
    s = rec.stats()
    assert s["events"] == flight_recorder._MAX_EVENTS and s["event_total"] == 600
    assert s["traces"] == 2 and s["trace_total"] == 5


def analyze_text(pkg: str, session, df) -> list:
    """explain_analyze's lines, numbers and ids as placeholders."""
    text = PKGS[pkg].Hyperspace(session).explain_analyze(df)
    lines = normalize_timeline(text.splitlines())
    return [re.sub(r"query \d+: <t> ms", "query <n>: <t> ms", re.sub(r"=\d+\.\d+s", "=<t>s", x))
            for x in lines]


def test_explain_analyze_equals_jax(tmp_path):
    from test_torch_introspection import fresh_bank_state
    reports = {}
    for pkg in PKGS:
        fresh_bank_state()
        session, d = make_pair(str(tmp_path), pkg)
        hs = PKGS[pkg].Hyperspace(session)
        hs.create_index(session.read.parquet(d), PKGS[pkg].IndexConfig("kIdx", ["k"], ["v"]))
        session.enable_hyperspace()
        session.conf.set(TC.TRACE_SAMPLE_RATE, "0.0")  # forced on regardless
        df = session.read.parquet(d).filter(expr_module(pkg).col("k") == 7).select("v")
        reports[pkg] = analyze_text(pkg, session, df)
    assert reports["torch"] == reports["jax"]
    text = "\n".join(reports["torch"])
    assert "== Explain Analyze ==" in text and "exec.stage" in text
    assert "cache: no lookup (result cache off)" in text and "robustness: clean" in text
    assert "bank: misses=+1 programs=+1 stages=+1 stages_by_kind.fused-predicate=+1" \
        in text


def test_no_telemetry_module_reads_the_environment():
    """Conf is read through config.py only."""
    root = os.path.dirname(sys.modules["hyperspace_tpu_torch.telemetry"].__file__)
    for name in os.listdir(root):
        if name.endswith(".py"):
            with open(os.path.join(root, name)) as f:
                src = f.read()
            assert "os.environ" not in src and "getenv" not in src, name
