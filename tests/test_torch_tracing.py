"""The port's span traces held against the JAX package's
(``hyperspace_tpu_torch/telemetry/trace.py`` against
``hyperspace_tpu/telemetry/trace.py``).

One numpy-seeded TPC-H-shaped lake (``bench.make_tpch_like``) runs the
same steps through both packages, each on its staged path (fusion and
the distributed tier off; a fused Q3 and a one-device dispatch are held
to the JAX package's on their own), the JAX package on the CPU, the port
with ``device="cpu"``. For a filter query, an indexed Q3, a serving sweep
of four members, a join-reordered Q17 and a streaming append and commit,
the span trees must be equal as lists of (name, depth, node, rows, hit,
tier, files, members), with no tolerance: the program bank's lookups
included, hit for hit (but for the sweep, where the JAX package's stacked
mask has no counterpart). Spans the port does not have are left out of the
JAX tree, and depth counts the spans kept. Times and ids are never
compared.

Within the port: tracing off gives byte-identical answers and opens no
trace; every span name the package opens is a constant of its
``span_names.py``, and every constant there is observed here; the chrome
export, the maintenance traces, the one-shot profiler capture and the
``hyperspace.tpu.trace.dir`` capture write what they promise.
"""

import ast
import datetime
import glob
import json
import os

import numpy as np
import torch
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import bench
import chip_smoke
import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import buffer_pool as jbp
from hyperspace_tpu.serving import frontend as jfrontend
from hyperspace_tpu_torch.execution import buffer_pool as tbp
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.serving import frontend as tfrontend
from hyperspace_tpu_torch.telemetry import span_names as SN
from hyperspace_tpu_torch.telemetry import trace as ttrace
from hyperspace_tpu_torch.telemetry.constants import TelemetryConstants as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.002
CONF = {
    IndexConstants.INDEX_NUM_BUCKETS: "8",
    "hyperspace.tpu.distributed.enabled": "false",
    "hyperspace.tpu.execution.fusion.enabled": "false",
    IndexConstants.TPU_IO_THREADS: "4",
    TC.TRACE_SAMPLE_RATE: "1.0",
}
INDEXES = [
    ("li_idx", "lineitem", ["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"]),
    ("od_idx", "orders", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_shippriority"]),
    ("li_ship_idx", "lineitem", ["l_shipdate"], ["l_orderkey", "l_extendedprice"]),
]
PKGS = {"jax": hst, "torch": ht}
ATTRS = ("node", "rows", "hit", "tier", "files", "members")


def fresh_telemetry_state(*sessions) -> None:
    """Start both packages' process-wide SLO monitors anew and forget the
    sessions' last traces: explain's "SLO:" and "Trace:" sections render
    from them once any query has run in the process."""
    from hyperspace_tpu.telemetry import slo as jslo
    from hyperspace_tpu_torch.telemetry import slo as tslo
    jslo._MONITOR = None
    tslo._MONITOR = None
    for session in sessions:
        session._last_trace = None


def make_session(pkg: str, system_path: str, conf=None):
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return PKGS[pkg].Session(conf=dict(conf or CONF), system_path=system_path, **kw)


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    li_dir, od_dir, pt_dir, _, _ = bench.make_tpch_like(str(root / "data"), SCALE)
    dirs = {"lineitem": li_dir, "orders": od_dir, "part": pt_dir}
    out = {"dirs": dirs, "root": root}
    for pkg, mod in PKGS.items():
        session = make_session(pkg, str(root / f"{pkg}_indexes"))
        hs = mod.Hyperspace(session)
        for name, table, indexed, included in INDEXES:
            hs.create_index(session.read.parquet(dirs[table]),
                            mod.IndexConfig(name, indexed, included))
        out[pkg] = session
    return out


def expr_module(pkg: str):
    if pkg == "jax":
        from hyperspace_tpu.plan import expr
    else:
        from hyperspace_tpu_torch.plan import expr
    return expr


def clear_pools() -> None:
    jbp.get_pool().clear()
    tbp.get_pool().clear()


def span_rows(trace) -> list:
    """(name, depth, node, rows, hit, tier, files, members) per span, in
    tree order; spans not in the port's registry are left out and depth
    counts only the spans kept."""
    kids = {}
    for s in trace.spans:
        kids.setdefault(s.parent_id, []).append(s)
    out = []

    def walk(span, depth):
        keep = span.name in SN.SPAN_NAMES
        if keep:
            out.append((span.name, depth) + tuple(span.attrs.get(k) for k in ATTRS))
        for child in kids.get(span.span_id, []):
            walk(child, depth + (1 if keep else 0))

    for r in kids.get(None, []):
        walk(r, 0)
    return out


def last_trace(lake, pkg):
    return PKGS[pkg].Hyperspace(lake[pkg]).last_trace()


def filter_query(lake, pkg):
    e = expr_module(pkg)
    li = lake[pkg].read.parquet(lake["dirs"]["lineitem"])
    return li.filter(e.col("l_shipdate") > chip_smoke.CUTOFF).select("l_extendedprice")


def q3(lake, pkg):
    session, d = lake[pkg], lake["dirs"]
    builders = bench if pkg == "jax" else chip_smoke
    return builders.build_q3(session, d["lineitem"], d["orders"])


def q17(lake, pkg):
    session, d = lake[pkg], lake["dirs"]
    builders = bench if pkg == "jax" else chip_smoke
    return builders.build_q17(session, d["lineitem"], d["part"])


def traced_cold_run(lake, pkg, build, indexed=True):
    session = lake[pkg]
    (session.enable_hyperspace if indexed else session.disable_hyperspace)()
    try:
        df = build(lake, pkg)
        df.to_arrow()  # warm: the JAX package compiles, both cache the index list
        clear_pools()
        table = df.to_arrow()
        return table, span_rows(last_trace(lake, pkg))
    finally:
        session.disable_hyperspace()


@pytest.mark.parametrize("indexed", [True, False])
@pytest.mark.parametrize("name", ["filter", "q3"])
def test_query_span_tree_equals_jax(lake, name, indexed):
    build = filter_query if name == "filter" else q3
    got, rows = traced_cold_run(lake, "torch", build, indexed)
    want, jrows = traced_cold_run(lake, "jax", build, indexed)
    assert got.equals(want)
    assert rows == jrows
    names = {r[0] for r in rows}
    assert {SN.QUERY, SN.PLAN_NORMALIZE, SN.EXEC_STAGE} <= names
    assert (SN.INDEX_REWRITE in names) == indexed
    assert rows[0][:2] == (SN.QUERY, 0)


@pytest.mark.parametrize("indexed", [True, False])
def test_fused_region_span_tree_equals_jax(lake, indexed):
    """With fusion on in both packages, Q3's fused regions record one
    exec.fused span each in place of their nodes' exec.stage spans, and
    the trees are equal. Indexed, the covering indexes' bucket order keeps
    the staged merge join: no region fuses."""
    from hyperspace_tpu_torch.execution import fusion as tfusion
    for session in (lake["torch"], lake["jax"]):
        session.conf.set(IndexConstants.TPU_FUSION_ENABLED, "true")
    try:
        d0 = tfusion.DISPATCH_COUNT
        got, rows = traced_cold_run(lake, "torch", q3, indexed)
        want, jrows = traced_cold_run(lake, "jax", q3, indexed)
    finally:
        for session in (lake["torch"], lake["jax"]):
            session.conf.set(IndexConstants.TPU_FUSION_ENABLED, "false")
    assert got.equals(want)
    assert rows == jrows
    assert (tfusion.DISPATCH_COUNT > d0) == (not indexed)
    assert (SN.EXEC_FUSED in {r[0] for r in rows}) == (not indexed)


def test_q3_tree_has_a_stage_per_plan_node_and_reads_under_scans(lake):
    _, rows = traced_cold_run(lake, "torch", q3, True)
    plan = q3(lake, "torch")
    lake["torch"].enable_hyperspace()
    try:
        optimized = plan.optimized_plan()
    finally:
        lake["torch"].disable_hyperspace()
    stages = [r for r in rows if r[0] == SN.EXEC_STAGE]
    assert stages[0][2] == optimized.node_name
    reads = [i for i, r in enumerate(rows) if r[0] == SN.IO_READ]
    assert len(reads) == 2
    for i in reads:
        parent = rows[i - 1]
        assert parent[0] == SN.EXEC_STAGE and parent[1] == rows[i][1] - 1
        assert rows[i][6] >= 1  # files


def test_cache_hit_and_miss_trees_equal_jax(lake):
    """Cold against result-cache hit: the trees differ at the cache-lookup
    span, in both packages alike."""
    trees = {}
    for pkg in PKGS:
        session = lake[pkg]
        session.conf.set("serving.result_cache.enabled", "true")
        session.conf.set("serving.result_cache.minComputeSeconds", "0")
        try:
            df = filter_query(lake, pkg)
            trees[pkg] = []
            for _ in range(2):
                df.to_arrow()
                trees[pkg].append(span_rows(last_trace(lake, pkg)))
        finally:
            session.conf.set("serving.result_cache.enabled", "false")
    assert trees["torch"] == trees["jax"]
    miss, hit = trees["torch"]
    assert [r for r in miss if r[0] == SN.CACHE_LOOKUP][0][4:6] == (False, None)
    assert [r for r in hit if r[0] == SN.CACHE_LOOKUP][0][4:6] == (True, "device")
    assert not any(r[0] == SN.EXEC_STAGE for r in hit)


def q6_variant(lake, pkg, i):
    e = expr_module(pkg)
    li = lake[pkg].read.parquet(lake["dirs"]["lineitem"])
    lo = datetime.date(1994, 1, 1) + datetime.timedelta(days=30 * i)
    hi = lo + datetime.timedelta(days=365)
    return (li.filter((e.col("l_shipdate") >= lo) & (e.col("l_shipdate") < hi)
                      & (e.col("l_discount") >= 0.02))
            .agg(e.sum_(e.col("l_extendedprice") * e.col("l_discount")).alias("revenue")))


def test_sweep_members_nest_under_one_sweep_span_as_jax(lake, monkeypatch):
    monkeypatch.setattr(tfrontend, "_DEFAULT", None)
    monkeypatch.setattr(jfrontend, "_DEFAULT", None)
    trees, answers = {}, {}
    for pkg, fe_mod in (("torch", tfrontend), ("jax", jfrontend)):
        session = lake[pkg]
        session.conf.set("hyperspace.tpu.serving.admission.maxBytes", str(1 << 40))
        front = fe_mod.ServingFrontend(session)
        clear_pools()
        pending = front.submit_wave([(q6_variant(lake, pkg, i).plan, session, "c", None)
                                     for i in range(4)])
        answers[pkg] = [p.result(timeout=120) for p in pending]
        front.drain()
        # The program bank's spans are leaves and differ here by design
        # (ROADMAP queue C): the JAX package evaluates the members' masks
        # in one stacked "fused-predicate-sweep" program under the sweep,
        # the port evaluates each member's own mask under its query.
        trees[pkg] = [r for r in span_rows(last_trace(lake, pkg))
                      if r[0] not in (SN.BANK_LOOKUP, SN.BANK_COMPILE)]
    for got, want in zip(answers["torch"], answers["jax"]):
        assert got.num_rows == want.num_rows == 1
    assert trees["torch"] == trees["jax"]
    rows = trees["torch"]
    assert rows[0][:2] == (SN.SERVING_SWEEP, 0) and rows[0][7] == 4
    assert [r[:2] for r in rows if r[0] == SN.QUERY] == [(SN.QUERY, 1)] * 4


@pytest.fixture(scope="module")
def sql_lake(tmp_path_factory):
    """The sql path's TPC-H lake (``chip_smoke.make_tpch_sql``), its tables
    as temp views of one session per package."""
    root = tmp_path_factory.mktemp("tracing_sql")
    dirs, _ = chip_smoke.make_tpch_sql(str(root / "data"), 0.002)
    out = {}
    for pkg in PKGS:
        session = make_session(pkg, str(root / f"{pkg}_indexes"))
        for name, d in dirs.items():
            session.create_temp_view(name, session.read.parquet(d))
        out[pkg] = session
    return out


def test_reordered_q17_tree_equals_jax(sql_lake):
    """TPC-H Q17's text with join reordering on: part, then lineitem, then
    the per-part average (the chain the sql path reorders at every
    scale)."""
    trees, answers = {}, {}
    for pkg in PKGS:
        session = sql_lake[pkg]
        session.conf.set("hyperspace.tpu.optimizer.joinReorder.enabled", "true")
        try:
            df = session.sql(chip_smoke.TPCH_TEXTS["q17"])
            df.to_arrow()
            clear_pools()
            answers[pkg] = df.to_arrow()
            tr = PKGS[pkg].Hyperspace(session).last_trace()
            spans = tr.find(SN.JOIN_REORDER)
            assert len(spans) == 1 and spans[0].attrs["reordered"] == 1
            trees[pkg] = span_rows(tr)
        finally:
            session.conf.set("hyperspace.tpu.optimizer.joinReorder.enabled", "false")
    assert answers["torch"].equals(answers["jax"])
    assert trees["torch"] == trees["jax"]
    assert (SN.JOIN_REORDER, 1) in [r[:2] for r in trees["torch"]]


def streaming_steps(pkg: str, root: str):
    """Create an index over a one-file table, append a batch and commit it;
    the (append, commit) trees."""
    mod = PKGS[pkg]
    table = os.path.join(root, pkg, "events")
    os.makedirs(table)
    rng = np.random.default_rng(21)
    pq.write_table(pa.table({"id": np.arange(200, dtype=np.int64),
                             "v": rng.integers(0, 50, 200).astype(np.int64)}),
                   os.path.join(table, "part-0.parquet"))
    conf = dict(CONF)
    conf["hyperspace.tpu.streaming.enabled"] = "true"
    session = make_session(pkg, os.path.join(root, pkg, "ix"), conf)
    hs = mod.Hyperspace(session)
    hs.create_index(session.read.parquet(table), mod.IndexConfig("ev_idx", ["id"], ["v"]))
    batch = pa.table({"id": np.arange(200, 260, dtype=np.int64),
                      "v": rng.integers(0, 50, 60).astype(np.int64)})
    hs.append(table, batch)
    append_tree = span_rows(hs.last_trace())
    hs.commit(table)
    return append_tree, span_rows(hs.last_trace())


def test_streaming_append_and_commit_trees_equal_jax(tmp_path):
    got = streaming_steps("torch", str(tmp_path))
    want = streaming_steps("jax", str(tmp_path))
    assert got == want
    append_tree, commit_tree = got
    assert append_tree[0][:2] == (SN.INGEST_APPEND, 0)
    assert [r[:2] for r in commit_tree[:2]] == [(SN.INGEST_WAVE, 0), (SN.INGEST_COMMIT, 1)]


def test_tracing_off_is_byte_identical_and_opens_no_trace(lake):
    session = lake["torch"]
    session.enable_hyperspace()
    try:
        on = q3(lake, "torch").to_arrow()
        session.conf.set(TC.TRACE_ENABLED, "false")
        session._last_trace = None
        off = q3(lake, "torch").to_arrow()
        assert session._last_trace is None
        assert ht.Hyperspace(session).last_trace() is None
    finally:
        session.conf.set(TC.TRACE_ENABLED, "true")
        session.disable_hyperspace()
    assert on.equals(off)
    for name in on.column_names:
        a, b = on.column(name).to_numpy(), off.column(name).to_numpy()
        assert a.tobytes() == b.tobytes()


def test_span_is_a_shared_noop_without_a_trace():
    assert ttrace.idle()
    assert ttrace.span(SN.EXEC_STAGE, node="x") is ttrace.NOOP
    assert ttrace.add_span(SN.IO_READ) is None
    assert ttrace.active_ids() == ("", "")


def test_sample_rate_zero_discards_and_rate_one_keeps(lake):
    session = lake["torch"]
    session.conf.set(TC.TRACE_SAMPLE_RATE, "0.0")
    try:
        session._last_trace = None
        filter_query(lake, "torch").to_arrow()
        assert session._last_trace is None
    finally:
        session.conf.set(TC.TRACE_SAMPLE_RATE, "1.0")
    filter_query(lake, "torch").to_arrow()
    assert session._last_trace is not None


def test_a_failed_query_is_tail_kept_at_rate_zero(lake):
    """A query cancelled at its deadline fails; its trace survives a
    negative sample coin, marked by the robustness note and the error."""
    import time
    from hyperspace_tpu_torch.exceptions import QueryDeadlineError
    from hyperspace_tpu_torch.serving.context import QueryContext
    session = lake["torch"]
    session.conf.set(TC.TRACE_SAMPLE_RATE, "0.0")
    try:
        session._last_trace = None
        ctx = QueryContext.for_session(session, deadline_s=time.perf_counter() - 1.0)
        with pytest.raises(QueryDeadlineError):
            session.execute(filter_query(lake, "torch").plan, context=ctx)
        tr = session._last_trace
        assert tr is not None
        assert tr.keep_reasons == ["robustness", "query.cancelled", "error"]
        assert [s.attrs.get("cancelled_at") for s in tr.spans
                if s.attrs.get("deadline_exceeded")] == ["exec.stage"]
    finally:
        session.conf.set(TC.TRACE_SAMPLE_RATE, "1.0")


def test_chrome_export_carries_the_tree(lake):
    traced_cold_run(lake, "torch", q3, True)
    tr = last_trace(lake, "torch")
    doc = json.loads(tr.to_chrome_json())
    events = doc["traceEvents"]
    assert len(events) == len(tr.spans) and doc["otherData"]["trace_id"] == tr.trace_id
    ids = {e["args"]["span_id"] for e in events}
    assert all(e["args"].get("parent_id") in ids for e in events if "parent_id" in e["args"])
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)


def normalize_timeline(lines) -> list:
    """Timeline lines with times and ids as placeholders, the spans of
    tiers the port does not have (the program bank's ``bank.lookup``)
    left out, and the name column's padding collapsed."""
    import re
    out = []
    for line in lines:
        name = line.split()[0] if line.split() else ""
        if "." in name and name not in SN.SPAN_NAMES:
            continue
        line = re.sub(r"trace [0-9a-f]+: \d+ span\(s\)", "trace <id>: <n> span(s)", line)
        line = re.sub(r"\d+\.\d+ ms", "<t> ms", line)
        indent = len(line) - len(line.lstrip(" "))
        out.append(" " * indent + re.sub(r" +", " ", line.strip()))
    return out


def test_explain_trace_section_equals_jax_after_normalizing(lake):
    from hyperspace_tpu.plananalysis.explain import explain_string as jexplain
    from hyperspace_tpu_torch.plananalysis.explain import explain_string as texplain
    texts = {}
    for pkg, fn in (("torch", texplain), ("jax", jexplain)):
        traced_cold_run(lake, pkg, q3, True)
        text = fn(lake[pkg], filter_query(lake, pkg).plan)
        section = text[text.index("Trace:"):].split("\n\n")[0]
        texts[pkg] = normalize_timeline(section.splitlines())
    assert texts["torch"] == texts["jax"]
    assert any("exec.stage" in line for line in texts["torch"])


def test_maintenance_trace_only_without_an_ambient_trace(lake):
    session = lake["torch"]
    with ttrace.maintenance_trace(session, "m") as tr:
        assert tr is not None
        with ttrace.span(SN.INGEST_COMPACT) as sp:
            assert sp is not None
            with ttrace.maintenance_trace(session, "inner") as inner:
                assert inner is None
    assert session._last_trace is tr
    assert [s.name for s in tr.spans] == [SN.INGEST_COMPACT]


def test_compaction_and_source_spans(tmp_path):
    session = make_session("torch", str(tmp_path / "ix"),
                           dict(CONF, **{"hyperspace.tpu.streaming.enabled": "true",
                                         "hyperspace.tpu.streaming.compaction.minEntries":
                                         "1"}))
    hs = ht.Hyperspace(session)
    table = str(tmp_path / "t")
    os.makedirs(table)
    pq.write_table(pa.table({"id": np.arange(10, dtype=np.int64)}),
                   os.path.join(table, "p0.parquet"))
    hs.create_index(session.read.parquet(table), ht.IndexConfig("t_idx", ["id"], []))
    for i in range(2):
        hs.append(table, pa.table({"id": np.arange(10 + i, 11 + i, dtype=np.int64)}))
        hs.commit(table)
    hs.compact()
    assert [s.name for s in hs.last_trace().spans] == [SN.INGEST_COMPACT]
    watch = str(tmp_path / "drops")
    os.makedirs(watch)
    pq.write_table(pa.table({"id": np.arange(50, 52, dtype=np.int64)}),
                   os.path.join(watch, "d0.parquet"))
    src = hs.tail_directory(watch, table)
    try:
        assert src._poll_once()
        names = [s.name for s in hs.last_trace().spans]
    finally:
        src.stop()
    assert names[0] == SN.INGEST_SOURCE and SN.INGEST_APPEND in names


def test_profiler_capture_is_one_shot_and_exports_a_chrome_trace(lake, tmp_path):
    session = lake["torch"]
    out_dir = str(tmp_path / "prof")
    session.conf.set(TC.PROFILER_ENABLED, "true")
    session.conf.set(TC.PROFILER_DIR, out_dir)
    ttrace.reset_profiler()
    try:
        filter_query(lake, "torch").to_arrow()
        filter_query(lake, "torch").to_arrow()
    finally:
        session.conf.set(TC.PROFILER_ENABLED, "false")
        ttrace.reset_profiler()
    files = glob.glob(os.path.join(out_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        doc = json.load(f)
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])


def test_trace_dir_captures_every_execution(lake, tmp_path):
    session = lake["torch"]
    session.conf.set(IndexConstants.TPU_TRACE_DIR, str(tmp_path / "td"))
    try:
        filter_query(lake, "torch").to_arrow()
        filter_query(lake, "torch").to_arrow()
    finally:
        session.conf.unset(IndexConstants.TPU_TRACE_DIR)
    assert len(glob.glob(str(tmp_path / "td" / "*.json"))) == 2


def _span_name_args(tree: ast.AST) -> list:
    """The first argument of every ``span(...)``, ``add_span(...)`` and
    ``new_span(...)`` call."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("span", "add_span", "new_span") and node.args:
                out.append(node.args[0])
    return out


def test_span_registry_is_closed():
    """Every span site in the port names a constant of its span_names.py
    (an attribute of the imported module), never a free-form string, and
    every constant has a site. trace.py's own helpers forward their
    caller's name."""
    constants = {k for k, v in vars(SN).items() if isinstance(v, str) and k.isupper()}
    used = set()
    for path in glob.glob(os.path.join(ROOT, "hyperspace_tpu_torch", "**", "*.py"),
                          recursive=True):
        forwarding = path.endswith(os.path.join("telemetry", "trace.py"))
        with open(path) as f:
            tree = ast.parse(f.read())
        for arg in _span_name_args(tree):
            if forwarding and not (isinstance(arg, ast.Attribute)
                                   and getattr(arg.value, "id", "") == "span_names"):
                continue
            assert isinstance(arg, ast.Attribute) and arg.attr in constants, \
                f"{path}: span name must be a span_names constant"
            used.add(arg.attr)
    assert used == constants
    assert {getattr(SN, k) for k in constants} == set(SN.SPAN_NAMES)


# Every registered span name, observed by a test of this file (the test
# named beside it asserts the span appears).
OBSERVED_BY = {
    SN.QUERY: "test_query_span_tree_equals_jax",
    SN.PLAN_NORMALIZE: "test_query_span_tree_equals_jax",
    SN.INDEX_REWRITE: "test_query_span_tree_equals_jax",
    SN.EXEC_STAGE: "test_query_span_tree_equals_jax",
    SN.EXEC_FUSED: "test_fused_region_span_tree_equals_jax",
    SN.IO_READ: "test_q3_tree_has_a_stage_per_plan_node_and_reads_under_scans",
    SN.IO_PREFETCH: "test_prefetch_stream_records_its_span",
    SN.CACHE_LOOKUP: "test_cache_hit_and_miss_trees_equal_jax",
    SN.JOIN_REORDER: "test_reordered_q17_tree_equals_jax",
    SN.SERVING_SWEEP: "test_sweep_members_nest_under_one_sweep_span_as_jax",
    SN.INGEST_APPEND: "test_streaming_append_and_commit_trees_equal_jax",
    SN.INGEST_COMMIT: "test_streaming_append_and_commit_trees_equal_jax",
    SN.INGEST_WAVE: "test_streaming_append_and_commit_trees_equal_jax",
    SN.INGEST_COMPACT: "test_compaction_and_source_spans",
    SN.INGEST_SOURCE: "test_compaction_and_source_spans",
    SN.CLUSTER_FORWARD: "test_cluster_forward_broadcast_and_gather_spans",
    SN.CLUSTER_BROADCAST: "test_cluster_forward_broadcast_and_gather_spans",
    SN.CLUSTER_GATHER: "test_cluster_forward_broadcast_and_gather_spans",
    SN.SPMD_DISPATCH: "test_spmd_dispatch_span_equals_jax",
    SN.BANK_LOOKUP: "test_bank_and_artifact_spans",
    SN.BANK_COMPILE: "test_bank_and_artifact_spans",
    SN.ARTIFACT_EXPORT: "test_bank_and_artifact_spans",
    SN.ARTIFACT_LOAD: "test_bank_and_artifact_spans",
    SN.ARTIFACT_WARMUP: "test_bank_and_artifact_spans",
}


def test_bank_and_artifact_spans(lake, tmp_path, monkeypatch):
    """A first bank lookup records bank.lookup with a nested bank.compile
    (a miss), a second one bank.lookup alone (a hit); the artifact store's
    publication, load and preload record their spans."""
    from hyperspace_tpu_torch.artifacts import store as tstore
    from hyperspace_tpu_torch.artifacts.manager import ArtifactManager
    from hyperspace_tpu_torch.serving import program_bank
    bank = program_bank.ProgramBank()
    env = {"torch": "t", "cuda": "c", "nvcc": "n", "arch": "a"}
    monkeypatch.setattr(tstore, "runtime_env", lambda: dict(env))
    store = tstore.ArtifactStore(str(tmp_path / "store"), 1 << 20)
    fields = tstore.key_fields("not_a_kernel", "src", env)
    with ttrace.maintenance_trace(lake["torch"], "t") as tr:
        for _ in range(2):
            bank.lookup(("fused-predicate", "k"), (1024,), lambda: len)
        assert store.publish(fields, b"payload")
        assert store.load(fields) == b"payload"
        out = ArtifactManager(store).preload(5000.0, 1 << 20)
    lookups = tr.find(SN.BANK_LOOKUP)
    assert [sp.attrs["hit"] for sp in lookups] == [False, True]
    assert len(tr.find(SN.BANK_COMPILE)) == 1
    assert tr.find(SN.ARTIFACT_EXPORT)[0].attrs["published"] is True
    assert tr.find(SN.ARTIFACT_LOAD)[0].attrs["hit"] is True
    warm, = tr.find(SN.ARTIFACT_WARMUP)
    assert warm.attrs["loaded"] == out["loaded"] == 0 and out["skipped"] == 1


def test_spmd_dispatch_span_equals_jax(lake, monkeypatch):
    """A one-device SPMD dispatch (singleDevice=on, both packages on a
    one-device mesh) records one spmd.dispatch span under the aggregate's
    stage, with the same mode and rows."""
    from hyperspace_tpu.execution import spmd as jspmd
    from hyperspace_tpu_torch.execution import spmd as tspmd
    monkeypatch.setattr(jspmd, "_device_count", lambda *a: 1)
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device("cpu")])
    conf = dict(CONF, **{"hyperspace.tpu.distributed.enabled": "true",
                         "hyperspace.tpu.distributed.singleDevice": "on",
                         "hyperspace.tpu.distributed.minStreamRows": "0"})
    got = {}
    for pkg, mod in PKGS.items():
        session = make_session(pkg, str(lake["root"] / f"{pkg}_spmd"), conf)
        E = expr_module(pkg)
        session.read.parquet(lake["dirs"]["lineitem"]).filter(
            E.col("l_quantity") < 20).agg(E.count(None).alias("n")).to_arrow()
        spans = mod.Hyperspace(session).last_trace().find(SN.SPMD_DISPATCH)
        got[pkg] = [(sp.attrs["mode"], sp.attrs["rows"]) for sp in spans]
    assert got["torch"] == got["jax"] == [("agg", 1)]


def test_cluster_forward_broadcast_and_gather_spans(tmp_path):
    """A forward to a peer nobody runs (degraded), a commit notice to it,
    and a two-rank host gather (rank 1 a thread) each record their span."""
    import threading
    import time
    from hyperspace_tpu_torch.cluster import gather, membership, worker
    from hyperspace_tpu_torch.cluster.constants import ClusterConstants as CC
    from hyperspace_tpu_torch.parallel import io as pio
    session = make_session("torch", str(tmp_path / "ix"),
                           dict(CONF, **{CC.ENABLED: "true", CC.WORKER_ID: "w-span",
                                         CC.FORWARD_TIMEOUT_MS: "300"}))
    node = worker.get_node(session)
    try:
        root = membership.membership_dir(session)
        now = time.time() * 1000.0
        with open(os.path.join(root, "member-w-gone.json"), "w") as f:
            f.write(json.dumps({"worker_id": "w-gone", "host": "127.0.0.1", "port": 1,
                                "pid": 999999, "started_ms": now, "heartbeat_ms": now}))
        gone = next(m for m in node.membership.live_members() if m.worker_id == "w-gone")
        gather.init_process(0, 2, f"tracing-{tmp_path}")
        rdv = gather._rendezvous_dir(gather.process_identity()[2])
        rank1 = threading.Thread(target=gather.host_allgather, args=(np.array([2]),),
                                 kwargs=dict(rank=1, n=2, seq=1, rendezvous_dir=rdv))
        with ttrace.maintenance_trace(session, "cluster") as tr:
            assert node.forward(gone, None, "digest") is None
            assert node.broadcast_commit("tbl") == 0
            rank1.start()
            with pio.use_session(session):
                stacked = gather.allgather(np.array([1]))
            rank1.join(timeout=60)
        assert stacked.tolist() == [[1], [2]]
        assert len(tr.find(SN.CLUSTER_FORWARD)) == 1
        bc, = tr.find(SN.CLUSTER_BROADCAST)
        assert (bc.attrs["peers"], bc.attrs["delivered"]) == (1, 0)
        assert len(tr.find(SN.CLUSTER_GATHER)) == 1
    finally:
        worker.shutdown_for_tests()
        gather.reset_for_tests()


def test_every_registered_span_is_observed():
    assert set(OBSERVED_BY) == set(SN.SPAN_NAMES)
    names = set(globals())
    assert all(test in names for test in OBSERVED_BY.values())


def test_prefetch_stream_records_its_span(lake):
    from hyperspace_tpu_torch.parallel import io as pio
    session = lake["torch"]
    with ttrace.maintenance_trace(session, "t") as tr:
        with pio.use_session(session):
            assert list(pio.prefetch_iter(iter(range(5)), label="unit")) == list(range(5))
    spans = tr.find(SN.IO_PREFETCH)
    assert len(spans) == 1 and spans[0].attrs["items"] == 5
    assert spans[0].attrs["label"] == "unit"


def test_a_read_over_the_pool_budget_still_records_io_read(lake):
    """A multi-file read too large for the reader pool's in-flight budget
    goes to pyarrow's threads and records the io.read span the pooled
    fan-out would (the JAX package, which has no budget, fans out)."""
    session = lake["torch"]
    session.conf.set(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES, "1")
    try:
        table, rows = traced_cold_run(lake, "torch", filter_query, indexed=False)
        reads = last_trace(lake, "torch").find(SN.IO_READ)
    finally:
        session.conf.set(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES, str(256 << 20))
    want, jrows = traced_cold_run(lake, "jax", filter_query, indexed=False)
    assert table.equals(want) and rows == jrows
    assert [r.attrs["route"] for r in reads] == ["pyarrow"]


def test_frontend_queries_keep_their_own_traces(lake, monkeypatch):
    """Queries on concurrent frontend workers each record into their own
    trace (the submission's copied context carries nothing of another
    query's): every trace holds one query root, with its own query id,
    and its stages."""
    monkeypatch.setattr(tfrontend, "_DEFAULT", None)
    session = make_session("torch", str(lake["root"] / "frontend_ix"),
                           dict(CONF, **{"hyperspace.tpu.serving.maxConcurrency": "4",
                                         "hyperspace.tpu.serving.batching.enabled": "false"}))
    front = tfrontend.ServingFrontend(session)
    pending = [front.submit(q6_variant({"torch": session, "dirs": lake["dirs"]}, "torch", i))
               for i in range(12)]
    for p in pending:
        assert p.result(timeout=120).num_rows == 1
    front.drain()
    for p in pending:
        tr = p.context.trace
        roots = [s for s in tr.spans if s.parent_id is None]
        assert [s.name for s in roots] == [SN.QUERY]
        assert roots[0].attrs["query_id"] == p.query_id
        assert len(tr.find(SN.QUERY)) == 1 and tr.find(SN.EXEC_STAGE)
    assert len({id(p.context.trace) for p in pending}) == len(pending)
