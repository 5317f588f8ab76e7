"""Whole-plan fusion (``hyperspace_tpu_torch/execution/fusion.py`` and
``fusion_boundaries.py``) against the JAX package's, the counterpart of
``tests/test_fusion.py``.

Both packages run their default (fused) route and their staged route
(``hyperspace.tpu.execution.fusion.enabled=false``) on the same
numpy-seeded files, and the port's answers must equal the JAX package's
route for route: keys, counts and strings exactly, float64 values bit for
bit. Regions fuse where the JAX package's do (dispatch counts, the
``exec.fused`` spans' attributes and the boundary counters move alike),
every boundary kind is driven, and a failed region runs staged while
degradation is on and raises while it is off.

Left out, with no counterpart in the port: the ProgramBank tests
(cross-session program sharing, the bank's per-kind breakdown), the
compile-count tests (a warm rerun and a literal sweep compiling nothing)
and the distributed tier's fused MeshProgram. Eager torch compiles no
programs.

The JAX side runs on the CPU at ``test_fusion.py``'s sizes, below
``distributed.minStreamRows``, so its single-device fusion tier (not its
mesh) runs; the port on CPU tensors, where ``singleDevice=auto`` does not
dispatch.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
import test_tpch_sql as tpch_mod
from goldstandard import tpcds_real
from hyperspace_tpu.execution import fusion as jfusion
from hyperspace_tpu.execution import fusion_boundaries as JFB
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu_torch.execution import fusion as tfusion
from hyperspace_tpu_torch.execution import fusion_boundaries as FB
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.serving.constants import ServingConstants
from hyperspace_tpu_torch.telemetry import span_names as SN
from hyperspace_tpu_torch.telemetry.constants import TelemetryConstants as TC
from test_torch_sql import assert_same

FUSION = IndexConstants.TPU_FUSION_ENABLED
DEGRADE = "hyperspace.tpu.robustness.degrade.enabled"
PKGS = {"jax": (hst, JE, jfusion), "torch": (ht, TE, tfusion)}


def _session(pkg: str, path: str, **conf):
    mod = PKGS[pkg][0]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return mod.Session(conf=dict(conf), system_path=path, **kw)


def _fusion(session, on: bool) -> None:
    session.conf.set(FUSION, "true" if on else "false")


def _fallbacks(pkg: str) -> dict:
    return dict(PKGS[pkg][2].stats()["fallbacks"])


def _delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def routes(sessions: dict, build) -> dict:
    """{(pkg, on): (table, fused dispatches, boundary deltas)}: each
    package's session run fused (its default) and staged."""
    out = {}
    for pkg, session in sessions.items():
        for on in (True, False):
            _fusion(session, on)
            before, d0 = _fallbacks(pkg), PKGS[pkg][2].DISPATCH_COUNT
            try:
                table = build(session, PKGS[pkg][1]).to_arrow()
            finally:
                _fusion(session, True)
            out[(pkg, on)] = (table, PKGS[pkg][2].DISPATCH_COUNT - d0,
                              _delta(before, _fallbacks(pkg)))
    return out


def assert_routes_equal(out: dict, fused: Optional[bool] = True) -> None:
    """The port equals the JAX package route for route, runs as many fused
    regions and notes the same boundaries; its staged route fuses nothing.
    ``fused``: whether any region fuses (None: either)."""
    for on in (True, False):
        assert_same(out[("torch", on)][0], out[("jax", on)][0])
        assert out[("torch", on)][2] == out[("jax", on)][2], on
    assert out[("torch", True)][1] == out[("jax", True)][1]
    if fused is not None:
        assert (out[("torch", True)][1] > 0) == fused
    assert out[("torch", False)][1] == 0


# ---------------------------------------------------------------------------
# Fixtures (test_fusion.py's).
# ---------------------------------------------------------------------------

@pytest.fixture()
def mini(tmp_path):
    """A q3-shaped miniature: lineitem (nullable discount) x orders, and a
    session of each package over it."""
    rng = np.random.default_rng(11)
    n, n_od = 2400, 300
    li_dir, od_dir = str(tmp_path / "li"), str(tmp_path / "od")
    os.makedirs(li_dir)
    os.makedirs(od_dir)
    disc = rng.uniform(0, 0.1, n).round(3)
    disc_mask = rng.random(n) < 0.1
    pq.write_table(pa.table({
        "l_orderkey": rng.integers(0, n_od, n).astype(np.int64),
        "l_shipdate": rng.integers(0, 1000, n).astype(np.int64),
        "l_extendedprice": rng.uniform(1, 1000, n).round(2),
        "l_discount": pa.array([None if m else float(v) for m, v in zip(disc_mask, disc)],
                               type=pa.float64()),
        "l_tag": rng.choice(["ab", "cd", "ef", "gh"], n),
    }), os.path.join(li_dir, "part0.parquet"))
    pq.write_table(pa.table({
        "o_orderkey": np.arange(n_od, dtype=np.int64),
        "o_orderdate": rng.integers(0, 1000, n_od).astype(np.int64),
        "o_shippriority": rng.integers(0, 3, n_od).astype(np.int64),
        "o_tag": rng.choice(["ab", "cd", "xy"], n_od),
    }), os.path.join(od_dir, "part0.parquet"))
    sessions = {pkg: _session(pkg, str(tmp_path / f"ix_{pkg}")) for pkg in PKGS}
    return sessions, li_dir, od_dir


def q3ish(session, E, li_dir, od_dir, cut=500):
    li = session.read.parquet(li_dir).filter(E.col("l_shipdate") > int(cut))
    od = session.read.parquet(od_dir).filter(E.col("o_orderdate") < 700)
    return (li.join(od, on=E.col("l_orderkey") == E.col("o_orderkey"))
            .group_by("o_shippriority")
            .agg(E.sum_(E.col("l_extendedprice") * (1 - E.col("l_discount"))).alias("revenue"))
            .sort("o_shippriority"))


# ---------------------------------------------------------------------------
# The fused path is taken, and equals the JAX package's.
# ---------------------------------------------------------------------------

class TestFusedExecution:
    def test_q3ish_fuses_and_matches_jax(self, mini):
        sessions, li_dir, od_dir = mini
        out = routes(sessions, lambda s, E: q3ish(s, E, li_dir, od_dir))
        assert_routes_equal(out)
        assert out[("torch", True)][1] == out[("jax", True)][1]
        assert_same(out[("torch", True)][0], out[("torch", False)][0])

    def test_fused_region_spans_and_dispatch_counts(self, mini):
        """One exec.fused span per region with the JAX package's attributes,
        no exec.stage span inside one (only the region's program-bank
        lookup, as in the JAX package), and fewer execution spans than the
        staged run of the same query."""
        sessions, li_dir, od_dir = mini
        fused_spans, traces = {}, {}
        for pkg, session in sessions.items():
            session.conf.set(TC.TRACE_ENABLED, "true")
            hs = PKGS[pkg][0].Hyperspace(session)
            q = q3ish(session, PKGS[pkg][1], li_dir, od_dir)
            q.to_arrow()
            traces[(pkg, True)] = hs.last_trace()
            _fusion(session, False)
            q.to_arrow()
            traces[(pkg, False)] = hs.last_trace()
            _fusion(session, True)
            fused_spans[pkg] = sorted((s.attrs["fused_nodes"], s.attrs["root"], s.attrs["rows"])
                                      for s in traces[(pkg, True)].find(SN.EXEC_FUSED))
        assert fused_spans["torch"] == fused_spans["jax"]
        fused_tr, staged_tr = traces[("torch", True)], traces[("torch", False)]
        spans = fused_tr.find(SN.EXEC_FUSED)
        # The agg + project + join + filter region, and the join side's own
        # project + filter region.
        assert len(spans) >= 1 and max(s.attrs["fused_nodes"] for s in spans) >= 3
        assert staged_tr.find(SN.EXEC_FUSED) == []
        fused_ids = {s.span_id for s in spans}
        inside = [s.name for s in fused_tr.spans if s.parent_id in fused_ids]
        assert inside == [SN.BANK_LOOKUP] * len(spans)
        assert [s.name for s in traces[("jax", True)].spans
                if s.parent_id in {j.span_id for j in traces[("jax", True)].find(
                    SN.EXEC_FUSED)}] == inside
        n_fused = len(fused_tr.find(SN.EXEC_STAGE)) + len(spans)
        assert n_fused < len(staged_tr.find(SN.EXEC_STAGE))

    def test_fused_join_records_actuals(self, mini):
        """A fused region feeds the join-actuals store as the staged join
        does, and with the JAX package's values."""
        sessions, li_dir, od_dir = mini
        got = {}
        for pkg, session in sessions.items():
            for on in (True, False):
                session._join_actuals.clear()
                _fusion(session, on)
                q3ish(session, PKGS[pkg][1], li_dir, od_dir).to_arrow()
                got[(pkg, on)] = dict(session._join_actuals)
            _fusion(session, True)
        assert got[("torch", True)], "the fused region recorded no join actuals"
        assert got[("torch", True)] == got[("torch", False)]
        assert sorted(got[("torch", True)].values()) == sorted(got[("jax", True)].values())

    def test_literal_sweep_is_noted_as_sweep(self, mini):
        """Literal-sweep members run staged over one shared scan: each
        region attempt under the sweep is a ``sweep`` boundary."""
        from hyperspace_tpu_torch.serving import frontend as tfrontend
        sessions, li_dir, _ = mini
        s = sessions["torch"]
        qs = [s.read.parquet(li_dir).filter(TE.col("l_shipdate") > c)
              .filter(TE.col("l_extendedprice") > 10.0).select("l_orderkey")
              for c in (300, 400, 500)]
        serial = [q.to_arrow() for q in qs]
        before, d0 = _fallbacks("torch"), tfusion.DISPATCH_COUNT
        fe = tfrontend.ServingFrontend(s)
        out = fe.submit_wave([(q.plan, s, "", None) for q in qs])
        for ref, p in zip(serial, out):
            assert p.result(timeout=120).to_arrow().equals(ref)
        fe.drain()
        assert fe.stats()["batches"] == 1
        assert _delta(before, _fallbacks("torch")).get(FB.SWEEP, 0) >= 3
        assert tfusion.DISPATCH_COUNT == d0


# ---------------------------------------------------------------------------
# TPC-H and a TPC-DS sample, route for route.
# ---------------------------------------------------------------------------

def _sql_sessions(root: str, register) -> dict:
    out = {}
    for pkg in PKGS:
        s = _session(pkg, os.path.join(root, f"ix_{pkg}"))
        register(s)
        out[pkg] = s
    return out


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_tpch_fusion"))
    tables = tpch_mod._make_tables(np.random.default_rng(20260804))
    dirs = {}
    for name, t in tables.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        pq.write_table(t, os.path.join(d, "part0.parquet"))
        dirs[name] = d

    def register(s):
        for name, d in dirs.items():
            s.create_temp_view(name, s.read.parquet(d))
    return _sql_sessions(root, register)


TPCH_TEXTS = {c[0]: c[1] for c in tpch_mod._CASES}


class TestTpchParity:
    @pytest.mark.parametrize("name", ["q3", "q17"])
    def test_acceptance_queries_identical(self, tpch, name):
        out = routes(tpch, lambda s, E: s.sql(TPCH_TEXTS[name]))
        assert_routes_equal(out)
        assert_same(out[("torch", True)][0], out[("torch", False)][0])
        assert out[("torch", True)][0].num_rows > 0

    @pytest.mark.parametrize("name", [n for n in TPCH_TEXTS if n not in ("q3", "q17")])
    def test_full_suite_identical(self, tpch, name):
        out = routes(tpch, lambda s, E: s.sql(TPCH_TEXTS[name]))
        for on in (True, False):
            assert_same(out[("torch", on)][0], out[("jax", on)][0])
            assert out[("torch", on)][2] == out[("jax", on)][2], on
        assert (out[("torch", True)][1] > 0) == (out[("jax", True)][1] > 0)


TPCDS_EXEC_BUDGET = 6  # test_fusion.py's deterministic first six.


@pytest.fixture(scope="module")
def tpcds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_tpcds_fusion"))
    data = os.path.join(root, "data")
    jax_session = _session("jax", os.path.join(root, "ix_jax"))
    tpcds_real.register_tables(jax_session, data)
    torch_session = _session("torch", os.path.join(root, "ix_torch"))
    for name in sorted(os.listdir(data)):
        torch_session.create_temp_view(name, torch_session.read.parquet(os.path.join(data, name)))
    return {"jax": jax_session, "torch": torch_session}


class TestTpcdsParity:
    @pytest.mark.parametrize("name", tpcds_real.QUERY_NAMES[:TPCDS_EXEC_BUDGET])
    def test_sample_identical(self, tpcds, name):
        out = routes(tpcds, lambda s, E: s.sql(tpcds_real.QUERY_TEXTS[name]))
        for on in (True, False):
            assert_same(out[("torch", on)][0], out[("jax", on)][0])
            assert out[("torch", on)][2] == out[("jax", on)][2], on
        assert out[("torch", True)][1] == out[("jax", True)][1]


# ---------------------------------------------------------------------------
# Every boundary kind, route for route.
# ---------------------------------------------------------------------------

def _li(s, li_dir):
    return s.read.parquet(li_dir)


def _od(s, od_dir):
    return s.read.parquet(od_dir)


# name -> (build(session, E, li_dir, od_dir), kinds the fused run notes,
#          whether a region still fuses)
BOUNDARY_QUERIES = {
    "leaf": (lambda s, E, li, od: _li(s, li).filter(E.col("l_shipdate") > 300)
             .filter(E.col("l_extendedprice") > 10.0).select("l_orderkey"),
             {FB.LEAF}, True),
    "sort": (lambda s, E, li, od: _li(s, li).sort("l_orderkey")
             .filter(E.col("l_shipdate") > 300).filter(E.col("l_extendedprice") > 10.0)
             .select("l_orderkey", "l_extendedprice"), {FB.SORT}, True),
    "limit": (lambda s, E, li, od: _li(s, li).limit(700)
              .filter(E.col("l_shipdate") > 300).filter(E.col("l_extendedprice") > 10.0)
              .select("l_orderkey"), {FB.LIMIT}, True),
    "union": (lambda s, E, li, od: _li(s, li).select("l_orderkey", "l_shipdate")
              .union(_li(s, li).select("l_orderkey", "l_shipdate"))
              .filter(E.col("l_shipdate") > 300).filter(E.col("l_orderkey") > 10)
              .select("l_orderkey"), {FB.UNION}, True),
    "aggregate": (lambda s, E, li, od: _li(s, li).group_by("l_orderkey")
                  .agg(E.sum_(E.col("l_extendedprice")).alias("s"))
                  .filter(E.col("s") > 100.0).filter(E.col("l_orderkey") > 10)
                  .select("l_orderkey", "s"), {FB.AGGREGATE}, True),
    "outer_join": (lambda s, E, li, od: _li(s, li).join(
        _od(s, od), on=E.col("l_orderkey") == E.col("o_orderkey"), how="left")
        .filter(E.col("l_shipdate") > 300).filter(E.col("l_extendedprice") > 10.0)
        .select("l_orderkey", "o_shippriority"), {FB.OUTER_JOIN, FB.UNSUPPORTED_EXPR}, True),
    "multi_key_join": (lambda s, E, li, od: _li(s, li).join(
        _od(s, od), on=(E.col("l_orderkey") == E.col("o_orderkey"))
        & (E.col("l_shipdate") == E.col("o_orderdate")))
        .group_by("o_shippriority").agg(E.count().alias("n")), {FB.MULTI_KEY_JOIN}, None),
    "count_distinct": (lambda s, E, li, od: _li(s, li).filter(E.col("l_shipdate") > 300)
                       .group_by("l_orderkey")
                       .agg(E.count_distinct(E.col("l_extendedprice")).alias("n")),
                       {FB.COUNT_DISTINCT}, None),
    "region_too_small": (lambda s, E, li, od: _li(s, li).filter(E.col("l_shipdate") > 300),
                         {FB.REGION_TOO_SMALL}, False),
    "duplicate_probe_keys": (lambda s, E, li, od: _li(s, li)
                             .filter(E.col("l_shipdate") > 800)
                             .join(_li(s, li).select(E.col("l_orderkey").alias("r_orderkey"),
                                                     E.col("l_extendedprice").alias("r_price")),
                                   on=E.col("l_orderkey") == E.col("r_orderkey"))
                             .group_by("l_orderkey").agg(E.sum_(E.col("r_price")).alias("s")),
                             {FB.DUPLICATE_PROBE_KEYS}, True),
    "empty_side": (lambda s, E, li, od: _li(s, li).join(
        _od(s, od).filter(E.col("o_orderdate") > 5000), on=E.col("l_orderkey")
        == E.col("o_orderkey")).group_by("o_shippriority").agg(E.count().alias("n")),
        {FB.EMPTY_INPUT}, None),
    "string_min_of_expression": (lambda s, E, li, od: _li(s, li)
                                 .filter(E.col("l_shipdate") > 300).group_by("l_orderkey")
                                 .agg(E.max_(E.upper(E.col("l_tag"))).alias("m")),
                                 {FB.UNSUPPORTED_AGG}, None),
    "semi_anti_string_keys": (lambda s, E, li, od: _li(s, li).join(
        _od(s, od), on=E.col("l_tag") == E.col("o_tag"), how="semi")
        .join(_od(s, od).filter(E.col("o_orderdate") > 500),
              on=E.col("l_tag") == E.col("o_tag"), how="anti")
        .group_by("l_tag").agg(E.count().alias("n")), {FB.LEAF}, True),
}


@pytest.mark.parametrize("name", sorted(BOUNDARY_QUERIES))
def test_boundary_equals_jax(mini, name):
    build, kinds, fused = BOUNDARY_QUERIES[name]
    sessions, li_dir, od_dir = mini
    out = routes(sessions, lambda s, E: build(s, E, li_dir, od_dir))
    assert_routes_equal(out, fused)
    assert kinds <= set(out[("torch", True)][2]), out[("torch", True)][2]
    assert out[("torch", False)][2].get(FB.DISABLED, 0) > 0


def test_window_barrier(tmp_path):
    """A window below a region is staged; the chain above it fuses."""
    rng = np.random.default_rng(5)
    d = str(tmp_path / "w")
    os.makedirs(d)
    pq.write_table(pa.table({"g": rng.integers(0, 9, 800).astype(np.int64),
                             "v": rng.uniform(0, 50, 800)}), os.path.join(d, "p.parquet"))
    sessions = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg}"))
        s.create_temp_view("w", s.read.parquet(d))
        sessions[pkg] = s
    text = ("select g, v, t from (select g, v, sum(v) over (partition by g) t from w) x "
            "where v > 10 and t > 100")
    out = routes(sessions, lambda s, E: s.sql(text))
    assert_routes_equal(out, fused=None)
    assert FB.WINDOW in out[("torch", True)][2]


def test_cross_join_barrier(mini):
    """The SQL front end's comma join of two global aggregates is a cross
    join: a barrier."""
    sessions, li_dir, od_dir = mini
    for pkg, s in sessions.items():
        s.create_temp_view("li", s.read.parquet(li_dir))
        s.create_temp_view("od", s.read.parquet(od_dir))
    text = ("select a.s, b.n from "
            "(select sum(l_extendedprice) s from li where l_shipdate > 100) a, "
            "(select count(*) n from od where o_orderdate > 100) b where a.s > b.n")
    out = routes(sessions, lambda s, E: s.sql(text))
    assert_routes_equal(out, fused=True)
    assert FB.CROSS_JOIN in out[("torch", True)][2]


@pytest.mark.parametrize("case", ["non_equi", "key_dtype"])
def test_join_shapes_the_staged_path_refuses(mini, case):
    """A join whose keys do not split across its sides, or a string key
    against an integer one: the region notes its boundary, and the staged
    path refuses the join in both packages."""
    sessions, li_dir, od_dir = mini
    noted = {}
    for pkg, s in sessions.items():
        E = PKGS[pkg][1]
        cond = (E.col("l_orderkey") == E.col("l_shipdate")) if case == "non_equi" \
            else (E.col("l_tag") == E.col("o_orderkey"))
        before = _fallbacks(pkg)
        with pytest.raises(Exception):
            (s.read.parquet(li_dir).filter(E.col("l_shipdate") > 3)
             .join(s.read.parquet(od_dir), on=cond).agg(E.count().alias("n")).to_arrow())
        noted[pkg] = _delta(before, _fallbacks(pkg))
    kind = FB.NON_EQUI_JOIN if case == "non_equi" else FB.KEY_DTYPE
    assert noted["torch"].get(kind, 0) > 0
    assert noted["torch"] == noted["jax"]


def test_min_stages_is_no_key_of_the_port(mini):
    """ROADMAP queue C 25, by design: the port fuses every region of at
    least two nodes (``fusion.MIN_STAGES``) and reads no
    ``fusion.minStages``; a JAX session that raises it to 3 runs a
    two-node region staged. The rows are equal."""
    sessions, li_dir, _ = mini
    for s in sessions.values():
        s.conf.set("hyperspace.tpu.execution.fusion.minStages", "3")
    out = routes(sessions, lambda s, E: _li(s, li_dir).filter(E.col("l_shipdate") > 300)
                 .select("l_orderkey", "l_extendedprice"))
    assert tfusion.MIN_STAGES == 2
    for on in (True, False):
        assert_same(out[("torch", on)][0], out[("jax", on)][0])
    assert out[("torch", True)][1] == 1 and out[("jax", True)][1] == 0
    assert FB.REGION_TOO_SMALL in out[("jax", True)][2]


def test_leaf_rows_and_budget(mini, tmp_path):
    """The stream leaf's rows come from parquet metadata (None for another
    format), and the chunk budget admits a leaf of exactly maxChunkRows."""
    from hyperspace_tpu_torch.execution import leaf
    sessions, li_dir, _ = mini
    s = sessions["torch"]
    scan = _li(s, li_dir).plan
    assert leaf.leaf_rows(scan) == 2400
    assert leaf.leaf_rows(_li(s, li_dir).filter(TE.col("l_shipdate") > 3).plan) is None
    s.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, "2400")
    assert leaf.within_budget(scan, s)
    s.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, "2399")
    assert not leaf.within_budget(scan, s)
    csv_dir = str(tmp_path / "csv")
    os.makedirs(csv_dir)
    with open(os.path.join(csv_dir, "a.csv"), "w") as f:
        f.write("k,v\n1,2.0\n")
    csv_scan = s.read.csv(csv_dir).plan
    assert leaf.leaf_rows(csv_scan) is None and leaf.within_budget(csv_scan, s)


def test_chunked_source_falls_back(mini):
    """A leaf past the chunk budget belongs to the staged chunked path; the
    region never holds it whole."""
    sessions, li_dir, od_dir = mini
    for s in sessions.values():
        s.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, "512")
    out = routes(sessions, lambda s, E: q3ish(s, E, li_dir, od_dir))
    assert_routes_equal(out)
    assert FB.CHUNKED_SOURCE in out[("torch", True)][2]


def test_empty_stream_falls_back(tmp_path):
    """A stream of no rows runs staged before any body runs."""
    d = str(tmp_path / "e")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array([], pa.int64()), "v": pa.array([], pa.float64())}),
                   os.path.join(d, "p.parquet"))
    sessions = {pkg: _session(pkg, str(tmp_path / f"ix_{pkg}")) for pkg in PKGS}
    out = routes(sessions, lambda s, E: s.read.parquet(d).filter(E.col("k") > 1)
                 .agg(E.sum_(E.col("v")).alias("s"), E.count().alias("n")))
    assert_routes_equal(out, fused=False)
    assert FB.EMPTY_INPUT in out[("torch", True)][2]


def test_bucket_ordered_stream_falls_back_to_staged(tmp_path):
    """A covering index's scan in bucket order keeps the staged
    sort-skipping group-by; the region steps aside at runtime."""
    rng = np.random.default_rng(2)
    d = str(tmp_path / "t")
    os.makedirs(d)
    pq.write_table(pa.table({
        "k": rng.integers(0, 40, 2000).astype(np.int64),
        "w": rng.integers(0, 900, 2000).astype(np.int64),
        "v": rng.uniform(0, 10, 2000),
    }), os.path.join(d, "p.parquet"))
    sessions = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg}"))
        PKGS[pkg][0].Hyperspace(s).create_index(s.read.parquet(d),
                                                PKGS[pkg][0].IndexConfig("kidx", ["k"], ["w", "v"]))
        s.enable_hyperspace()
        sessions[pkg] = s
    out = routes(sessions, lambda s, E: s.read.parquet(d).filter(E.col("k") > 5)
                 .filter(E.col("w") > 100).group_by("k").agg(E.sum_(E.col("v")).alias("sv")))
    assert_routes_equal(out, fused=False)
    assert FB.BUCKET_ORDER in out[("torch", True)][2]


def test_disabled_restores_staged(mini):
    sessions, li_dir, od_dir = mini
    s = sessions["torch"]
    _fusion(s, False)
    try:
        before, d0 = _fallbacks("torch"), tfusion.DISPATCH_COUNT
        q3ish(s, TE, li_dir, od_dir).to_arrow()
        assert tfusion.DISPATCH_COUNT == d0
        assert _delta(before, _fallbacks("torch")).get(FB.DISABLED, 0) > 0
    finally:
        _fusion(s, True)


# ---------------------------------------------------------------------------
# A failed region.
# ---------------------------------------------------------------------------

def test_failed_region_runs_staged_with_degrade_and_raises_without(mini, monkeypatch):
    """A region body that fails raises while degradation is off. While it
    is on, the query runs staged with the same answer, each failed region
    counts one ``fused-program-error`` and is poisoned: a rerun, and a
    literal variant of it, stay staged without running a body."""
    sessions, li_dir, od_dir = mini
    s = sessions["torch"]
    want = {cut: q3ish(s, TE, li_dir, od_dir, cut).to_arrow() for cut in (611, 612)}
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise RuntimeError("region body failed")

    # The memo is process-wide: this test's poisoned keys leave with it.
    monkeypatch.setattr(tfusion._STATE, "poisoned", set())
    monkeypatch.setattr(tfusion, "_run_body", broken)
    s.conf.set(DEGRADE, "false")
    try:
        with pytest.raises(RuntimeError, match="region body failed"):
            q3ish(s, TE, li_dir, od_dir, 611).to_arrow()
    finally:
        s.conf.set(DEGRADE, "true")
    assert tfusion.stats()["poisoned_regions"] >= 1
    before, p0 = _fallbacks("torch"), len(calls)
    assert q3ish(s, TE, li_dir, od_dir, 611).to_arrow().equals(want[611])
    failed = _delta(before, _fallbacks("torch")).get(FB.FUSED_PROGRAM_ERROR, 0)
    assert failed >= len(calls) - p0 >= 1
    n_calls = len(calls)
    before = _fallbacks("torch")
    assert q3ish(s, TE, li_dir, od_dir, 611).to_arrow().equals(want[611])
    assert q3ish(s, TE, li_dir, od_dir, 612).to_arrow().equals(want[612])
    assert len(calls) == n_calls
    assert _delta(before, _fallbacks("torch")).get(FB.FUSED_PROGRAM_ERROR, 0) >= 2


def test_transient_error_does_not_poison(mini, monkeypatch):
    """An injected fault (or an OSError) inside a region leaves the region
    fusible: the next run fuses again."""
    from hyperspace_tpu_torch.robustness.faults import InjectedFaultError
    sessions, li_dir, od_dir = mini
    s = sessions["torch"]
    real = tfusion._run_body
    fail = [True]

    def flaky(*args, **kw):
        if fail[0]:
            fail[0] = False
            raise InjectedFaultError("injected")
        return real(*args, **kw)

    monkeypatch.setattr(tfusion._STATE, "poisoned", set())
    monkeypatch.setattr(tfusion, "_run_body", flaky)
    want = q3ish(s, TE, li_dir, od_dir, 623)
    p0 = tfusion.stats()["poisoned_regions"]
    first = want.to_arrow()
    d0 = tfusion.DISPATCH_COUNT
    assert q3ish(s, TE, li_dir, od_dir, 623).to_arrow().equals(first)
    assert tfusion.DISPATCH_COUNT > d0
    assert tfusion.stats()["poisoned_regions"] == p0


# ---------------------------------------------------------------------------
# The registry, the result cache and the collector.
# ---------------------------------------------------------------------------

class TestBoundaryRegistry:
    def test_registry_is_the_expected_frozen_vocabulary(self):
        assert FB.BOUNDARY_KINDS == JFB.BOUNDARY_KINDS == frozenset({
            "leaf", "sort", "window", "limit", "union", "aggregate",
            "outer-join", "cross-join", "non-equi-join", "multi-key-join",
            "count-distinct", "unsupported-agg", "unsupported-expr",
            "disabled", "sweep", "region-too-small", "chunked-source",
            "bucket-order", "duplicate-probe-keys", "key-dtype",
            "empty-input", "fused-program-error",
        })


class TestResultCacheContracts:
    def _enable_cache(self, session):
        session.conf.set(ServingConstants.RESULT_CACHE_ENABLED, "true")
        session.conf.set(ServingConstants.RESULT_CACHE_MIN_COMPUTE_SECONDS, "0")

    def test_cache_hit_on_fused_query_is_two_span_trace(self, mini):
        sessions, li_dir, od_dir = mini
        s = sessions["torch"]
        self._enable_cache(s)
        hs = ht.Hyperspace(s)
        q = q3ish(s, TE, li_dir, od_dir)
        s.conf.set(TC.TRACE_ENABLED, "true")
        q.to_arrow()
        cold = hs.last_trace()
        q.to_arrow()
        hit = hs.last_trace()
        assert cold.find(SN.EXEC_FUSED) != []
        assert {sp.name for sp in hit.spans} == {SN.QUERY, SN.CACHE_LOOKUP}

    def test_fusion_toggle_keeps_warm_entries(self, mini):
        """fusion.* is left out of the result-cache conf hash."""
        sessions, li_dir, od_dir = mini
        s = sessions["torch"]
        self._enable_cache(s)
        q = q3ish(s, TE, li_dir, od_dir)
        q.to_arrow()
        hits0 = s.result_cache.stats()["hits"]
        _fusion(s, False)
        try:
            q.to_arrow()
        finally:
            _fusion(s, True)
        assert s.result_cache.stats()["hits"] == hits0 + 1

    @pytest.mark.parametrize("pkg", sorted(PKGS))
    def test_fusion_toggle_serves_the_fused_empty_aggregate(self, mini, pkg):
        """ROADMAP queue C 24, held for parity: the cache key leaves
        fusion.* out, so a global sum of a nullable column over no kept
        rows, cached as NULL on the fused route, is served after
        fusion.enabled=false, whose staged route answers 0.0. Both
        packages alike."""
        sessions, li_dir, _ = mini
        s, E = sessions[pkg], PKGS[pkg][1]

        def answer():
            return (s.read.parquet(li_dir).filter(E.col("l_shipdate") > 5000)
                    .agg(E.sum_(E.col("l_discount")).alias("sd")).to_arrow().to_pydict())

        _fusion(s, False)
        try:
            assert answer() == {"sd": [0.0]}  # staged, the cache still off
        finally:
            _fusion(s, True)
        self._enable_cache(s)
        assert answer() == {"sd": [None]}  # fused, admitted
        hits0 = s.result_cache.stats()["hits"]
        _fusion(s, False)
        try:
            assert answer() == {"sd": [None]}  # the fused answer, served
        finally:
            _fusion(s, True)
        assert s.result_cache.stats()["hits"] == hits0 + 1


class TestFusionStats:
    def test_metrics_collector_registered(self, mini):
        sessions, li_dir, od_dir = mini
        q3ish(sessions["torch"], TE, li_dir, od_dir).to_arrow()
        m = ht.Hyperspace(sessions["torch"]).metrics()
        assert "fusion" in m["collectors"]
        assert m["collectors"]["fusion"]["fused_executions"] >= 1
        assert isinstance(m["collectors"]["fusion"]["fallbacks"], dict)
        assert set(m["collectors"]["fusion"]) == set(jfusion.stats())

    def test_datetime_literals_fuse(self, tmp_path):
        rng = np.random.default_rng(4)
        d = str(tmp_path / "t")
        os.makedirs(d)
        base = datetime.date(1995, 1, 1)
        pq.write_table(pa.table({
            "ship": pa.array([base + datetime.timedelta(days=int(x))
                              for x in rng.integers(0, 400, 1200)]),
            "price": rng.uniform(1, 100, 1200),
        }), os.path.join(d, "part0.parquet"))
        sessions = {pkg: _session(pkg, str(tmp_path / f"ix_{pkg}")) for pkg in PKGS}
        out = routes(sessions, lambda s, E: s.read.parquet(d)
                     .filter(E.col("ship") > datetime.date(1995, 6, 1))
                     .filter(E.col("price") > 5.0).agg(E.sum_(E.col("price")).alias("s")))
        assert_routes_equal(out)
