"""The literal sweep and the concurrent frontend
(``hyperspace_tpu_torch/serving/{batcher,frontend}.py`` and the "Serving:"
section of explain) against the JAX package's, on the same numpy-seeded
files. The oracle is the JAX package's ``tests/test_serving_frontend.py``.

Batches collapse deterministically with ``maxConcurrency=1`` and
``batching.window=0.3``: one worker waits out the window for the burst.
A batch shares its scan; each member evaluates its own mask over the
shared table, which is held bit for bit to the mask of its run alone and
to the JAX package's, float32 columns and the range kernel's shape
included; every answer is held to serial execution and to the JAX
frontend's. The JAX package's stacked mask pass (its ``sweep_invocations``
counter), which it runs only off the TPU, has no counterpart in the port;
the port counts a member's rerun after a failure inside its batch
(``member_fallbacks``).
"""

import datetime
import os
import re
import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import evaluator as jevaluator
from hyperspace_tpu.execution.columnar import Table as JTable
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.serving import batcher as jbatcher
from hyperspace_tpu.serving import frontend as jfrontend
from hyperspace_tpu.serving import fingerprint as jfp
from hyperspace_tpu_torch.exceptions import (HyperspaceException, QueryDeadlineError,
                                             ServingRejectedError)
from hyperspace_tpu_torch.execution import evaluator as tevaluator
from hyperspace_tpu_torch.execution.columnar import Table as TTable
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.serving import batcher as tbatcher
from hyperspace_tpu_torch.serving import fingerprint as tfp
from hyperspace_tpu_torch.serving import frontend as tfrontend
from hyperspace_tpu_torch.serving.constants import ServingConstants as SC

BASE_CONF = {"hyperspace.tpu.distributed.enabled": "false",
             "hyperspace.tpu.execution.fusion.enabled": "false",
             IndexConstants.INDEX_NUM_BUCKETS: "4"}
COLLAPSE = {SC.SERVING_MAX_CONCURRENCY: "1", SC.SERVING_BATCHING_WINDOW: "0.3"}
PKGS = {"jax": (hst, JE, jfrontend), "torch": (ht, TE, tfrontend)}
FRONTEND_STATS = ("submitted", "admitted", "rejected", "completed", "failed", "batches",
                  "batched_queries", "shared_scans", "shared_scan_hits")


def _write(d, n=4000, seed=7, files=1):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"k": rng.integers(0, 50, n).astype(np.int64),
                       "v": rng.integers(0, 9, n).astype(np.int64)})
    os.makedirs(str(d), exist_ok=True)
    step = max(n // files, 1)
    for i in range(files):
        hi = (i + 1) * step if i < files - 1 else n
        pq.write_table(pa.Table.from_pandas(df.iloc[i * step:hi]),
                       os.path.join(str(d), f"p{i}.parquet"))
    return df


def _session(pkg, tmp_path, cls=None, **conf):
    mod = PKGS[pkg][0]
    cls = cls or mod.Session
    full = dict(BASE_CONF, **conf)
    path = str(tmp_path / f"ix_{pkg}")
    if pkg == "torch":
        return cls(conf=full, system_path=path, device="cpu")
    return cls(conf=full, system_path=path)


def _variants(pkg, session, path, n=8):
    """n literal variants of one aggregation (one template)."""
    E = PKGS[pkg][1]
    r = session.read.parquet(str(path))
    return [r.filter(E.col("k") < i + 3).group_by("k").agg(E.sum_(E.col("v")).alias("sv"))
            .sort("k") for i in range(n)]


def _stats(fe) -> dict:
    s = fe.stats()
    return {k: s[k] for k in FRONTEND_STATS}


def _through_frontend(pkg, session, queries, **kw):
    fe = PKGS[pkg][2].ServingFrontend(session)
    pend = [fe.submit(q, **kw) for q in queries]
    tables = [p.result(timeout=120).to_arrow() for p in pend]
    fe.drain()
    return fe, pend, tables


@pytest.fixture(autouse=True)
def no_default_frontend(monkeypatch):
    """Each test starts without a process-default frontend in either
    package."""
    monkeypatch.setattr(tfrontend, "_DEFAULT", None)
    monkeypatch.setattr(jfrontend, "_DEFAULT", None)


# ---------------------------------------------------------------------------
# Templates.
# ---------------------------------------------------------------------------

def test_template_key_matches_literal_variants_only(tmp_path):
    """Variants share a key; another column, another shape or a plan with no
    filter literal do not. The keys (template digest and conf hash) are the
    JAX package's."""
    _write(tmp_path / "d")
    keys = {}
    for pkg in PKGS:
        s = _session(pkg, tmp_path)
        E = PKGS[pkg][1]
        fp = tfp if pkg == "torch" else jfp
        bt = tbatcher if pkg == "torch" else jbatcher
        r = s.read.parquet(str(tmp_path / "d"))
        plans = [q.plan for q in _variants(pkg, s, tmp_path / "d", 2)]
        plans.append(r.filter(E.col("v") < 3).group_by("k").agg(
            E.sum_(E.col("v")).alias("sv")).sort("k").plan)
        plans.append(r.filter((E.col("k") >= 4) & ((E.col("v") == 2) | ~(E.col("v") < 7)))
                     .select("k").plan)
        plans.append(r.filter(E.col("k").isin([1, 2, 3])).select("v").plan)
        plans.append(r.select("k").plan)
        keys[pkg] = [bt.template_key(s, fp.normalize(p)) for p in plans]
    k = keys["torch"]
    assert k[0] is not None and k[0] == k[1] and k[2] not in (None, k[0])
    assert k[3] is not None and k[4] is not None and k[5] is None
    # The port's session stores system_path in its conf like the JAX one's,
    # but under another directory here: compare the template digests.
    assert [None if x is None else x[0] for x in k] == \
        [None if x is None else x[0] for x in keys["jax"]]


def test_condition_template_equals_jax():
    conds = [(TE.col("a") < 3, JE.col("a") < 3),
             (TE.lit(5) > TE.col("a"), JE.lit(5) > JE.col("a")),
             ((TE.col("a") >= 1.5) & ~(TE.col("b") == "x"),
              (JE.col("a") >= 1.5) & ~(JE.col("b") == "x")),
             (TE.col("a").isin([1, 2]) | (TE.col("c") <= datetime.date(1995, 1, 1)),
              JE.col("a").isin([1, 2]) | (JE.col("c") <= datetime.date(1995, 1, 1)))]
    for t, j in conds:
        assert tbatcher.condition_template(t) == jbatcher.condition_template(j)


@pytest.mark.parametrize("n", [2, 3, 5, 8, 9, 16])
def test_wave_shares_one_scan(tmp_path, monkeypatch, n):
    """A wave of n literal variants reads its source once (one shared scan,
    n - 1 hits) and evaluates n masks, one per member over the shared
    table; each answer equals its run alone."""
    from hyperspace_tpu_torch.execution import executor as texecutor
    _write(tmp_path / "d", n=2000, files=2, seed=35)
    s = _session("torch", tmp_path)
    qs = _variants("torch", s, tmp_path / "d", n)
    serial = [q.to_arrow() for q in qs]
    masks = []
    single = texecutor.eval_predicate_mask
    monkeypatch.setattr(texecutor, "eval_predicate_mask",
                        lambda table, cond: masks.append(table.num_rows) or single(table, cond))
    fe = tfrontend.ServingFrontend(s)
    out = fe.submit_wave([(q.plan, s, "", None) for q in qs])
    for ref, p in zip(serial, out):
        assert p.result(timeout=120).to_arrow().equals(ref)
    fe.drain()
    st = fe.stats()
    assert (st["batches"], st["batched_queries"], st["shared_scans"], st["shared_scan_hits"],
            st["member_fallbacks"]) == (1, n, 1, n - 1, 0), st
    assert masks == [2000] * n


def test_member_failing_in_the_batch_reruns_alone(tmp_path, monkeypatch):
    """A member whose execution fails inside the batch runs again alone, is
    counted in ``member_fallbacks`` and in explain, and answers as its
    serial run does; its siblings are untouched."""
    _write(tmp_path / "d", seed=37)
    s = _session("torch", tmp_path, **{SC.SERVING_ENABLED: "true"})
    qs = _variants("torch", s, tmp_path / "d", 3)
    serial = [q.to_arrow() for q in qs]
    calls = []
    shared = tbatcher.SweepContext.shared_scan

    def flaky(self, key, compute):
        calls.append(key)
        if len(calls) == 2:
            raise RuntimeError("injected inside the batch")
        return shared(self, key, compute)

    monkeypatch.setattr(tbatcher.SweepContext, "shared_scan", flaky)
    fe = tfrontend.ServingFrontend(s)
    out = fe.submit_wave([(q.plan, s, "", None) for q in qs])
    for ref, p in zip(serial, out):
        assert p.result(timeout=120).to_arrow().equals(ref)
    fe.drain()
    st = fe.stats()
    assert (st["completed"], st["failed"], st["member_fallbacks"]) == (3, 0, 1), st
    assert (st["shared_scans"], st["shared_scan_hits"]) == (1, 1), st
    assert "member_fallbacks=1" in ht.Hyperspace(s).explain(qs[0])


def test_sweep_is_scoped_to_its_member():
    """The active sweep is visible inside use_sweep only, and never in
    another thread's context."""
    sweep = tbatcher.SweepContext(2)
    seen = []
    assert tbatcher.active_sweep() is None
    with tbatcher.use_sweep(sweep):
        assert tbatcher.active_sweep() is sweep
        t = threading.Thread(target=lambda: seen.append(tbatcher.active_sweep()))
        t.start()
        t.join()
        with tbatcher.use_sweep(None):
            assert tbatcher.active_sweep() is sweep
    assert tbatcher.active_sweep() is None and seen == [None]
    assert sweep.shared_scan("k", lambda: 1) == sweep.shared_scan("k", lambda: 2) == 1
    assert sweep.stats() == {"members": 2, "shared_scans": 1, "shared_scan_hits": 1}


# ---------------------------------------------------------------------------
# Each member's own mask over the shared scan, bit for bit.
# ---------------------------------------------------------------------------

def _mask_table():
    rng = np.random.default_rng(11)
    n = 3000
    f32 = np.asarray([1.1, 1.0999999, 1.1000001, 0.5, 2.0, -0.0, 0.0] * (n // 7 + 1),
                     dtype=np.float32)[:n]
    s = np.array(["apple", "banana", "cherry", "date"], dtype=object)[rng.integers(0, 4, n)]
    nulls = rng.random(n) < 0.1
    return pa.table({
        "i64": pa.array(rng.integers(-50, 50, n).astype(np.int64)),
        "i32": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
        "f32": pa.array(f32, type=pa.float32()),
        "f64": pa.array(np.round(rng.uniform(0, 0.1, n), 2)),
        "d": pa.array(rng.integers(8000, 10000, n).astype(np.int32)).cast(pa.date32()),
        "s": pa.array(s),
        "nv": pa.array(rng.integers(0, 9, n).astype(np.int64), mask=nulls),
        "rid": pa.array(np.arange(n, dtype=np.int64)),
    })


def _mask_wave(tmp_path, conds):
    """The mask table written as parquet, then one filter query per
    condition submitted as one wave: (the members' row ids, their runs
    alone, the frontend's stats, the shared table)."""
    d = tmp_path / "m"
    os.makedirs(str(d), exist_ok=True)
    pq.write_table(_mask_table(), os.path.join(str(d), "p.parquet"))
    s = _session("torch", tmp_path)
    qs = [s.read.parquet(str(d)).filter(c).select("rid") for c in conds]
    alone = [q.to_arrow() for q in qs]
    fe = tfrontend.ServingFrontend(s)
    out = fe.submit_wave([(q.plan, s, "", None) for q in qs])
    got = [p.result(timeout=120).to_arrow() for p in out]
    fe.drain()
    return got, alone, fe.stats()


def _d(days):
    return datetime.date(1970, 1, 1) + datetime.timedelta(days=days)


# (label, condition builder over an expr module, literal sets for 5 members).
MASK_CASES = [
    ("int64 <", lambda E, v: E.col("i64") < v[0], [(-3,), (0,), (7,), (50,), (-51,)]),
    ("int32 ==", lambda E, v: E.col("i32") == v[0], [(1,), (2,), (-7,), (49,), (0,)]),
    ("int32 fractional", lambda E, v: E.col("i32") > v[0], [(1.5,), (-2.5,), (0.25,), (3.5,),
                                                           (9.75,)]),
    ("float32 >", lambda E, v: E.col("f32") > v[0], [(1.1,), (1.1000001,), (1.0999999,),
                                                     (0.5,), (2.0,)]),
    ("float32 <=", lambda E, v: E.col("f32") <= v[0], [(1.1,), (0.0,), (-0.0,), (1e40,),
                                                       (2.0,)]),
    ("float64 between", lambda E, v: (E.col("f64") >= v[0]) & (E.col("f64") <= v[1]),
     [(0.01, 0.03), (0.02, 0.04), (0.05, 0.07), (0.08, 0.1), (0.0, 0.0)]),
    ("date range", lambda E, v: (E.col("d") >= v[0]) & (E.col("d") < v[1]),
     [(_d(8000), _d(8365)), (_d(8365), _d(8730)), (_d(9000), _d(9200)),
      (_d(9500), _d(9999)), (_d(8500), _d(8500))]),
    ("reversed range", lambda E, v: (E.col("i32") <= v[1]) & (E.col("i32") > v[0]),
     [(-5, 5), (0, 10), (-50, 49), (3, 3), (10, -10)]),
    ("string ops", lambda E, v: (E.col("s") >= v[0]) & ~(E.col("s") == v[1]),
     [("banana", "cherry"), ("a", "date"), ("cherry", "zzz"), ("apple", "apple"),
      ("b", "banana")]),
    ("in and or", lambda E, v: E.col("i64").isin([v[0], v[1]]) | (E.col("s") < v[2]),
     [(1, 2, "b"), (3, 4, "c"), (-1, 0, "a"), (5, 5, "zz"), (7, 8, "banana")]),
    ("nulls and is null", lambda E, v: ((E.col("nv") > v[0]) & E.col("i64").is_not_null())
     | E.col("nv").is_null(), [(2,), (5,), (0,), (8,), (-1,)]),
    ("nullable range", lambda E, v: (E.col("nv") >= v[0]) & (E.col("nv") <= v[1]),
     [(1, 3), (2, 8), (0, 0), (5, 4), (-10, 100)]),
    ("column vs column", lambda E, v: (E.col("i64") > E.col("nv")) & (E.col("f64") < v[0]),
     [(0.05,), (0.01,), (0.1,), (0.0,), (0.07,)]),
]


@pytest.mark.parametrize("label,build,lit_sets", MASK_CASES, ids=[c[0] for c in MASK_CASES])
def test_stacked_masks_equal_single_masks(tmp_path, label, build, lit_sets):
    """Five members of one wave over one shared scan: each member's kept
    rows are those of its run alone and of the JAX package's mask, bit for
    bit."""
    arrow = _mask_table()
    jtable = JTable.from_arrow(arrow)
    got, alone, st = _mask_wave(tmp_path, [build(TE, v) for v in lit_sets])
    assert (st["batches"], st["shared_scans"], st["shared_scan_hits"]) == (1, 1, 4), st
    for g, a, v in zip(got, alone, lit_sets):
        assert g.equals(a), (label, v)
        jmask = np.asarray(jevaluator.eval_predicate_mask(jtable, build(JE, v)))
        assert g.column("rid").to_pylist() == np.flatnonzero(jmask[:arrow.num_rows]).tolist(), \
            (label, v)


def test_slots_decline_what_the_single_path_compares_otherwise(tmp_path):
    """Members whose literals the single-query path compares differently
    (integral, fractional and out-of-range literals on an int32 column,
    arithmetic on the column) share the scan and each keeps its own mask."""
    conds = [TE.col("i32") > 2, TE.col("i32") > 1.5, TE.col("i32") > 2 ** 40,
             (TE.col("i32") + 1) > 2]
    got, alone, st = _mask_wave(tmp_path, conds)
    assert (st["shared_scans"], st["shared_scan_hits"], st["member_fallbacks"]) == (1, 3, 0), st
    for g, a in zip(got, alone):
        assert g.equals(a)
    assert got[1].num_rows > got[0].num_rows > got[2].num_rows == 0


@pytest.mark.parametrize("op", ["<", "<=", "==", ">=", ">"])
def test_out_of_range_int_literal_compares_exactly(op):
    """An int literal past an int32 column's range compares exactly, as the
    pushed parquet read does, so a swept member (no pushdown) and its run
    alone agree. The JAX package's mask wraps the literal to 32 bits
    (2**40 to 0): that fault of the reference is pinned here."""
    arrow = _mask_table()
    table = TTable.from_arrow(arrow, "cpu")
    jtable = JTable.from_arrow(arrow)
    x = np.asarray(arrow["i32"])
    ops = {"<": np.less, "<=": np.less_equal, "==": np.equal, ">=": np.greater_equal,
           ">": np.greater}
    build = {"<": lambda c, v: c < v, "<=": lambda c, v: c <= v, "==": lambda c, v: c == v,
             ">=": lambda c, v: c >= v, ">": lambda c, v: c > v}[op]
    for v in (2 ** 40, -2 ** 40, 2 ** 31, -2 ** 31 - 1):
        mask = tevaluator.eval_predicate_mask(table, build(TE.col("i32"), v)).numpy()
        assert np.array_equal(mask, ops[op](x, v)), v
    jmask = np.asarray(jevaluator.eval_predicate_mask(jtable, build(JE.col("i32"), 2 ** 40)))
    assert np.array_equal(jmask[:arrow.num_rows], ops[op](x, 0))


def test_float32_slots_are_float32():
    """The trap: a float literal against a float32 column compares as
    float32 (the kernel's cast), as the JAX package does; promoting the
    column to float64 would flip the rows at float32(1.1)."""
    arrow = _mask_table()
    table = TTable.from_arrow(arrow, "cpu")
    cond = TE.col("f32") > 1.1
    mask = tevaluator.eval_predicate_mask(table, cond)
    jmask = np.asarray(jevaluator.eval_predicate_mask(JTable.from_arrow(arrow),
                                                      JE.col("f32") > 1.1))
    assert np.array_equal(mask.numpy(), jmask[:arrow.num_rows])
    promoted = table.column("f32").data.to(torch.float64) > 1.1
    assert not torch.equal(mask, promoted)


# ---------------------------------------------------------------------------
# Batches through the frontend.
# ---------------------------------------------------------------------------

def test_eight_variants_one_invocation_byte_identical(tmp_path):
    """Eight literal variants run as one batch over one shared scan, each
    answer equal to serial execution and to the JAX frontend's, with the
    JAX frontend's counters."""
    _write(tmp_path / "d", n=5000, files=2, seed=31)
    got = {}
    for pkg in PKGS:
        s = _session(pkg, tmp_path, **COLLAPSE)
        qs = _variants(pkg, s, tmp_path / "d", 8)
        serial = [q.to_arrow() for q in qs]
        fe, pend, tables = _through_frontend(pkg, s, qs)
        for ref, t in zip(serial, tables):
            assert ref.equals(t)
        assert all(p.batched and p.batch_size == 8 for p in pend)
        got[pkg] = (tables, _stats(fe))
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert a.equals(b)
    assert got["torch"][1] == got["jax"][1]
    st = got["torch"][1]
    assert (st["batches"], st["batched_queries"], st["shared_scans"],
            st["shared_scan_hits"]) == (1, 8, 1, 7)


def test_submit_wave_is_one_sweep(tmp_path):
    """A caller-formed wave of literal variants is one batch whatever
    ``maxBatch`` says; a member that admission refuses comes back in its
    place."""
    _write(tmp_path / "d", n=3000, files=2, seed=33)
    got = {}
    for pkg in PKGS:
        s = _session(pkg, tmp_path, **{SC.SERVING_BATCHING_MAX_BATCH: "2"})
        qs = _variants(pkg, s, tmp_path / "d", 6)
        serial = [q.to_arrow() for q in qs]
        fe = PKGS[pkg][2].ServingFrontend(s)
        out = fe.submit_wave([(q.plan, s, f"c{i}", None) for i, q in enumerate(qs)])
        tables = [p.result(timeout=120).to_arrow() for p in out]
        fe.drain()
        for ref, t in zip(serial, tables):
            assert ref.equals(t)
        got[pkg] = (tables, _stats(fe))
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][1]["batches"] == 1 and got["torch"][1]["shared_scans"] == 1
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert a.equals(b)
    s = _session("torch", tmp_path, **{SC.SERVING_ADMISSION_MAX_BYTES: "1"})
    qs = _variants("torch", s, tmp_path / "d", 2)
    out = tfrontend.ServingFrontend(s).submit_wave([(q.plan, s, "", None) for q in qs])
    assert isinstance(out[1], ServingRejectedError)
    assert out[0].result(timeout=60).to_arrow().equals(qs[0].to_arrow())


def test_batching_disabled_still_identical(tmp_path):
    _write(tmp_path / "d", seed=41)
    got = {}
    for pkg in PKGS:
        s = _session(pkg, tmp_path, **{SC.SERVING_BATCHING_ENABLED: "false"})
        qs = _variants(pkg, s, tmp_path / "d", 4)
        serial = [q.to_arrow() for q in qs]
        fe, _, tables = _through_frontend(pkg, s, qs)
        for ref, t in zip(serial, tables):
            assert ref.equals(t)
        got[pkg] = (tables, _stats(fe))
    assert got["torch"][1]["batches"] == 0 and got["torch"][1] == got["jax"][1]
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert a.equals(b)


def test_mixed_batchable_and_not(tmp_path):
    """Batchable members around a query of another shape: every answer is
    right, and the other one runs alone."""
    _write(tmp_path / "d", seed=43)
    got = {}
    for pkg in PKGS:
        E = PKGS[pkg][1]
        s = _session(pkg, tmp_path, **COLLAPSE)
        r = s.read.parquet(str(tmp_path / "d"))
        qs = _variants(pkg, s, tmp_path / "d", 3)
        solo = r.filter(E.col("v") >= 4).select("v").sort("v").limit(5)
        batch = [qs[0], solo, qs[1], qs[2]]
        serial = [q.to_arrow() for q in batch]
        fe, pend, tables = _through_frontend(pkg, s, batch)
        for ref, t in zip(serial, tables):
            assert ref.equals(t)
        assert not pend[1].batched and pend[0].batched
        got[pkg] = (tables, _stats(fe))
    assert got["torch"][1] == got["jax"][1]
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert a.equals(b)


def test_float32_literals_byte_identical(tmp_path):
    """The JAX package's float32 case: eight literals around the float32
    rounding of 1.1, one sweep, each answer equal to its serial run and to
    the JAX frontend's."""
    d = tmp_path / "d"
    os.makedirs(str(d))
    vals = np.asarray([1.1, 1.0999999, 1.1000001, 0.5, 2.0] * 800, dtype=np.float32)
    pq.write_table(pa.table({"x": pa.array(vals, type=pa.float32()),
                             "k": pa.array(np.arange(vals.size) % 7, type=pa.int64())}),
                   os.path.join(str(d), "p.parquet"))
    lits = [1.1, 1.1000001, 1.0999999, 1.1, 0.5, 1.1, 2.0, 1.1]
    got = {}
    for pkg in PKGS:
        E = PKGS[pkg][1]
        s = _session(pkg, tmp_path, **COLLAPSE)
        qs = [s.read.parquet(str(d)).filter(E.col("x") > v).select("k") for v in lits]
        serial = [q.to_arrow() for q in qs]
        fe, _, tables = _through_frontend(pkg, s, qs)
        for ref, t in zip(serial, tables):
            assert ref.equals(t)
        st = _stats(fe)
        assert st["batches"] == 1 and st["shared_scans"] == 1, st
        got[pkg] = tables
    for a, b in zip(got["torch"], got["jax"]):
        assert a.equals(b)


def test_indexed_members_run_alone_inside_the_batch(tmp_path):
    """Members that plan an IndexScan share no scan: they run per member
    inside the batch, with the serial answers."""
    _write(tmp_path / "d", seed=45)
    got = {}
    for pkg in PKGS:
        mod, E, fe_mod = PKGS[pkg]
        s = _session(pkg, tmp_path, **COLLAPSE)
        r = s.read.parquet(str(tmp_path / "d"))
        mod.Hyperspace(s).create_index(r, mod.IndexConfig("kIdx", ["k"], ["v"]))
        s.enable_hyperspace()
        qs = [r.filter(E.col("k") == i).select("k", "v") for i in range(4)]
        assert "IndexScan" in qs[0].optimized_plan().tree_string()
        serial = [q.to_arrow() for q in qs]
        fe, _, tables = _through_frontend(pkg, s, qs)
        for ref, t in zip(serial, tables):
            assert ref.equals(t)
        got[pkg] = (tables, _stats(fe))
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][1]["batches"] == 1 and got["torch"][1]["shared_scans"] == 0
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert a.equals(b)


# ---------------------------------------------------------------------------
# Admission control.
# ---------------------------------------------------------------------------

class _GatedSession(ht.Session):
    """A session whose execute() waits for the gate: the tests then control
    what the queue holds."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gate = threading.Event()

    def execute(self, plan, context=None):
        assert self.gate.wait(timeout=60), "gate never released"
        return super().execute(plan, context)


def _wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_queue_depth_rejection(tmp_path):
    _write(tmp_path / "d")
    s = _session("torch", tmp_path, cls=_GatedSession,
                 **{SC.SERVING_QUEUE_DEPTH: "1", SC.SERVING_MAX_CONCURRENCY: "1",
                    SC.SERVING_BATCHING_ENABLED: "false"})
    fe = tfrontend.ServingFrontend(s)
    qs = _variants("torch", s, tmp_path / "d", 3)
    p1 = fe.submit(qs[0])
    assert _wait_until(lambda: fe.stats()["queued"] == 0 and fe.stats()["active_workers"] == 1)
    p2 = fe.submit(qs[1])  # fills the depth-1 queue
    with pytest.raises(ServingRejectedError, match="queue full"):
        fe.submit(qs[2])
    st = fe.stats()
    assert st["rejected"] == 1 and st["admitted"] == 2
    s.gate.set()
    assert p1.result(timeout=60).to_arrow().equals(qs[0].to_arrow())
    assert p2.result(timeout=60).to_arrow().equals(qs[1].to_arrow())
    fe.drain()
    assert fe.stats()["inflight_bytes"] == 0


def test_byte_budget_rejection_but_lone_query_always_runs(tmp_path):
    _write(tmp_path / "d")
    s = _session("torch", tmp_path, cls=_GatedSession,
                 **{SC.SERVING_MAX_CONCURRENCY: "1", SC.SERVING_BATCHING_ENABLED: "false",
                    SC.SERVING_ADMISSION_MAX_BYTES: "1"})
    fe = tfrontend.ServingFrontend(s)
    qs = _variants("torch", s, tmp_path / "d", 2)
    p1 = fe.submit(qs[0])  # over the budget alone, but nothing is in flight
    assert p1.estimated_bytes > 1
    with pytest.raises(ServingRejectedError, match="byte budget"):
        fe.submit(qs[1])
    s.gate.set()
    assert p1.result(timeout=60).num_rows > 0
    fe.drain()


def test_worker_survives_bad_conf(tmp_path):
    """A malformed batching window fails the worker outside any query: the
    unstarted member runs alone and answers, and nothing leaks."""
    _write(tmp_path / "d", seed=97)
    s = _session("torch", tmp_path, **{SC.SERVING_BATCHING_WINDOW: "0.3s"})
    fe = tfrontend.ServingFrontend(s)
    q = _variants("torch", s, tmp_path / "d", 1)[0]
    assert fe.submit(q).result(timeout=60).to_arrow().equals(q.to_arrow())
    fe.drain()
    st = fe.stats()
    assert st["active_workers"] == 0 and st["inflight_bytes"] == 0
    assert st["completed"] == 1 and st["failed"] == 0


def test_deadline_in_the_queue(tmp_path):
    _write(tmp_path / "d")
    s = _session("torch", tmp_path, cls=_GatedSession,
                 **{SC.SERVING_MAX_CONCURRENCY: "1", SC.SERVING_BATCHING_ENABLED: "false"})
    fe = tfrontend.ServingFrontend(s)
    qs = _variants("torch", s, tmp_path / "d", 2)
    p1 = fe.submit(qs[0])
    p2 = fe.submit(qs[1], deadline_ms=1)
    time.sleep(0.05)
    s.gate.set()
    p1.result(timeout=60)
    with pytest.raises(QueryDeadlineError):
        p2.result(timeout=60)
    fe.drain()
    assert fe.stats()["failed"] == 1


# ---------------------------------------------------------------------------
# The shared result cache and io attribution.
# ---------------------------------------------------------------------------

def test_tenant_b_hits_tenant_a_result(tmp_path):
    _write(tmp_path / "d", seed=53)
    conf = {SC.RESULT_CACHE_ENABLED: "true", SC.RESULT_CACHE_MIN_COMPUTE_SECONDS: "0",
            SC.SERVING_BATCHING_ENABLED: "false"}
    got = {}
    for pkg in PKGS:
        gov = _session(pkg, tmp_path, **conf)
        a = _session(pkg, tmp_path, **conf)
        b = _session(pkg, tmp_path, **conf)
        fe = PKGS[pkg][2].ServingFrontend(gov)
        ta = fe.submit(_variants(pkg, a, tmp_path / "d", 1)[0]).result(timeout=120)
        fe.drain()
        tb = fe.submit(_variants(pkg, b, tmp_path / "d", 1)[0]).result(timeout=120)
        s = fe.result_cache().stats()
        assert ta.to_arrow().equals(tb.to_arrow())
        assert a.result_cache.stats()["misses"] == 0 and b.result_cache.stats()["misses"] == 0
        got[pkg] = (tb.to_arrow(), s["admissions"], s["hits"], s["misses"])
    assert got["torch"][0].equals(got["jax"][0])
    assert got["torch"][1:] == got["jax"][1:] == (1, 1, 1)


def test_reads_attributed_to_the_right_query(tmp_path):
    _write(tmp_path / "small", n=2000, files=2, seed=61)
    _write(tmp_path / "big", n=12000, files=6, seed=62)
    s = _session("torch", tmp_path, **{IndexConstants.TPU_IO_THREADS: "8",
                                      SC.SERVING_MAX_CONCURRENCY: "2",
                                      SC.SERVING_BATCHING_ENABLED: "false"})
    small = s.read.parquet(str(tmp_path / "small")).filter(TE.col("k") < 10)
    big = s.read.parquet(str(tmp_path / "big")).filter(TE.col("k") < 10)
    fe = tfrontend.ServingFrontend(s)
    ps, pb = fe.submit(small, client="small"), fe.submit(big, client="big")
    ps.result(timeout=120)
    pb.result(timeout=120)
    io_s, io_b = ps.context.io_stats(), pb.context.io_stats()
    assert io_s["read_tasks"] == 2 and io_b["read_tasks"] == 6
    assert io_b["read_bytes"] > io_s["read_bytes"]


# ---------------------------------------------------------------------------
# Concurrency.
# ---------------------------------------------------------------------------

def _mix(pkg, s, d):
    """Eight queries of several shapes over one lake: filters, a group-by,
    a join, a sort with a limit, a global aggregate, literal variants."""
    E = PKGS[pkg][1]
    r = s.read.parquet(str(d))
    other = r.select(E.col("k").alias("k2"), E.col("v").alias("v2"))
    return {
        "filter": r.filter(E.col("k") < 10).select("k", "v"),
        "group": r.group_by("v").agg(E.sum_(E.col("k")).alias("sk")).sort("v"),
        "join": r.filter(E.col("k") < 5).join(other, on=E.col("k") == E.col("k2"))
        .group_by("k").agg(E.sum_(E.col("v2")).alias("s2")).sort("k"),
        "top": r.sort(("k", False), "v").limit(7),
        "global": r.filter(E.col("v") >= 3).agg(E.sum_(E.col("k")).alias("t")),
        "var1": r.filter(E.col("k") < 20).group_by("k").agg(E.sum_(E.col("v")).alias("sv"))
        .sort("k"),
        "var2": r.filter(E.col("k") < 30).group_by("k").agg(E.sum_(E.col("v")).alias("sv"))
        .sort("k"),
        "in": r.filter(E.col("v").isin([1, 4, 6])).group_by("v").agg(
            E.sum_(E.col("k")).alias("sk")).sort("v"),
    }


@pytest.mark.parametrize("through_frontend", [True, False])
def test_m_threads_k_queries_identical_to_serial(tmp_path, through_frontend):
    """Eight client threads over two sessions, each running half of the
    mix, through the frontend or by concurrent execute(): every answer
    equals the serial one, which equals the JAX package's."""
    _write(tmp_path / "d", n=6000, files=3, seed=71)
    js = _session("jax", tmp_path)
    serial_jax = {n: q.to_arrow() for n, q in _mix("jax", js, tmp_path / "d").items()}
    ref = _session("torch", tmp_path)
    serial = {n: q.to_arrow() for n, q in _mix("torch", ref, tmp_path / "d").items()}
    for name, t in serial.items():
        assert t.equals(serial_jax[name]), name
    sessions = [_session("torch", tmp_path, **{SC.SERVING_MAX_CONCURRENCY: "4"})
                for _ in range(2)]
    mixes = [_mix("torch", s, tmp_path / "d") for s in sessions]
    fe = tfrontend.ServingFrontend(sessions[0]) if through_frontend else None
    results, errors = {}, []
    names = list(serial)

    def client(tid):
        try:
            for j, name in enumerate(names):
                if (j + tid) % 2:
                    continue
                q = mixes[tid % 2][name]
                t = fe.submit(q, client=f"c{tid}").result(timeout=300) if fe else q.execute()
                results[(tid, name)] = t.to_arrow()
        except BaseException as e:  # pragma: no cover - the failure channel
            errors.append((tid, e))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a client hung"
    assert not errors, errors
    assert len(results) == 8 * len(names) // 2
    for (tid, name), t in results.items():
        assert t.equals(serial[name]), (tid, name)


def test_temp_view_registration_is_locked(tmp_path):
    _write(tmp_path / "d", seed=73)
    s = _session("torch", tmp_path)
    df = s.read.parquet(str(tmp_path / "d"))
    errors = []

    def worker(tid):
        try:
            for i in range(50):
                s.create_temp_view(f"v_{tid}_{i}", df)
                assert s.table(f"v_{tid}_{i}") is not None
        except BaseException as e:  # pragma: no cover - the failure channel
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(s._temp_views) == 8 * 50 and s._temp_views_version == 8 * 50


# ---------------------------------------------------------------------------
# Observability.
# ---------------------------------------------------------------------------

def _serving_section(text):
    if "Serving:" not in text:
        return None
    lines = text.splitlines()
    start = lines.index("Serving:") - 1
    end = start + 3
    while end < len(lines) and lines[end] and not lines[end].startswith("====="):
        end += 1
    # The JAX package's program-bank line and stacked-mask counter have no
    # counterpart in the port (eager torch compiles no programs; a member
    # evaluates its own mask), nor has the port's member_fallbacks in the
    # JAX line.
    return [re.sub(r"sweep_invocations=\d+ | member_fallbacks=\d+", "", ln)
            for ln in lines[start:end] if not ln.startswith("program bank:")]


def test_serving_stats_and_explain_section_equal_jax(tmp_path):
    """Enabled: the "Serving:" section before and after a query through the
    default frontend, equal to the JAX text without its program-bank line
    and stacked-mask counter; serving_stats() with the JAX counters (its
    program-bank entry left out)."""
    _write(tmp_path / "d", seed=83)
    got = {}
    for pkg in PKGS:
        mod, E, fe_mod = PKGS[pkg]
        s = _session(pkg, tmp_path, **{SC.SERVING_ENABLED: "true"})
        hs = mod.Hyperspace(s)
        before = hs.serving_stats()
        df = s.read.parquet(str(tmp_path / "d")).filter(E.col("k") < 4)
        sec0 = _serving_section(hs.explain(df))
        fe = hs.serving_frontend()
        assert isinstance(fe.submit(df), fe_mod.PendingQuery)
        fe.drain()
        stats = hs.serving_stats()
        got[pkg] = (before["frontend"], sec0, _serving_section(hs.explain(df)),
                    {k: stats[k] for k in FRONTEND_STATS + ("frontend",)})
    assert got["torch"] == got["jax"]
    assert got["torch"][3]["submitted"] == 1 and got["torch"][3]["frontend"] is True
    assert "queries: submitted=1" in "\n".join(got["torch"][2])


def test_disabled_serving_explain_silent(tmp_path):
    _write(tmp_path / "d", seed=89)
    s = _session("torch", tmp_path)
    assert "Serving:" not in ht.Hyperspace(s).explain(s.read.parquet(str(tmp_path / "d")))
    from hyperspace_tpu_torch.serving.program_bank import get_bank
    assert ht.Hyperspace(s).serving_stats() == {"frontend": None,
                                                "program_bank": get_bank().stats()}


def test_default_frontend_requires_enabled(tmp_path):
    with pytest.raises(HyperspaceException):
        tfrontend.get_frontend(_session("torch", tmp_path))


def test_direct_construction_registers_default(tmp_path):
    _write(tmp_path / "d", seed=97)
    s = _session("torch", tmp_path)
    fe = tfrontend.ServingFrontend(s)
    assert tfrontend._DEFAULT is fe and fe in tfrontend.all_frontends()
    fe.submit(s.read.parquet(str(tmp_path / "d")).filter(TE.col("k") < 4)).result(timeout=120)
    fe.drain()
    stats = ht.Hyperspace(s).serving_stats()
    assert stats["frontend"] is True and stats["submitted"] == 1
    assert re.search(r"queries: submitted=1 ", ht.Hyperspace(s).explain(
        s.read.parquet(str(tmp_path / "d"))))
