"""The robustness tier (``hyperspace_tpu_torch/robustness/`` and the fault
points, retries, deadlines and degradation ladders it places in the io,
scan, buffer-pool, result-cache and serving tiers) against the JAX
package's. The oracles are the JAX package's ``tests/test_robustness.py``,
``test_fault_injection.py``, ``test_chaos_soak.py`` and
``test_crash_recovery.py``.

Every scenario runs once through each package on the same numpy-seeded
files, with the same spec strings armed, and the two records are compared
exactly: answers byte for byte (Arrow IPC), the typed error's class, the
deltas of the process-wide ``note(...)`` counters, and the kinds of the
events emitted. The JAX sessions run staged (``fusion.enabled=false``) and
single-device (``distributed.enabled=false``), the path the port follows.
The chaos soak is a short seeded schedule run serially through each
package's frontend, so its counters replay exactly.
"""

import os
import subprocess
import sys
import textwrap
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
from hyperspace_tpu.execution import buffer_pool as jbuffer_pool
from hyperspace_tpu.parallel import io as jio
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plananalysis.explain import explain_string as jexplain
from hyperspace_tpu.robustness import fault_names as JFN
from hyperspace_tpu.robustness import faults as jfaults
from hyperspace_tpu.robustness import retry as jretry
from hyperspace_tpu.serving import frontend as jfrontend
from hyperspace_tpu.serving import context as jcontext
from hyperspace_tpu.serving import result_cache as jresult_cache
from hyperspace_tpu_torch.execution import buffer_pool as tbuffer_pool
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.parallel import io as tio
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.plananalysis.explain import explain_string as texplain
from hyperspace_tpu_torch.robustness import fault_names as TFN
from hyperspace_tpu_torch.robustness import faults as tfaults
from hyperspace_tpu_torch.robustness import retry as tretry
from hyperspace_tpu_torch.robustness.constants import RobustnessConstants as RC
from hyperspace_tpu_torch.serving import context as tcontext
from hyperspace_tpu_torch.serving import frontend as tfrontend
from hyperspace_tpu_torch.serving import result_cache as tresult_cache
from hyperspace_tpu_torch.serving.constants import ServingConstants as SC

from conftest import capture_logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE_CONF = {"hyperspace.tpu.distributed.enabled": "false",
             "hyperspace.tpu.execution.fusion.enabled": "false",
             IndexConstants.INDEX_NUM_BUCKETS: "4",
             IndexConstants.TPU_IO_THREADS: "4",
             IndexConstants.EVENT_LOGGER_CLASS: "tests.conftest.CaptureLogger"}


class Pkg:
    """One package's modules, so a scenario is written once."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.mod = hst if jax else ht
        self.E = JE if jax else TE
        self.FN = JFN if jax else TFN
        self.faults = jfaults if jax else tfaults
        self.retry = jretry if jax else tretry
        self.frontend = jfrontend if jax else tfrontend
        self.result_cache = jresult_cache if jax else tresult_cache
        self.buffer_pool = jbuffer_pool if jax else tbuffer_pool
        self.io = jio if jax else tio
        self.context = jcontext if jax else tcontext
        self.explain = jexplain if jax else texplain

    def session(self, tmp_path, cls=None, **conf):
        cls = cls or self.mod.Session
        full = dict(BASE_CONF, **conf)
        path = str(tmp_path / f"ix_{self.name}")
        if self.name == "torch":
            return cls(conf=full, system_path=path, device="cpu")
        return cls(conf=full, system_path=path)

    def registry(self, specs, seed=0):
        return self.faults.FaultRegistry.from_conf_specs(specs, seed=seed)


PKGS = [Pkg("jax"), Pkg("torch")]


def fkey(point: str) -> str:
    return f"{RC.FAULTS_PREFIX}.{point}"


def write(d, n=4000, seed=7, files=3):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"k": rng.integers(0, 50, n).astype(np.int64),
                       "v": rng.integers(0, 9, n).astype(np.int64)})
    os.makedirs(str(d), exist_ok=True)
    step = max(n // files, 1)
    for i in range(files):
        hi = (i + 1) * step if i < files - 1 else n
        pq.write_table(pa.Table.from_pandas(df.iloc[i * step:hi]),
                       os.path.join(str(d), f"p{i}.parquet"))
    return str(d)


def query(p: Pkg, session, d):
    E = p.E
    return session.read.parquet(d).filter(E.col("k") < 20).group_by("k") \
        .agg(E.sum_(E.col("v")).alias("sv")).sort("k")


def ipc(table) -> bytes:
    """An answer's bytes: a Table (either package's) or an Arrow table."""
    if not isinstance(table, pa.Table):
        table = table.to_arrow()
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def fresh(p: Pkg) -> None:
    """Process-wide state a scenario must not inherit."""
    p.buffer_pool.get_pool().clear()
    p.buffer_pool.get_pool().reset_stats()
    p.io.reset_stats()
    capture_logger().events.clear()


def event_kinds(names=("RetryEvent", "QueryCancelledEvent", "ResultCacheMissEvent",
                       "BufferPoolMissEvent")):
    """The kinds (and the robustness-relevant fields) of the events emitted
    since ``fresh``."""
    out = []
    for e in capture_logger().events:
        kind = type(e).__name__
        if kind not in names:
            continue
        if kind == "RetryEvent":
            out.append((kind, e.where, e.succeeded))
        elif kind == "QueryCancelledEvent":
            out.append((kind, e.where))
        elif kind == "ResultCacheMissEvent":
            out.append((kind, e.reason))
        else:
            out.append((kind, e.reason))
    return out


class Counters:
    """Deltas of a package's ``note(...)`` counters over a block."""

    def __init__(self, p: Pkg):
        self.p = p
        self.before = p.faults.stats()

    def delta(self) -> dict:
        after = self.p.faults.stats()
        keys = set(after) | set(self.before)
        return {k: after.get(k, 0) - self.before.get(k, 0) for k in sorted(keys)
                if after.get(k, 0) != self.before.get(k, 0)}


def outcome(fn):
    """(answer bytes or None, error class name or None)."""
    try:
        return ipc(fn()), None
    except Exception as e:  # the typed error is the record
        return None, type(e).__name__


def both(tmp_path, scenario):
    """Run ``scenario(p, tmp)`` through each package and return the two
    records."""
    out = {}
    for p in PKGS:
        tmp = tmp_path / p.name
        tmp.mkdir()
        fresh(p)
        out[p.name] = scenario(p, tmp)
    return out["jax"], out["torch"]


# ---------------------------------------------------------------------------
# Names, specs and registries.
# ---------------------------------------------------------------------------

LEFT_OUT = {"spmd.compile"}


def test_fault_names_are_the_reference_less_the_five_refused():
    """Queue C item 14, narrowed to one: spmd.dispatch is placed with the
    mesh tier, bank.compile with the program bank, artifacts.write and
    artifacts.read with the artifact store; spmd.compile stays refused."""
    assert TFN.FAULT_NAMES == JFN.FAULT_NAMES - LEFT_OUT
    assert len(TFN.FAULT_NAMES) == 19
    assert TFN.SPMD_DISPATCH == "spmd.dispatch"
    assert (TFN.BANK_COMPILE, TFN.ARTIFACTS_WRITE, TFN.ARTIFACTS_READ) == \
        ("bank.compile", "artifacts.write", "artifacts.read")
    for name in TFN.FAULT_NAMES:
        const = [k for k, v in vars(TFN).items() if v == name and k.isupper()]
        assert const and all(getattr(JFN, k) == name for k in const)


@pytest.mark.parametrize("name", sorted(JFN.FAULT_NAMES))
def test_parse_accepts_placed_and_refuses_left_out(name):
    spec = "transient:p=0.25,nth=2,times=3,ms=7"
    if name in LEFT_OUT:
        with pytest.raises(ht.HyperspaceException, match="Unknown fault point"):
            tfaults.FaultSpec.parse(name, spec)
        return
    j, t = jfaults.FaultSpec.parse(name, spec), tfaults.FaultSpec.parse(name, spec)
    assert [getattr(j, s) for s in j.__slots__] == [getattr(t, s) for s in t.__slots__]


@pytest.mark.parametrize("spec", ["error:nth=3", "error:times=2", "latency:ms=0,times=1",
                                  "transient:p=0.5", "error:p=0.3,times=4",
                                  "error:exc=OSError,nth=2"])
def test_registry_fires_the_same_hits(spec):
    """The same spec and seed fire on the same hits with the same error."""
    def run(p: Pkg):
        reg = p.registry({p.FN.IO_POOLED_READ: spec}, seed=1234)
        fired = []
        for _ in range(12):
            try:
                reg.trigger(p.FN.IO_POOLED_READ)
                fired.append(None)
            except Exception as e:
                fired.append(type(e).__name__)
        return fired, reg.hit_count(p.FN.IO_POOLED_READ)

    assert run(PKGS[0]) == run(PKGS[1])


@pytest.mark.parametrize("bad", [("no.such.point", "error"), ("io.pooled_read", "explode"),
                                 ("io.pooled_read", "error:bogus=1"),
                                 ("io.pooled_read", "error:exc=KeyError"),
                                 ("io.pooled_read", "error:nth")])
def test_bad_specs_are_refused_alike(bad):
    errs = []
    for p in PKGS:
        with pytest.raises(Exception) as err:
            p.faults.FaultSpec.parse(*bad)
        errs.append((type(err.value).__name__, str(err.value).split(";")[0]))
    assert errs[0] == errs[1]


def test_unarmed_point_is_silent():
    for p in PKGS:
        reg = p.registry({p.FN.SCAN_PARQUET_DECODE: "error"})
        with p.faults.scope(reg):
            p.faults.fault_point(p.FN.IO_POOLED_READ)
        assert reg.hit_count(p.FN.IO_POOLED_READ) == 0


# ---------------------------------------------------------------------------
# Fault points on the query path.
# ---------------------------------------------------------------------------

def test_disarmed_and_armed_at_p0_are_byte_identical(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d")
        s = p.session(tmp)
        plain = ipc(query(p, s, d).to_arrow())
        s.conf.set(fkey(p.FN.IO_POOLED_READ), "error:p=0")
        s.conf.set(fkey(p.FN.SCAN_PARQUET_DECODE), "error:p=0")
        return plain, ipc(query(p, s, d).to_arrow())

    j, t = both(tmp_path, scenario)
    assert j == t and j[0] == j[1]


@pytest.mark.parametrize("pool", ["true", "false"])
def test_scan_decode_error_is_typed_and_recovers(tmp_path, pool):
    def scenario(p, tmp):
        d = write(tmp / "d")
        s = p.session(tmp, **{"hyperspace.tpu.execution.bufferPool.enabled": pool,
                              fkey(p.FN.SCAN_PARQUET_DECODE): "error"})
        c = Counters(p)
        failed = outcome(lambda: query(p, s, d).to_arrow())
        s.conf.unset(fkey(p.FN.SCAN_PARQUET_DECODE))
        return failed, outcome(lambda: query(p, s, d).to_arrow()), c.delta()

    j, t = both(tmp_path, scenario)
    assert j == t
    assert j[0] == (None, "InjectedFaultError") and j[1][0] is not None
    assert j[2] == {"injected": 1}


def test_scan_decode_latency_slows_not_breaks(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d", files=1)
        s = p.session(tmp)
        base = ipc(query(p, s, d).to_arrow())
        s.conf.set(fkey(p.FN.SCAN_PARQUET_DECODE), "latency:ms=120")
        t0 = time.perf_counter()
        slow = ipc(query(p, s, d).to_arrow())
        return base == slow, time.perf_counter() - t0 >= 0.12, slow

    j, t = both(tmp_path, scenario)
    assert j == t and j[0] and j[1]


@pytest.mark.parametrize("spec,expect", [("error:nth=3", [0, 1]),
                                         ("error:times=0", list(range(10))),
                                         ("latency:ms=1,times=2", list(range(10)))])
def test_prefetch_producer_fault_surfaces_at_consumer(spec, expect):
    records = []
    for p in PKGS:
        reg = p.registry({p.FN.IO_PREFETCH_PRODUCE: spec})
        got, err = [], None
        with p.faults.scope(reg):
            try:
                for x in p.io.prefetch_iter(iter(range(10)), label="test",
                                            params=p.io.IoParams(threads=4)):
                    got.append(x)
            except Exception as e:
                err = type(e).__name__
        records.append((got, err, reg.hit_count(p.FN.IO_PREFETCH_PRODUCE)))
    assert records[0] == records[1]
    assert records[1][0] == expect


# ---------------------------------------------------------------------------
# Retry.
# ---------------------------------------------------------------------------

def _flaky(errors):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if errors:
            raise errors.pop(0)
        return "ok"

    return fn, calls


@pytest.mark.parametrize("case", ["transient_recovers", "file_not_found", "value_error",
                                  "exhaustion", "injected_transient", "single_attempt"])
def test_retry_call_matches(case):
    def run(p: Pkg):
        errors = {
            "transient_recovers": [OSError("flaky"), TimeoutError("slow")],
            "file_not_found": [FileNotFoundError("gone")],
            "value_error": [ValueError("deterministic")],
            "exhaustion": [OSError("first"), OSError("second"), OSError("third")],
            "injected_transient": [p.faults.TransientInjectedFaultError("t")],
            "single_attempt": [OSError("once")],
        }[case]
        attempts = 1 if case == "single_attempt" else 3
        fn, calls = _flaky(errors)
        c = Counters(p)
        try:
            res = p.retry.call(fn, where="unit",
                               policy=p.retry.RetryPolicy(max_attempts=attempts, base_ms=0.1))
        except Exception as e:
            res = f"{type(e).__name__}: {e}"
        return res, calls["n"], c.delta()

    assert run(PKGS[0]) == run(PKGS[1])


@pytest.mark.parametrize("conf", [{}, {RC.RETRY_MAX_ATTEMPTS: "5", RC.RETRY_BASE_MS: "2.5"},
                                  {RC.RETRY_MAX_ATTEMPTS: "0", RC.RETRY_BASE_MS: "-1"}])
def test_policy_from_conf_matches(tmp_path, conf):
    pols = []
    for p in PKGS:
        s = p.session(tmp_path / p.name, **conf)
        pol = p.retry.policy_from_conf(s.hs_conf)
        pols.append((pol.max_attempts, pol.base_ms))
    assert pols[0] == pols[1]


def test_pooled_read_retry_end_to_end(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d")
        s = p.session(tmp)
        base = ipc(query(p, s, d).to_arrow())
        fresh(p)  # a warm repeat would be served from the pool: no read
        c = Counters(p)
        s.conf.set(fkey(p.FN.IO_POOLED_READ), "transient:times=2")
        got = ipc(query(p, s, d).to_arrow())
        events = event_kinds(("RetryEvent",))
        return base == got, c.delta(), sorted(set(events))

    j, t = both(tmp_path, scenario)
    assert j == t
    assert j[0] and j[1] == {"injected": 2, "retries": 2}
    assert j[2] == [("RetryEvent", "io.pooled_read", True)]


@pytest.mark.parametrize("threads", ["2", "4"])
def test_pooled_read_retry_exhaustion(tmp_path, threads):
    """Every attempt fails: the consumer raises the typed transient error
    after an exhausted sequence. The totals are not compared: reads still
    in flight when the consumer raises finish their own attempts on the
    pool's threads, at their own pace, in either package."""
    def scenario(p, tmp):
        d = write(tmp / "d")
        s = p.session(tmp, **{RC.RETRY_MAX_ATTEMPTS: "2", RC.RETRY_BASE_MS: "1",
                              IndexConstants.TPU_IO_THREADS: threads,
                              fkey(p.FN.IO_POOLED_READ): "transient"})
        c = Counters(p)
        res = outcome(lambda: query(p, s, d).to_arrow())
        return res, c.delta().get("retry_failures", 0) >= 1, \
            ("RetryEvent", "io.pooled_read", False) in event_kinds(("RetryEvent",))

    j, t = both(tmp_path, scenario)
    assert j == t == ((None, "TransientInjectedFaultError"), True, True)


# ---------------------------------------------------------------------------
# Deadlines.
# ---------------------------------------------------------------------------

def test_conf_deadline_cancels_with_typed_error(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d")
        # The deadline outlasts planning, so the decode's latency is
        # always injected before it trips.
        s = p.session(tmp, **{fkey(p.FN.SCAN_PARQUET_DECODE): "latency:ms=800",
                              RC.DEADLINE_MS: "300"})
        c = Counters(p)
        res = outcome(lambda: query(p, s, d).to_arrow())
        cancelled = [e for e in capture_logger().events
                     if type(e).__name__ == "QueryCancelledEvent"]
        elapsed_ok = len(cancelled) == 1 and cancelled[0].elapsed_ms >= 300
        s.conf.unset(RC.DEADLINE_MS)
        s.conf.unset(fkey(p.FN.SCAN_PARQUET_DECODE))
        # Where the check trips (the wait on the decode's read, or the
        # stage's exit) is held to the two boundaries, not compared.
        places = [e.where for e in cancelled]
        return res, c.delta(), len(cancelled), elapsed_ok, \
            outcome(lambda: query(p, s, d).to_arrow()), places

    j, t = both(tmp_path, scenario)
    assert j[:5] == t[:5]
    assert j[0] == (None, "QueryDeadlineError") and j[3]
    assert j[1] == {"deadline_cancellations": 1, "injected": 1} and j[2] == 1
    assert set(j[5]) | set(t[5]) <= {"exec.stage", "io.read"}


def test_deadline_at_io_prefetch_wait(tmp_path):
    """A consumer waiting on a stalled producer polls its deadline."""
    def run(p: Pkg):
        s = p.session(tmp_path / p.name, **{RC.DEADLINE_MS: "30"})
        qc = p.context.QueryContext.for_session(s)
        c = Counters(p)

        def slow():
            for i in range(3):
                time.sleep(0.2)
                yield i

        err = None
        with qc.activate():
            try:
                list(p.io.prefetch_iter(slow(), label="t", params=p.io.IoParams(threads=4)))
            except Exception as e:
                err = (type(e).__name__, "io.prefetch" in str(e))
        return err, c.delta()

    assert run(PKGS[0]) == run(PKGS[1]) == (("QueryDeadlineError", True),
                                            {"deadline_cancellations": 1})


def test_submit_deadline_frees_slot(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d")
        s = p.session(tmp, **{fkey(p.FN.SCAN_PARQUET_DECODE): "latency:ms=100"})
        fe = p.frontend.ServingFrontend(s)
        pend = fe.submit(query(p, s, d), deadline_ms=30)
        res = outcome(lambda: pend.result(timeout=120))
        fe.drain()
        st = fe.stats()
        freed = (st["active_workers"], st["queued"], st["inflight_bytes"])
        s.conf.unset(fkey(p.FN.SCAN_PARQUET_DECODE))
        ok = outcome(lambda: fe.submit(query(p, s, d)).result(timeout=120))
        fe.drain()
        return res, freed, ok

    j, t = both(tmp_path, scenario)
    assert j == t and j[0] == (None, "QueryDeadlineError") and j[1] == (0, 0, 0)


def test_expired_in_queue_fast_fails(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d")
        gate = threading.Event()

        class Gated(p.mod.Session):
            def execute(self, plan, context=None):
                assert gate.wait(timeout=60)
                return super().execute(plan, context)

        s = p.session(tmp, cls=Gated, **{SC.SERVING_MAX_CONCURRENCY: "1",
                                         SC.SERVING_BATCHING_ENABLED: "false"})
        fe = p.frontend.ServingFrontend(s)
        q = query(p, s, d)
        c = Counters(p)
        blocker = fe.submit(q)
        doomed = fe.submit(q, deadline_ms=20)
        time.sleep(0.08)
        gate.set()
        blocker.result(timeout=120)
        try:
            doomed.result(timeout=120)
            err = None
        except Exception as e:
            err = (type(e).__name__, "serving.queue" in str(e))
        ids = [e.query_id == doomed.query_id for e in capture_logger().events
               if type(e).__name__ == "QueryCancelledEvent"]
        fe.drain()
        return err, ids, c.delta(), fe.stats()["active_workers"]

    j, t = both(tmp_path, scenario)
    assert j == t and j[0] == ("QueryDeadlineError", True) and j[1] == [True]


# ---------------------------------------------------------------------------
# Degradation ladders: the result cache and its spill tier.
# ---------------------------------------------------------------------------

CACHE_ON = {SC.RESULT_CACHE_ENABLED: "true", SC.RESULT_CACHE_MIN_COMPUTE_SECONDS: "0"}


@pytest.mark.parametrize("degrade", ["true", "false"])
def test_device_put_fault(tmp_path, degrade):
    """With degrade on the entry lands in the host tier and answers again
    from there; off, the fault raises."""
    def scenario(p, tmp):
        d = write(tmp / "d", seed=23)
        s = p.session(tmp, **CACHE_ON, **{RC.DEGRADE_ENABLED: degrade,
                                          fkey(p.FN.RESULT_CACHE_DEVICE_PUT): "error"})
        q = query(p, s, d)
        c = Counters(p)
        first = outcome(lambda: q.to_arrow())
        if first[0] is None:
            return first, c.delta()
        st = s.result_cache.stats()
        again = outcome(lambda: q.to_arrow())
        return first, again, (st["host_entries"], st["device_entries"]), \
            s.result_cache.stats()["host_hits"], c.delta()

    j, t = both(tmp_path, scenario)
    assert j == t
    if degrade == "true":
        assert j[0] == j[1] and j[2] == (1, 0) and j[3] == 1
        assert j[4] == {"degraded_device_put": 1, "injected": 1}
    else:
        assert j[0] == (None, "InjectedFaultError")


def _spilled(p: Pkg, tmp, seed):
    d = write(tmp / "d", seed=seed)
    s = p.session(tmp)
    t = query(p, s, d).execute().to_host()
    n = p.result_cache.table_nbytes(t)
    rc = p.result_cache.ResultCache(device_bytes=0, host_bytes=n,
                                    spill_dir=str(tmp / "spill"), spill_bytes=10 * n)
    rc.put("a", t)
    rc.put("b", t)  # "a" goes to disk
    return rc, t


@pytest.mark.parametrize("damage", ["garbage", "truncated", "fault_point", "none"])
def test_spill_read_back(tmp_path, damage):
    def scenario(p, tmp):
        rc, t = _spilled(p, tmp, seed=31)
        path = rc._spill["a"][0]
        if damage == "garbage":
            with open(path, "wb") as f:
                f.write(b"garbage bytes, not a spilled table")
        elif damage == "truncated":
            data = open(path, "rb").read()
            with open(path, "wb") as f:
                f.write(data[:len(data) // 2])
        c = Counters(p)
        reg = p.registry({p.FN.RESULT_CACHE_SPILL_READ: "error"}) \
            if damage == "fault_point" else None
        with p.faults.scope(reg):
            got = rc.get("a")
        st = rc.stats()
        return (None if got is None else (ipc(got[0]) == ipc(t), got[1]),
                st["spill_corruptions"], st["spill_entries"], os.path.exists(path), c.delta())

    j, t = both(tmp_path, scenario)
    assert j == t
    if damage == "none":
        assert j[0] == (True, "spill") and j[1] == 0
    else:
        assert j[0] is None and j[1] == 1 and j[2] == 0 and not j[3]
        assert j[4]["spill_corruptions"] == 1


def test_corrupt_spill_recomputes_with_event(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d", seed=43)
        s = p.session(tmp)
        E = p.E
        qa = query(p, s, d)
        qb = s.read.parquet(d).filter(E.col("v") < 5).group_by("v") \
            .agg(E.sum_(E.col("k")).alias("sk")).sort("v")
        n = p.result_cache.table_nbytes(qa.execute().to_host())
        for k, v in {**CACHE_ON, SC.RESULT_CACHE_DEVICE_BYTES: "1",
                     SC.RESULT_CACHE_HOST_BYTES: str(n),
                     SC.RESULT_CACHE_SPILL_DIR: str(tmp / "spill")}.items():
            s.conf.set(k, v)
        a1 = ipc(qa.to_arrow())
        qb.to_arrow()
        cache = s.result_cache
        spilled = cache.stats()["spill_entries"]
        path = next(iter(cache._spill.values()))[0]
        with open(path, "wb") as f:
            f.write(b"\x00\x01garbage")
        capture_logger().events.clear()
        c = Counters(p)
        a2 = ipc(qa.to_arrow())
        return a1 == a2, spilled, event_kinds(("ResultCacheMissEvent",)), \
            cache.stats()["spill_corruptions"], c.delta()

    j, t = both(tmp_path, scenario)
    assert j == t and j[0] and j[1] == 1
    assert ("ResultCacheMissEvent", "spill-corrupt") in j[2]


# ---------------------------------------------------------------------------
# Degradation ladders: the buffer pool.
# ---------------------------------------------------------------------------

POOL_STATS = ("hits", "misses", "invalidations", "degraded_loads", "admissions")


@pytest.mark.parametrize("degrade", ["true", "false"])
def test_buffer_load_fault(tmp_path, degrade):
    """A warm pool probe struck by ``buffer.load``: with degrade on a
    silent miss and a re-read (the same answer, the entry dropped); off,
    the typed error."""
    def scenario(p, tmp):
        d = write(tmp / "d", seed=11)
        s = p.session(tmp, **{RC.DEGRADE_ENABLED: degrade})
        cold = ipc(query(p, s, d).to_arrow())
        p.buffer_pool.get_pool().reset_stats()
        capture_logger().events.clear()
        c = Counters(p)
        s.conf.set(fkey(p.FN.BUFFER_LOAD), "error:times=1")
        warm = outcome(lambda: query(p, s, d).to_arrow())
        st = p.buffer_pool.get_pool().stats()
        return cold == warm[0], warm[1], {k: st[k] for k in POOL_STATS}, c.delta(), \
            event_kinds(("BufferPoolMissEvent",))

    j, t = both(tmp_path, scenario)
    assert j == t
    if degrade == "true":
        assert j[0] and j[2]["degraded_loads"] == 1 and j[2]["invalidations"] == 1
        assert j[3] == {"degraded_buffer_loads": 1, "injected": 1}
        assert ("BufferPoolMissEvent", "fault") in j[4]
    else:
        assert j[1] == "InjectedFaultError"


@pytest.mark.parametrize("degrade", ["true", "false"])
def test_failed_promotion_rereads_onto_the_session_device(tmp_path, monkeypatch, degrade):
    """A host-tier hit whose copy back to the device fails: with degrade on,
    the entry drops, the probe is a miss and the files are read again onto
    the session's device (the host copy is never served); off, the copy's
    error. The port's own ladder: torch does not move a host table back to
    the device on use, as JAX does, so serving the host copy would move the
    query off the card."""
    p = PKGS[1]
    fresh(p)
    d1 = write(tmp_path / "d1", seed=11)
    d2 = write(tmp_path / "d2", seed=12)
    s = p.session(tmp_path, **{RC.DEGRADE_ENABLED: degrade})
    want = ipc(query(p, s, d1).to_arrow())
    pool = p.buffer_pool.get_pool()
    s.conf.set(IndexConstants.TPU_BUFFER_POOL_DEVICE_BYTES, str(pool.stats()["device_nbytes"]))
    query(p, s, d2).to_arrow()  # d1's scan goes down to the host tier
    before = pool.stats()
    assert (before["device_entries"], before["host_entries"]) == (1, 1)
    with pool._lock:
        on_device = set(pool._device)
    copies = []

    def broken_copy(table, device):
        copies.append(device)
        raise RuntimeError("device copy failed")

    monkeypatch.setattr(p.buffer_pool, "_table_to_device", broken_copy)
    c = Counters(p)
    got = outcome(lambda: query(p, s, d1).to_arrow())
    after = pool.stats()
    delta = {k: after[k] - before[k] for k in ("host_hits", "misses", "loads", "promotions",
                                               "invalidations", "degraded_loads")}
    assert copies == [s.device]
    if degrade == "false":
        assert got == (None, "RuntimeError")
        return
    assert got == (want, None)
    assert delta == {"host_hits": 0, "misses": 1, "loads": 1, "promotions": 0,
                     "invalidations": 1, "degraded_loads": 1}
    assert c.delta() == {"degraded_buffer_loads": 1}
    with pool._lock:
        reread = [e for k, e in pool._device.items() if k not in on_device]
    assert len(reread) == 1 and reread[0].device == s.device
    assert all(c.data.device == s.device for c in reread[0].payload.columns.values())


# ---------------------------------------------------------------------------
# Degradation ladders: the serving frontend.
# ---------------------------------------------------------------------------

def _variants(p: Pkg, s, d, n):
    E = p.E
    r = s.read.parquet(d)
    return [r.filter(E.col("k") < i + 3).group_by("k").agg(E.sum_(E.col("v")).alias("sv"))
            .sort("k") for i in range(n)]


@pytest.mark.parametrize("degrade", ["true", "false"])
def test_sweep_member_fault_falls_back_per_member(tmp_path, degrade):
    def scenario(p, tmp):
        d = write(tmp / "d", n=5000, files=2, seed=47)
        s = p.session(tmp, **{SC.SERVING_MAX_CONCURRENCY: "1",
                              SC.SERVING_BATCHING_WINDOW: "0.5",
                              RC.DEGRADE_ENABLED: degrade})
        qs = _variants(p, s, d, 4)
        serial = [ipc(q.to_arrow()) for q in qs]
        fe = p.frontend.ServingFrontend(s)
        c = Counters(p)
        reg = p.registry({p.FN.SCAN_PARQUET_DECODE: "error:nth=1"})
        with p.faults.scope(reg):
            pend = [fe.submit(q) for q in qs]
        got = [outcome(lambda pq_=pq_: pq_.result(timeout=180)) for pq_ in pend]
        fe.drain()
        return [g[0] == ref if g[0] else g[1] for g, ref in zip(got, serial)], c.delta()

    j, t = both(tmp_path, scenario)
    assert j == t
    if degrade == "true":
        assert j[0] == [True] * 4 and j[1] == {"injected": 1, "member_fallbacks": 1}
    else:
        assert j[0] == ["InjectedFaultError", True, True, True]


@pytest.mark.parametrize("degrade", ["true", "false"])
def test_worker_death_releases_members(tmp_path, degrade):
    def scenario(p, tmp):
        d = write(tmp / "d", seed=53)
        s = p.session(tmp, **{SC.SERVING_MAX_CONCURRENCY: "1",
                              SC.SERVING_BATCHING_WINDOW: "0.3",
                              RC.DEGRADE_ENABLED: degrade})
        qs = _variants(p, s, d, 3)
        serial = [ipc(q.to_arrow()) for q in qs]
        fe = p.frontend.ServingFrontend(s)
        c = Counters(p)
        reg = p.registry({p.FN.SERVING_WORKER: "error:nth=1"})
        with p.faults.scope(reg):
            pend = [fe.submit(q) for q in qs]
        got = [outcome(lambda pq_=pq_: pq_.result(timeout=180)) for pq_ in pend]
        fe.drain()
        st = fe.stats()
        return [g[0] == ref if g[0] else g[1] for g, ref in zip(got, serial)], c.delta(), \
            (st["active_workers"], st["inflight_bytes"])

    j, t = both(tmp_path, scenario)
    assert j == t and j[2] == (0, 0)
    if degrade == "true":
        assert j[0] == [True] * 3 and j[1] == {"injected": 1, "worker_releases": 1}
    else:
        assert j[0][0] == "InjectedFaultError"


def test_serving_worker_fires_only_under_a_scope(tmp_path):
    """Armed through the session's conf the point never fires: the worker
    runs before the query's own fault scope."""
    def scenario(p, tmp):
        d = write(tmp / "d", seed=5)
        s = p.session(tmp, **{fkey(p.FN.SERVING_WORKER): "error"})
        fe = p.frontend.ServingFrontend(s)
        c = Counters(p)
        res = outcome(lambda: fe.submit(query(p, s, d)).result(timeout=120))
        fe.drain()
        return res[1], c.delta()

    j, t = both(tmp_path, scenario)
    assert j == t == (None, {})


# ---------------------------------------------------------------------------
# Observability.
# ---------------------------------------------------------------------------

def _robustness_section(text: str) -> list:
    lines = text.splitlines()
    if "Robustness:" not in lines:
        return []
    i = lines.index("Robustness:")
    out = []
    for line in lines[i:]:
        if not line.strip() and out:
            break
        out.append(line)
    return out


def test_explain_section_gated_and_rendered(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d", seed=59)
        s = p.session(tmp)
        q = query(p, s, d)
        saved = p.faults.stats()
        p.faults.reset_stats()
        try:
            before = _robustness_section(p.explain(s, q.plan))
            s.conf.set(fkey(p.FN.IO_POOLED_READ), "transient:times=1")
            p.buffer_pool.get_pool().clear()
            q.to_arrow()
            s.conf.set(RC.DEADLINE_MS, "600000")
            s.conf.set(RC.DEGRADE_ENABLED, "false")
            return before, _robustness_section(p.explain(s, q.plan))
        finally:
            p.faults.reset_stats()
            p.faults.note(**{k: v for k, v in saved.items() if v})

    j, t = both(tmp_path, scenario)
    assert j == t and j[0] == []
    assert "fault points armed: 1 (io.pooled_read)" in t[1]
    assert any("retries=1 " in line for line in t[1])


def test_robustness_keys_leave_the_cache_key_alone(tmp_path):
    def scenario(p, tmp):
        d = write(tmp / "d", seed=67)
        s = p.session(tmp, **CACHE_ON)
        q = query(p, s, d)
        first = ipc(q.to_arrow())
        hits = s.result_cache.stats()["hits"]
        s.conf.set(RC.DEADLINE_MS, "600000")
        s.conf.set(RC.RETRY_MAX_ATTEMPTS, "5")
        s.conf.set(RC.DEGRADE_ENABLED, "false")
        s.conf.set(fkey(p.FN.IO_POOLED_READ), "error:p=0")
        again = ipc(q.to_arrow())
        return first == again, s.result_cache.stats()["hits"] - hits

    j, t = both(tmp_path, scenario)
    assert j == t == (True, 1)


def test_metrics_collector_keys(tmp_path):
    keys = []
    for p in PKGS:
        m = p.mod.Hyperspace(p.session(tmp_path / p.name)).metrics()
        keys.append(set(m["collectors"]["robustness"]) >= set(tfaults._COUNTER_KEYS))
    assert keys == [True, True]
    assert set(tfaults._COUNTER_KEYS) == set(jfaults._COUNTER_KEYS)


# ---------------------------------------------------------------------------
# The chaos soak: a short seeded schedule, run serially.
# ---------------------------------------------------------------------------

# One registry's RNG serves every point, so the points a query hits on
# several threads at once (the pooled reads) arm by ``nth``: a draw there
# would go to whichever thread came first.
CHAOS = {
    "io.pooled_read": "transient:nth=2",
    "io.prefetch_produce": "error:nth=1",
    "scan.parquet_decode": "error:p=0.15",
    "buffer.load": "error:p=0.4",
    "result_cache.device_put": "error:p=0.3",
    "result_cache.spill_read": "error:p=0.3",
    "serving.worker": "error:p=0.2",
    "log.write": "error:p=0.5",
    "action.op": "error:p=0.5",
    "cluster.forward": "error:p=0.1",
}


def test_chaos_schedule_same_outcomes_and_counters(tmp_path):
    """Every submission ends in the serial answer or a typed error; the
    outcomes and counters are the same in both packages, and the frontend
    strands nothing."""
    def scenario(p, tmp):
        d = write(tmp / "d", n=6000, files=3, seed=71)
        s = p.session(tmp, **CACHE_ON, **{
            SC.SERVING_MAX_CONCURRENCY: "1", SC.SERVING_BATCHING_ENABLED: "false",
            SC.RESULT_CACHE_SPILL_DIR: str(tmp / "spill"),
            IndexConstants.TPU_BUFFER_POOL_DEVICE_BYTES: str(64 * 1024),
            IndexConstants.TPU_BUFFER_POOL_HOST_BYTES: str(16 * 1024)})
        qs = _variants(p, s, d, 6)
        serial = [ipc(q.to_arrow()) for q in qs]
        s.result_cache.clear()
        fresh(p)
        fe = p.frontend.ServingFrontend(s)
        reg = p.registry(dict(CHAOS), seed=1234)
        c = Counters(p)
        results = []
        for rnd in range(3):
            for i, q in enumerate(qs):
                with p.faults.scope(reg):
                    pend = fe.submit(q)
                got = outcome(lambda: pend.result(timeout=180))
                results.append(got[0] == serial[i] if got[0] is not None else got[1])
        fe.drain()
        st = fe.stats()
        hits = {n: reg.hit_count(n) for n in sorted(CHAOS)}
        return results, c.delta(), hits, (st["queued"], st["active_workers"],
                                          st["inflight_bytes"])

    j, t = both(tmp_path, scenario)
    assert t[3] == (0, 0, 0)
    assert all(r is True or r in ("InjectedFaultError", "TransientInjectedFaultError")
               for r in t[0])
    assert j == t
    assert t[1].get("injected", 0) > 0


# ---------------------------------------------------------------------------
# Crash recovery at a new point: a kill -9 mid-create.
# ---------------------------------------------------------------------------

CHILD = textwrap.dedent("""
    import json, sys
    pkg, data_dir, sys_dir, point = sys.argv[1:5]
    conf = {"hyperspace.tpu.distributed.enabled": "false",
            "hyperspace.tpu.execution.fusion.enabled": "false",
            "hyperspace.index.num.buckets": "4",
            "hyperspace.tpu.robustness.faults." + point: "kill"}
    if pkg == "jax":
        import hyperspace_tpu as mod
        s = mod.Session(conf=conf, system_path=sys_dir)
    else:
        import hyperspace_tpu_torch as mod
        s = mod.Session(conf=conf, system_path=sys_dir, device="cpu")
    hs = mod.Hyperspace(s)
    hs.create_index(s.read.parquet(data_dir), mod.IndexConfig("kx", ["k"], ["v"]))
    print("survived")
""")


@pytest.mark.parametrize("point", ["scan.parquet_decode", "io.pooled_read"])
def test_kill9_mid_create_then_recover(tmp_path, point):
    """A create killed at a read point leaves a transient log state; a
    fresh session's recover() rolls it back, and a new create serves the
    same answer, in both packages."""
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")

    def scenario(p, tmp):
        d = write(tmp / "d", seed=83)
        sys_dir = str(tmp / f"ix_{p.name}")
        proc = subprocess.run([sys.executable, str(child), p.name, d, sys_dir, point],
                              env=env, capture_output=True, text=True, timeout=300)
        killed = proc.returncode == -9
        s = p.session(tmp)
        summary = p.mod.Hyperspace(s).recover() if hasattr(p.mod.Hyperspace, "recover") \
            else None
        recovered = (sorted(summary.get("cancelled", [])), sorted(summary.get("vacuumed", {})))
        hs = p.mod.Hyperspace(s)
        hs.create_index(s.read.parquet(d), p.mod.IndexConfig("kx", ["k"], ["v"]))
        s.enable_hyperspace()
        q = s.read.parquet(d).filter(p.E.col("k") == 7).select("k", "v")
        return killed, recovered, ipc(q.to_arrow())

    j, t = both(tmp_path, scenario)
    assert j == t and j[0]
    assert j[1][0] == ["kx"]


# ---------------------------------------------------------------------------
# The SPMD -> single-device ladder (spmd.dispatch, placed with the mesh tier).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degrade", ["true", "false"])
def test_spmd_dispatch_fault_degrades_or_raises_as_jax(tmp_path, monkeypatch, degrade):
    """An armed ``spmd.dispatch`` on a one-device mesh (singleDevice=on in
    both packages): with degrade on, the same answer as unarmed, one
    ``degraded_spmd`` and a fallback event whose reason starts "fault:";
    with degrade off, the injected error. The same in both packages."""
    from hyperspace_tpu.execution import spmd as jspmd
    from hyperspace_tpu_torch.execution import spmd as tspmd
    monkeypatch.setattr(jspmd, "_device_count", lambda *a: 1)
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device("cpu")])
    d = write(tmp_path / "data")
    out = {}
    for p in PKGS:
        s = p.session(tmp_path / p.name, **{
            "hyperspace.tpu.distributed.enabled": "true",
            IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE: "on",
            IndexConstants.TPU_DISTRIBUTED_MIN_STREAM_ROWS: "0",
            RC.DEGRADE_ENABLED: degrade})
        want = ipc(query(p, s, d))
        capture_logger().events.clear()
        before = p.faults.stats()
        s.conf.set(fkey(p.FN.SPMD_DISPATCH), "error")
        try:
            got = ("answer", ipc(query(p, s, d)) == want)
        except Exception as e:
            got = ("error", type(e).__name__)
        after = p.faults.stats()
        reasons = [e.reason.split(":")[0] for e in capture_logger().events
                   if type(e).__name__ == "DistributedFallbackEvent"]
        out[p.name] = (got, after["degraded_spmd"] - before["degraded_spmd"],
                       after["injected"] - before["injected"], reasons)
    assert out["torch"] == out["jax"]
    if degrade == "true":
        assert out["torch"] == (("answer", True), 1, 1, ["fault"])
    else:
        assert out["torch"] == (("error", "InjectedFaultError"), 0, 1, [])
