"""Crash safety of the streaming tier and the fault-point registry
(``hyperspace_tpu_torch/robustness/``), against the JAX package's. The
oracles are the JAX package's ``tests/test_streaming.py``,
``tests/test_streaming_scale.py`` (kill -9 mid-commit and mid-wave) and
``tests/test_crash_recovery.py``.

A child process of each package, with ``uuid.uuid4`` seeded as in the
parent, makes a healthy commit and dies by SIGKILL at ``ingest.stage``
(while staging) or ``ingest.publish`` (mid-commit, one batch or a 4-batch
wave). The parent's ``recover()`` then rolls the wreck back; the recover
summaries, the op logs, every file and the answers after recovery, and
after one more commit, equal the JAX package's.
"""

import os
import signal
import subprocess
import sys
import textwrap

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as ht
from hyperspace_tpu.robustness import faults as jfaults
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.constants import STABLE_STATES, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.robustness import fault_names as FN
from hyperspace_tpu_torch.robustness import faults as tfaults
from hyperspace_tpu_torch.streaming import ingest as tingest
from hyperspace_tpu_torch.streaming.constants import StreamingConstants as SC
from test_torch_streaming import (BASE_CONF, Side, assert_same, frame, lake_files,
                                  lake_logs, rng_of, run_both)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The child: the lake's session of one package, uuids seeded as in the
# parent; a healthy commit, then the armed kill.
CHILD = textwrap.dedent("""
    import json, os, random, sys, types, uuid
    import numpy as np
    import pandas as pd

    pkg, point, spec, wave, data_dir, sys_dir, conf = sys.argv[1:8]
    if pkg == "jax":
        import hyperspace_tpu as mod
        from hyperspace_tpu.streaming import ingest
        session = mod.Session(conf=json.loads(conf), system_path=sys_dir)
    else:
        import hyperspace_tpu_torch as mod
        from hyperspace_tpu_torch.streaming import ingest
        session = mod.Session(conf=json.loads(conf), system_path=sys_dir, device="cpu")
    rnd = random.Random(99)
    ingest.uuid = types.SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=rnd.getrandbits(128), version=4))
    hs = mod.Hyperspace(session)
    rng = np.random.default_rng(41)

    def frame(n):
        return pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int64),
                             "v": rng.integers(0, 9, n).astype(np.int64)})

    hs.append(data_dir, frame(150))
    hs.commit(data_dir)
    for _ in range(int(wave)):
        hs.append(data_dir, frame(200))
    session.conf.set("hyperspace.tpu.robustness.faults." + point, spec)
    if point == "ingest.stage":
        hs.append(data_dir, frame(99))
    else:
        hs.commit(data_dir)
    print("CHILD-SURVIVED")
""")


def run_child(side, point, spec, wave):
    import json
    script = os.path.join(os.path.dirname(side.root), f"child_{side.pkg}.py")
    with open(script, "w") as f:
        f.write(CHILD)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, script, side.pkg, point, spec, str(wave), side.data, side.sys,
         json.dumps(BASE_CONF)],
        env=env, capture_output=True, text=True, timeout=420, cwd=ROOT)


@pytest.mark.parametrize("point,wave", [("ingest.publish", 1), ("ingest.stage", 1),
                                        ("ingest.publish", 4)])
def test_kill9_then_recover_matches(tmp_path, point, wave):
    """kill -9 at the point; recover(); the lake serves exactly the
    pre-crash commits, a second recover() and compact() change nothing,
    and ingestion goes on; all equal to the JAX package's."""

    def scenario(side):
        proc = run_child(side, point, "kill:nth=1", wave)
        assert proc.returncode == -signal.SIGKILL, \
            f"rc={proc.returncode}\n{proc.stdout}\n{proc.stderr[-3000:]}"
        assert "CHILD-SURVIVED" not in proc.stdout
        mgr = side.mod.index.log_manager.IndexLogManager(
            side.ingest.table_log_dir(side.session, side.data))
        tip = mgr.get_latest_log().state
        summary = side.hs.recover()
        summary.pop("artifacts")
        files = len(side.session.read.parquet(side.data).plan.relation.all_files())
        assert mgr.get_latest_log().state in STABLE_STATES
        assert not os.listdir(os.path.join(side.data, SC.STAGING_DIR)) \
            if os.path.isdir(os.path.join(side.data, SC.STAGING_DIR)) else True
        answer = side.answers()
        again = side.hs.recover()
        compacted = side.hs.compact(None)
        compacted.pop("artifacts")
        assert side.answers() == answer
        for _ in range(wave):
            side.hs.append(side.data, frame(rng_of(77), 120))
        after = side.hs.commit(side.data)
        return {"tip": tip, "recover": summary, "files": files, "answer": answer,
                "again": again["streaming"], "compact": compacted,
                "committed": after["committed_batches"], "final": side.answers(),
                "logs": lake_logs(side), "lake": lake_files(side)}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    t = out["torch"]
    key = tingest.table_key(str(tmp_path / "lake" / "tbl"))
    assert t["files"] == 2 and t["committed"] == wave
    assert t["recover"]["streaming"]["staging_swept"] >= 1 and not t["recover"]["errors"]
    assert not t["again"]["rolled_back"] and t["again"]["staging_swept"] == 0
    if point == "ingest.publish":
        assert t["tip"] == States.REFRESHING and key in t["recover"]["streaming"]["rolled_back"]
    assert_same(out)


# ---------------------------------------------------------------------------
# The action fault points, in process.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point,spec,action", [
    ("action.op", "error:nth=1", "create"),
    ("log.write", "error:nth=2", "create"),
    ("log.stable", "error:nth=1", "create"),
    ("log.write", "error:nth=2,exc=OSError", "refresh"),
    ("action.op", "error:nth=1", "refresh"),
])
def test_action_fault_then_recover_matches(tmp_path, point, spec, action):
    """An error at an op-log boundary of create or an incremental refresh
    leaves the wreck the JAX package's leaves (a transient OSError at
    log.write is retried instead); recover() rolls it back (or keeps a
    committed final entry), and the action run again ends as in the JAX
    package."""

    def scenario(side):
        t = side.session.read.parquet(side.data)
        cfg = side.mod.IndexConfig("cx", ["k"], ["v"])

        def act():
            if action == "create":
                side.hs.create_index(side.session.read.parquet(side.data), cfg)
            else:
                side.hs.refresh_index("cx", "incremental")

        if action == "refresh":
            side.hs.create_index(t, cfg)
            pq.write_table(pa.Table.from_pandas(frame(rng_of(5), 300)),
                           os.path.join(side.data, "extra.parquet"))
        key = "hyperspace.tpu.robustness.faults." + point
        side.session.conf.set(key, spec)
        try:
            act()
            raised = None
        except Exception as err:
            raised = f"{type(err).__name__}: {err}"
        side.session.conf.unset(key)
        summary = side.hs.recover()
        summary.pop("artifacts")
        entry = side.session.index_collection_manager.get_index("cx")
        state = entry.state if entry is not None else None
        try:
            act()
            again = "done"
        except Exception as err:
            again = f"{type(err).__name__}: {err}"
        return {"raised": raised, "recover": summary,
                "state": state, "again": again, "answer": side.answers(),
                "logs": lake_logs(side), "files": lake_files(side)}

    out = run_both(tmp_path, scenario, base=True, indexes=())
    # A transient OSError at log.write is retried; every other armed error
    # fails the action.
    assert (out["torch"]["raised"] is None) == spec.endswith("exc=OSError")
    assert_same(out)


# ---------------------------------------------------------------------------
# The fault registry.
# ---------------------------------------------------------------------------

SPECS = ["error", "error:nth=2", "error:exc=OSError,times=1", "transient:p=0.5",
         "latency:ms=3", "kill:nth=4", "error:p=2,times=-1,nth=0"]
BAD = [("ingest.stage", "explode"), ("ingest.stage", "error:nth"),
       ("ingest.stage", "error:bogus=1"), ("ingest.stage", "error:exc=KeyError"),
       ("nope.point", "error")]
# The reference's point the port refuses by design (ROADMAP queue C 14):
# the mesh program compile, which eager torch has no site for.
# spmd.dispatch came with the mesh tier, the program bank's and the
# artifact store's points with those modules; each is accepted as the JAX
# package accepts it.
REFUSED_BY_DESIGN = ("spmd.compile",)
PLACED_WITH_THE_MESH_TIER = ("spmd.dispatch", "bank.compile", "artifacts.write",
                             "artifacts.read")
BAD += [(name, "error") for name in PLACED_WITH_THE_MESH_TIER + REFUSED_BY_DESIGN]


@pytest.mark.parametrize("raw", SPECS)
def test_spec_parse_matches(raw):
    got = tfaults.FaultSpec.parse(FN.INGEST_PUBLISH, raw)
    want = jfaults.FaultSpec.parse("ingest.publish", raw)
    assert [getattr(got, k) for k in got.__slots__] == [getattr(want, k) for k in want.__slots__]


@pytest.mark.parametrize("name,raw", BAD)
def test_bad_spec_refused_as_jax(name, raw):
    if name in PLACED_WITH_THE_MESH_TIER:
        got, want = tfaults.FaultSpec.parse(name, raw), jfaults.FaultSpec.parse(name, raw)
        assert [getattr(got, k) for k in got.__slots__] == \
            [getattr(want, k) for k in want.__slots__]
        return
    with pytest.raises(HyperspaceException) as got:
        tfaults.FaultSpec.parse(name, raw)
    if name in REFUSED_BY_DESIGN:
        jfaults.FaultSpec.parse(name, raw)  # the JAX package arms it
        assert "Unknown fault point" in str(got.value)
        return
    with pytest.raises(Exception) as want:
        jfaults.FaultSpec.parse(name, raw)
    if name in FN.FAULT_NAMES:
        assert str(got.value) == str(want.value)
    else:
        assert "Unknown fault point" in str(got.value)


def test_registry_counts_and_fires():
    reg = tfaults.FaultRegistry.from_conf_specs({FN.LOG_WRITE: "error:nth=2",
                                                 FN.LOG_STABLE: "transient:times=1",
                                                 FN.ACTION_OP: "latency:ms=1"})
    before = tfaults.stats()["injected"]
    with tfaults.scope(reg):
        tfaults.fault_point(FN.LOG_WRITE)
        with pytest.raises(tfaults.InjectedFaultError):
            tfaults.fault_point(FN.LOG_WRITE)
        tfaults.fault_point(FN.LOG_WRITE)
        with pytest.raises(tfaults.TransientInjectedFaultError):
            tfaults.fault_point(FN.LOG_STABLE)
        tfaults.fault_point(FN.LOG_STABLE)
        tfaults.fault_point(FN.ACTION_OP)
        tfaults.fault_point(FN.INGEST_STAGE)  # not armed
    tfaults.fault_point(FN.LOG_WRITE)  # disarmed outside the scope
    assert reg.hit_count(FN.LOG_WRITE) == 3 and reg.hit_count(FN.INGEST_STAGE) == 0
    assert tfaults.stats()["injected"] - before == 3


def test_scope_for_arms_from_conf_only_when_set(tmp_path):
    s = ht.Session(system_path=str(tmp_path / "ix"), device="cpu")
    with tfaults.scope_for(s.hs_conf) as reg:
        assert reg is None and tfaults.armed() is None
    s.conf.set("hyperspace.tpu.robustness.faults.ingest.stage", "error:nth=3")
    with tfaults.scope_for(s.hs_conf) as reg:
        assert tfaults.armed() is reg and reg.hit_count(FN.INGEST_STAGE) == 0
    assert tfaults.armed() is None
    assert s.hs_conf.robustness_fault_specs() == {"ingest.stage": "error:nth=3"}


def test_faulted_stage_leaves_nothing_staged(tmp_path):
    """An error at ingest.stage: append raises, no staging file or queued
    batch remains, and the next append and commit go through."""
    side = Side("torch", tmp_path, indexes=("cx",))
    key = "hyperspace.tpu.robustness.faults.ingest.stage"
    side.session.conf.set(key, "error:nth=1")
    with pytest.raises(tfaults.InjectedFaultError):
        side.hs.append(side.data, frame(rng_of(3), 30))
    assert not os.listdir(os.path.join(side.data, SC.STAGING_DIR))
    assert tingest.get_queue().staged_count(os.path.abspath(side.data)) == 0
    side.session.conf.unset(key)
    side.hs.append(side.data, frame(rng_of(4), 30))
    assert side.hs.commit(side.data)["indexes_updated"] == ["cx"]
    mgr = IndexLogManager(os.path.join(side.sys, "cx"))
    assert mgr.get_latest_stable_log().state == States.ACTIVE
