"""The streaming tier at width (``hyperspace_tpu_torch/streaming/``): group
commit, blocking backpressure, standing-query fan-out and continuous
sources. The oracle is the JAX package's ``tests/test_streaming_scale.py``;
sequences whose batch order is deterministic run through both packages as
in ``test_torch_streaming.py`` (one lake path, seeded uuids) and are
compared exactly. Same-template subscriptions fire as one wave over one
shared scan with each member's own mask (the port's serving batch; the JAX
package's stacked ``sweep_invocations`` pass has no counterpart).
"""

import json
import os
import threading
import time

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as ht
from hyperspace_tpu.plan.expr import sum_ as jsum
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.robustness import fault_names as FN
from hyperspace_tpu_torch.streaming import ingest as tingest
from hyperspace_tpu_torch.streaming.constants import StreamingConstants as SC
from hyperspace_tpu_torch.streaming.sources import DirectoryTailSource, LogTailSource
from test_torch_streaming import (Side, assert_same, delivery_table, frame, fresh_frontend,
                                  lake_logs, rng_of, run_both, summary_of)
from test_torch_streaming import _close_frontends  # noqa: F401  (autouse fixture)


def count_log_files(path):
    from hyperspace_tpu_torch.index.constants import IndexConstants
    log = os.path.join(path, IndexConstants.HYPERSPACE_LOG)
    return len([n for n in os.listdir(log) if n.isdigit()])


def concurrent_commits(hs, data, n, timeout=180.0):
    """n commit() callers released together: (results, errors)."""
    results, errors = [None] * n, []
    barrier = threading.Barrier(n)

    def run(i):
        try:
            barrier.wait(30)
            results[i] = hs.commit(data)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "commit hung"
    return results, errors


def wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# Group commit.
# ---------------------------------------------------------------------------

def test_sixteen_committers_one_wave_one_log_entry(tmp_path):
    """16 batches staged, 16 commit() callers released together: one wave,
    one sub-wave, one commit's worth of log entries in the table's log and
    the index's, riders marked; logs, files and answers equal the JAX
    package's."""

    def scenario(side):
        rng = rng_of(31)
        side.hs.append(side.data, frame(rng, 60))
        side.hs.commit(side.data)
        tbl_log = side.ingest.table_log_dir(side.session, side.data)
        idx_log = os.path.join(side.sys, "cx")
        for _ in range(16):
            side.hs.append(side.data, frame(rng, 60))
        before = side.ingest.get_coordinator().stats()
        t1, i1 = count_log_files(tbl_log), count_log_files(idx_log)
        results, errors = concurrent_commits(side.hs, side.data, 16)
        assert not errors, errors
        after = side.ingest.get_coordinator().stats()
        deltas = {k: after[k] - before[k] for k in ("commit_calls", "waves", "sub_waves",
                                                    "wave_batches")}
        assert after["joined"] > before["joined"]
        assert any(r.get("joined_wave") for r in results)
        assert sum(r["committed_batches"] for r in results if not r.get("joined_wave")) == 16
        full = next(r for r in results if r["committed_batches"] == 16)
        return {"deltas": deltas, "entries": [count_log_files(tbl_log) - t1,
                                              count_log_files(idx_log) - i1],
                "full": {k: v for k, v in summary_of(full).items() if k != "joined_wave"},
                "answer": side.answers(), "logs": lake_logs(side)}

    out = run_both(tmp_path, scenario, indexes=("cx",))
    assert out["torch"]["deltas"] == {"commit_calls": 16, "waves": 1, "sub_waves": 1,
                                      "wave_batches": 16}
    assert out["torch"]["entries"] == [2, 2]
    assert_same(out)


def test_deep_queue_drains_in_bounded_sub_waves(tmp_path):
    def scenario(side):
        rng = rng_of(37)
        side.hs.append(side.data, frame(rng, 40))
        side.hs.commit(side.data)
        tbl_log = side.ingest.table_log_dir(side.session, side.data)
        for _ in range(8):
            side.hs.append(side.data, frame(rng, 40))
        before = side.ingest.get_coordinator().stats()
        t1 = count_log_files(tbl_log)
        out = summary_of(side.hs.commit(side.data))
        after = side.ingest.get_coordinator().stats()
        return {"commit": out, "waves": [after[k] - before[k] for k in ("waves", "sub_waves")],
                "entries": count_log_files(tbl_log) - t1, "logs": lake_logs(side),
                "answer": side.answers()}

    out = run_both(tmp_path, scenario, conf={SC.GROUP_COMMIT_MAX_WAVE: "4"}, indexes=("cx",))
    t = out["torch"]
    assert t["commit"]["committed_batches"] == 8 and t["commit"]["sub_waves"] == 2
    assert t["waves"] == [1, 2] and t["entries"] == 4
    assert_same(out)


def test_group_commit_off_matches_and_answers_as_a_wave(tmp_path):
    """Group commit off: one entry pair per commit, no coordinator call,
    equal to the JAX package's; the same batches committed as one wave
    answer byte for byte alike."""
    frames = [frame(rng_of(100 + i), 60) for i in range(8)]

    def scenario(side):
        before = side.ingest.get_coordinator().stats()["commit_calls"]
        outs = []
        for f in frames:
            side.hs.append(side.data, f)
            outs.append(summary_of(side.hs.commit(side.data)))
        assert side.ingest.get_coordinator().stats()["commit_calls"] == before
        return {"commits": outs, "answer": side.answers(), "logs": lake_logs(side)}

    out = run_both(tmp_path, scenario, conf={SC.GROUP_COMMIT_ENABLED: "false"}, indexes=("cx",))
    assert all(c["committed_batches"] == 1 and "joined_wave" not in c
               for c in out["torch"]["commits"])
    assert_same(out)

    on = Side("torch", tmp_path / "on", indexes=("cx",))
    for f in frames:
        on.hs.append(on.data, f)
    results, errors = concurrent_commits(on.hs, on.data, 8)
    assert not errors and max(r["committed_batches"] for r in results) == 8
    assert on.answers()[1].equals(out["torch"]["answer"][1])


# ---------------------------------------------------------------------------
# Blocking backpressure.
# ---------------------------------------------------------------------------

def test_blocked_append_parks_until_commit_frees(tmp_path):
    side = Side("torch", tmp_path, conf={SC.MAX_STAGED_BATCHES: "1"}, indexes=())
    side.hs.append(side.data, frame(rng_of(51), 40))
    done, caught = threading.Event(), []

    def blocked():
        try:
            side.hs.append(side.data, frame(rng_of(52), 40), block=True)
        except Exception as e:
            caught.append(e)
        finally:
            done.set()

    t = threading.Thread(target=blocked)
    start = time.monotonic()
    t.start()
    time.sleep(0.3)
    assert not done.is_set(), "append did not wait on a full budget"
    side.hs.commit(side.data)
    t.join(60)
    assert done.is_set() and not caught, caught
    assert time.monotonic() - start >= 0.25
    assert side.hs.commit(side.data)["committed_batches"] == 1


def test_blocked_append_times_out(tmp_path):
    side = Side("torch", tmp_path, conf={SC.MAX_STAGED_BATCHES: "1",
                                         SC.BACKPRESSURE_TIMEOUT_MS: "200"}, indexes=())
    side.hs.append(side.data, frame(rng_of(53), 40))
    with pytest.raises(HyperspaceException, match="timed out"):
        side.hs.append(side.data, frame(rng_of(54), 40), block=True)
    assert side.hs.commit(side.data)["committed_batches"] == 1


def test_default_stays_raise_on_full(tmp_path):
    side = Side("torch", tmp_path, conf={SC.MAX_STAGED_BATCHES: "1"}, indexes=())
    side.hs.append(side.data, frame(rng_of(55), 40))
    t0 = time.monotonic()
    with pytest.raises(HyperspaceException, match="maxStagedBatches"):
        side.hs.append(side.data, frame(rng_of(56), 40))
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# Standing-query fan-out.
# ---------------------------------------------------------------------------

SUMS = {"jax": jsum, "torch": ht.sum_}


def variant(side, i):
    return (side.session.read.parquet(side.data).filter(side.col("k") < (i % 37) + 2)
            .group_by("k").agg(SUMS[side.pkg](side.col("v")).alias("sv")).sort("k"))


@pytest.mark.parametrize("n", [10, 100])
def test_fanout_one_shared_scan_exactly_once(tmp_path, n):
    """n same-template subscriptions, one commit: one batch of n members over
    one shared scan, one wave group, each subscription delivered once with
    its own literal's rows, equal to the same plan submitted ad hoc."""
    side = Side("torch", tmp_path, conf={SC.SUBSCRIPTIONS_MAX: "1200"}, indexes=())
    front = fresh_frontend(side)
    subs = [front.subscribe(variant(side, i)) for i in range(n)]
    before = front.stats()
    side.hs.append(side.data, frame(rng_of(61), 300))
    assert side.hs.commit(side.data)["subscriptions_fired"] == n
    for sub in subs:
        ds = sub.wait_for(1, timeout=180.0)
        assert len(ds) == 1 and ds[0].ok, ds[0].error
    wait_until(lambda: front.stats()["batches"] > before["batches"], 30.0, "batch counters")
    after = front.stats()
    assert {k: after[k] - before[k] for k in ("batches", "batched_queries", "shared_scans",
                                              "shared_scan_hits")} == \
        {"batches": 1, "batched_queries": n, "shared_scans": 1, "shared_scan_hits": n - 1}
    regs, regs0 = after["subscriptions"], before["subscriptions"]
    assert {k: regs[k] - regs0[k] for k in ("wave_groups", "wave_members", "fired_queries",
                                            "rejected_queries")} == \
        {"wave_groups": 1, "wave_members": n, "fired_queries": n, "rejected_queries": 0}
    assert all(s.delivered_total == 1 for s in subs)
    for i in (0, n // 2, n - 1):
        want = front.submit(variant(side, i)).result(timeout=120.0).to_arrow()
        assert subs[i].latest(timeout=10.0).result.to_arrow().equals(want)


def test_fanout_deliveries_and_counters_equal_jax(tmp_path):
    """Two templates and a lone plan on one table: one wave per template
    group, the lone plan alone; every delivery and the registry's counters
    equal the JAX package's."""

    def scenario(side):
        front = fresh_frontend(side)
        subs = [front.subscribe(variant(side, i)) for i in range(4)]
        subs += [front.subscribe(side.session.read.parquet(side.data)
                                 .filter(side.col("k") == i).select("k", "v")) for i in range(3)]
        subs.append(front.subscribe(side.session.read.parquet(side.data).group_by("v")
                                    .agg(SUMS[side.pkg](side.col("k")).alias("sk")).sort("v")))
        side.hs.append(side.data, frame(rng_of(63), 100))
        fired = side.hs.commit(side.data)["subscriptions_fired"]
        deliveries = [delivery_table(s.wait_for(1, timeout=120.0)[0]) for s in subs]
        front.drain()
        regs = front.stats()["subscriptions"]
        return {"fired": fired, "deliveries": deliveries,
                "regs": {k: regs[k] for k in ("fires", "fired_queries", "rejected_queries",
                                              "wave_groups", "wave_members", "live")}}

    out = run_both(tmp_path, scenario, indexes=())
    assert out["torch"]["regs"]["wave_groups"] == 2 and out["torch"]["regs"]["wave_members"] == 7
    assert out["torch"]["fired"] == 8
    assert_same(out)


def test_batching_off_falls_back_to_singles(tmp_path):
    side = Side("torch", tmp_path, indexes=())
    front = fresh_frontend(side, **{"hyperspace.tpu.serving.batching.enabled": "false"})
    subs = [front.subscribe(variant(side, i)) for i in range(6)]
    before = front.stats()
    side.hs.append(side.data, frame(rng_of(62), 100))
    assert side.hs.commit(side.data)["subscriptions_fired"] == 6
    for sub in subs:
        assert sub.wait_for(1, timeout=120.0)[0].ok
    front.drain()
    after = front.stats()
    assert after["subscriptions"]["wave_groups"] == before["subscriptions"]["wave_groups"]
    assert after["batches"] == before["batches"]


# ---------------------------------------------------------------------------
# Continuous sources.
# ---------------------------------------------------------------------------

def drop(watch, name, df):
    tmp = os.path.join(watch, name + ".tmp")
    pq.write_table(pa.Table.from_pandas(df), tmp)
    os.replace(tmp, os.path.join(watch, name))


def source_side(tmp_path, **conf):
    conf.setdefault(SC.SOURCE_POLL_MS, "20")
    return Side("torch", tmp_path, conf=conf, indexes=())


def test_directory_tail_ingests_and_commits(tmp_path):
    side = source_side(tmp_path, **{SC.SOURCE_COMMIT_BATCHES: "2"})
    watch = str(tmp_path / "drop")
    os.makedirs(watch)
    frames = [frame(rng_of(80 + i), 30) for i in range(5)]
    for i, f in enumerate(frames):
        drop(watch, f"b{i}.parquet", f)
    src = side.hs.tail_directory(watch, side.data)
    try:
        wait_until(lambda: src.stats()["batches"] == 5, msg="5 batches tailed")
        assert src.running()
    finally:
        out = src.stop(drain=True)
    assert out["commits"] >= 3 and out["errors"] == 0 and out["pending"] == 0
    assert out["pauses"] == 0 and not src.running()
    assert side.session.read.parquet(side.data).count() == 2000 + 150


def test_log_tail_consumes_only_complete_lines(tmp_path):
    side = source_side(tmp_path)
    log = str(tmp_path / "events.jsonl")
    with open(log, "w") as f:
        f.write("\n".join(json.dumps({"k": i % 40, "v": i % 9}) for i in range(6)) + "\n")
        f.write('{"k": 3, "v"')  # mid-write
    src = side.hs.tail_log(log, side.data)
    try:
        wait_until(lambda: src.stats()["rows"] == 6, msg="complete lines tailed")
        time.sleep(0.2)
        assert src.stats()["rows"] == 6
        with open(log, "a") as f:
            f.write(': 5}\n')
        wait_until(lambda: src.stats()["rows"] == 7, msg="completed line tailed")
    finally:
        src.stop(drain=True)
    assert side.session.read.parquet(side.data).count() == 2007


def test_source_survives_injected_faults(tmp_path):
    side = source_side(tmp_path)
    side.session.conf.set("hyperspace.tpu.robustness.faults." + FN.STREAMING_SOURCE,
                          "error:times=2")
    watch = str(tmp_path / "drop")
    os.makedirs(watch)
    drop(watch, "b0.parquet", frame(rng_of(85), 30))
    src = DirectoryTailSource(side.session, watch, side.data).start()
    try:
        wait_until(lambda: src.stats()["batches"] == 1, msg="batch landed despite faults")
        assert src.stats()["errors"] == 2 and src.running()
    finally:
        out = src.stop(drain=True)
    assert out["errors"] == 2


def test_blocked_source_frees_on_external_commit(tmp_path):
    side = source_side(tmp_path, **{SC.MAX_STAGED_BATCHES: "2", SC.SOURCE_COMMIT_BATCHES: "100"})
    watch = str(tmp_path / "drop")
    os.makedirs(watch)
    for i in range(3):
        drop(watch, f"b{i}.parquet", frame(rng_of(87 + i), 30))
    src = DirectoryTailSource(side.session, watch, side.data).start()
    try:
        wait_until(lambda: tingest.get_queue().staged_count(os.path.abspath(side.data)) >= 2,
                   msg="budget filled")
        side.hs.commit(side.data)
        wait_until(lambda: src.stats()["batches"] == 3, msg="tail resumed after commit")
    finally:
        out = src.stop(drain=True)
    assert out["waits"] >= 1
    assert side.session.read.parquet(side.data).count() == 2000 + 90


def test_sources_need_streaming_enabled(tmp_path):
    side = source_side(tmp_path, **{SC.ENABLED: "false"})
    with pytest.raises(HyperspaceException, match="streaming.enabled"):
        LogTailSource(side.session, str(tmp_path / "x.jsonl"), side.data).start()
