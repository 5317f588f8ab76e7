"""The result line: exactly the keys a result line carries, the compared numbers last
beside their limits; no line and a non-zero exit without a CUDA device."""

import json
import os
import subprocess
import sys

from hsbench.tests import _cpu

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_untraced_line():
    r = _cpu.run("tpch_sf10.join_indexed", seed=2 ** 33 + 3)
    assert list(r) == KEYS
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "queries_per_s", "query_p95_ms", "query_p50_ms"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_traced_line():
    r = _cpu.run("tpch_sql_sf2.streams", seed=31, trace=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # The CPU gives no device records: no device metric is read.
    assert "device_idle_pct" not in r["metrics"]
    assert {"sql_lower_ms", "plan_ms", "exec_host_ms"} <= set(r["metrics"])


def test_no_device_no_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "hsbench/run.py", "--workload",
                          "tpch_sf10.join_indexed", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
