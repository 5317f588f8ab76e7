"""A cell, a configuration, a query template and a per-layer metric are
added as files alone: the harness, copied unchanged into a temporary
checkout, finds each by its name."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(HERE, tmp_path / "hsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "hsbench"
    config = json.load(open(b / "configs" / "tpch_sf10_covering.json"))
    config["name"] = "tpch_sf1_covering"
    config["scale"] = 1
    (b / "configs" / "tpch_sf1_covering.json").write_text(json.dumps(config))
    work = json.load(open(b / "workloads" / "tpch_sf10.join_indexed.json"))
    work.update(name="tpch_sf1.orders_point", config="tpch_sf1_covering",
                traffic="orders_point")
    work["mix"] = [{"template": "od_point", "weight": 1, "indexes": ["od_idx"],
                    "params": {"key": {"int": [1, 100]}},
                    "sample": {"rate": 1.0, "params": 4}}]
    (b / "workloads" / "tpch_sf1.orders_point.json").write_text(json.dumps(work))
    (b / "queries" / "od_point.py").write_text(textwrap.dedent('''
        COLUMNS = ["o_orderkey", "o_orderdate"]
        FLOATS = ()
        ORDERED = False
        READS = {"orders": COLUMNS}

        def build(session, dirs, p):
            from hyperspace_tpu_torch import col
            return (session.read.parquet(dirs["orders"])
                    .filter(col("o_orderkey") == int(p["key"])).select(*COLUMNS))

        def reference(ref, p, fdt):
            rows = ref.col("orders", "o_orderkey") == int(p["key"])
            return {c: ref.col("orders", c)[rows] for c in COLUMNS}
    '''))
    (b / "metrics" / "orders_seen.py").write_text(
        "def read(r):\n    return float(len(r.queries)) or None\n")
    bench["per_layer"].append({"name": "orders_seen", "unit": "queries", "better": "higher",
                               "source": "host_clock", "layer": "serving",
                               "moves": "queries_per_s",
                               "workloads": ["tpch_sf1.orders_point"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = textwrap.dedent('''
        import json, sys
        sys.path[0:0] = [sys.argv[1], sys.argv[2]]
        from hsbench import harness, metrics
        work, config = harness.load_cell("tpch_sf1.orders_point")
        t = harness.template(work["mix"][0]["template"])
        print(json.dumps({"config": config["name"], "template": t.__name__,
                          "file": t.__file__, "metrics": metrics.names(),
                          "cell_metrics": [m["name"] for m in
                                           harness.cell_metrics("tpch_sf1.orders_point", True)]}))
    ''')
    # The copy comes first on the path; the port is found at the real root.
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path), ROOT],
                         capture_output=True, text=True, check=True, cwd=tmp_path)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "tpch_sf1_covering"
    assert got["template"] == "hsbench.queries.od_point"
    assert got["file"].startswith(str(tmp_path))
    assert "orders_seen" in got["metrics"]
    assert "orders_seen" in got["cell_metrics"]
