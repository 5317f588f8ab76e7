"""The streaming tier on TPC-H lakes, through both packages' public entry
points, compared exactly (one lake path and seeded uuids, as in
``test_torch_streaming.py``):

- TPC-H Q3 after several append/commit rounds into lineitem and orders:
  each bucket of li_idx and od_idx then holds several files, and the
  bucketed merge join must still order rows within a bucket across them;
  plans (two IndexScans under one join, no hybrid note), answers bit for
  bit, indexed equal to scanned.
- chip_smoke.py's streaming path at a small scale: TPC-H RF1 refreshes
  (``chip_smoke.rf1_tables``) into the sql lake, four batches committed
  by four threads as one wave, orders with two sketch indexes, and four
  standing Q6 queries; commit summaries, op logs, every file, each
  delivery bit for bit, and each delivery within 1e-9 of the numpy
  reference.
"""

import datetime
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

import bench
import chip_smoke
import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu_torch.plan.nodes import IndexScan, Join
from test_torch_streaming import (PKGS, assert_same, fresh_frontend, lake_files, lake_logs,
                                  seeded_uuids, summary_of)
from test_torch_streaming import _close_frontends  # noqa: F401  (autouse fixture)

CONF = {"hyperspace.tpu.distributed.enabled": "false",
        "hyperspace.tpu.execution.fusion.enabled": "false",
        "hyperspace.index.numBuckets": "8",
        "hyperspace.tpu.streaming.groupCommit.windowMs": "50"}


class TpchSide:
    """One package's session over a TPC-H lake under ``root``."""

    def __init__(self, pkg, root):
        self.pkg = pkg
        self.mod, self.col, self.ingest, self.frontend = PKGS[pkg]
        self.root = str(root)
        self.sys = os.path.join(self.root, "indexes")
        self.data = ""
        if pkg == "torch":
            self.session = ht.Session(conf=dict(CONF), system_path=self.sys, device="cpu")
        else:
            self.session = hst.Session(conf=dict(CONF), system_path=self.sys)
        self.hs = self.mod.Hyperspace(self.session)


def run_both(tmp_path, scenario):
    out = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / "lake"
        with seeded_uuids(PKGS[pkg][2]):
            out[pkg] = scenario(TpchSide(pkg, root))
        os.rename(root, tmp_path / pkg)
    return out


def schema_of(d):
    return pq.read_schema(os.path.join(d, sorted(f for f in os.listdir(d)
                                                 if f.endswith(".parquet"))[0]))


def q3_batches(li_dir, od_dir, first_key, n, seed):
    """n new orders (half placed before Q3's cutoff) and 1-7 lineitems each
    (half shipped after it), some lines against existing orders."""
    rng = np.random.default_rng(seed)
    base = (datetime.date(1992, 1, 1) - chip_smoke.EPOCH).days
    keys = np.arange(first_key, first_key + n, dtype=np.int64)
    orders = pa.table({
        "o_orderkey": pa.array(keys),
        "o_custkey": pa.array(rng.integers(0, 300, n).astype(np.int64)),
        "o_orderdate": pa.array((rng.integers(0, 2400, n) + base).astype(np.int32),
                                type=pa.int32()).cast(pa.date32()),
        "o_shippriority": pa.array(np.zeros(n, dtype=np.int32)),
        "o_totalprice": pa.array(np.round(rng.uniform(1000, 400000, n), 2))})
    lk = np.concatenate([np.repeat(keys, rng.integers(1, 8, n)),
                         rng.integers(0, first_key, n).astype(np.int64)])
    m = lk.shape[0]
    lineitem = pa.table({
        "l_orderkey": pa.array(lk),
        "l_partkey": pa.array(rng.integers(0, 400, m).astype(np.int64)),
        "l_quantity": pa.array(rng.integers(1, 51, m).astype(np.int64)),
        "l_extendedprice": pa.array(np.round(rng.uniform(900, 105000, m), 2)),
        "l_discount": pa.array(np.round(rng.uniform(0, 0.1, m), 2)),
        "l_shipdate": pa.array((rng.integers(0, 2520, m) + base).astype(np.int32),
                               type=pa.int32()).cast(pa.date32())})
    return orders.cast(schema_of(od_dir)), lineitem.cast(schema_of(li_dir))


def test_q3_after_commits_matches(tmp_path):
    """Three rounds of appends to lineitem and orders, each committed: Q3
    joins two exact IndexScans on the bucket spec (each bucket now several
    files), equals the JAX package's bit for bit, and the scanned run within
    1e-9 relative."""

    def scenario(side):
        li_dir, od_dir, _, _, n_od = bench.make_tpch_like(os.path.join(side.root, "data"), 0.002)
        for name, d, indexed, included in (
                ("li_idx", li_dir, ["l_orderkey"], ["l_extendedprice", "l_discount",
                                                     "l_shipdate"]),
                ("od_idx", od_dir, ["o_orderkey"], ["o_custkey", "o_orderdate",
                                                     "o_shippriority"])):
            side.hs.create_index(side.session.read.parquet(d),
                                 side.mod.IndexConfig(name, indexed, included))
        commits, key = [], n_od
        for r in range(3):
            od, li = q3_batches(li_dir, od_dir, key, 150, 300 + r)
            key += 150
            for part in (li.slice(0, li.num_rows // 2), li.slice(li.num_rows // 2)):
                side.hs.append(li_dir, part)
            side.hs.append(od_dir, od)
            commits += [summary_of(side.hs.commit(li_dir)), summary_of(side.hs.commit(od_dir))]
        build = bench.build_q3 if side.pkg == "jax" else chip_smoke.build_q3
        df = build(side.session, li_dir, od_dir)
        side.session.enable_hyperspace()
        plan = df.optimized_plan()
        indexed = df.to_arrow()
        side.session.disable_hyperspace()
        scanned = df.to_arrow()
        # Indexed and scanned sum the revenue in other row orders: keys
        # exact, sums within 1e-9 relative (chip_smoke.REL_TOL).
        assert indexed.num_rows == 10
        assert indexed.drop(["revenue"]).equals(scanned.drop(["revenue"]))
        np.testing.assert_allclose(indexed.column("revenue").to_numpy(),
                                   scanned.column("revenue").to_numpy(),
                                   rtol=chip_smoke.REL_TOL, atol=0)
        entry = side.session.index_collection_manager.get_index("li_idx")
        per_bucket = {}
        for f in entry.content.files:
            b = os.path.basename(f)[:10]
            per_bucket[b] = per_bucket.get(b, 0) + 1
        return {"commits": commits, "plan": plan.tree_string(), "plan_obj": plan,
                "indexed": indexed, "files_per_bucket": max(per_bucket.values()),
                "logs": lake_logs(side), "files": lake_files(side)}

    out = run_both(tmp_path, scenario)
    plan = out["torch"].pop("plan_obj")
    out["jax"].pop("plan_obj")
    joins = [n for n in _walk(plan) if isinstance(n, Join)]
    assert joins and any(all(isinstance(leaf, IndexScan) for leaf in j.collect_leaves())
                         for j in joins), plan.tree_string()
    assert "hybrid(" not in out["torch"]["plan"]
    assert out["torch"]["files_per_bucket"] == 7  # the build and two batches a round
    assert [c["indexes_updated"] for c in out["torch"]["commits"]] == [["li_idx"], ["od_idx"]] * 3
    assert_same(out)


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


SQL_INDEXES = [("lineitem", "sql_li_ship", ["l_shipdate"],
                ["l_extendedprice", "l_discount", "l_quantity", "l_returnflag", "l_linestatus",
                 "l_tax"]),
               ("lineitem", "sql_li_pk", ["l_partkey"],
                ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate", "l_shipmode",
                 "l_shipinstruct"])]
PARAMS = chip_smoke.Q6_PARAMS[:4]


def test_rf1_rounds_with_standing_q6_match(tmp_path):
    """chip_smoke.py's streaming path at scale 0.002 in both packages."""

    def scenario(side):
        dirs, rows = chip_smoke.make_tpch_sql(os.path.join(side.root, "data"), 0.002)
        s, hs = side.session, side.hs
        for name in ("lineitem", "orders"):
            s.create_temp_view(name, s.read.parquet(dirs[name]))
        for table, name, indexed, included in SQL_INDEXES:
            hs.create_index(s.table(table), side.mod.IndexConfig(name, indexed, included))
        od = s.read.parquet(dirs["orders"])
        hs.create_index(od, side.mod.DataSkippingIndexConfig(
            "st_od_skip", [side.mod.MinMaxSketch("o_orderdate")]))
        hs.create_index(od, side.mod.DataSkippingIndexConfig(
            "st_od_bloom", [side.mod.BloomFilterSketch("o_orderkey", expected_items=4096)]))
        schemas = chip_smoke.table_schemas(dirs)
        texts = [chip_smoke.q6_text(*p) for p in PARAMS]
        li = chip_smoke._read(dirs["lineitem"], ["l_shipdate", "l_discount", "l_quantity",
                                                 "l_extendedprice"])
        totals = np.array([chip_smoke.q6_reference(
            *[chip_smoke._num(li, c) for c in li.column_names], *p)["revenue"][0]
            for p in PARAMS])
        s.enable_hyperspace()
        front = fresh_frontend(side)
        subs = [front.subscribe(s.sql(t)) for t in texts]
        obs = {"leaders": [], "orders": [], "deliveries": []}
        key = rows["orders"] + 1
        for r in range(2):
            od_b, li_b = chip_smoke.rf1_tables(rows, schemas, key, 40, 100 + r)
            key += 40
            totals = totals + np.array(_revenues(li_b))
            step = -(-li_b.num_rows // 4)
            for i in range(4):
                hs.append(dirs["lineitem"], li_b.slice(i * step, step))
            results = [None] * 4
            barrier = threading.Barrier(4)

            def commit(i):
                barrier.wait(60)
                results[i] = hs.commit(dirs["lineitem"])

            threads = [threading.Thread(target=commit, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            # One wave: one leader publishes all four batches; the others
            # rode it (or, arriving after it landed, found nothing left).
            leader = [x for x in results if not x.get("joined_wave") and x["committed_batches"]]
            assert len(leader) == 1 and leader[0]["committed_batches"] == 4, results
            obs["leaders"].append(summary_of(leader[0]))
            hs.append(dirs["orders"], od_b)
            obs["orders"].append(summary_of(hs.commit(dirs["orders"])))
            got = []
            for i, sub in enumerate(subs):
                sub.wait_for(r + 1, timeout=120)
                assert sub.delivered_total == r + 1
                table = sub.latest().result.to_arrow()
                chip_smoke.check_sql_answer("q6", table, {"revenue": np.array([totals[i]])},
                                            f"{side.pkg} round {r}")
                got.append(table)
            obs["deliveries"].append(got)
        s.create_temp_view("lineitem", s.read.parquet(dirs["lineitem"]), replace=True)
        adhoc = []
        for t, d in zip(texts, obs["deliveries"][-1]):
            df = s.sql(t)
            tree = df.optimized_plan().tree_string()
            assert "sql_li_ship" in tree and "hybrid(" not in tree, tree
            a = df.to_arrow()
            assert chip_smoke._same_bits(a, d)
            adhoc.append(a)
        s.disable_hyperspace()
        front.drain()
        obs.update(adhoc=adhoc, logs=lake_logs(side), files=lake_files(side))
        return obs

    out = run_both(tmp_path, scenario)
    assert [o["indexes_updated"] for o in out["torch"]["orders"]] == \
        [["st_od_bloom", "st_od_skip"]] * 2
    assert [sorted(x["indexes_updated"]) for x in out["torch"]["leaders"]] == \
        [["sql_li_pk", "sql_li_ship"]] * 2
    assert_same(out)


def _revenues(lineitem):
    cols = [chip_smoke._num(lineitem, c) for c in ("l_shipdate", "l_discount", "l_quantity",
                                                   "l_extendedprice")]
    return [float(chip_smoke.q6_reference(*cols, *p)["revenue"][0]) for p in PARAMS]
