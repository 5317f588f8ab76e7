"""The port stands alone: with ``jax`` and ``hyperspace_tpu`` made
unimportable, the slices (covering indexes over lineitem, sketch indexes
over orders, TPC-H Q3 and Q17 over covering-index joins, the sources
slice: hive partitions and a struct column in one lake, with the
partitions, cache, statistics, explain and display modules and the
introspection calls, the host read tier (the reader pool, the buffer pool
and the index-table cache, a warm repeat of Q3 and Q17), and the mutable
slice: a chunked build with lineage, Hybrid Scan over a deleted and an
appended file, every refresh mode and optimize, the SQL front end:
TPC-H Q4, Q16 and Q17 through ``session.sql``, the serving tier: a
frontend wave of four Q6 literal variants as one sweep over one shared
scan, and a result-cache hit, and the streaming tier: an append and a
commit landing a covering and a sketch delta, a standing query's
delivery, ``compact()`` and ``recover()``; and the formats, the writer and
the optimizer: every reader and writer format, bucket_by, partition_by,
avro, BucketUnion, indexes over csv and orc, and a reordered join with its
actuals and explain section; and the lake tier: delta and iceberg tables
with time travel, Hybrid Scan and an index on the ``hsmem://`` object
store; and the self-tuning tier: every advisor and adaptive module,
capture, what-if, recommend and a builder pass; and the robustness tier
and the cluster: fault points, retries, ladders, a deadline, a one-worker
cluster and a two-rank gather; whole-plan fusion and the length
classes; and the native runtime, the program bank and the artifact store)
still run end to end on the CPU, with the
join, group-by, column-pruning and score-based rule modules imported (in
a subprocess, because conftest imports jax in this one); the default device refuses to
run without CUDA; and chip_smoke.py prints no result without a card or
without the repository beside it.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import hyperspace_tpu_torch as ht

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = textwrap.dedent("""
    import datetime, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import chip_smoke
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants, col
    root = tempfile.mkdtemp()
    li_dir, od_dir, pt_dir, n_li, n_od = chip_smoke.make_tpch(root, 0.002)
    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu")
    s.conf.set(IndexConstants.INDEX_FILTER_RULE_USE_BUCKET_SPEC, "true")
    hs = ht.Hyperspace(s)
    li = s.read.parquet(li_dir)
    s.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    hs.create_index(li, ht.IndexConfig("li_idx", ["l_orderkey"],
                                       ["l_extendedprice", "l_discount", "l_shipdate"]))
    s.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 8)
    hs.create_index(li, ht.IndexConfig("li_ship_idx", ["l_shipdate"],
                                       ["l_orderkey", "l_extendedprice"]))
    qs = [li.filter(col("l_shipdate").between(datetime.date(1995, 3, 1),
                                               datetime.date(1995, 3, 31))),
          li.filter(col("l_shipdate") > datetime.date(1995, 3, 15)),
          li.filter(col("l_orderkey") == 7)]
    for q in qs:
        q = q.select("l_extendedprice")
        s.enable_hyperspace()
        plan = q.optimized_plan()
        a = q.to_arrow()
        s.disable_hyperspace()
        b = q.to_arrow()
        assert "IndexScan" in plan.collect_leaves()[0].simple_string()
        assert a.sort_by("l_extendedprice").equals(b.sort_by("l_extendedprice"))
    od = s.read.parquet(od_dir)
    hs.create_index(od, ht.DataSkippingIndexConfig(
        "od_skip", [ht.MinMaxSketch("o_orderdate")]))
    hs.create_index(od, ht.DataSkippingIndexConfig(
        "od_bloom", [ht.BloomFilterSketch("o_orderkey", expected_items=100_000)]))
    kept = []
    for q in [od.filter(col("o_orderdate").between(datetime.date(1994, 6, 1),
                                                    datetime.date(1994, 7, 31))),
              od.filter(col("o_orderkey").isin([n_od // 5, n_od // 2, (4 * n_od) // 5]))]:
        q = q.select("o_orderkey", "o_totalprice")
        s.enable_hyperspace()
        leaf = q.optimized_plan().collect_leaves()[0]
        a = q.to_arrow()
        s.disable_hyperspace()
        b = q.to_arrow()
        assert "files after skipping" in leaf.simple_string()
        kept.append(len(leaf.relation.all_files()))
        assert a.num_rows > 0 and a.sort_by("o_orderkey").equals(b.sort_by("o_orderkey"))
    s.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    hs.create_index(od, ht.IndexConfig("od_idx", ["o_orderkey"],
                                       ["o_custkey", "o_orderdate", "o_shippriority"]))
    hs.create_index(s.read.parquet(pt_dir),
                    ht.IndexConfig("pt_idx", ["p_partkey"], ["p_brand", "p_container"]))
    hs.create_index(li, ht.IndexConfig("li_pk_idx", ["l_partkey"],
                                       ["l_quantity", "l_extendedprice"]))
    from hyperspace_tpu_torch.rules import (column_pruning, groupby_rule, index_filters,
                                            join_rule, score_optimizer)
    rows = []
    joins = dict(q3=chip_smoke.build_q3(s, li_dir, od_dir),
                 q17=chip_smoke.build_q17(s, li_dir, pt_dir))
    for q in joins.values():
        s.enable_hyperspace()
        leaves = [leaf.index_entry.name for leaf in q.optimized_plan().collect_leaves()
                  if hasattr(leaf, "index_entry")]
        a = q.to_arrow()
        s.disable_hyperspace()
        b = q.to_arrow()
        assert len(leaves) >= 2, leaves
        assert a.column_names == b.column_names and a.num_rows == b.num_rows
        rows.append(a.num_rows)
    # The host read tier: the reader pool, the buffer pool and the index
    # cache; a warm repeat equals the cold run.
    from hyperspace_tpu_torch.execution import buffer_pool, index_cache
    from hyperspace_tpu_torch.parallel import io as pio
    s.enable_hyperspace()
    hits = buffer_pool.pool_stats()["hits"]
    for q in joins.values():
        assert q.to_arrow().equals(q.to_arrow())
    s.disable_hyperspace()
    assert buffer_pool.pool_stats()["hits"] > hits and index_cache.get_cache().hits > 0
    assert pio.pool_stats()["pooled_reads"] > 0
    # The sources slice: hive partitions and a struct column in one lake,
    # then indexes(), index(), explain() and why_not() on the whole lake.
    from hyperspace_tpu_torch.index import cache, statistics
    from hyperspace_tpu_torch.plan.expr import count, sum_
    from hyperspace_tpu_torch.plananalysis import display, explain
    from hyperspace_tpu_torch.sources import partitions
    hive_dir = os.path.join(root, "orders_hive")
    assert chip_smoke.make_orders_hive(od_dir, hive_dir) == n_od
    hive = s.read.parquet(hive_dir)
    hs.create_index(hive, ht.IndexConfig(chip_smoke.HIVE_INDEX, *chip_smoke.HIVE_INDEX_COLUMNS))
    refs = chip_smoke.sources_reference(hive_dir)
    for name, q in chip_smoke.sources_queries(hive, col, count, sum_).items():
        for indexed in (True, False):
            (s.enable_hyperspace if indexed else s.disable_hyperspace)()
            got = q.to_arrow()
            s.disable_hyperspace()
            if name == "by_priority":
                chip_smoke.check_by_priority(got, refs[name], str(indexed))
            else:
                assert got.num_rows > 0 and chip_smoke.sorted_table(got).equals(
                    chip_smoke.sorted_table(refs[name])), name
    names = ["li_idx", "li_ship_idx", "od_skip", "od_bloom", "od_idx", "pt_idx", "li_pk_idx",
             chip_smoke.HIVE_INDEX]
    chip_smoke.check_introspection(s, hs, joins, names)
    # The mutable slice: a chunked build with lineage, a deleted and an
    # appended file under Hybrid Scan, every refresh mode and optimize.
    from hyperspace_tpu_torch.ops import index_build
    s2 = ht.Session(system_path=os.path.join(root, "ix2"), device="cpu")
    s2.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, 1000)
    s2.conf.set(IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    s2.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 8)
    hs2 = ht.Hyperspace(s2)
    index_build.CHUNK_STATS.update(chunks=0, max_device_rows=0)
    hs2.create_index(s2.read.parquet(od_dir), ht.IndexConfig(
        "od_lin_idx", ["o_orderkey"], ["o_orderdate", "o_totalprice"]))
    assert index_build.CHUNK_STATS["chunks"] == 3, index_build.CHUNK_STATS
    per_file = n_od // chip_smoke.ORDERS_PARTS
    os.remove(os.path.join(od_dir, "part00.parquet"))
    chip_smoke.append_orders_file(od_dir, per_file, n_od, 16, seed=101)

    def orders_point(hybrid):
        s2.conf.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, hybrid)
        q = s2.read.parquet(od_dir).filter(col("o_orderkey").isin(
            [5, n_od // 2, n_od + 3])).select("o_orderkey", "o_totalprice")
        s2.enable_hyperspace()
        leaf = q.optimized_plan().collect_leaves()[0].simple_string()
        a = q.to_arrow()
        s2.disable_hyperspace()
        b = q.to_arrow()
        assert a.num_rows == 2 and a.sort_by("o_orderkey").equals(b.sort_by("o_orderkey"))
        return leaf

    assert "hybrid(+1 appended, -1 deleted files)" in orders_point("true")
    hs2.refresh_index("od_lin_idx", "quick")
    assert "hybrid(+1 appended, -1 deleted files)" in orders_point("true")
    hs2.refresh_index("od_lin_idx", "incremental")
    chip_smoke.append_orders_file(od_dir, per_file, n_od + per_file, 17, seed=102)
    hs2.refresh_index("od_lin_idx", "incremental")
    assert "IndexScan" in orders_point("false")
    hs2.optimize_index("od_lin_idx", "quick")
    os.remove(os.path.join(od_dir, "part01.parquet"))
    hs2.refresh_index("od_lin_idx", "full")
    assert "IndexScan" in orders_point("false")
    assert len(hs2.index_manager.get_index("od_lin_idx").content.files) == 8
    # The SQL front end: Q4 (EXISTS: a semi join), Q16 (NOT IN: an anti
    # join, COUNT DISTINCT, LIKE) and Q17 (a decorrelated scalar subquery)
    # through session.sql over temp views, against chip_smoke's reference.
    from hyperspace_tpu_torch import sql
    sql_dirs, _ = chip_smoke.make_tpch_sql(os.path.join(root, "tpch_sql"), 0.002)
    s3 = ht.Session(system_path=os.path.join(root, "ix3"), device="cpu")
    for name, d in sql_dirs.items():
        s3.create_temp_view(name, s3.read.parquet(d))
    sql_refs = chip_smoke.tpch_sql_references(sql_dirs)
    sql_rows = []
    for name in ("q4", "q16", "q17"):
        got = s3.sql(chip_smoke.TPCH_TEXTS[name]).to_arrow()
        chip_smoke.check_sql_answer(name, got, sql_refs[name], "no jax")
        sql_rows.append(got.num_rows)
    assert sql_rows[0] == 5 and sql_rows[1] > 0 and sql_rows[2] == 1, sql_rows
    # The serving tier: four Q6 literal variants as one wave over one shared
    # scan, each equal to its run alone; then a result-cache hit.
    from hyperspace_tpu_torch import serving
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend
    texts = [chip_smoke.q6_text(*p) for p in chip_smoke.Q6_PARAMS[:4]]
    alone = [s3.sql(t).to_arrow() for t in texts]
    fe = ServingFrontend(s3)
    wave = fe.submit_wave([(s3.sql(t).plan, s3, "", None) for t in texts])
    assert all(p.result(timeout=120).to_arrow().equals(a) for p, a in zip(wave, alone))
    st = fe.stats()
    assert (st["batches"], st["shared_scans"], st["shared_scan_hits"]) == (1, 1, 3), st
    s3.conf.set(serving.ServingConstants.RESULT_CACHE_ENABLED, "true")
    s3.conf.set(serving.ServingConstants.RESULT_CACHE_MIN_COMPUTE_SECONDS, "0")
    q6 = s3.sql(texts[0])
    assert q6.to_arrow().equals(q6.to_arrow()) and s3.result_cache.stats()["device_hits"] == 1
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    sd = os.path.join(root, "stream_tbl")
    os.makedirs(sd)
    pq.write_table(pa.table({{"k": np.arange(100, dtype=np.int64),
                             "v": np.arange(100, dtype=np.int64) % 7}}),
                   os.path.join(sd, "p0.parquet"))
    s4 = ht.Session(system_path=os.path.join(root, "ix4"), device="cpu",
                    conf={{"hyperspace.index.numBuckets": "4"}})
    hs4 = ht.Hyperspace(s4)
    hs4.create_index(s4.read.parquet(sd), ht.IndexConfig("sk", ["k"], ["v"]))
    hs4.create_index(s4.read.parquet(sd), ht.DataSkippingIndexConfig(
        "ss", [ht.MinMaxSketch("k")]))
    s4.enable_hyperspace()
    fe4 = ServingFrontend(s4)
    sub = fe4.subscribe(s4.read.parquet(sd).filter(col("k") >= 95).select("k"))
    hs4.append(sd, pa.table({{"k": np.arange(100, 110, dtype=np.int64),
                             "v": np.zeros(10, dtype=np.int64)}}))
    out4 = hs4.commit(sd)
    assert sorted(out4["indexes_updated"]) == ["sk", "ss"] and out4["subscriptions_fired"] == 1
    assert sub.wait_for(1, timeout=120)[0].result.to_arrow().num_rows == 15
    assert "sk" in hs4.compact()["compacted"]
    rec = hs4.recover()
    assert not rec["errors"] and rec["artifacts"] == {{"enabled": False}}, rec
    assert s4.read.parquet(sd).filter(col("k") >= 95).select("k").to_arrow().num_rows == 15
    bad = [m for m, v in sys.modules.items() if v is not None and (
        m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
        or m.startswith("hyperspace_tpu.") or m == "bench")]
    assert not bad, bad
    print("SLICE_OK", n_li, n_od, *kept, "Q3", rows[0], "Q17", rows[1], "SOURCES_OK",
          "MUTABLE_OK", "SQL_OK", "SERVING_OK", "STREAMING_OK")
""")


def test_slice_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SLICE.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SLICE_OK 12000 3000 2 3 Q3 10 Q17 1 SOURCES_OK MUTABLE_OK SQL_OK SERVING_OK " \
        "STREAMING_OK" in proc.stdout


FORMATS = textwrap.dedent("""
    import datetime, json, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants, col, sum_
    from hyperspace_tpu_torch.optimizer import cardinality, join_order, stats
    from hyperspace_tpu_torch.optimizer.constants import OptimizerConstants
    from hyperspace_tpu_torch.plan.nodes import BucketSpec, BucketUnion
    from hyperspace_tpu_torch.plananalysis.explain import explain_string
    from hyperspace_tpu_torch.util import avro
    root = tempfile.mkdtemp()
    rng = np.random.default_rng(1)
    src = os.path.join(root, "src")
    os.makedirs(src)
    pq.write_table(pa.table({{
        "k": np.arange(400, dtype=np.int64), "c": rng.integers(0, 20, 400),
        "v": np.round(rng.uniform(0, 9, 400), 2),
        "d": pa.array(rng.integers(9000, 9100, 400).astype(np.int32)).cast(pa.date32()),
    }}), os.path.join(src, "p0.parquet"))
    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu",
                   conf={{"hyperspace.index.numBuckets": "4"}})
    df = s.read.parquet(src)
    # The writer in every format, bucketed and partitioned, read back.
    for fmt in ("csv", "json", "avro", "parquet"):
        getattr(df.write, fmt)(os.path.join(root, fmt))
        back = getattr(s.read, fmt)(os.path.join(root, fmt))
        assert back.count() == 400, fmt
    df.write.bucket_by(4, "k").parquet(os.path.join(root, "bucketed"))
    with open(os.path.join(root, "bucketed", "_bucket_spec.json")) as f:
        assert json.load(f) == {{"numBuckets": 4, "columns": ["k"]}}
    df.write.partition_by("c").parquet(os.path.join(root, "parted"))
    parted = s.read.parquet(os.path.join(root, "parted"))
    assert parted.filter(col("c") == 3).count() == int((np.asarray(
        pq.read_table(src).column("c")) == 3).sum())
    orc = os.path.join(root, "orc")
    os.makedirs(orc)
    import pyarrow.orc as pa_orc
    pa_orc.write_table(pq.read_table(src), os.path.join(orc, "p0.orc"))
    txt = os.path.join(root, "txt")
    os.makedirs(txt)
    with open(os.path.join(txt, "a.txt"), "w", newline="") as f:
        f.write("a\\r\\nb\\rc\\n")
    assert s.read.text(txt).to_arrow().column("value").to_pylist() == ["a", "b", "c"]
    # An index over csv and a MinMax sketch over orc.
    hs = ht.Hyperspace(s)
    csv_df = s.read.csv(os.path.join(root, "csv"))
    hs.create_index(csv_df, ht.IndexConfig("csv_idx", ["k"], ["v"]))
    hs.create_index(s.read.orc(orc), ht.DataSkippingIndexConfig(
        "orc_skip", [ht.MinMaxSketch("k")]))
    s.enable_hyperspace()
    q = csv_df.filter(col("k") == 17).select("k", "v")
    assert "IndexScan" in q.optimized_plan().tree_string() and q.count() == 1
    s.disable_hyperspace()
    tbl = pq.read_table(src)
    avro.write_avro(tbl, os.path.join(root, "t.avro"), codec="deflate")
    assert avro.read_avro(os.path.join(root, "t.avro")).equals(tbl)
    u = s.create_dataframe(BucketUnion([df.plan, df.plan], BucketSpec(4, ("k",), ("k",))))
    assert u.count() == 800
    # Join reordering with its statistics, actuals and explain section.
    dim = os.path.join(root, "dim")
    os.makedirs(dim)
    pq.write_table(pa.table({{"dk": np.arange(20, dtype=np.int64),
                             "cat": rng.integers(0, 4, 20)}}), os.path.join(dim, "p0.parquet"))
    s.conf.set(OptimizerConstants.JOIN_REORDER_ENABLED, "true")
    left = s.read.parquet(src)
    d1 = s.read.parquet(dim).filter(col("cat") == 1)
    d2 = s.read.parquet(dim).select(col("dk").alias("dk2"), col("cat").alias("cat2"))
    q = left.join(d2, col("c") == col("dk2")).join(d1, col("c") == col("dk")).agg(
        sum_(col("v")).alias("t"))
    assert "[reordered, est~" in q.optimized_plan().tree_string()
    q.to_arrow()
    assert "Join order:" in explain_string(s, q.plan) and len(s._join_actuals) == 2
    assert cardinality.equi_join_rows(10.0, 10.0, [(2.0, None)]) == 10.0
    bad = [m for m, v in sys.modules.items() if v is not None and (
        m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
        or m.startswith("hyperspace_tpu."))]
    assert not bad, bad
    print("FORMATS_OK")
""")


def test_formats_writer_and_optimizer_run_without_jax():
    proc = subprocess.run([sys.executable, "-c", FORMATS.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "FORMATS_OK" in proc.stdout


LAKE = textwrap.dedent("""
    import os, sys, tempfile, uuid
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants, col
    from hyperspace_tpu_torch.index import data_store, log_store
    from hyperspace_tpu_torch.lake.delta import DeltaTable
    from hyperspace_tpu_torch.lake.iceberg import IcebergTable
    from hyperspace_tpu_torch.plan.nodes import IndexScan
    from hyperspace_tpu_torch.sources.delta import DeltaLakeRelation
    from hyperspace_tpu_torch.sources.iceberg import IcebergRelation
    root = tempfile.mkdtemp()

    def rows(lo, hi):
        return pa.table({{"k": np.arange(lo, hi, dtype=np.int64),
                          "grp": (np.arange(lo, hi) % 13).astype(np.int64)}})

    def index_ids(df):
        return [leaf.index_entry.id for leaf in df.optimized_plan().collect_leaves()
                if isinstance(leaf, IndexScan)]

    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu",
                   conf={{"hyperspace.index.numBuckets": "4"}})
    hs = ht.Hyperspace(s)
    d = DeltaTable(os.path.join(root, "d"))
    d.create(rows(0, 2000))
    hs.create_index(s.read.delta(d.path), ht.IndexConfig("dix", ["grp"], ["k"]))
    d.append(rows(2000, 2400))
    s.enable_hyperspace()
    s.conf.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
    q = s.read.delta(d.path).filter(col("grp") == 2).select("k")
    assert index_ids(q) == [1] and q.count() == int((np.arange(2400) % 13 == 2).sum())
    s.conf.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "false")
    hs.refresh_index("dix", "incremental")
    assert index_ids(s.read.delta(d.path, version_as_of=0).filter(col("grp") == 2)) == [1]
    assert index_ids(s.read.delta(d.path).filter(col("grp") == 2)) == [3]
    assert DeltaLakeRelation(d.path, {{"versionAsOf": "0"}}).describe().endswith("@v0")
    ib = IcebergTable(os.path.join(root, "i"))
    s0 = ib.create(rows(0, 100))
    ib.append(rows(100, 150))
    hs.create_index(s.read.iceberg(ib.path), ht.IndexConfig("iix", ["grp"], ["k"]))
    assert index_ids(s.read.iceberg(ib.path).filter(col("grp") == 3)) == [1]
    assert s.read.iceberg(ib.path, snapshot_id=s0).count() == 100
    assert IcebergRelation(ib.path).snapshot_id != s0
    src = os.path.join(root, "src")
    os.makedirs(src)
    pq.write_table(rows(0, 300), os.path.join(src, "p0.parquet"))
    m = ht.Session(system_path=f"hsmem://nojax-{{uuid.uuid4().hex}}/ix", device="cpu")
    mhs = ht.Hyperspace(m)
    mhs.create_index(m.read.parquet(src), ht.IndexConfig("mix", ["k"], ["grp"]))
    m.enable_hyperspace()
    mq = m.read.parquet(src).filter(col("k") == 7).select("grp")
    assert index_ids(mq) == [1] and mq.to_arrow().column("grp").to_pylist() == [7]
    files = m.index_collection_manager.get_index("mix").content.files
    assert files and all(f.startswith("hsmem://") for f in files)
    assert isinstance(log_store.store_for_path("hsmem://x/y"),
                      data_store._MemConditionalPutLogStore)
    mhs.delete_index("mix")
    mhs.vacuum_index("mix")
    bad = [n for n, v in sys.modules.items() if v is not None and (
        n == "jax" or n.startswith("jax.") or n.startswith("hyperspace_tpu."))]
    assert not bad, bad
    print("LAKE_OK")
""")


def test_lake_runs_without_jax():
    """Delta and iceberg tables with time travel and Hybrid Scan, and an
    index on the hsmem:// object store, with ``jax`` and
    ``hyperspace_tpu`` unimportable."""
    proc = subprocess.run([sys.executable, "-c", LAKE.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LAKE_OK" in proc.stdout


TELEMETRY = textwrap.dedent("""
    import glob, importlib, json, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import chip_smoke
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import col
    pkg_dir = os.path.join({root!r}, "hyperspace_tpu_torch", "telemetry")
    for f in sorted(glob.glob(os.path.join(pkg_dir, "*.py"))):
        name = os.path.basename(f)[:-3]
        if name != "__init__":
            importlib.import_module("hyperspace_tpu_torch.telemetry." + name)
    from hyperspace_tpu_torch.plananalysis import analyze  # noqa: F401
    root = tempfile.mkdtemp()
    li_dir, od_dir, pt_dir, n_li, n_od = chip_smoke.make_tpch(root, 0.002)
    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu")
    hs = ht.Hyperspace(s)
    hs.create_index(s.read.parquet(li_dir), ht.IndexConfig(
        "li_idx", ["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"]))
    s.enable_hyperspace()
    q3 = chip_smoke.build_q3(s, li_dir, od_dir)
    assert q3.to_arrow().num_rows == 10
    tr = hs.last_trace()
    names = {{sp.name for sp in tr.spans}}
    assert {{"query", "plan.normalize", "rewrite.index_rules", "exec.stage"}} <= names, names
    report = hs.explain_analyze(q3)
    assert "== Explain Analyze ==" in report and "exec.stage" in report
    text = hs.metrics_text()
    assert "hst_trace_sampled_total" in text and text.endswith("# EOF\\n")
    dump = json.loads(hs.dump_flight_recorder())
    assert dump["otherData"]["trace_ids"]
    assert hs.health()["count"] >= 2
    assert sys.modules["jax"] is None and sys.modules["hyperspace_tpu"] is None
    print("TELEMETRY_OK", len(tr.spans))
""")


def test_telemetry_runs_without_jax():
    """Every telemetry module imports, a traced Q3 runs, and
    explain_analyze, metrics_text and dump_flight_recorder answer, with
    ``jax`` and ``hyperspace_tpu`` unimportable."""
    proc = subprocess.run([sys.executable, "-c", TELEMETRY.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "TELEMETRY_OK" in proc.stdout


SELF_TUNING = textwrap.dedent("""
    import datetime, glob, importlib, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import chip_smoke
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import col
    for tier in ("advisor", "adaptive"):
        pkg_dir = os.path.join({root!r}, "hyperspace_tpu_torch", tier)
        for f in sorted(glob.glob(os.path.join(pkg_dir, "*.py"))):
            name = os.path.basename(f)[:-3]
            if name != "__init__":
                importlib.import_module(f"hyperspace_tpu_torch.{{tier}}." + name)
    root = tempfile.mkdtemp()
    li_dir, od_dir, pt_dir, n_li, n_od = chip_smoke.make_tpch(root, 0.002)
    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu")
    s.conf.set("hyperspace.tpu.adaptive.enabled", "true")
    s.enable_hyperspace()
    hs = ht.Hyperspace(s)
    od = s.read.parquet(od_dir)
    lo, hi = datetime.date(1994, 6, 1), datetime.date(1994, 7, 31)
    q = od.filter(col("o_orderdate").between(lo, hi)).select("o_orderkey", "o_totalprice")
    s.conf.set("hyperspace.tpu.advisor.capture.enabled", "true")
    want = q.to_arrow()
    s.conf.set("hyperspace.tpu.advisor.capture.enabled", "false")
    out = hs.what_if(q, [ht.IndexConfig("hypo", ["o_orderdate"],
                                        ["o_orderkey", "o_totalprice"])])
    assert out.rewritten, out.explain()
    assert hs.recommend(top_k=3).recommendations
    built = hs.adaptive_builder().run_once(force=True)["built"]
    assert built, built
    assert "IndexScan" in q.optimized_plan().tree_string()
    assert q.to_arrow().sort_by("o_orderkey").equals(want.sort_by("o_orderkey"))
    assert s._index_usage_counts[built[0]] > 0, s._index_usage_counts
    assert hs.adaptive_stats()["builder"]["built"] == built
    assert sys.modules["jax"] is None and sys.modules["hyperspace_tpu"] is None
    print("SELF_TUNING_OK", built)
""")


def test_self_tuning_runs_without_jax():
    """Every advisor and adaptive module imports, and capture, what-if,
    recommend and the builder's pass build an index a query then reads,
    with ``jax`` and ``hyperspace_tpu`` unimportable."""
    proc = subprocess.run([sys.executable, "-c", SELF_TUNING.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SELF_TUNING_OK" in proc.stdout


ROBUSTNESS_AND_CLUSTER = textwrap.dedent("""
    import os, sys, tempfile, threading
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import numpy as np
    import chip_smoke
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import col
    from hyperspace_tpu_torch.cluster import (constants, gather, hashring, membership,
                                              transport, worker)
    from hyperspace_tpu_torch.execution import buffer_pool
    from hyperspace_tpu_torch.robustness import faults
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend
    root = tempfile.mkdtemp()
    li_dir, od_dir, pt_dir, n_li, n_od = chip_smoke.make_tpch(root, 0.002)
    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu")
    s.conf.set("serving.result_cache.enabled", "true")
    s.conf.set("serving.result_cache.minComputeSeconds", "0")
    q = s.read.parquet(li_dir).filter(col("l_quantity") < 20).select("l_orderkey")
    want = q.to_arrow()
    before = faults.stats()
    s.result_cache.clear()
    buffer_pool.get_pool().clear()
    for point, spec in (("io.pooled_read", "transient:times=2"), ("buffer.load", "error"),
                        ("result_cache.device_put", "error")):
        s.conf.set("hyperspace.tpu.robustness.faults." + point, spec)
    assert q.to_arrow().equals(want) and q.to_arrow().equals(want)
    after = faults.stats()
    assert after["injected"] > before["injected"], (before, after)
    assert after["degraded_device_put"] == before["degraded_device_put"] + 1, after
    s.conf.set("hyperspace.tpu.robustness.deadlineMs", "0.001")
    try:
        s.read.parquet(od_dir).select("o_orderkey").to_arrow()
        raise AssertionError("no deadline")
    except ht.exceptions.QueryDeadlineError:
        pass
    s.conf.unset("hyperspace.tpu.robustness.deadlineMs")
    s.conf.set("hyperspace.tpu.cluster.enabled", "true")
    s.conf.set("hyperspace.tpu.cluster.worker.id", "w-alone")
    fe = ServingFrontend(s)
    assert fe.submit(q).result(timeout=120).to_arrow().equals(want)
    node = worker.get_node(s)
    assert node.stats()["members"] == 1 and worker.broadcast_commit(s, li_dir) == 0
    assert hashring.HashRing(["a", "b"]).owner("x") in ("a", "b")
    assert membership.membership_dir(s).endswith(constants.CLUSTER_DIR_NAME)
    me = node.membership.live_members()[0]
    assert transport.send_request(me.host, me.port, {{"op": "ping"}})["worker"] == "w-alone"
    fleet = ht.Hyperspace(s).fleet_metrics()
    assert list(fleet["workers"]) == ["w-alone"], fleet
    gather.init_process(0, 2, "no-jax-" + root)
    rdv = gather._rendezvous_dir(gather.process_identity()[2])
    t = threading.Thread(target=gather.host_allgather, args=(np.array([2]),),
                         kwargs=dict(rank=1, n=2, seq=1, rendezvous_dir=rdv))
    t.start()
    assert gather.allgather(np.array([1])).tolist() == [[1], [2]]
    t.join()
    worker.shutdown_for_tests()
    gather.reset_for_tests()
    assert sys.modules["jax"] is None and sys.modules["hyperspace_tpu"] is None
    print("ROBUSTNESS_CLUSTER_OK")
""")


def test_robustness_and_cluster_run_without_jax():
    """The six cluster modules and the new fault points, retries, ladders
    and deadline run, with ``jax`` and ``hyperspace_tpu`` unimportable: a
    pooled-read retry, a buffer-pool load fault and a result-cache device
    copy fault give the same answer, a deadline cancels, and a one-worker
    cluster serves, pings, reports fleet metrics and gathers over two ranks."""
    proc = subprocess.run([sys.executable, "-c", ROBUSTNESS_AND_CLUSTER.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ROBUSTNESS_CLUSTER_OK" in proc.stdout


MESH = textwrap.dedent("""
    import importlib, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import torch
    import chip_smoke
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants
    from hyperspace_tpu_torch.plan.expr import col, count, sum_
    for name in ("parallel.mesh", "parallel.sharding", "parallel.distributed_build",
                 "parallel.distributed_query", "parallel.multihost", "execution.spmd"):
        importlib.import_module("hyperspace_tpu_torch." + name)
    from hyperspace_tpu_torch.execution import spmd
    from hyperspace_tpu_torch.parallel import distributed_build, multihost
    root = tempfile.mkdtemp()
    li_dir, od_dir, pt_dir, n_li, n_od = chip_smoke.make_tpch(root, 0.002)
    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu")
    s.conf.set(IndexConstants.TPU_DISTRIBUTED_MIN_STREAM_ROWS, "0")
    q = lambda: s.read.parquet(li_dir).filter(col("l_quantity") < 20).group_by(
        "l_partkey").agg(count(None).alias("n"), sum_(col("l_quantity")).alias("q"))
    staged = q().to_arrow()
    s.conf.set(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE, "on")
    before = spmd.DISPATCH_COUNT
    assert q().to_arrow().equals(staged)
    assert spmd.DISPATCH_COUNT == before + 1
    from hyperspace_tpu_torch.parallel import mesh as pmesh
    pmesh.mesh_devices = lambda session=None: [torch.device("cpu")] * 4
    assert q().to_arrow().equals(staged)
    b0 = distributed_build.DISPATCH_COUNT
    ht.Hyperspace(s).create_index(s.read.parquet(od_dir),
                                  ht.IndexConfig("od_mesh", ["o_orderkey"], ["o_totalprice"]))
    assert distributed_build.DISPATCH_COUNT == b0 + 1
    assert ht.Hyperspace(s).spmd_stats()["mesh_devices"] == 4
    assert multihost.initialize_multihost()["process_count"] == 1
    assert sys.modules["jax"] is None and sys.modules["hyperspace_tpu"] is None
    print("MESH_OK")
""")


def test_mesh_tier_runs_without_jax():
    """The mesh tier's six modules import, a one-device SPMD dispatch and a
    4-device CPU mesh give the staged answer, and a mesh build runs, with
    ``jax`` and ``hyperspace_tpu`` unimportable."""
    proc = subprocess.run([sys.executable, "-c", MESH.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MESH_OK" in proc.stdout


FUSION = textwrap.dedent("""
    import importlib, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import chip_smoke
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants
    from hyperspace_tpu_torch.plan.expr import col, count, sum_
    for name in ("shapes", "execution.fusion_boundaries", "execution.fusion",
                 "execution.leaf"):
        importlib.import_module("hyperspace_tpu_torch." + name)
    from hyperspace_tpu_torch import shapes
    from hyperspace_tpu_torch.execution import fusion
    root = tempfile.mkdtemp()
    li_dir, od_dir, pt_dir, n_li, n_od = chip_smoke.make_tpch(root, 0.002)
    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu")
    q = lambda: s.read.parquet(li_dir).filter(col("l_quantity") < 20).group_by(
        "l_partkey").agg(count(None).alias("n"), sum_(col("l_quantity")).alias("q"))
    before = fusion.DISPATCH_COUNT
    fused = q().to_arrow()
    assert fusion.DISPATCH_COUNT == before + 1
    s.conf.set(IndexConstants.TPU_FUSION_ENABLED, "false")
    assert q().to_arrow().equals(fused)
    assert fusion.DISPATCH_COUNT == before + 1
    assert "fusion" in ht.Hyperspace(s).metrics()["collectors"]
    with shapes.use_conf(s.hs_conf):
        assert shapes.padded_length(1025) == 2048
    assert sys.modules["jax"] is None and sys.modules["hyperspace_tpu"] is None
    print("FUSION_OK")
""")


def test_fusion_and_shapes_run_without_jax():
    """The three modules of whole-plan fusion and length classes import,
    a region fuses and equals the staged answer, with ``jax`` and
    ``hyperspace_tpu`` unimportable."""
    proc = subprocess.run([sys.executable, "-c", FUSION.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "FUSION_OK" in proc.stdout


LAST_MODULES = textwrap.dedent("""
    import os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["hyperspace_tpu"] = None
    sys.path.insert(0, {root!r})
    import numpy as np
    import pyarrow as pa
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.artifacts import constants, manager, store
    from hyperspace_tpu_torch.serving import program_bank
    from hyperspace_tpu_torch.util import avro
    root = tempfile.mkdtemp()
    tbl = pa.table({{"k": pa.array(np.arange(300, dtype=np.int64)),
                     "s": pa.array([f"v{{i}}" if i % 3 else None for i in range(300)])}})
    avro.write_avro(tbl, os.path.join(root, "t.avro"), codec="deflate", block_rows=70)
    assert avro.read_avro(os.path.join(root, "t.avro")).equals(tbl)
    assert avro.read_avro_plain(os.path.join(root, "t.avro")).equals(tbl)
    assert native.minmax_prune([1, 5], [3, 9], "GreaterThan", 4, "int64").tolist() == [False, True]
    s = ht.Session(system_path=os.path.join(root, "ix"), device="cpu",
                   conf={{"hyperspace.tpu.artifacts.enabled": "true",
                          "hyperspace.tpu.execution.fusion.enabled": "false"}})
    pq_dir = os.path.join(root, "pq")
    os.makedirs(pq_dir)
    import pyarrow.parquet as pq
    pq.write_table(tbl, os.path.join(pq_dir, "p.parquet"))
    df = s.read.parquet(pq_dir)
    assert df.filter(ht.col("k") > 100).to_arrow().num_rows == 199
    assert program_bank.get_bank().stats()["misses"] == 1
    hs = ht.Hyperspace(s)
    assert hs.warmup()["enabled"] is True and hs.artifact_stats()["enabled"] is True
    assert hs.compact()["artifacts"]["enabled"] is True
    assert constants.ARTIFACT_DIR_NAME == "_hst_artifacts"
    assert sys.modules["jax"] is None and sys.modules["hyperspace_tpu"] is None
    print("LAST_MODULES_OK")
""")


def test_native_bank_and_artifacts_run_without_jax():
    """The native runtime (its avro decoder and sketch probe), the program
    bank and the artifact store import and run, with ``jax`` and
    ``hyperspace_tpu`` unimportable."""
    proc = subprocess.run([sys.executable, "-c", LAST_MODULES.format(root=ROOT)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LAST_MODULES_OK" in proc.stdout


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ht.HyperspaceException, match="CUDA is not available"):
        ht.Session(system_path=str(tmp_path))
    assert ht.Session(system_path=str(tmp_path), device="cpu").device.type == "cpu"


def _no_result(proc) -> bool:
    return proc.returncode != 0 and '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--out", ""],
                          capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert _no_result(proc), proc.stdout[-2000:]


def test_chip_smoke_fails_alone(tmp_path):
    """Even where a card is reported, the script alone cannot import the
    port, so it fails before printing a result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    code = ("import runpy, sys, torch; torch.cuda.is_available = lambda: True; "
            "sys.argv = ['chip_smoke.py', '--out', '']; "
            "runpy.run_path('chip_smoke.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path), env=env)
    assert _no_result(proc), proc.stdout[-2000:]
