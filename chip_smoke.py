#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hyperspace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 10] [--sql-scale 2] [--out chiprun_out/chip_smoke.json]

Phases, each of which fails the run on any error:

1. build   -- compile every CUDA kernel from hyperspace_tpu_torch/csrc/
              (one nvcc per source, all started together);
2. kernels -- each kernel against its plain torch version on the card,
              at several sizes and edge shapes, exact equality (bit for
              bit for masked_minmax's words: signed zeros, NaN bit
              patterns, sentinels, the any-valid word), and masked_minmax's
              per-stream scratch reused across 100 calls on each of two
              streams;
2b. artifacts -- phase 1's five libraries published to an artifact store
              (``hyperspace.tpu.artifacts.*``) on a small lake of its own
              (SF0.05); a child process with an empty build directory and
              ``artifacts.preload.enabled`` preloads them, calls warmup(),
              runs the cutoff and range filters, a covering and a MinMax
              sketch build and two indexed queries with no nvcc run (five
              store hits, no KernelCompileEvent), every kernel launched and
              equal to its plain version at phase 2's sizes, answers equal
              this process's; one blob is corrupted, and a second child
              quarantines it, builds that kernel alone with nvcc (equal
              answers), then dies at an armed artifacts.write kill, whose
              temp compact() sweeps; prints the ``artifacts`` line (cold
              nvcc seconds, the child's warmup and first-query seconds,
              hits, misses, bytes);
3. datagen -- TPC-H lineitem, orders and part at ``--scale`` (SF10:
              60,000,000 lineitem rows in 4 parquet files, 15,000,000
              orders rows in 16 time-ordered files, 2,000,000 part rows in
              one), the repository's benchmark generator (bench.py
              make_tpch_like, same formulas and seed), copied here;
4. build   -- through the public API: the covering indexes li_idx
              (l_orderkey; 32 buckets), li_ship_idx (l_shipdate; 8
              buckets), od_idx (o_orderkey; 32 buckets), li_pk_idx
              (l_partkey; 32 buckets) and pt_idx (p_partkey; 32 buckets),
              and the data-skipping indexes od_skip (MinMax on
              o_orderdate) and od_bloom (Bloom on o_orderkey); od_skip's
              sketch table must hold each file's pyarrow min and max;
5. queries -- the range, cutoff and point queries over lineitem, the
              skipping (o_orderdate BETWEEN) and bloom (o_orderkey IN)
              queries over orders, and TPC-H Q3 and Q17 (bench.py's
              texts), indexed and scanned: results equal a pyarrow
              reference (Q3 and Q17: keys exact, float64 within 1e-9
              relative), every lineitem plan holds an IndexScan, each
              orders plan is a Scan narrowed by its sketches (MinMax to
              exactly the files whose date range meets the filter, Bloom to
              a superset of the files holding a key, both to fewer than
              16), Q3's plan joins li_idx and od_idx with the bucket spec
              and Q17's reads li_pk_idx and pt_idx under its first join and
              li_pk_idx under its threshold; two indexed runs of Q3 or Q17
              give the same bytes;
6. timing  -- each kernel beside its plain version and one PyTorch call
              computing the same function, at the inputs the main path
              gave it and at full-size columns: ``ms`` is the mean of 20
              back-to-back calls by CUDA events (the host-paced time the
              main path pays; median of 3 rounds, with their spread), and
              ``device_ms`` the card's own time per call, the sum of the
              profiler's device records over 20 calls, read after every
              host-paced time (a profiling session slows the process's
              host path for good), which also count
              the kernels and memsets each call puts on the stream (a
              kernel without device records fails the run); a
              device-to-device copy of the full column, the memory rate
              reached in practice; and the microseconds of each piece of
              a wrapper's host path, and of whole calls by the host clock
              and by CUDA events;
   sources -- after the joins path: a copy of orders partitioned by
              o_orderpriority (hive directories, 5 x 4 files) with the
              struct o_attrs<o_orderdate, o_totalprice>; ohp_idx on the
              leaf o_attrs.o_orderdate built in memory at the default
              device budget; three queries (1-URGENT in June-July 1994,
              whose scan keeps 4 of 20 files; after the Q3 cutoff; orders
              and revenue per priority) indexed and scanned against a
              hive-partitioned pyarrow dataset; then indexes(), index(),
              explain(Q3) and why_not(Q17) on the run's lake, which must
              leave the usage counts as they were;
   io      -- after the sources path: the range, cutoff, point, skipping,
              bloom, Q3 and Q17 queries, indexed and scanned, each run
              cold (buffer pool emptied, reader-pool counters zeroed),
              warm, and sequential (io.threads=1, buffer pool disabled and
              emptied): byte-equal results that equal the phases' pyarrow
              references, a pool hit on every warm run, the "parquet read
              -> device" span and peak device memory of each run, the
              pool's residency against its budgets; od_skip and od_bloom
              built at io.threads 1 and the default into two lakes
              (byte-equal sketch tables); a small lineitem lake built
              chunked at both thread counts (byte-equal bucket files) and
              in memory (equal tables);
   formats -- after the io path, in a session of its own: all lineitem
              rows (5 columns) written with bucket_by(32, "l_orderkey")
              (every file holds only its bucket's keys, sorted; the rows
              and column sums add up; _bucket_spec.json; an append of the
              same spec adds one file a bucket, another spec is refused),
              with its seconds, rows/s and peak device memory; orders (with
              a seeded o_orderpriority) written with
              partition_by("o_orderpriority") and queried (one priority and
              an o_orderdate window: 1 of 5 files kept); orders as 16 csv
              appends, one orc file (pyarrow's writer), and one orders
              file as json and avro, each read back through session.read
              and equal to the source under pyarrow's type inference (avro
              through the native decoder, whose table equals the plain
              Python decoder's, timed on the same file); over
              the csv copy csv_od_idx (o_orderkey, in memory) and
              csv_od_skip (MinMax on o_orderdate), a point query
              (IndexScan), a date window (2-3 of 16 files kept) and the
              orders after it, indexed and scanned, equal to pyarrow's
              answer; prints the ``formats`` line;
   lake    -- after the formats path, on a lake of its own made from
              phase 3's orders: a delta table (lake/delta.py) of files 0-11
              as 12 parts (v0), dl_od_idx (o_orderdate; o_orderkey,
              o_totalprice; 32 buckets, lineage) at v0, files 12-13
              appended (v1), a date point query (==) and a date window
              (BETWEEN) under Hybrid Scan (hybrid(+2 appended, -0 deleted
              files)), the earliest part removed (v2) and both again
              (-1 deleted), an incremental refresh and both with Hybrid
              Scan off (log id 3), both on read.delta(version_as_of=0)
              (the log id 1 built at v0, deltaVersionHistory "1:0,3:2");
              an iceberg table (lake/iceberg.py) of all 16 files,
              ib_od_skip (MinMax on o_orderdate; its sketch rows equal each
              part's pyarrow min and max), a window that keeps exactly the
              parts whose range meets it, one appended snapshot (a full
              scan until the sketch is refreshed), the old snapshot by
              snapshot_id, an incremental refresh; st_od_idx over a
              hard-linked copy of orders with its system path on an
              hsobj:// object store registered here (pyarrow's
              SubTreeFileSystem behind a handler that counts calls and
              fails any rename; an O_EXCL log store): create, the window,
              refresh after an appended file, optimize, delete and vacuum,
              the index's files under the store's root and nowhere else.
              Every answer equals pyarrow's over the snapshot's files,
              cold and warm; prints the ``lake`` line;
   advisor -- after the lake path, on a lake and session of its own
              (run_advisor_path): phase 3's orders (hard links) and a
              skewed star (tests/test_adaptive.py's shape, a fact table of
              orders' 15M rows in 4 files); a captured workload of eight
              orders queries, what-if and recommend leaving the system path
              byte for byte as it was, the adaptive builder's passes (the
              advisor's covering indexes and a MinMax sketch, within the
              1 GiB budget), the workload again on them against pyarrow, an
              unused index retired and restored, SLO admission degrading the
              window sum to a sampled answer (held to numpy over the kept
              files) and shedding it, and the star's three-way join with one
              mid-query re-plan and its q-error run by run; then it clears
              the process-wide adaptive state; prints the ``advisor`` line;
   reorder -- after the sql path, on its lake: each of the nine texts
              optimized with optimizer.joinReorder.enabled off and on; a
              text whose tree changes runs twice each way (warm seconds),
              the answers equal after sorting rows and the numpy reference,
              each step's estimated rows against the actual ones
              (q-error), explain's "Join order:" section; at least one
              text must reorder; prints the ``reorder`` line;
7. breakdown -- host spans, peak device memory and the profiler's
              device time for rebuilds of li_ship_idx, li_pk_idx, pt_idx,
              od_skip and od_bloom and for the four filter queries and Q3
              and Q17, indexed and scanned; left out when the script's
              clock is past BREAKDOWN_LATE_S at its start;
   mutations -- after every other path, since appends change every
              source signature; a session at the default device budget
              (8,388,608 rows), so builds and filtered scans of lineitem
              and orders stream in chunks. Lineitem gets bench.py's append
              (BASELINE config #5): the range, cutoff and Q3 queries under
              Hybrid Scan (the IndexScans say hybrid(+1 appended, -0
              deleted files); results equal scanned and a pyarrow
              reference; Q3's appended rows merge into li_idx's bucket
              order and its join stays shuffle-free); quick and incremental
              refresh of li_ship_idx; a chunked build of li_chunk_idx over
              all 63M rows (files checked bucket by bucket, device rows
              within the budget, spans per stage); the first Hybrid query
              after the append must miss the buffer pool. Orders: od_lin_idx
              built chunked with lineage, one file deleted and one
              appended, a key query under Hybrid Scan, the od_skip and
              od_bloom refreshes with their queries, then quick,
              incremental (masked rebuild, then append-only), optimize and
              full refresh of od_lin_idx, each checked against the files
              and a reference;
   sql     -- after the io path: a TPC-H lake with the columns the nine
              texts of tests/test_tpch_sql.py read, at ``--sql-scale``
              (SF2: lineitem 12M rows in 4 files, orders 3M in 16,
              customer 300k, part 400k, partsupp 1.6M, supplier 20k; the
              serving, faults, streaming and cluster paths run on this
              lake too), TPC-H's value domains, seeded; covering indexes sql_li_ship (l_shipdate),
              sql_li_pk (l_partkey) and sql_pt_pk (p_partkey); the nine
              texts, Q13's outer join and a rank and running sum over each
              customer's orders through session.sql, twice indexed and
              twice scanned (the buffer pool emptied before each first
              run): every result equals a numpy reference (keys, counts,
              dates and strings exact, float64 within 1e-9 relative),
              indexed equals scanned, Q6, Q14 and Q17 plan an IndexScan;
   serving -- after the sql path, on its lake: 16 TPC-H Q6 texts under
              distinct substitution parameters (Q6_PARAMS) through the
              serving frontend (run_serving_path): a scanned wave (one
              batch over one shared scan, each member's own mask through
              the range kernel, each member bit for bit its run alone and
              within 1e-9 of a numpy reference), an indexed wave
              (sql_li_ship; each member alone with the range kernel), the
              result cache (16 device-tier hits on a repeat, misses after
              delete_index and restore_index, host-tier hits after
              demotion), no submission rejected; prints the ``serving``
              line, with the program bank's stats() delta over the path;
   faults  -- after the serving path, on its lake and conf
              (run_faults_path): pooled-read retries under a scanned wave,
              a serving worker's death releasing a member, result-cache
              device copies failing to the host tier, a corrupt spill file
              read as a miss, a buffer-pool load fault as a silent miss
              (and the typed error with degrade off), the scan-decode and
              prefetch-producer faults' typed errors, a 1 ms deadline on a
              cold Q1 (at the default configuration, then with its read
              over the reader pool), an orders index rebuilt under a transient read fault
              to the same bucket files; each step against the same step
              unarmed, with the counters it moved; changes no data; prints
              the ``faults`` line;
   streaming -- after the faults path, on its lake and session: the
              TPC-H New Sales Refresh (RF1: SF x 1,500 orders and their
              1-7 lineitems) in 6 rounds (at least 4: no later one starts
              once the script's clock passes STREAMING_LATE_S), four
              threads appending a quarter of each round's lineitem and
              committing together (one
              group-commit wave), a fifth the round's orders, with 16
              standing Q6 queries (Q6_PARAMS) delivering after every
              lineitem commit within 1e-9 of the reference; one bulk round
              of a quarter of each table; a child killed by SIGKILL at
              ingest.publish and rolled back by recover(); compact(); a
              continuous source polling an empty drop directory throughout,
              never paused (run_streaming_path); prints the ``streaming``
              line;
   cluster -- after the streaming path, on its lake (run_cluster_path):
              two worker processes on the card and the parent as a third
              member; the 16 Q6 texts routed twice by the hash ring (the
              answers the parent's own, bit for bit; forwards and the
              owners' cache hits as the ring says), then under an armed
              cluster.forward (all local, same bytes); a host allgather
              over the three processes; fleet_metrics with each worker's
              own kernel launches; an RF1 quarter committed at the parent
              firing a standing Q6 on each worker (equal to the parent's
              ad-hoc Q6), and a commit under cluster.broadcast=error that
              still lands; a worker killed by SIGKILL leaving the ring
              after the staleness window; prints the ``cluster`` line;
   mesh    -- after the cluster path (run_mesh_path): TPC-H at SF1 (the
              largest lineitem the SPMD dispatch's budget takes whole);
              under the default conf (singleDevice auto: the one-device
              dispatch on the card) a Q6 window (range kernel), the
              cutoff sorted and limited (compare kernel; one card sorts
              the gathered rows once), Q3, Q17, and a left outer and an
              anti join of orders against lineitem: each dispatched with
              its ShardedExecutionEvent mode; at singleDevice=off each
              takes the fused route (execution/fusion.py) where the CPU
              run at scale 0.01 takes it (fused regions and boundary
              kinds), the mask kernels launching inside the regions, and
              with fusion.enabled=false the staged route; the three
              routes' answers equal bit for bit and equal to pyarrow,
              warm seconds of each (median of 3); a global SUM/MIN of a
              nullable column under a filter that keeps nothing: NULL
              fused, the staged values staged, as on the CPU; the
              sample sort forced on the card, the cutoff's rows again;
              spmd.dispatch armed (degraded with
              its event, raised with degrade off); the lineitem mesh
              build on a mesh of the one card against the single-device
              build, bucket for bucket; the program bank's stats() delta
              over the path; spmd_stats() and explain's
              "Distributed:" section; the six on the card against the CPU
              at singleDevice=on, bit for bit at scale 0.01; prints the
              ``mesh`` line. Since the dispatch is the default on the
              card, every earlier path's query whose leaf fits
              maxChunkRows takes it too; the run fails if the SPMD ladder
              degraded outside an armed fault;
   telemetry -- after the streaming path, on the main path's lake and
              session (run_telemetry_path): indexed Q3 and the cutoff
              filter indexed, warm 10 runs and cold (the buffer pool
              emptied before each run) 3 runs a setting, alternating
              telemetry.trace.enabled false and true (the medians and the
              overhead; answers byte-equal, the overhead is reported, not a
              gate); one cold traced Q3 whose last_trace() holds query,
              plan.normalize, rewrite.index_rules, an exec.stage span per
              executed plan node and io.read spans under the scans;
              explain_analyze(Q3), metrics_text(), dump_flight_recorder()
              and health(); after phase 6 (telemetry_capture), the armed
              one-shot torch.profiler capture of a cold range query, then
              one capture around a cold cutoff (compare) query and the
              rebuilds of pt_idx and od_skip: the exported chrome traces
              must hold the CUDA kernels hash_bucket_kernel,
              bucket_histogram_kernel, masked_minmax_kernel and mask_kernel
              for both predicates; prints the ``telemetry`` line. Every
              path runs traced: tracing is on by default;
8. parity  -- Q3 and Q17 on a small lake on the card and through the
              port on the CPU (which the tests hold to the JAX package),
              reported bit for bit; the sql path's queries on a lake at
              scale 0.01, which must be equal bit for bit; the CPU side
              at singleDevice=on, route for route with the card.

Launch counters are reset just before each path (lineitem, orders,
joins and sources of phases 4-5, io, formats, lake, advisor, sql, reorder,
serving, faults, streaming, cluster, mesh, telemetry (its capture
counted with it), then mutations) and read just after it. Phase 5 runs each
query twice: since the buffer pool is on, the second run is warm; phase 7
empties the pool before each query it times. The last lines of standard
output are the summary, ``formats``, ``lake``, ``advisor``, ``reorder``,
``serving``, ``faults``, ``streaming``, ``cluster``, ``mesh``, ``telemetry`` and ``kernels``
JSON objects, the card's name and power
limit as nvidia-smi reports them, and the status object ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit
# non-tensor-core rate, used for the 32-bit integer lanes of these kernels.
PEAK_BYTES_PER_S = 3.35e12
PEAK_32BIT_OPS_PER_S = 67e12

EPOCH = datetime.date(1970, 1, 1)
RANGE_LO, RANGE_HI = datetime.date(1995, 3, 1), datetime.date(1995, 3, 31)
CUTOFF = datetime.date(1995, 3, 15)
ORDERS_PARTS = 16
# The kernels each path must launch: lineitem's covering builds and
# queries, then orders' covering and sketch builds and skipping queries.
PATH_KERNELS = {
    "lineitem": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask"),
    "orders": ("hash_bucket", "bucket_histogram", "range_mask", "masked_minmax"),
    "joins": ("hash_bucket", "bucket_histogram", "compare_mask"),
    "sources": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask"),
    "io": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask", "masked_minmax"),
    "mutations": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask",
                  "masked_minmax"),
    # The covering builds on the TPC-H lake, the date filters, and Q19's
    # p_size (int32) BETWEEN.
    "sql": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask"),
    # Q6's l_shipdate pair, one range-kernel pass for every member of the
    # scanned and the indexed wave (at least 16 in each: the serving path
    # checks the counts).
    "serving": ("range_mask",),
    # Each append's covering deltas (sql_li_ship, sql_li_pk) and MinMax
    # sketch row (st_od_skip); Q6's l_shipdate pair in every standing fire.
    "streaming": ("hash_bucket", "bucket_histogram", "masked_minmax", "range_mask"),
    # bucket_by's hash and histogram over 60M rows and csv_od_idx's build;
    # the csv copy's o_orderdate window (BETWEEN) and the orders after it
    # (>); csv_od_skip's build.
    "formats": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask",
                "masked_minmax"),
    # The covering builds and refreshes over the delta table and on the
    # object store; the date point query (==) and windows (BETWEEN) on
    # their indexes; ib_od_skip's build and refresh over the iceberg table.
    "lake": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask",
             "masked_minmax"),
    # The builder's covering builds (hash, histogram) and MinMax sketch
    # (minmax); the date windows (range) and the point count (compare) on
    # what it built.
    "advisor": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask",
                "masked_minmax"),
    # The reordered text (Q17) filters strings and compares floats: no
    # kernel of the repo.
    "reorder": (),
    # The faults path: sql_pt_pk's rebuild (hash, histogram), the
    # l_shipdate cutoff under buffer.load (compare), the Q6 waves (range).
    "faults": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask"),
    # The cluster path, at the parent: the commit's covering deltas (hash,
    # histogram) and its own Q6 runs (range). Each worker's range_mask is
    # read from its metrics reply.
    "cluster": ("hash_bucket", "bucket_histogram", "range_mask"),
    # The mesh path: the cutoff filter (compare) and the Q6 window (range)
    # inside the dispatched program, and the one-card mesh build's hash.
    "mesh": ("hash_bucket", "compare_mask", "range_mask"),
    # Q3 and the cutoff filter (compare); the capture's range query, the
    # pt_idx rebuild (hash, histogram) and the od_skip rebuild (minmax).
    "telemetry": ("hash_bucket", "bucket_histogram", "compare_mask", "range_mask",
                  "masked_minmax"),
}
# The telemetry path's runs a setting, warm and cold (a cold run decodes
# its scans again), and the CUDA kernels its profiler captures must hold:
# label -> what the demangled name contains. The runs are few because the
# whole script must finish inside its 1200 s limit, which the other paths
# alone come within 60 s of on a slow host.
TELEMETRY_RUNS = 10
TELEMETRY_COLD_RUNS = 3
CAPTURED_KERNELS = {
    "hash_bucket_kernel": ("hash_bucket_kernel",),
    "bucket_histogram_kernel": ("bucket_histogram_kernel",),
    "masked_minmax_kernel": ("masked_minmax_kernel",),
    "mask_kernel (compare)": ("mask_kernel", "ComparePred"),
    "mask_kernel (range)": ("mask_kernel", "RangePred"),
}
# The io path's queries, and what each path's query phases hold them to:
# name -> ("rows", pyarrow table) | ("q3", (rows, tied_last)) | ("q17", value).
IO_QUERIES = ("range", "cutoff", "point", "skipping", "bloom", "q3", "q17")
REFERENCES: dict = {}
# Float64 results against the pyarrow reference, and indexed against
# scanned: the same values summed in another order.
REL_TOL = 1e-9
# The card against the port on the CPU, bit for bit, on a lake this small.
PARITY_SCALE = 0.01
SKIP_LO, SKIP_HI = datetime.date(1994, 6, 1), datetime.date(1994, 7, 31)

# Kernels whose call must put exactly one kernel, and no memset or copy,
# on the stream (checked with the profiler in phase 6).
ONE_KERNEL_A_CALL = ("masked_minmax", "range_mask", "compare_mask", "hash_bucket")

REPLACES = {
    "hash_bucket": "hyperspace_tpu/ops/pallas_kernels.py:146",
    "bucket_histogram": "hyperspace_tpu/ops/pallas_kernels.py:402",
    "compare_mask": "hyperspace_tpu/ops/pallas_kernels.py:201",
    "range_mask": "hyperspace_tpu/ops/pallas_kernels.py:237",
    "masked_minmax": "hyperspace_tpu/ops/pallas_kernels.py:334",
}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Data: the lineitem and orders parts of bench.py's make_tpch_like, in the
# generator's order of draws, so both tables equal bench.py's.
# ---------------------------------------------------------------------------

def make_tpch(root: str, scale: float, seed: int = 0):
    """TPC-H-shaped lineitem (4 parquet files), orders (16 files,
    time-ordered: each file covers a range of o_orderdate) and part (one
    file). Returns (lineitem dir, orders dir, part dir, lineitem rows,
    orders rows)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    n_li = max(int(6_000_000 * scale), 10_000)
    n_od = max(n_li // 4, 2_500)
    n_pt = max(n_li // 30, 200)
    base = (datetime.date(1992, 1, 1) - EPOCH).days

    def write_parts(table, out_dir, n_parts, name):
        from concurrent.futures import ThreadPoolExecutor
        os.makedirs(out_dir)
        n = table.num_rows
        step = n // n_parts

        def part(i):
            lo, hi = i * step, (i + 1) * step if i < n_parts - 1 else n
            pq.write_table(table.slice(lo, hi - lo), os.path.join(out_dir, name(i)))

        with ThreadPoolExecutor(min(n_parts, 8)) as pool:
            list(pool.map(part, range(n_parts)))

    o_orderdate = np.sort(rng.integers(0, 2400, n_od) + base).astype(np.int32)
    orders = pa.table({
        "o_orderkey": pa.array(np.arange(n_od, dtype=np.int64)),
        "o_custkey": pa.array(rng.integers(0, max(n_od // 10, 1), n_od).astype(np.int64)),
        "o_orderdate": pa.array(o_orderdate, type=pa.int32()).cast(pa.date32()),
        "o_shippriority": pa.array(np.zeros(n_od, dtype=np.int32)),
        "o_totalprice": pa.array(np.round(rng.uniform(1000, 400000, n_od), 2)),
    })
    od_dir = os.path.join(root, "orders")
    write_parts(orders, od_dir, ORDERS_PARTS, lambda i: f"part{i:02d}.parquet")
    del orders, o_orderdate

    l_orderkey = rng.integers(0, n_od, n_li).astype(np.int64)
    l_shipdate = (rng.integers(0, 2520, n_li) + base).astype(np.int32)
    lineitem = pa.table({
        "l_orderkey": pa.array(l_orderkey),
        "l_partkey": pa.array(rng.integers(0, n_pt, n_li).astype(np.int64)),
        "l_quantity": pa.array(rng.integers(1, 51, n_li).astype(np.int64)),
        "l_extendedprice": pa.array(np.round(rng.uniform(900, 105000, n_li), 2)),
        "l_discount": pa.array(np.round(rng.uniform(0, 0.1, n_li), 2)),
        "l_shipdate": pa.array(l_shipdate, type=pa.int32()).cast(pa.date32()),
    })
    li_dir = os.path.join(root, "lineitem")
    write_parts(lineitem, li_dir, 4, lambda i: f"part{i}.parquet")
    del lineitem, l_orderkey, l_shipdate

    part = pa.table({
        "p_partkey": pa.array(np.arange(n_pt, dtype=np.int64)),
        "p_brand": pa.array(rng.choice(
            ["Brand#11", "Brand#23", "Brand#34", "Brand#45", "Brand#52"], n_pt)),
        "p_container": pa.array(rng.choice(
            ["SM BOX", "MED BOX", "LG BOX", "SM CASE", "MED CASE", "LG CASE",
             "JUMBO PKG"], n_pt)),
    })
    pt_dir = os.path.join(root, "part")
    write_parts(part, pt_dir, 1, lambda i: f"part{i}.parquet")
    return li_dir, od_dir, pt_dir, n_li, n_od


def build_q3(session, li_dir: str, od_dir: str):
    """TPC-H Q3 as bench.py writes it: lineitem shipped after the cutoff
    joined to orders placed before it, revenue per (order, date,
    priority), the ten largest."""
    from hyperspace_tpu_torch import col, sum_

    li = session.read.parquet(li_dir)
    od = session.read.parquet(od_dir)
    return (li.filter(col("l_shipdate") > CUTOFF)
            .join(od.filter(col("o_orderdate") < CUTOFF),
                  on=col("l_orderkey") == col("o_orderkey"))
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(sum_(col("l_extendedprice") * (1 - col("l_discount"))).alias("revenue"))
            .sort(("revenue", False), "o_orderdate")
            .limit(10))


def build_q17(session, li_dir: str, pt_dir: str):
    """TPC-H Q17 as bench.py writes it: the per-part average quantity as a
    group-by joined back, lineitem of one brand and container below a
    fifth of its part's average, the yearly price."""
    from hyperspace_tpu_torch import avg, col, sum_

    li = session.read.parquet(li_dir)
    pt = session.read.parquet(pt_dir)
    thr = (li.group_by("l_partkey")
           .agg(avg(col("l_quantity")).alias("avg_qty"))
           .select(col("l_partkey").alias("t_partkey"),
                   (col("avg_qty") * 0.2).alias("qty_thr")))
    return (li.join(pt.filter((col("p_brand") == "Brand#23")
                              & (col("p_container") == "MED BOX")),
                    on=col("l_partkey") == col("p_partkey"))
            .join(thr, on=col("l_partkey") == col("t_partkey"))
            .filter(col("l_quantity") < col("qty_thr"))
            .agg(sum_(col("l_extendedprice")).alias("price_sum"))
            .select((col("price_sum") / 7.0).alias("avg_yearly")))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _max_abs_err(a, b) -> float:
    import torch
    if a.dtype == torch.bool:
        a, b = a.to(torch.int64), b.to(torch.int64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max().item()) \
        if a.numel() else 0.0


def check_equal(name: str, got, want, errors: dict) -> None:
    import torch
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    errors[name] = max(errors.get(name, 0.0), err)


def check_kernels(errors: dict) -> int:
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck
    from hyperspace_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    checks = 0

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int64)

    sizes = (1, 3, 4, 5, 130, 4097, 32769, 1_000_003)
    for n in sizes:
        checks += check_masks(n, g, errors)
        # hash_bucket: 1..8 columns, odd and even bucket counts, with and
        # without the hash output; the unaligned view starts 4 bytes in.
        words = [kernels.to_words(ints(n + 1, 0, 2 ** 32)) for _ in range(8)]
        for ncols in (1, 2, 3, 8):
            for nb in (1, 7, 32, 37, 200):
                for offset in (0, 1):
                    cols = [w[offset:offset + n] for w in words[:ncols]]
                    h, b = ck.hash_bucket(cols, nb, with_hash=True)
                    ph, pb = ck.hash_bucket_plain(cols, nb, with_hash=True)
                    check_equal("hash_bucket", h, ph, errors)
                    check_equal("hash_bucket", b, pb, errors)
                    _, b2 = ck.hash_bucket(cols, nb)
                    check_equal("hash_bucket", b2, pb, errors)
                    checks += 3
        # bucket_histogram: ids include -1 pads and ids past the bucket
        # count; 12288 is the largest shared-memory histogram, 12289 and
        # up count with global atomics.
        for nb in (1, 2, 32, 37, 12288, 12289, 50000):
            bids = ints(n + 1, -1, nb + 2).to(torch.int32)
            for offset in (0, 1):
                x = bids[offset:offset + n]
                check_equal("bucket_histogram", ck.bucket_histogram(x, nb),
                            ck.bucket_histogram_plain(x, nb), errors)
                checks += 1
    # A column long enough that every thread of the one-wave mask grid
    # takes more than one grid-stride step.
    checks += check_masks(8_650_755, g, errors)
    return checks + check_minmax(errors)


def check_masks(n: int, g, errors: dict) -> int:
    """compare_mask and range_mask against their plain versions over int32,
    uint32 and float32 columns of n rows (with NaN, +-0.0 and +-inf),
    aligned and unaligned."""
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    i32 = torch.randint(-1000, 1000, (n + 1,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    f32 = (torch.randn(n + 1, generator=g, device=dev) * 100).to(torch.float32)
    specials = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                             -float("inf"), 3.0], device=dev)
    f32[: min(6, n + 1)] = specials[: min(6, n + 1)]
    columns = [
        (i32, [0, 3, -1000, 999, 2 ** 31 - 1]),
        (i32.view(torch.uint32), [0, 3, 2 ** 32 - 1, 2 ** 31]),
        (f32, [0.0, -0.0, 3.0, 0.1, float("inf"), float("nan")]),
    ]
    checks = 0
    for col, lits in columns:
        hi = lits[-2]
        for offset in (0, 1):
            x = col[offset:offset + n]
            for v in lits:
                for op in ck.OPS:
                    check_equal("compare_mask", ck.compare_mask(x, op, v),
                                ck.compare_mask_plain(x, op, v), errors)
                    checks += 1
                for lo_incl in (True, False):
                    for hi_incl in (True, False):
                        check_equal("range_mask", ck.range_mask(x, v, hi, lo_incl, hi_incl),
                                    ck.range_mask_plain(x, v, hi, lo_incl, hi_incl), errors)
                        checks += 1
    return checks


def check_minmax(errors: dict) -> int:
    """masked_minmax against its plain version, bit for bit over all four
    output words (torch.equal would take NaN != NaN and -0.0 == 0.0), with
    the JAX kernel's padding rule and with the sentinels forced (the
    sketch's length classes): int32 and float32; no mask, a random mask,
    all-True, one False, all-False and a mask that hides the NaNs; signed
    zeros in both orders, +-inf, +-FLT_MAX, one NaN bit pattern (the
    canonical NaN, -NaN, a signalling NaN) and several; all-+inf and all
    -inf columns at 32,768 and 65,536 rows, where no lane pads; aligned and
    unaligned."""
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    fmax = torch.finfo(torch.float32).max
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), fmax, -fmax],
                            device=dev)
    nan_bits = {"neg_nan": [-0x400000], "snan": [0x7F800001],
                "several_nans": [0x7FC00001, -0x3FFFFF, 0x7F800001]}
    checks = 0

    def check(x, valid):
        nonlocal checks
        for pad in (None, True):
            got = ck.masked_minmax_words(x, valid, pad)
            want = ck.masked_minmax_words_plain(x, valid, pad)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(
                    f"masked_minmax: kernel words {got.view(torch.int32).tolist()} != plain "
                    f"{want.view(torch.int32).tolist()} ({x.dtype}[{x.shape[0]}], mask "
                    f"{valid is not None}, pad {pad})")
            checks += 1
        errors["masked_minmax"] = errors.get("masked_minmax", 0.0)

    for n in (1, 2, 3, 4, 5, 130, 4097, 32768, 32769, 65536, 1_000_003):
        m = n + 1
        pos = torch.randint(0, m, (8,), generator=g, device=dev)
        base = torch.randn(m, generator=g, device=dev) * 100
        with_specials = base.clone()
        with_specials[pos[:6]] = specials
        with_nan = with_specials.clone()
        with_nan[pos[6]] = float("nan")
        with_nan_bits = []
        for bits in nan_bits.values():
            col = with_specials.clone()
            where = torch.randint(0, m, (len(bits),), generator=g, device=dev)
            col.view(torch.int32)[where] = torch.tensor(bits, dtype=torch.int32, device=dev)
            with_nan_bits.append(col)
        signed_zeros = torch.where(torch.rand(m, generator=g, device=dev) < 0.5,
                                   torch.tensor(0.0, device=dev), torch.tensor(-0.0, device=dev))
        floats = [base, with_specials, with_nan, *with_nan_bits, signed_zeros,
                  signed_zeros.flip(0), torch.full((m,), float("inf"), device=dev),
                  torch.full((m,), -float("inf"), device=dev)]
        ints = torch.randint(-2 ** 31, 2 ** 31, (m,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
        int_edges = ints.clone()
        int_edges[pos[:2]] = torch.tensor([2 ** 31 - 1, -2 ** 31], device=dev,
                                          dtype=torch.int32)
        random_mask = torch.rand(m, generator=g, device=dev) < 0.5
        one_false = torch.ones(m, dtype=torch.bool, device=dev)
        one_false[m // 2] = False
        no_nan_mask = ~torch.isnan(with_nan)
        for offset in (0, 1):
            masks = [None, random_mask[offset:offset + n],
                     torch.ones(n, dtype=torch.bool, device=dev), one_false[offset:offset + n],
                     torch.zeros(n, dtype=torch.bool, device=dev),
                     no_nan_mask[offset:offset + n]]
            for col in floats + [ints, int_edges]:
                x = col[offset:offset + n]
                for valid in masks:
                    check(x, valid)
    return checks + check_minmax_reuse()


def check_minmax_reuse() -> int:
    """masked_minmax's scratch words are kept per stream and put back to 0
    by each launch: 100 calls in a row on each of two streams at once, the
    inputs alternating between two columns of different results (a word
    left over from one call would show in the next), each call's words
    equal to the plain version's; afterwards every scratch buffer is 0."""
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    n = 937_500
    a = torch.randn(n, generator=g, device=dev) * 100
    b = torch.randn(n, generator=g, device=dev)
    b[n // 3] = float("nan")
    valid = torch.rand(n, generator=g, device=dev) < 0.5
    cases = [(a, None), (b, valid), (a, valid), (b, None)]
    want = [ck.masked_minmax_words_plain(x, v) for x, v in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = {i: [] for i in range(len(streams))}
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for call in range(100):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                x, v = cases[(call + i) % len(cases)]
                got[i].append(ck.masked_minmax_words(x, v))
    torch.cuda.synchronize()
    checks = 0
    for i in got:
        for call, words in enumerate(got[i]):
            expect = want[(call + i) % len(cases)]
            if not torch.equal(words.view(torch.int32), expect.view(torch.int32)):
                raise AssertionError(
                    f"masked_minmax on stream {i}, call {call}: {words.view(torch.int32).tolist()}"
                    f" != plain {expect.view(torch.int32).tolist()}")
            checks += 1
    handles = {s.cuda_stream for s in streams}
    kept = [words for (_, stream), (words, _) in ck._SCRATCH.items() if stream in handles]
    if len(kept) != len(streams):
        raise AssertionError(f"{len(kept)} scratch buffers for {len(streams)} streams")
    if any(bool(words.ne(0).any()) for words, _ in ck._SCRATCH.values()):
        raise AssertionError("a masked_minmax scratch buffer was not put back to 0")
    return checks


# ---------------------------------------------------------------------------
# Phases 4-5: the main path.
# ---------------------------------------------------------------------------

def sorted_table(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


def _sorted_columns_on_card(t) -> list:
    """A table's columns sorted lexicographically by all of them, as
    tensors on the card (chained stable sorts, last column first)."""
    import pyarrow as pa
    import torch

    cols = []
    for name in t.column_names:
        arr = t.column(name)
        if pa.types.is_date32(arr.type):
            arr = arr.cast(pa.int32())
        cols.append(torch.from_numpy(arr.to_numpy().copy()).to("cuda"))
    perm = torch.arange(t.num_rows, device="cuda")
    for k in reversed(cols):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return [k[perm] for k in cols]


def same_rows(a, b) -> bool:
    """The same rows in any order: the tables sorted by every column are
    equal. Results of a million rows or more (the cutoff query's 32M) are
    sorted on the card, where pyarrow's sort would take tens of seconds;
    columns without nulls of numeric or date types there."""
    import torch

    if a.column_names != b.column_names or a.num_rows != b.num_rows \
            or a.schema.types != b.schema.types:
        return False
    if a.num_rows < 1_000_000:
        return sorted_table(a).equals(sorted_table(b))
    if any(a.column(c).null_count or b.column(c).null_count for c in a.column_names):
        raise AssertionError("same_rows: nulls in a result sorted on the card")
    return all(torch.equal(x, y) for x, y in zip(_sorted_columns_on_card(a),
                                                _sorted_columns_on_card(b)))


def run_twice(session, df, indexed: bool):
    """Two runs: (tables, seconds, peak device bytes above the base)."""
    import torch
    (session.enable_hyperspace if indexed else session.disable_hyperspace)()
    tables, secs, peaks = [], [], []
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            tables.append(df.to_arrow())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() - base)
    finally:
        session.disable_hyperspace()
    return tables, secs, peaks


def reference(data_dir: str, condition, columns):
    """The query answered by pyarrow alone, from the source files."""
    import pyarrow.dataset as ds
    return ds.dataset(data_dir, format="parquet").to_table(columns=columns,
                                                           filter=condition)


def run_main_path(li_dir: str, n_li: int, system_path: str, results: dict):
    """Phases 4-5. Returns (session, hyperspace, queries) for phase 7."""
    import pyarrow.compute as pc
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import Hyperspace, IndexConfig, IndexConstants, col

    session = ht.Session(system_path=system_path, device="cuda")
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    session.conf.set(IndexConstants.INDEX_ROW_GROUP_SIZE, max(4096, int(n_li / 32 / 8)))
    session.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, n_li + 1)
    session.conf.set(IndexConstants.INDEX_FILTER_RULE_USE_BUCKET_SPEC, "true")
    hs = Hyperspace(session)
    li = session.read.parquet(li_dir)

    builds = {}
    for name, indexed, included, buckets in (
            ("li_idx", ["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"], 32),
            ("li_ship_idx", ["l_shipdate"], ["l_orderkey", "l_extendedprice"], 8)):
        session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, buckets)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs.create_index(li, IndexConfig(name, indexed, included))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        builds[name] = {"seconds": secs, "rows_per_s": n_li / secs,
                        "buckets": buckets,
                        "files": len(hs.index_manager.get_index(name).content.files)}
        log(f"built {name}: {secs:.3f} s ({n_li / secs:,.0f} rows/s)")
    results["builds"] = builds

    # A point key that exists: the first row's order key.
    import pyarrow.parquet as pq
    first = sorted(os.listdir(li_dir))[0]
    key = int(pq.read_table(os.path.join(li_dir, first),
                            columns=["l_orderkey"]).column(0)[0].as_py())
    shipdate = pc.field("l_shipdate")
    queries = {
        "range": (li.filter(col("l_shipdate").between(RANGE_LO, RANGE_HI))
                  .select("l_orderkey", "l_extendedprice"),
                  (shipdate >= RANGE_LO) & (shipdate <= RANGE_HI),
                  ["l_orderkey", "l_extendedprice"], "li_ship_idx"),
        "cutoff": (li.filter(col("l_shipdate") > CUTOFF)
                   .select("l_orderkey", "l_extendedprice"),
                   shipdate > CUTOFF, ["l_orderkey", "l_extendedprice"], "li_ship_idx"),
        "point": (li.filter(col("l_orderkey") == key)
                  .select("l_extendedprice", "l_discount"),
                  pc.field("l_orderkey") == key, ["l_extendedprice", "l_discount"],
                  "li_idx"),
    }
    out = {}
    for name, (df, pa_cond, columns, index_name) in queries.items():
        session.enable_hyperspace()
        leaves = [leaf.simple_string() for leaf in df.optimized_plan().collect_leaves()]
        if not any("IndexScan" in s and f"Name: {index_name}," in s for s in leaves):
            raise AssertionError(f"{name}: plan was not rewritten to {index_name}: {leaves}")
        times, tables = {}, {}
        for mode in ("indexed", "scanned"):
            outs, times[mode], _ = run_twice(session, df, mode == "indexed")
            tables[mode] = outs[-1]
        ref = reference(li_dir, pa_cond, columns)
        REFERENCES[name] = ("rows", ref)
        if not same_rows(tables["indexed"], tables["scanned"]):
            raise AssertionError(f"{name}: indexed result differs from scanned result")
        if not same_rows(tables["scanned"], ref):
            raise AssertionError(f"{name}: result differs from the pyarrow reference")
        if name != "point" and tables["indexed"].num_rows == 0:
            raise AssertionError(f"{name}: matched no rows")
        out[name] = {"rows": tables["indexed"].num_rows,
                     "indexed_s": times["indexed"], "scanned_s": times["scanned"],
                     "index": index_name}
        log(f"{name}: {out[name]['rows']} rows; indexed {times['indexed']} s, "
            f"scanned {times['scanned']} s")
    results["queries"] = out
    results["point_key"] = key
    return session, hs, {name: q[0] for name, q in queries.items()}


def files_meeting(od_dir: str, column: str, keep) -> list:
    """The orders files for which ``keep(values of column)`` holds, read by
    pyarrow alone."""
    import pyarrow.parquet as pq
    out = []
    for f in sorted(os.listdir(od_dir)):
        path = os.path.join(od_dir, f)
        if keep(pq.read_table(path, columns=[column]).column(0)):
            out.append(path)
    return out


def check_minmax_sketch(hs, od_dir: str, name: str = "od_skip", files=None) -> None:
    """The sketch table of ``name`` holds one row for each orders file (or
    each of ``files``), with the file's pyarrow min and max of o_orderdate:
    the masked_minmax results of the build (or of a streaming append)."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    path = [f for f in hs.index_manager.get_index(name).content.files
            if f.endswith("sketches.parquet")][0]
    table = pq.read_table(path, partitioning=None).to_pydict()
    got = {f: (lo, hi) for f, lo, hi in zip(table["_file"], table["minmax__o_orderdate__min"],
                                            table["minmax__o_orderdate__max"])}
    if files is None:
        files = sorted(os.path.join(od_dir, f) for f in os.listdir(od_dir)
                       if f.endswith(".parquet"))
    if len(table["_file"]) != len(files):
        raise AssertionError(f"{name}: {len(table['_file'])} sketch rows for {len(files)} files")
    for full in files:
        f = os.path.basename(full)
        mm = pc.min_max(pq.read_table(full, columns=["o_orderdate"]).column(0)).as_py()
        if got.get(full) != (mm["min"], mm["max"]):
            raise AssertionError(f"{name} sketch of {f}: {got.get(full)} != pyarrow's "
                                 f"{(mm['min'], mm['max'])}")


def run_orders_path(session, hs, od_dir: str, n_od: int, results: dict):
    """Phases 4-5 for orders: the od_idx, od_skip and od_bloom builds, then
    the skipping and bloom queries with hyperspace on and off. Returns
    the queries for phase 7."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import torch

    from hyperspace_tpu_torch import (BloomFilterSketch, DataSkippingIndexConfig,
                                      IndexConfig, IndexConstants, MinMaxSketch, col)

    od = session.read.parquet(od_dir)
    configs = [
        ("od_idx", IndexConfig("od_idx", ["o_orderkey"],
                               ["o_custkey", "o_orderdate", "o_shippriority"])),
        ("od_skip", DataSkippingIndexConfig("od_skip", [MinMaxSketch("o_orderdate")])),
        ("od_bloom", DataSkippingIndexConfig("od_bloom", [BloomFilterSketch(
            "o_orderkey", expected_items=max(n_od // ORDERS_PARTS, 100_000))])),
    ]
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    for name, config in configs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs.create_index(od, config)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        results["builds"][name] = {
            "seconds": secs, "rows_per_s": n_od / secs,
            "files": len(hs.index_manager.get_index(name).content.files)}
        log(f"built {name}: {secs:.3f} s ({n_od / secs:,.0f} rows/s)")
    check_minmax_sketch(hs, od_dir)

    keys = [n_od // 5, n_od // 2, (4 * n_od) // 5]
    date = pc.field("o_orderdate")
    queries = {
        "skipping": (od.filter(col("o_orderdate").between(SKIP_LO, SKIP_HI))
                     .select("o_orderkey", "o_custkey"),
                     (date >= SKIP_LO) & (date <= SKIP_HI), ["o_orderkey", "o_custkey"],
                     files_meeting(od_dir, "o_orderdate", lambda c: (
                         pc.min(c).as_py() <= SKIP_HI and pc.max(c).as_py() >= SKIP_LO))),
        "bloom": (od.filter(col("o_orderkey").isin(keys)).select("o_orderkey", "o_totalprice"),
                  pc.field("o_orderkey").isin(keys), ["o_orderkey", "o_totalprice"],
                  files_meeting(od_dir, "o_orderkey",
                                lambda c: pc.any(pc.is_in(c, value_set=pa.array(keys)))
                                .as_py())),
    }
    for name, (df, pa_cond, columns, holding) in queries.items():
        session.enable_hyperspace()
        leaves = df.optimized_plan().collect_leaves()
        session.disable_hyperspace()
        if len(leaves) != 1 or type(leaves[0]).__name__ != "Scan" \
                or not leaves[0].skipping_note:
            raise AssertionError(f"{name}: plan was not narrowed by a skipping index: "
                                 f"{[leaf.simple_string() for leaf in leaves]}")
        kept = leaves[0].relation.all_files()
        if not len(kept) < ORDERS_PARTS:
            raise AssertionError(f"{name}: kept all {len(kept)} files")
        if name == "skipping" and kept != holding:
            raise AssertionError(f"skipping: MinMax kept {kept}; the files whose "
                                 f"o_orderdate range meets the filter are {holding}")
        if name == "bloom" and set(holding) - set(kept):
            raise AssertionError(f"bloom: dropped files holding a key: "
                                 f"{sorted(set(holding) - set(kept))}")
        times, tables = {}, {}
        for mode in ("indexed", "scanned"):
            outs, times[mode], _ = run_twice(session, df, mode == "indexed")
            tables[mode] = outs[-1]
        ref = sorted_table(reference(od_dir, pa_cond, columns))
        REFERENCES[name] = ("rows", ref)
        for mode in ("indexed", "scanned"):
            if not sorted_table(tables[mode]).equals(ref):
                raise AssertionError(f"{name} ({mode}): result differs from the pyarrow "
                                     "reference")
        if tables["indexed"].num_rows == 0:
            raise AssertionError(f"{name}: matched no rows")
        results["queries"][name] = {
            "rows": tables["indexed"].num_rows, "indexed_s": times["indexed"],
            "scanned_s": times["scanned"], "files_kept": len(kept),
            "files_total": ORDERS_PARTS, "note": leaves[0].skipping_note}
        log(f"{name}: {tables['indexed'].num_rows} rows; {leaves[0].skipping_note}; "
            f"indexed {times['indexed']} s, scanned {times['scanned']} s")
    return {name: q[0] for name, q in queries.items()}


# ---------------------------------------------------------------------------
# Phases 4-5, joins: TPC-H Q3 and Q17 over covering-index joins.
# ---------------------------------------------------------------------------

Q3_COLUMNS = ["l_orderkey", "o_orderdate", "o_shippriority", "revenue"]


def q3_reference(li_dir: str, od_dir: str):
    """Q3 by pyarrow alone: its ten rows as a dict of columns, and whether
    the 10th and 11th revenues lie within REL_TOL (then the 10th's key is
    not decided by the tolerance)."""
    import pyarrow.compute as pc
    import pyarrow.dataset as ds

    li = ds.dataset(li_dir, format="parquet").to_table(
        columns=["l_orderkey", "l_extendedprice", "l_discount"],
        filter=pc.field("l_shipdate") > CUTOFF)
    od = ds.dataset(od_dir, format="parquet").to_table(
        columns=["o_orderkey", "o_orderdate", "o_shippriority"],
        filter=pc.field("o_orderdate") < CUTOFF)
    j = li.join(od, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
    j = j.append_column("rev", pc.multiply(j["l_extendedprice"],
                                           pc.subtract(1.0, j["l_discount"])))
    g = j.group_by(["l_orderkey", "o_orderdate", "o_shippriority"]).aggregate([("rev", "sum")])
    top = g.sort_by([("rev_sum", "descending"), ("o_orderdate", "ascending")]) \
        .slice(0, 11).rename_columns(Q3_COLUMNS).to_pydict()
    tied_last = len(top["revenue"]) > 10 and close(top["revenue"][9], top["revenue"][10])
    return {c: v[:10] for c, v in top.items()}, tied_last


def q17_reference(li_dir: str, pt_dir: str) -> float:
    """Q17's avg_yearly by pyarrow alone."""
    import pyarrow.compute as pc
    import pyarrow.dataset as ds

    li = ds.dataset(li_dir, format="parquet").to_table(
        columns=["l_partkey", "l_quantity", "l_extendedprice"])
    avg = li.group_by("l_partkey").aggregate([("l_quantity", "mean")])
    pt = ds.dataset(pt_dir, format="parquet").to_table(
        columns=["p_partkey"], filter=(pc.field("p_brand") == "Brand#23")
        & (pc.field("p_container") == "MED BOX"))
    j = li.join(pt, keys="l_partkey", right_keys="p_partkey", join_type="inner")
    j = j.join(avg, keys="l_partkey", join_type="inner")
    keep = pc.less(pc.cast(j["l_quantity"], "double"),
                   pc.multiply(j["l_quantity_mean"], 0.2))
    return pc.sum(j.filter(keep)["l_extendedprice"]).as_py() / 7.0


def close(a: float, b: float) -> bool:
    return abs(a - b) <= REL_TOL * max(abs(a), abs(b))


def check_q3(got, ref: dict, tied_last: bool, what: str) -> None:
    """Keys, dates and row count exact, revenue within REL_TOL of ``ref``
    (columns as Q3's); the last key may differ only where the pyarrow
    reference's 10th and 11th revenues lie within REL_TOL of each other
    (``tied_last``)."""
    if got.num_rows != 10 or got.column_names != Q3_COLUMNS:
        raise AssertionError(f"Q3 ({what}): {got.num_rows} rows, columns {got.column_names}")
    g = got.to_pydict()
    for i in range(10):
        if not close(g["revenue"][i], ref["revenue"][i]):
            raise AssertionError(f"Q3 ({what}) row {i}: revenue {g['revenue'][i]!r} != "
                                 f"{ref['revenue'][i]!r}")
        if i == 9 and tied_last:
            continue
        for c in Q3_COLUMNS[:3]:
            if g[c][i] != ref[c][i]:
                raise AssertionError(f"Q3 ({what}) row {i}: {c} {g[c][i]!r} != {ref[c][i]!r}")


def check_q17(got, ref: float, what: str) -> None:
    value = got.column("avg_yearly").to_pylist()
    if got.num_rows != 1 or value[0] is None or not close(value[0], ref):
        raise AssertionError(f"Q17 ({what}): {value} != {ref!r}")


def float_bits(table) -> dict:
    import numpy as np
    return {n: table.column(n).to_numpy().view(np.int64).tolist()
            for n in table.column_names if str(table.column(n).type) == "double"}


def plan_index_names(plan) -> list:
    return [leaf.index_entry.name if hasattr(leaf, "index_entry") else None
            for leaf in plan.collect_leaves()]


def _nodes(plan, kind):
    out = [plan] if isinstance(plan, kind) else []
    for c in plan.children:
        out += _nodes(c, kind)
    return out


def check_q3_plan(q3_plan) -> None:
    """Q3: one Join of IndexScans of li_idx and od_idx with the bucket spec."""
    from hyperspace_tpu_torch.plan.nodes import IndexScan, Join

    joins = _nodes(q3_plan, Join)
    leaves = joins[0].collect_leaves() if len(joins) == 1 else []
    if [getattr(leaf, "index_entry", None) and leaf.index_entry.name for leaf in leaves] \
            != ["li_idx", "od_idx"] or not all(
                isinstance(leaf, IndexScan) and leaf.use_bucket_spec for leaf in leaves):
        raise AssertionError(f"Q3: plan is not a bucketed join of li_idx and od_idx:\n"
                             f"{q3_plan.tree_string()}")


def check_join_plans(q3_plan, q17_plan) -> None:
    """Q3 as check_q3_plan. Q17: li_pk_idx and pt_idx under the first join,
    li_pk_idx under the threshold's Aggregate."""
    from hyperspace_tpu_torch.plan.nodes import Aggregate, Join

    check_q3_plan(q3_plan)
    joins = _nodes(q17_plan, Join)
    first = [j for j in joins if not _nodes(j.left, Join) and not _nodes(j.right, Join)]
    aggs = [a for a in _nodes(q17_plan, Aggregate) if a.group_cols == ["l_partkey"]]
    if len(first) != 1 or plan_index_names(first[0]) != ["li_pk_idx", "pt_idx"] \
            or len(aggs) != 1 or plan_index_names(aggs[0]) != ["li_pk_idx"]:
        raise AssertionError(f"Q17: plan does not read li_pk_idx and pt_idx under its first "
                             f"join and li_pk_idx under the threshold:\n"
                             f"{q17_plan.tree_string()}")


def build_join_indexes(session, hs, li_dir: str, pt_dir: str, builds: dict, log_it=True):
    from hyperspace_tpu_torch import IndexConfig, IndexConstants
    import pyarrow.parquet as pq
    import torch

    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    for name, src, indexed, included in (
            ("li_pk_idx", li_dir, ["l_partkey"], ["l_quantity", "l_extendedprice"]),
            ("pt_idx", pt_dir, ["p_partkey"], ["p_brand", "p_container"])):
        rows = sum(pq.ParquetFile(os.path.join(src, f)).metadata.num_rows
                   for f in os.listdir(src))
        if session.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs.create_index(session.read.parquet(src), IndexConfig(name, indexed, included))
        if session.device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        builds[name] = {"seconds": secs, "rows_per_s": rows / secs, "rows": rows,
                        "buckets": 32,
                        "files": len(hs.index_manager.get_index(name).content.files)}
        if log_it:
            log(f"built {name}: {secs:.3f} s ({rows / secs:,.0f} rows/s)")


def run_joins_path(session, hs, li_dir: str, od_dir: str, pt_dir: str, results: dict):
    """Phases 4-5 for the joins: the li_pk_idx and pt_idx builds, then Q3
    and Q17 indexed and scanned, twice each. Returns the queries for
    phase 7."""
    build_join_indexes(session, hs, li_dir, pt_dir, results["builds"])
    queries = {"q3": build_q3(session, li_dir, od_dir),
               "q17": build_q17(session, li_dir, pt_dir)}
    session.enable_hyperspace()
    plans = {name: df.optimized_plan() for name, df in queries.items()}
    session.disable_hyperspace()
    check_join_plans(plans["q3"], plans["q17"])

    t0 = time.perf_counter()
    q3_ref, tied_last = q3_reference(li_dir, od_dir)
    refs = {"q3": q3_ref, "q17": q17_reference(li_dir, pt_dir)}
    REFERENCES.update(q3=("q3", (q3_ref, tied_last)), q17=("q17", refs["q17"]))
    results["join_reference_s"] = time.perf_counter() - t0
    log(f"pyarrow references in {results['join_reference_s']:.1f} s")

    def check(name, got, ref, what):
        if name == "q3":
            check_q3(got, ref, tied_last, what)
        else:
            check_q17(got, ref, what)

    for name, df in queries.items():
        times, peaks, tables = {}, {}, {}
        for mode in ("indexed", "scanned"):
            tables[mode], times[mode], peaks[mode] = run_twice(session, df, mode == "indexed")
            for out in tables[mode]:
                check(name, out, refs[name], mode)
        first, second = tables["indexed"]
        if not (first.equals(second) and float_bits(first) == float_bits(second)):
            raise AssertionError(f"{name}: the two indexed runs differ in their bytes")
        # Indexed against scanned, under the same rule.
        indexed = tables["indexed"][0]
        check(name, tables["scanned"][0],
              indexed.to_pydict() if name == "q3" else indexed.column(0)[0].as_py(),
              "scanned against indexed")
        out = tables["indexed"][0]
        results["queries"][name] = {
            "rows": out.num_rows, "indexed_s": times["indexed"], "scanned_s": times["scanned"],
            "peak_bytes_indexed": peaks["indexed"], "peak_bytes_scanned": peaks["scanned"],
            "indexes": [n for n in plan_index_names(plans[name]) if n],
            "result": out.to_pydict()}
        log(f"{name}: {out.num_rows} rows; indexed {times['indexed']} s, scanned "
            f"{times['scanned']} s; peak device bytes above the base: indexed "
            f"{peaks['indexed']}, scanned {peaks['scanned']}")
    return queries


# ---------------------------------------------------------------------------
# The sources path: hive partitions and a struct column in one lake.
# ---------------------------------------------------------------------------

# O_ORDERPRIORITY's five values (TPC-H 4.2.3).
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
HIVE_FILES_PER_PARTITION = 4
HIVE_INDEX = "ohp_idx"
HIVE_INDEX_COLUMNS = (["o_attrs.o_orderdate"],
                      ["o_orderkey", "o_orderpriority", "o_attrs.o_totalprice"])


def make_orders_hive(od_dir: str, out_dir: str, seed: int = 0) -> int:
    """A copy of the orders rows partitioned by o_orderpriority (drawn
    uniformly from the five priorities, from ``seed``), 4 files a
    partition, each holding o_orderkey, o_custkey and the struct
    o_attrs<o_orderdate date32, o_totalprice float64>, rows in the orders'
    order. Returns the rows."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    orders = pq.read_table(sorted(os.path.join(od_dir, f) for f in os.listdir(od_dir)),
                           columns=["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"])
    attrs = pa.StructArray.from_arrays(
        [orders.column("o_orderdate").combine_chunks(),
         orders.column("o_totalprice").combine_chunks()],
        ["o_orderdate", "o_totalprice"])
    table = pa.table({"o_orderkey": orders.column("o_orderkey"),
                      "o_custkey": orders.column("o_custkey"), "o_attrs": attrs})
    priority = np.random.default_rng(seed).integers(0, len(PRIORITIES), table.num_rows)
    for p, name in enumerate(PRIORITIES):
        part_dir = os.path.join(out_dir, f"o_orderpriority={name}")
        os.makedirs(part_dir)
        rows = np.nonzero(priority == p)[0]
        for i, piece in enumerate(np.array_split(rows, HIVE_FILES_PER_PARTITION)):
            pq.write_table(table.take(piece), os.path.join(part_dir, f"part-{i:02d}.parquet"))
    return table.num_rows


def sources_queries(df, col, count, sum_) -> dict:
    """The sources path's three queries over the hive lake ``df``, written
    with a package's ``col``, ``count`` and ``sum_``: 1-URGENT orders of
    June and July 1994; orders after the Q3 cutoff; orders and revenue per
    priority (TPC-H Q4's grouping)."""
    return {
        "urgent": df.filter((col("o_orderpriority") == PRIORITIES[0])
                            & col("o_attrs.o_orderdate").between(SKIP_LO, SKIP_HI))
        .select("o_orderkey", "o_orderpriority", "o_attrs.o_orderdate",
                "o_attrs.o_totalprice"),
        "after_cutoff": df.filter(col("o_attrs.o_orderdate") > CUTOFF)
        .select("o_orderkey", "o_attrs.o_totalprice"),
        "by_priority": df.group_by("o_orderpriority").agg(
            count(None).alias("order_count"), sum_(col("o_attrs.o_totalprice")).alias("revenue")),
    }


def sources_reference(hive_dir: str) -> dict:
    """The three queries answered by pyarrow alone: a hive-partitioned
    dataset, the struct leaves projected under their dotted names."""
    import pyarrow.compute as pc
    import pyarrow.dataset as ds

    lake = ds.dataset(hive_dir, format="parquet", partitioning="hive")
    date = pc.field("o_attrs", "o_orderdate")
    price = pc.field("o_attrs", "o_totalprice")
    urgent = lake.to_table(
        filter=(pc.field("o_orderpriority") == PRIORITIES[0]) & (date >= SKIP_LO)
        & (date <= SKIP_HI),
        columns={"o_orderkey": pc.field("o_orderkey"),
                 "o_orderpriority": pc.field("o_orderpriority"),
                 "o_attrs.o_orderdate": date, "o_attrs.o_totalprice": price})
    after = lake.to_table(filter=date > CUTOFF,
                          columns={"o_orderkey": pc.field("o_orderkey"),
                                   "o_attrs.o_totalprice": price})
    groups = lake.to_table(columns={"o_orderpriority": pc.field("o_orderpriority"),
                                    "revenue": price}) \
        .group_by("o_orderpriority").aggregate([("revenue", "count"), ("revenue", "sum")])
    by_priority = {p: (n, s) for p, n, s in zip(groups.column("o_orderpriority").to_pylist(),
                                                groups.column("revenue_count").to_pylist(),
                                                groups.column("revenue_sum").to_pylist())}
    return {"urgent": urgent, "after_cutoff": after, "by_priority": by_priority}


def check_by_priority(got, ref: dict, what: str) -> None:
    rows = got.to_pydict()
    if list(got.column_names) != ["o_orderpriority", "order_count", "revenue"]:
        raise AssertionError(f"by_priority ({what}): columns {got.column_names}")
    if sorted(rows["o_orderpriority"]) != sorted(ref):
        raise AssertionError(f"by_priority ({what}): groups {rows['o_orderpriority']}")
    for p, n, s in zip(rows["o_orderpriority"], rows["order_count"], rows["revenue"]):
        if n != ref[p][0] or not close(s, ref[p][1]):
            raise AssertionError(f"by_priority ({what}): {p}: ({n}, {s}) against pyarrow's "
                                 f"{ref[p]}")


def check_introspection(session, hs, queries: dict, names: list) -> dict:
    """indexes(), index(), explain() and why_not() on the run's lake: every
    index listed ACTIVE, li_idx's extended row, Q3's explain naming li_idx
    and od_idx under "Indexes used", why_not naming od_idx's reason on
    Q17, and neither of those two moving any usage count."""
    before = dict(session._index_usage_counts)
    summary = hs.indexes()
    listed = dict(zip(summary["name"], summary["state"]))
    if sorted(listed) != sorted(names) or set(listed.values()) != {"ACTIVE"}:
        raise AssertionError(f"indexes(): {listed}; the run built {sorted(names)}")
    usage = {n: int(c) for n, c in zip(summary["name"], summary["usageCount"])}
    if usage != {n: before.get(n, 0) for n in names} or usage["li_idx"] <= 0:
        raise AssertionError(f"indexes(): usage counts {usage}, the session's {before}")
    li = hs.index("li_idx").iloc[0]
    if (li["numBuckets"], li["indexFileCount"], li["sourceFileCount"]) != (32, 32, 4):
        raise AssertionError(f"index('li_idx'): {li.to_dict()}")
    text = hs.explain(queries["q3"])
    used = text.split("Indexes used:")[-1]
    if not all(f"{n} (Type: CI" in used for n in ("li_idx", "od_idx")):
        raise AssertionError(f"explain(q3) does not name li_idx and od_idx as used:\n{text}")
    why = hs.why_not(queries["q17"], "od_idx")
    if "[od_idx] COL_SCHEMA_MISMATCH" not in why:
        raise AssertionError(f"why_not(q17, od_idx): {why}")
    if dict(session._index_usage_counts) != before:
        raise AssertionError(f"explain or why_not moved the usage counts: {before} -> "
                             f"{session._index_usage_counts}")
    log(f"introspection: {len(listed)} indexes listed; usage {usage}; why_not(q17, od_idx): "
        f"{why.splitlines()[0]}")
    return {"indexes": listed, "usage": usage, "li_idx": {k: str(v) for k, v in li.items()},
            "why_not_q17_od_idx": why, "explain_q3": text}


def run_sources_path(root: str, session, hs, od_dir: str, queries: dict, results: dict) -> None:
    """A hive copy of orders with a struct column: ohp_idx built in memory
    at the default device budget, the three queries indexed and scanned
    against pyarrow, then the introspection calls on the run's lake."""
    from hyperspace_tpu_torch import IndexConfig, IndexConstants, col, sum_
    from hyperspace_tpu_torch.ops import index_build
    from hyperspace_tpu_torch.plan.expr import count

    out = {}
    results["sources"] = out
    hive_dir = os.path.join(root, "data", "orders_hive")
    t0 = time.perf_counter()
    rows = make_orders_hive(od_dir, hive_dir)
    out.update(rows=rows, datagen_s=time.perf_counter() - t0,
               files=len(PRIORITIES) * HIVE_FILES_PER_PARTITION)
    log(f"sources: {rows:,} orders rows in {out['files']} hive files in "
        f"{out['datagen_s']:.1f} s")

    budget = session.conf.get(IndexConstants.TPU_MAX_CHUNK_ROWS)
    session.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, IndexConstants.TPU_MAX_CHUNK_ROWS_DEFAULT)
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    try:
        hive = session.read.parquet(hive_dir)
        want = ["o_orderkey", "o_custkey", "o_attrs.o_orderdate", "o_attrs.o_totalprice",
                "o_orderpriority"]
        if hive.schema.names != want:
            raise AssertionError(f"sources: schema {hive.schema.names}, not {want}")
        chunks = index_build.CHUNK_STATS["chunks"]
        torch_sync()
        t0 = time.perf_counter()
        hs.create_index(hive, IndexConfig(HIVE_INDEX, *HIVE_INDEX_COLUMNS))
        torch_sync()
        secs = time.perf_counter() - t0
        if index_build.CHUNK_STATS["chunks"] != chunks:
            raise AssertionError(f"sources: {HIVE_INDEX} took the chunked build; partition "
                                 "columns and struct leaves must take the in-memory one")
        entry = hs.index_manager.get_index(HIVE_INDEX)
        if check_bucket_layout(entry, "o_attrs.o_orderdate") != rows:
            raise AssertionError(f"sources: {HIVE_INDEX} does not hold every row")
        out["build"] = {"seconds": secs, "rows_per_s": rows / secs,
                        "files": len(entry.content.files)}
        log(f"built {HIVE_INDEX}: {secs:.3f} s ({rows / secs:,.0f} rows/s)")

        t0 = time.perf_counter()
        refs = sources_reference(hive_dir)
        out["reference_s"] = time.perf_counter() - t0
        qs = sources_queries(session.read.parquet(hive_dir), col, count, sum_)
        for name, df in qs.items():
            session.enable_hyperspace()
            indexed_plan = df.optimized_plan()
            session.disable_hyperspace()
            scanned_plan = df.optimized_plan()
            names = plan_index_names(indexed_plan)
            if name != "by_priority" and names != [HIVE_INDEX]:
                raise AssertionError(f"sources {name}: plan reads {names}, not {HIVE_INDEX}")
            kept = [len(leaf.relation.all_files()) for leaf in scanned_plan.collect_leaves()]
            if name == "urgent" and kept != [HIVE_FILES_PER_PARTITION]:
                raise AssertionError(f"sources urgent: the scan keeps {kept} files, not "
                                     f"{HIVE_FILES_PER_PARTITION} of {out['files']}")
            times, peaks, tables = {}, {}, {}
            for mode in ("indexed", "scanned"):
                tables[mode], times[mode], peaks[mode] = run_twice(session, df,
                                                                   mode == "indexed")
            for mode in ("indexed", "scanned"):
                for t in tables[mode]:
                    if name == "by_priority":
                        check_by_priority(t, refs[name], mode)
                    elif not same_rows(t, refs[name]):
                        raise AssertionError(f"sources {name} ({mode}): result differs from "
                                             f"the pyarrow reference: {t.schema} against "
                                             f"{refs[name].schema}")
            if name != "by_priority" and tables["indexed"][0].num_rows == 0:
                raise AssertionError(f"sources {name}: matched no rows")
            out.setdefault("queries", {})[name] = {
                "rows": tables["indexed"][0].num_rows, "columns": tables["indexed"][0].column_names,
                "indexed_s": times["indexed"], "scanned_s": times["scanned"],
                "peak_bytes_indexed": peaks["indexed"], "peak_bytes_scanned": peaks["scanned"],
                "indexes": names, "scanned_files_kept": kept}
            log(f"sources {name}: {tables['indexed'][0].num_rows} rows; indexed "
                f"{times['indexed']} s, scanned {times['scanned']} s; peak device bytes "
                f"{peaks['indexed']} / {peaks['scanned']}; scanned files kept {kept}")
    finally:
        session.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, budget)
    names = [n for n in results["builds"]] + [HIVE_INDEX]
    out["introspection"] = check_introspection(session, hs, queries, names)


# ---------------------------------------------------------------------------
# The formats path: the writer (bucket_by, partition_by; csv, json, avro),
# the csv, json, orc and avro readers, and indexes over a csv source.
# ---------------------------------------------------------------------------

FORMATS_BUCKETS = 32
FORMATS_WRITE_COLUMNS = ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
                         "l_shipdate"]
# The point key and the o_orderdate window (days after the orders' first
# date) of the queries over the csv copy: the window crosses the boundary
# of the 6th and 7th of the 16 time-ordered files.
FORMATS_DATE_WINDOW = (840, 930)


def make_orders_priority(od_dir: str, out_dir: str, seed: int = 0) -> int:
    """A copy of the orders files, file for file, with o_orderpriority
    drawn uniformly from the five priorities (from ``seed``). Returns the
    rows."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir)
    rows = 0
    for f in sorted(os.listdir(od_dir)):
        t = pq.read_table(os.path.join(od_dir, f))
        prio = np.asarray(PRIORITIES)[rng.integers(0, len(PRIORITIES), t.num_rows)]
        pq.write_table(t.append_column("o_orderpriority", pa.array(prio)),
                       os.path.join(out_dir, f))
        rows += t.num_rows
    return rows


def same_under_mapping(got, source, what: str) -> None:
    """``got`` (read back from another format) equals ``source`` rows for
    row, each source column cast to the type the reader gave it (the JAX
    package's pyarrow inference: int32 as int64 from csv and json; from
    json, a date as the string pandas' ISO format wrote,
    "1992-01-01T00:00:00.000"); keys, counts, dates, strings and floats
    exact."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if got.column_names != source.column_names or got.num_rows != source.num_rows:
        raise AssertionError(f"{what}: {got.column_names} x {got.num_rows} rows, the source "
                             f"{source.column_names} x {source.num_rows}")
    for name in source.column_names:
        want = source.column(name)
        have = got.column(name)
        if pa.types.is_date32(want.type) and pa.types.is_string(have.type):
            want = pc.binary_join_element_wise(want.cast(pa.string()), "T00:00:00.000", "")
        elif have.type != want.type:
            want = want.cast(have.type)
        if not have.equals(want):
            raise AssertionError(f"{what}: column {name} differs from the source")


def by_key(table, key: str):
    return table.sort_by([(key, "ascending")])


def bucket_dir_rows(out_dir: str, files=None) -> int:
    """check_bucket_layout over a bucket_by output directory."""
    import types
    files = files if files is not None else sorted(
        os.path.join(out_dir, f) for f in os.listdir(out_dir) if f.endswith(".parquet"))
    return check_bucket_layout(types.SimpleNamespace(
        name=os.path.basename(out_dir), num_buckets=FORMATS_BUCKETS), "l_orderkey", files)


def column_sums(table_or_dir) -> dict:
    """Integer sums (dates as days) and float64 sums of a table or a
    parquet directory: the checksum of a rewrite that reorders rows (the
    integers exact, the floats within REL_TOL relative)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    t = pq.read_table(table_or_dir) if isinstance(table_or_dir, str) else table_or_dir
    out = {}
    for name in t.column_names:
        c = t.column(name)
        if pa.types.is_date32(c.type):
            c = c.cast(pa.int32())
        if pa.types.is_integer(c.type):
            c = c.cast(pa.int64())
        out[name] = pc.sum(c).as_py()
    return out


def run_formats_path(root: str, li_dir: str, od_dir: str, n_li: int, n_od: int,
                     results: dict) -> None:
    """The writer and the other readers on phase 3's lake, in a session of
    their own (see the module docstring)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.orc as pa_orc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import (DataSkippingIndexConfig, HyperspaceException,
                                      IndexConfig, IndexConstants, MinMaxSketch, col)
    from hyperspace_tpu_torch.ops import index_build
    from hyperspace_tpu_torch.plan.nodes import IndexScan, Scan

    out = results["formats"] = {}
    base = os.path.join(root, "formats")
    session = ht.Session(system_path=os.path.join(base, "indexes"), device="cuda")
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, FORMATS_BUCKETS)
    hs = ht.Hyperspace(session)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - mem0

    # 1. bucket_by(32, l_orderkey) over all lineitem rows, then appends.
    bucketed = os.path.join(base, "lineitem_bucketed")
    df = session.read.parquet(li_dir).select(*FORMATS_WRITE_COLUMNS)
    _, secs, peak = timed(lambda: df.write.bucket_by(FORMATS_BUCKETS, "l_orderkey")
                          .parquet(bucketed))
    first = sorted(f for f in os.listdir(bucketed) if f.endswith(".parquet"))
    if len(first) != FORMATS_BUCKETS:
        raise AssertionError(f"formats: bucket_by wrote {len(first)} files, not "
                             f"{FORMATS_BUCKETS}")
    if bucket_dir_rows(bucketed) != n_li:
        raise AssertionError("formats: the bucketed files do not hold every lineitem row")
    with open(os.path.join(bucketed, "_bucket_spec.json")) as f:
        spec = json.load(f)
    if spec != {"numBuckets": FORMATS_BUCKETS, "columns": ["l_orderkey"]}:
        raise AssertionError(f"formats: bucket spec {spec}")
    source = pq.read_table(li_dir, columns=FORMATS_WRITE_COLUMNS)
    have, want = column_sums(bucketed), column_sums(source)
    if any(not close(have[c], want[c]) if isinstance(want[c], float) else have[c] != want[c]
           for c in want):
        raise AssertionError(f"formats: the bucketed files' column sums {have} differ from "
                             f"lineitem's {want}")
    out["bucketed_write"] = {"rows": n_li, "seconds": secs, "rows_per_s": n_li / secs,
                             "peak_device_bytes": peak, "files": len(first)}
    log(f"formats: bucket_by({FORMATS_BUCKETS}, l_orderkey) of {n_li:,} rows in {secs:.2f} s "
        f"({n_li / secs:,.0f} rows/s), peak device {peak / 2**30:.3f} GiB")
    small = df.filter(col("l_orderkey") < n_li // 400)
    _, secs, _ = timed(lambda: small.write.mode("append").bucket_by(
        FORMATS_BUCKETS, "l_orderkey").parquet(bucketed))
    added = sorted(set(f for f in os.listdir(bucketed) if f.endswith(".parquet")) - set(first))
    added_rows = bucket_dir_rows(bucketed, [os.path.join(bucketed, f) for f in added])
    want_rows = pc.sum(pc.less(source.column("l_orderkey"), n_li // 400)).as_py()
    added_buckets = {index_build.bucket_id_from_file(f) for f in added}
    # From SF1 up the appended rows (about 600k at SF10) meet every bucket.
    every = want_rows >= 100 * FORMATS_BUCKETS
    if len(added_buckets) != len(added) or added_rows != want_rows or (
            every and len(added) != FORMATS_BUCKETS):
        raise AssertionError(f"formats: the append added {len(added)} files of {added_rows} "
                             f"rows, not one per bucket of {want_rows}")
    try:
        small.write.mode("append").bucket_by(FORMATS_BUCKETS // 2, "l_orderkey").parquet(
            bucketed)
    except HyperspaceException as e:
        refusal = str(e)
    else:
        raise AssertionError("formats: an append with another bucket spec was accepted")
    if "does not match the existing layout" not in refusal:
        raise AssertionError(f"formats: the other spec was refused as {refusal!r}")
    out["bucketed_append"] = {"rows": added_rows, "files": len(added), "seconds": secs}
    del source
    shutil.rmtree(bucketed)

    # The orders source of steps 2-4: phase 3's orders with a priority.
    t0 = time.perf_counter()
    op_dir = os.path.join(base, "orders_p")
    make_orders_priority(od_dir, op_dir)
    orders = pq.read_table(op_dir)
    out["datagen_s"] = time.perf_counter() - t0
    o_files = sorted(os.path.join(op_dir, f) for f in os.listdir(op_dir))
    d0 = pc.min(orders.column("o_orderdate")).as_py()
    lo = d0 + datetime.timedelta(days=FORMATS_DATE_WINDOW[0])
    hi = d0 + datetime.timedelta(days=FORMATS_DATE_WINDOW[1])

    # 2. partition_by(o_orderpriority), read back and queried.
    parted = os.path.join(base, "orders_parted")
    _, secs, peak = timed(lambda: session.read.parquet(op_dir).write.partition_by(
        "o_orderpriority").parquet(parted))
    # pyarrow escapes the directory names ("4-NOT%20SPECIFIED"); neither
    # package's partition discovery unescapes them (ROADMAP queue C 16).
    dirs = sorted(os.listdir(parted))
    if dirs != [f"o_orderpriority={urllib.parse.quote(p)}" for p in PRIORITIES]:
        raise AssertionError(f"formats: partition directories {dirs}")
    back = session.read.parquet(parted)
    q = back.filter((col("o_orderpriority") == PRIORITIES[0])
                    & col("o_orderdate").between(lo, hi)).select(
        "o_orderkey", "o_orderdate", "o_totalprice", "o_orderpriority")
    kept = [len(leaf.relation.all_files()) for leaf in q.optimized_plan().collect_leaves()]
    all_files = len(back.plan.relation.all_files())
    got, q_secs, _ = timed(q.to_arrow)
    mask = pc.and_(pc.equal(orders.column("o_orderpriority"), PRIORITIES[0]),
                   pc.and_(pc.greater_equal(orders.column("o_orderdate"), lo),
                           pc.less_equal(orders.column("o_orderdate"), hi)))
    want = orders.filter(mask).select(["o_orderkey", "o_orderdate", "o_totalprice",
                                       "o_orderpriority"])
    if kept != [1] or all_files != len(PRIORITIES):
        raise AssertionError(f"formats: the partition filter kept {kept} of {all_files} files")
    if got.num_rows == 0 or not by_key(got, "o_orderkey").equals(by_key(want, "o_orderkey")):
        raise AssertionError("formats: the partitioned query differs from pyarrow's")
    if back.count() != n_od:
        raise AssertionError("formats: the partitioned copy does not hold every order")
    out["partitioned"] = {"rows": n_od, "write_s": secs, "rows_per_s": n_od / secs,
                          "peak_device_bytes": peak, "query_s": q_secs,
                          "query_rows": got.num_rows, "files_kept": kept[0],
                          "files": all_files}
    log(f"formats: partition_by(o_orderpriority) in {secs:.2f} s; the query keeps "
        f"{kept[0]}/{all_files} files, {got.num_rows} rows in {q_secs:.3f} s")
    shutil.rmtree(parted)

    # 3. csv (one append per orders file), orc at full size, json and avro
    #    of one orders file; each read back through session.read.
    csv_dir = os.path.join(base, "orders_csv")

    def write_csv():
        for f in o_files:
            session.read.parquet(f).write.mode("append").csv(csv_dir)

    _, csv_write_s, _ = timed(write_csv)
    got, csv_read_s, _ = timed(lambda: session.read.csv(csv_dir).to_arrow())
    same_under_mapping(by_key(got, "o_orderkey"), orders, "formats csv")
    orc_dir = os.path.join(base, "orders_orc")
    os.makedirs(orc_dir)
    _, orc_write_s, _ = timed(lambda: pa_orc.write_table(orders, os.path.join(orc_dir,
                                                                                "part0.orc")))
    got, orc_read_s, _ = timed(lambda: session.read.orc(orc_dir).to_arrow())
    same_under_mapping(got, orders, "formats orc")
    one = pq.read_table(o_files[0])
    fmt_times = {"csv": {"rows": n_od, "files": len(o_files), "write_s": csv_write_s,
                         "read_s": csv_read_s},
                 "orc": {"rows": n_od, "files": 1, "write_s": orc_write_s,
                         "read_s": orc_read_s}}
    for fmt in ("json", "avro"):
        d = os.path.join(base, f"orders_{fmt}")
        _, w_secs, _ = timed(lambda: getattr(session.read.parquet(o_files[0]).write, fmt)(d))
        got, r_secs, _ = timed(lambda: getattr(session.read, fmt)(d).to_arrow())
        same_under_mapping(got, one, f"formats {fmt}")
        fmt_times[fmt] = {"rows": one.num_rows, "files": 1, "write_s": w_secs,
                          "read_s": r_secs}
    # The session's avro read decodes through the native library; the
    # plain (Python) decoder is timed on the same file here, and only here.
    from hyperspace_tpu_torch.util import avro as tavro
    avro_file = os.path.join(base, "orders_avro",
                             sorted(f for f in os.listdir(os.path.join(base, "orders_avro"))
                                    if f.endswith(".avro"))[0])
    native_t, native_s, _ = timed(lambda: tavro.read_avro(avro_file))
    plain_t, plain_s, _ = timed(lambda: tavro.read_avro_plain(avro_file))
    if not native_t.equals(plain_t):
        raise AssertionError("formats avro: the native decoder's table differs from the "
                             "plain decoder's")
    fmt_times["avro"].update(decoder="native", decode_s=native_s, plain_decode_s=plain_s)
    out["formats"] = fmt_times
    log(f"formats: write and read back {fmt_times}")

    # 4. A covering index and a MinMax sketch over the csv copy.
    csv_df = session.read.csv(csv_dir)
    _, secs, peak = timed(lambda: hs.create_index(csv_df, IndexConfig(
        "csv_od_idx", ["o_orderkey"], ["o_orderdate", "o_totalprice"])))
    entry = hs.index_manager.get_index("csv_od_idx")
    if check_bucket_layout(entry, "o_orderkey") != n_od:
        raise AssertionError("formats: csv_od_idx does not hold every order")
    _, sk_secs, _ = timed(lambda: hs.create_index(csv_df, DataSkippingIndexConfig(
        "csv_od_skip", [MinMaxSketch("o_orderdate")])))
    out["csv_builds"] = {"csv_od_idx": {"seconds": secs, "rows_per_s": n_od / secs,
                                        "peak_device_bytes": peak},
                         "csv_od_skip": {"seconds": sk_secs}}
    key = n_od // 2 + 7
    point = csv_df.filter(col("o_orderkey") == key).select("o_orderkey", "o_orderdate",
                                                            "o_totalprice")
    window = csv_df.filter(col("o_orderdate").between(lo, hi)).select(
        "o_orderkey", "o_orderdate", "o_totalprice")
    after = csv_df.filter(col("o_orderdate") > hi).select("o_orderkey", "o_orderdate",
                                                           "o_totalprice")
    meets = 0
    for f in o_files:
        dates = pq.read_table(f, columns=["o_orderdate"]).column(0)
        meets += pc.min(dates).as_py() <= hi and pc.max(dates).as_py() >= lo
    refs = {"point": orders.filter(pc.equal(orders.column("o_orderkey"), key)),
            "window": orders.filter(pc.and_(pc.greater_equal(orders.column("o_orderdate"), lo),
                                            pc.less_equal(orders.column("o_orderdate"), hi))),
            "after": orders.filter(pc.greater(orders.column("o_orderdate"), hi))}
    out["csv_queries"] = {}
    for name, qdf in (("point", point), ("window", window), ("after", after)):
        session.enable_hyperspace()
        plan = qdf.optimized_plan()
        session.disable_hyperspace()
        leaves = plan.collect_leaves()
        if name == "point" and not any(isinstance(leaf, IndexScan) for leaf in leaves):
            raise AssertionError(f"formats point: no IndexScan in\n{plan.tree_string()}")
        kept = [len(leaf.relation.all_files()) for leaf in leaves if isinstance(leaf, Scan)]
        if name == "window" and (kept != [meets] or not 2 <= meets <= 3):
            raise AssertionError(f"formats window: the scan keeps {kept} of 16 files, the "
                                 f"window meets {meets}")
        tables, times, peaks = {}, {}, {}
        for mode in ("indexed", "scanned"):
            tables[mode], times[mode], peaks[mode] = run_twice(session, qdf,
                                                               mode == "indexed")
        want = refs[name].select(["o_orderkey", "o_orderdate", "o_totalprice"])
        for mode, ts in tables.items():
            for t in ts:
                same_under_mapping(by_key(t, "o_orderkey"), want, f"formats {name} ({mode})")
        if want.num_rows == 0:
            raise AssertionError(f"formats {name}: the reference holds no row")
        out["csv_queries"][name] = {"rows": want.num_rows, "indexed_s": times["indexed"],
                                    "scanned_s": times["scanned"], "files_kept": kept,
                                    "peak_bytes_indexed": peaks["indexed"],
                                    "peak_bytes_scanned": peaks["scanned"]}
        log(f"formats csv {name}: {want.num_rows} rows; indexed {times['indexed']} s, "
            f"scanned {times['scanned']} s; files kept {kept}")
    del session, hs
    shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------
# The lake path: delta and iceberg tables with time travel, and an index that
# lives on an object store.
# ---------------------------------------------------------------------------

LAKE_BUCKETS = 32
LAKE_COLUMNS = ["o_orderkey", "o_orderdate", "o_totalprice"]
LAKE_SCHEME = "hsobj"
# The delta table's version 0 holds orders files 0-11; version 1 appends
# files 12-13.
LAKE_DELTA_FILES = 12
LAKE_DELTA_APPENDED = 2


def object_store_double(root: str):
    """A store of the ``hsobj://`` scheme over the local directory ``root``,
    behaving as an object store: the data side is a pyarrow
    SubTreeFileSystem behind a handler that counts every call and fails any
    move (an object store has no rename); the log side creates each entry
    with O_EXCL (the conditional put) and overwrites latestStable in place.
    Neither needs fsspec. Returns (data store, log store, call counts)."""
    import collections
    import posixpath

    import pyarrow.fs as pafs

    from hyperspace_tpu_torch.index import data_store, log_store

    calls = collections.Counter()
    base = pafs.SubTreeFileSystem(root, pafs.LocalFileSystem())
    prefix = LAKE_SCHEME + "://"

    class Handler(pafs.FileSystemHandler):
        def get_type_name(self):
            return LAKE_SCHEME

        def normalize_path(self, path):
            return path

        def get_file_info(self, paths):
            calls["info"] += len(paths)
            return base.get_file_info(paths)

        def get_file_info_selector(self, selector):
            calls["list"] += 1
            return base.get_file_info(selector)

        def create_dir(self, path, recursive):
            calls["mkdir"] += 1
            base.create_dir(path, recursive=recursive)

        def delete_dir(self, path):
            calls["delete"] += 1
            base.delete_dir(path)

        def delete_dir_contents(self, path, missing_dir_ok=False):
            calls["delete"] += 1
            base.delete_dir_contents(path, missing_dir_ok=missing_dir_ok)

        def delete_root_dir_contents(self):
            raise AssertionError("object store: a delete of the whole store")

        def delete_file(self, path):
            calls["delete"] += 1
            base.delete_file(path)

        def move(self, src, dest):
            calls["rename"] += 1
            raise AssertionError(f"object store: a rename of {src} to {dest}")

        def copy_file(self, src, dest):
            calls["copy"] += 1
            base.copy_file(src, dest)

        def open_input_stream(self, path):
            calls["get"] += 1
            return base.open_input_stream(path)

        def open_input_file(self, path):
            calls["get"] += 1
            return base.open_input_file(path)

        def open_output_stream(self, path, metadata):
            calls["put"] += 1
            return base.open_output_stream(path, metadata=metadata)

        def open_append_stream(self, path, metadata):
            raise AssertionError(f"object store: an append to {path}")

    fs = pafs.PyFileSystem(Handler())

    class Store(data_store.DataStore):
        def filesystem(self):
            return fs

        def normalize(self, path):
            return path[len(prefix):] if path.startswith(prefix) else path

        def _info(self, path):
            return fs.get_file_info(self.normalize(path))

        def is_dir(self, path):
            return self._info(path).type == pafs.FileType.Directory

        def list_dir(self, path):
            if not self.is_dir(path):
                return []
            return sorted(posixpath.basename(i.path) for i in
                          fs.get_file_info(pafs.FileSelector(self.normalize(path))))

        def list_leaf_files(self, path):
            if not self.is_dir(path):
                return []
            p = self.normalize(path).rstrip("/")
            out = []
            for i in fs.get_file_info(pafs.FileSelector(p, recursive=True)):
                rel = i.path[len(p):].lstrip("/")
                if i.type == pafs.FileType.File and \
                        not any(s.startswith((".", "_")) for s in rel.split("/")):
                    out.append(prefix + i.path)
            return sorted(out)

        def file_info(self, path):
            i = self._info(path)
            if i.type != pafs.FileType.File:
                raise FileNotFoundError(path)
            return (path, int(i.size), int(i.mtime_ns // 1_000_000))

        def makedirs(self, path):
            fs.create_dir(self.normalize(path), recursive=True)

        def delete_recursively(self, path):
            i = self._info(path)
            if i.type == pafs.FileType.Directory:
                fs.delete_dir(i.path)
            elif i.type == pafs.FileType.File:
                fs.delete_file(i.path)

    class Logs(log_store.LogStore):
        @staticmethod
        def _local(path):
            return os.path.join(root, path[len(prefix):])

        def put_if_absent(self, path, data):
            calls["log_put"] += 1
            local = self._local(path)
            os.makedirs(os.path.dirname(local), exist_ok=True)
            try:
                fd = os.open(local, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return False
            with os.fdopen(fd, "w") as f:
                f.write(data)
            return True

        def put_overwrite(self, path, data):
            calls["log_put"] += 1
            local = self._local(path)
            os.makedirs(os.path.dirname(local), exist_ok=True)
            with open(local, "w") as f:
                f.write(data)

        def read(self, path):
            calls["log_get"] += 1
            try:
                with open(self._local(path)) as f:
                    return f.read()
            except FileNotFoundError:
                return None

        def list_numeric_ids(self, dirpath):
            calls["log_list"] += 1
            d = self._local(dirpath)
            return [int(n) for n in os.listdir(d) if n.isdigit()] if os.path.isdir(d) else []

        def delete(self, path):
            calls["log_delete"] += 1
            try:
                os.unlink(self._local(path))
            except FileNotFoundError:
                pass
            return True

    return Store(), Logs(), calls


def part_ranges(paths) -> dict:
    """Each parquet file's pyarrow min and max of o_orderdate."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    out = {}
    for p in paths:
        mm = pc.min_max(pq.read_table(p, columns=["o_orderdate"]).column(0)).as_py()
        out[p] = (mm["min"], mm["max"])
    return out


def snapshot_reference(paths, condition):
    """The query answered by pyarrow alone over a snapshot's files."""
    import pyarrow.dataset as pa_ds
    return pa_ds.dataset(list(paths), format="parquet").to_table(columns=LAKE_COLUMNS,
                                                                 filter=condition)


def shifted_rows(table, key_offset: int):
    """``table``'s rows with their order keys moved past every existing key
    (new orders on the same dates)."""
    import pyarrow.compute as pc
    i = table.column_names.index("o_orderkey")
    return table.set_column(i, "o_orderkey", pc.add(table.column("o_orderkey"), key_offset))


def run_lake_path(root: str, od_dir: str, n_od: int, results: dict) -> None:
    """Delta and iceberg tables made from phase 3's orders, and a covering
    index on an object store (see the module docstring)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import (DataSkippingIndexConfig, IndexConfig, IndexConstants,
                                      MinMaxSketch, col)
    from hyperspace_tpu_torch.index import data_store, log_store
    from hyperspace_tpu_torch.lake import DeltaTable, IcebergTable
    from hyperspace_tpu_torch.plan.nodes import IndexScan, Scan

    out = results["lake"] = {"seconds_of": {}, "queries": {}, "plans": {}}
    secs_of = out["seconds_of"]
    base = os.path.join(root, "lake")
    os.makedirs(base)
    files = sorted(os.path.join(od_dir, f) for f in os.listdir(od_dir))
    step = n_od // ORDERS_PARTS
    date = pc.field("o_orderdate")
    hybrid_key = IndexConstants.INDEX_HYBRID_SCAN_ENABLED

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        secs_of[name] = time.perf_counter() - t0
        log(f"lake: {name} in {secs_of[name]:.3f} s")
        return value

    def new_session(system_path):
        s = ht.Session(system_path=system_path, device="cuda")
        s.conf.set(IndexConstants.INDEX_NUM_BUCKETS, LAKE_BUCKETS)
        s.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, n_od + 1)
        return s, ht.Hyperspace(s)

    def read(paths):
        return pa.concat_tables([pq.read_table(p) for p in paths])

    def leaf_of(session, df, hybrid: bool):
        session.conf.set(hybrid_key, str(hybrid).lower())
        session.enable_hyperspace()
        try:
            leaves = df.optimized_plan().collect_leaves()
        finally:
            session.disable_hyperspace()
        if len(leaves) != 1:
            raise AssertionError(f"lake: {len(leaves)} leaves in one query's plan")
        return leaves[0]

    def covering_plan(what, session, df, hybrid, index, log_id, note=""):
        """The plan reads ``index`` at op-log id ``log_id`` (None: any),
        its IndexScan saying ``note``."""
        leaf = leaf_of(session, df, hybrid)
        text = leaf.simple_string()
        if not isinstance(leaf, IndexScan) or leaf.index_entry.name != index \
                or (log_id is not None and leaf.index_entry.id != log_id) or note not in text:
            raise AssertionError(f"lake {what}: the plan reads {text}, not {index} at log id "
                                 f"{log_id} with {note!r}")
        out["plans"][what] = {"index": index, "log_id": leaf.index_entry.id,
                              "log_version": leaf.index_entry.log_version, "leaf": text}

    def check_answer(what, session, df, hybrid, ref):
        """Two runs, cold then warm, each equal to ``ref``."""
        session.conf.set(hybrid_key, str(hybrid).lower())
        tables, secs, _ = run_twice(session, df, True)
        for t in tables:
            if not same_rows(t, ref):
                raise AssertionError(f"lake {what}: the answer differs from pyarrow's over "
                                     "the snapshot's files")
        if ref.num_rows == 0:
            raise AssertionError(f"lake {what}: the reference holds no row")
        out["queries"][what] = {"rows": ref.num_rows, "cold_s": secs[0], "warm_s": secs[1]}
        log(f"lake {what}: {ref.num_rows} rows; cold {secs[0]:.3f} s, warm {secs[1]:.3f} s")

    # 1. Delta: v0 = files 0-11 as 12 parts; dl_od_idx at v0; v1 appends
    # files 12-13; v2 removes the earliest part.
    d_path = os.path.join(base, "delta")
    table = DeltaTable(d_path)
    timed("delta_create", lambda: table.create(read(files[:LAKE_DELTA_FILES]),
                                               max_rows_per_file=step))
    ranges0 = part_ranges(table.snapshot(0).file_paths)
    if len(ranges0) != LAKE_DELTA_FILES:
        raise AssertionError(f"lake: delta v0 holds {len(ranges0)} parts")
    earliest, second = sorted(ranges0, key=ranges0.get)[:2]
    # The day the earliest part shares with the next one (at SF10 every
    # part boundary splits a day), so the point query keeps rows after the
    # earliest part is removed.
    point_day = ranges0[second][0]
    session, hs = new_session(os.path.join(base, "indexes"))
    session.conf.set(IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    timed("dl_od_idx_build", lambda: hs.create_index(session.read.delta(d_path), IndexConfig(
        "dl_od_idx", ["o_orderdate"], ["o_orderkey", "o_totalprice"])))
    timed("delta_append", lambda: table.append(
        read(files[LAKE_DELTA_FILES:LAKE_DELTA_FILES + LAKE_DELTA_APPENDED]),
        max_rows_per_file=step))
    appended = [p for p in table.snapshot(1).file_paths if p not in ranges0]
    first_new = min(part_ranges(appended).values())[0]
    last_old = max(r[1] for r in ranges0.values())
    lo = last_old - datetime.timedelta(days=10)
    hi = first_new + datetime.timedelta(days=10)
    conditions = {"point": date == point_day, "window": (date >= lo) & (date <= hi)}

    def delta_queries(df):
        return {"point": df.filter(col("o_orderdate") == point_day).select(*LAKE_COLUMNS),
                "window": df.filter(col("o_orderdate").between(lo, hi)).select(*LAKE_COLUMNS)}

    def delta_round(tag, version, hybrid, log_id, note):
        df = session.read.delta(d_path, version_as_of=version)
        paths = table.snapshot(version).file_paths
        for name, q in delta_queries(df).items():
            covering_plan(f"delta_{tag}_{name}", session, q, hybrid, "dl_od_idx", log_id, note)
            check_answer(f"delta_{tag}_{name}", session, q, hybrid,
                         snapshot_reference(paths, conditions[name]))

    delta_round("v1_hybrid", None, True, 1, f"hybrid(+{LAKE_DELTA_APPENDED} appended, -0 "
                                            "deleted files)")
    timed("delta_remove", lambda: table.remove_files([earliest]))
    delta_round("v2_hybrid", None, True, 1, f"hybrid(+{LAKE_DELTA_APPENDED} appended, -1 "
                                            "deleted files)")
    timed("dl_od_idx_refresh_incremental",
          lambda: hs.refresh_index("dl_od_idx", "incremental"))
    delta_round("v2_refreshed", None, False, 3, "")
    # Time travel to v0 takes the log version built at v0.
    delta_round("v0_time_travel", 0, False, 1, "")
    history = hs.index_manager.get_index("dl_od_idx").derivedDataset.properties[
        "deltaVersionHistory"]
    if history != "1:0,3:2":
        raise AssertionError(f"lake: dl_od_idx's deltaVersionHistory is {history}")
    out["delta_version_history"] = history

    # 2. Iceberg: all 16 files as one snapshot; ib_od_skip; a window that
    # keeps exactly the parts whose range meets it; one appended snapshot.
    i_path = os.path.join(base, "iceberg")
    ib = IcebergTable(i_path)
    s0 = timed("iceberg_create", lambda: ib.create(read(files),
                                                   max_rows_per_file=-(-n_od // ORDERS_PARTS)))
    timed("ib_od_skip_build", lambda: hs.create_index(session.read.iceberg(i_path),
                                                      DataSkippingIndexConfig(
        "ib_od_skip", [MinMaxSketch("o_orderdate")])))
    check_minmax_sketch(hs, i_path, "ib_od_skip", files=ib.snapshot(s0).file_paths)
    window = (date >= SKIP_LO) & (date <= SKIP_HI)

    def iceberg_round(tag, snapshot_id, pruned: bool):
        paths = ib.snapshot(snapshot_id).file_paths
        meets = sorted(p for p, (a, b) in part_ranges(paths).items()
                       if a <= SKIP_HI and b >= SKIP_LO)
        q = session.read.iceberg(i_path, snapshot_id=snapshot_id).filter(
            col("o_orderdate").between(SKIP_LO, SKIP_HI)).select(*LAKE_COLUMNS)
        leaf = leaf_of(session, q, False)
        kept = sorted(leaf.relation.all_files()) if isinstance(leaf, Scan) else None
        if pruned and (not leaf.skipping_note or kept != meets):
            raise AssertionError(f"lake iceberg {tag}: the scan keeps {kept}, the window "
                                 f"meets {meets}")
        if not pruned and kept != sorted(paths):
            raise AssertionError(f"lake iceberg {tag}: a stale sketch pruned the scan")
        out["plans"][f"iceberg_{tag}"] = {"parts": len(paths), "kept": len(kept),
                                          "note": leaf.skipping_note}
        check_answer(f"iceberg_{tag}", session, q, False, snapshot_reference(paths, window))

    iceberg_round("s0", s0, True)
    new_rows = shifted_rows(snapshot_reference(ib.snapshot(s0).file_paths, window), n_od)
    s1 = timed("iceberg_append", lambda: ib.append(new_rows))
    iceberg_round("s1_stale_sketch", s1, False)
    iceberg_round("s0_time_travel", s0, True)
    timed("ib_od_skip_refresh_incremental",
          lambda: hs.refresh_index("ib_od_skip", "incremental"))
    iceberg_round("s1_refreshed", s1, True)

    # 3. An index on the object store: st_od_idx over a copy of orders (hard
    # links), its system path on hsobj://.
    store_root = os.path.join(base, "store")
    os.makedirs(store_root)
    store, logs, calls = object_store_double(store_root)
    data_store.register_scheme(LAKE_SCHEME, lambda: store)
    log_store.register_scheme(LAKE_SCHEME, lambda path: logs)
    src = os.path.join(base, "orders")
    os.makedirs(src)
    for f in files:
        os.link(f, os.path.join(src, os.path.basename(f)))
    so, hso = new_session(f"{LAKE_SCHEME}://lake/indexes")
    st_window = (date >= SKIP_LO) & (date <= SKIP_HI)

    def store_round(tag):
        q = so.read.parquet(src).filter(col("o_orderdate").between(SKIP_LO, SKIP_HI)).select(
            *LAKE_COLUMNS)
        covering_plan(f"store_{tag}", so, q, False, "st_od_idx", None)
        check_answer(f"store_{tag}", so, q, False, snapshot_reference(
            sorted(os.path.join(src, f) for f in os.listdir(src)), st_window))

    timed("st_od_idx_build", lambda: hso.create_index(so.read.parquet(src), IndexConfig(
        "st_od_idx", ["o_orderdate"], ["o_orderkey", "o_totalprice"])))
    store_round("created")
    pq.write_table(shifted_rows(snapshot_reference(files, st_window), 2 * n_od),
                   os.path.join(src, f"part{ORDERS_PARTS:02d}.parquet"))
    timed("st_od_idx_refresh_incremental",
          lambda: hso.refresh_index("st_od_idx", "incremental"))
    store_round("refreshed")
    timed("st_od_idx_optimize", lambda: hso.optimize_index("st_od_idx", "full"))
    store_round("optimized")
    index_dir = os.path.join(store_root, "lake", "indexes", "st_od_idx")
    content = hso.index_manager.get_index("st_od_idx").content.files
    local = {os.path.join(store_root, f[len(LAKE_SCHEME) + 3:]) for f in content}
    if not content or not all(f.startswith(f"{LAKE_SCHEME}://lake/indexes/st_od_idx/")
                              for f in content) or not all(map(os.path.isfile, local)):
        raise AssertionError(f"lake: st_od_idx's files are not the store's: {content[:3]}")
    strays = [os.path.join(d, n) for d, dirs, names in os.walk(base)
              if not d.startswith(store_root) for n in dirs + names if n == "st_od_idx"]
    if strays:
        raise AssertionError(f"lake: index files outside the store: {strays[:3]}")
    timed("st_od_idx_delete_vacuum", lambda: (hso.delete_index("st_od_idx"),
                                              hso.vacuum_index("st_od_idx")))
    if any(n.startswith("v__=") for n in os.listdir(index_dir)):
        raise AssertionError("lake: vacuum left st_od_idx's data in the store")
    if calls["rename"]:
        raise AssertionError("lake: the object store was asked to rename")
    out["store_calls"] = dict(calls)
    log(f"lake: object-store calls {dict(calls)}")
    del session, hs, so, hso
    shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------
# The advisor path: the self-tuning tier (advisor/, adaptive/) on a lake of
# its own.
# ---------------------------------------------------------------------------

ADVISOR_WINDOWS = ((datetime.date(1993, 1, 1), datetime.date(1993, 1, 31)),
                   (datetime.date(1994, 6, 1), datetime.date(1994, 7, 31)),
                   (datetime.date(1995, 3, 1), datetime.date(1995, 3, 31)),
                   (datetime.date(1996, 9, 1), datetime.date(1996, 9, 30)))
# Inside the first quarter of the time-ordered orders files: the sampled
# prefix SLO degrade keeps holds the window's rows.
ADVISOR_SUM_WINDOW = (datetime.date(1992, 7, 1), datetime.date(1993, 4, 30))
ADVISOR_POINT = datetime.date(1995, 3, 15)
ADVISOR_BUILD_CALLS = 4
ADVISOR_FEEDBACK_RUNS = 6
ADVISOR_OFF_RUNS = 2
# The skewed star of tests/test_adaptive.py at the fact size of orders:
# 95% of fact rows hit the one dim1 key whose category "b" the query picks.
STAR_FILES = 4
STAR_DIM1, STAR_DIM2 = 50, 20


def events_total() -> int:
    """How many events the process's flight recorder has rung so far."""
    from hyperspace_tpu_torch.telemetry import flight_recorder
    return flight_recorder.get_recorder().stats()["event_total"]


def recorded_events(since: int, name: str) -> list:
    """The messages of the events named ``name`` that the flight recorder
    rang after its ``since``-th event, oldest first. Fails if its ring has
    dropped any of them."""
    from hyperspace_tpu_torch.telemetry import flight_recorder
    doc = flight_recorder.get_recorder().dump()
    ring = [e for e in doc["traceEvents"] if e.get("cat") == "hyperspace.event"]
    new = doc["otherData"]["stats"]["event_total"] - since
    if new > len(ring):
        raise AssertionError(f"the flight recorder's ring dropped {new - len(ring)} events")
    return [e["args"]["message"] for e in ring[len(ring) - new:] if e["name"] == name]


def adaptive_actions(since: int, action: str) -> list:
    """The subjects of the AdaptiveActionEvents of ``action`` (``builder.build``,
    ``builder.retire``) rung after the ``since``-th event."""
    import re
    out = []
    for message in recorded_events(since, "AdaptiveActionEvent"):
        hit = re.fullmatch(r"adaptive action: (\S+)(?: \((.*)\))?", message)
        if hit and hit.group(1) == action:
            out.append(hit.group(2) or "")
    return out


def make_skew_star(out_dir: str, n_fact: int, seed: int = 0) -> dict:
    """fact (``n_fact`` rows in STAR_FILES files: f_d1, f_d2, f_val), dim1
    (50 rows, d1_key and d1_cat) and dim2 (20 rows, d2_key and d2_cat), the
    shape of tests/test_adaptive.py's skew_star: every fact row but 5% has
    f_d1 = 0, the one key whose d1_cat is "b". Returns {table: dir}."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed + 11)
    f_d1 = np.zeros(n_fact, dtype=np.int64)
    stragglers = n_fact // 20
    f_d1[:stragglers] = np.arange(stragglers) % (STAR_DIM1 - 1) + 1
    rng.shuffle(f_d1)
    fact = pa.table({
        "f_d1": pa.array(f_d1),
        "f_d2": pa.array(rng.integers(0, STAR_DIM2, n_fact).astype(np.int64)),
        "f_val": pa.array(np.round(rng.uniform(0, 100, n_fact), 3)),
    })
    d1_cat = np.array([f"c{i % 9}" for i in range(STAR_DIM1)], dtype=object)
    d1_cat[0] = "b"
    tables = {
        "fact": fact,
        "dim1": pa.table({"d1_key": pa.array(np.arange(STAR_DIM1, dtype=np.int64)),
                          "d1_cat": pa.array(d1_cat)}),
        "dim2": pa.table({"d2_key": pa.array(np.arange(STAR_DIM2, dtype=np.int64)),
                          "d2_cat": pa.array(rng.choice(["x", "y"], STAR_DIM2))}),
    }
    dirs = {}
    for name, table in tables.items():
        d = dirs[name] = os.path.join(out_dir, name)
        os.makedirs(d)
        parts = STAR_FILES if name == "fact" else 1
        step = -(-table.num_rows // parts)
        for i in range(parts):
            pq.write_table(table.slice(i * step, step), os.path.join(d, f"p{i}.parquet"))
    return dirs


def star_three_way(session, paths: dict, col):
    """tests/test_adaptive.py's _three_way: fact x dim2, then x dim1
    filtered to d1_cat = "b" (the text order the reorderer improves)."""
    fact = session.read.parquet(paths["fact"])
    d1 = session.read.parquet(paths["dim1"]).filter(col("d1_cat") == "b")
    d2 = session.read.parquet(paths["dim2"])
    return (fact.join(d2, on=col("f_d2") == col("d2_key"))
            .join(d1, on=col("f_d1") == col("d1_key"))
            .select("d1_cat", "d2_cat", "f_val"))


def star_rows_on_card(table) -> list:
    """The star's answer with its rows sorted, as tensors on the card: the
    two string columns by their values' rank, then f_val."""
    import pyarrow as pa
    import pyarrow.compute as pc

    cols = {}
    for name in ("d1_cat", "d2_cat"):
        arr = table.column(name)
        values = pa.array(sorted(v for v in pc.unique(arr).to_pylist()), type=pa.string())
        cols[name] = pc.index_in(arr, value_set=values).cast(pa.int32())
    cols["f_val"] = table.column("f_val")
    return _sorted_columns_on_card(pa.table(cols))


def star_q_error(session) -> float:
    """The worst q-error over the last reorder pass's steps (1.0 when the
    chain kept its text order)."""
    qs = []
    for step in (st for r in (session._last_join_order or []) for st in r["steps"]):
        actual = session._join_actuals.get(step["key"])
        if actual is None:
            continue
        est, act = max(float(step["est_rows"]), 1.0), max(float(actual), 1.0)
        qs.append(max(est / act, act / est))
    return max(qs) if qs else 1.0


def tree_hashes(path: str) -> dict:
    """{file under ``path``: sha256 of its bytes}."""
    import hashlib
    out = {}
    for d, _dirs, names in os.walk(path):
        for n in names:
            full = os.path.join(d, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = hashlib.sha256(f.read()).hexdigest()
    return out


def run_advisor_path(root: str, od_dir: str, n_od: int, results: dict) -> None:
    """The self-tuning tier on a lake and session of its own: orders (hard
    links of phase 3's 16 files) and a skewed star with a fact table of
    orders' size.

    1. Capture: four o_orderdate windows, two o_orderkey IN lookups, one
       o_orderdate point count and one window sum, captured with no index;
       one workload record per query with its scan shape.
    2. What-if: a covering o_orderdate index over the first window rewrites
       it with a predicted speedup above 1; the system path's bytes are the
       same after what_if and after recommend(top_k=5); two recommend calls
       agree on names, order and costs.
    3. Build: adaptive.enabled; run_once(force=True) until a call builds
       nothing (at most ADVISOR_BUILD_CALLS); the ledger's bytes under the
       1 GiB budget; one builder.build event per index; each index ACTIVE on
       the system path; the advisor's top recommendation left after the
       last pass (what one more pass would build). The workload again: every plan reads a built
       covering index or a Scan narrowed by a built sketch, every answer
       equals pyarrow's, and every built index is read or retired in step 4.
    4. Retire: adv_unused (covering o_custkey) is created; with the budget
       spent and builder.retireMinQueries 8, a pass starts its clock (and
       retires the built indexes the workload did not read), 8 workload
       queries run, and the next pass retires adv_unused alone;
       restore_index brings it back.
    5. Admission: telemetry.slo.p99Ms 0.001 with minCount 5 over 5 queries;
       in mode degrade a frontend submit of the window sum answers a numpy
       sum over the first ceil(16 x 0.25) sorted files scaled by total over
       kept bytes (1e-9 relative) with its approx_error_bound, recorded
       beside the exact sum and the bound it states; in mode shed
       the submit raises ServingRejectedError; disarmed, the first healthy
       verdict answers exactly.
    6. Feedback: the star's three-way join ADVISOR_FEEDBACK_RUNS times with
       adaptive.enabled and join reordering on: one re-plan (one
       ReplanEvent) in the first run, every answer equal to the switch-off
       run's with rows sorted, the q-error of each run (second half no worse
       than the first), and flat q-errors with the switch off.

    At its end the path clears the process-wide correction store, admission
    controller, builder ledger and SLO monitor, so no later path can be
    shed, degraded or re-planned by its state."""
    import math

    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConfig, IndexConstants
    from hyperspace_tpu_torch.adaptive import admission, builder, feedback
    from hyperspace_tpu_torch.adaptive.constants import ADMISSION_SAMPLE_FRACTION
    from hyperspace_tpu_torch.adaptive.constants import REPLAN_ERROR_THRESHOLD
    from hyperspace_tpu_torch.adaptive.constants import AdaptiveConstants as AC
    from hyperspace_tpu_torch.advisor.constants import AdvisorConstants
    from hyperspace_tpu_torch.exceptions import ServingRejectedError
    from hyperspace_tpu_torch.optimizer.constants import OptimizerConstants
    from hyperspace_tpu_torch.plan.expr import col, count, sum_
    from hyperspace_tpu_torch.plan.nodes import IndexScan, Scan
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend
    from hyperspace_tpu_torch.telemetry import slo
    from hyperspace_tpu_torch.telemetry.constants import TelemetryConstants as TC

    t_path = time.perf_counter()
    out = results["advisor"] = {"seconds_of": {}}
    secs_of = out["seconds_of"]
    base = os.path.join(root, "advisor")
    os.makedirs(base)
    system_path = os.path.join(base, "indexes")
    t0 = time.perf_counter()
    adv_od = os.path.join(base, "orders")
    os.makedirs(adv_od)
    for f in sorted(os.listdir(od_dir)):
        os.link(os.path.join(od_dir, f), os.path.join(adv_od, f))
    star = make_skew_star(os.path.join(base, "star"), n_od)
    secs_of["data"] = time.perf_counter() - t0
    log(f"advisor: orders linked, star of {n_od:,} fact rows written in {secs_of['data']:.2f} s")

    def step_done(name, t0):
        torch.cuda.synchronize()
        secs_of[name] = time.perf_counter() - t0
        log(f"advisor: {name} in {secs_of[name]:.3f} s")

    session = ht.Session(system_path=system_path, device="cuda")
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, LAKE_BUCKETS)
    session.enable_hyperspace()
    hs = ht.Hyperspace(session)
    od = session.read.parquet(adv_od)
    date = pc.field("o_orderdate")
    keys = [[(n_od * (7 * j + i)) // 40 for i in range(5)] for j in (1, 3)]
    workload = []  # (name, DataFrame, pyarrow reference)
    for i, (lo, hi) in enumerate(ADVISOR_WINDOWS):
        workload.append((f"window{i}", od.filter(col("o_orderdate").between(lo, hi)).select(
            "o_orderkey", "o_totalprice"), reference(adv_od, (date >= lo) & (date <= hi),
                                                     ["o_orderkey", "o_totalprice"])))
    for j, ks in enumerate(keys):
        workload.append((f"keys{j}", od.filter(col("o_orderkey").isin(ks)).select("o_orderdate"),
                         reference(adv_od, pc.field("o_orderkey").isin(ks), ["o_orderdate"])))
    n_point = reference(adv_od, date == ADVISOR_POINT, ["o_orderkey"]).num_rows
    workload.append(("point_count", od.filter(col("o_orderdate") == ADVISOR_POINT).agg(
        count().alias("n")), pa.table({"n": pa.array([n_point], type=pa.int64())})))
    lo, hi = ADVISOR_SUM_WINDOW
    window_rows = reference(adv_od, (date >= lo) & (date <= hi), ["o_totalprice"])
    window_sum = float(np.sum(window_rows.column(0).to_numpy()))
    sum_query = od.filter(col("o_orderdate").between(lo, hi)).agg(
        sum_(col("o_totalprice")).alias("revenue"))
    workload.append(("window_sum", sum_query, window_sum))

    def check_answer(name, got, ref):
        if isinstance(ref, float):
            value = got.column(0)[0].as_py()
            if not close(value, ref):
                raise AssertionError(f"advisor {name}: {value} != numpy's {ref}")
        elif not same_rows(got, ref):
            raise AssertionError(f"advisor {name}: the answer differs from pyarrow's")

    def run_workload(tag):
        for name, df, ref in workload:
            check_answer(f"{tag} {name}", df.to_arrow(), ref)

    # 1. Capture.
    t0 = time.perf_counter()
    session.conf.set(AdvisorConstants.CAPTURE_ENABLED, "true")
    run_workload("capture")
    session.conf.set(AdvisorConstants.CAPTURE_ENABLED, "false")
    records = session._workload_log.snapshot()
    rows = hs.workload()
    if len(records) != len(workload) or len(rows) != len(workload) \
            or any(len(r.scan_shapes) != 1 or r.scan_shapes[0].root_paths != (adv_od,)
                   or r.applied_indexes for r in records):
        raise AssertionError(f"advisor capture: {len(records)} records for {len(workload)} "
                             f"queries, shapes {[r.scan_shapes for r in records]}")
    out["capture"] = {"records": len(records), "shapes": [
        {"filter": list(r.scan_shapes[0].filter_cols),
         "project": list(r.scan_shapes[0].project_cols),
         "equality": list(r.scan_shapes[0].equality_cols),
         "range": list(r.scan_shapes[0].range_cols)} for r in records]}
    step_done("capture", t0)

    # 2. What-if and recommend, metadata only.
    t0 = time.perf_counter()
    before = tree_hashes(system_path)
    outcome = hs.what_if(workload[0][1], [IndexConfig("adv_whatif", ["o_orderdate"],
                                                      ["o_orderkey", "o_totalprice"])])
    if not outcome.rewritten or not outcome.predicted_speedup > 1.0:
        raise AssertionError(f"advisor what-if:\n{outcome.explain()}")
    if tree_hashes(system_path) != before:
        raise AssertionError("advisor: what_if changed the system path")
    reports = [hs.recommend(top_k=5), hs.recommend(top_k=5)]
    if tree_hashes(system_path) != before:
        raise AssertionError("advisor: recommend changed the system path")
    ranked = [[(r.rank, r.names, r.predicted_benefit_s, r.predicted_speedup,
                r.queries_matched) for r in rep.recommendations] for rep in reports]
    if ranked[0] != ranked[1] or not ranked[0]:
        raise AssertionError(f"advisor: two recommend calls differ: {ranked}")
    out["what_if"] = {"applied": list(outcome.applied), "cost_before_bytes":
                      outcome.cost_before_bytes, "cost_after_bytes": outcome.cost_after_bytes,
                      "predicted_speedup": outcome.predicted_speedup,
                      "system_path_files": len(before)}
    out["recommendations"] = [{"rank": r[0], "names": list(r[1]), "benefit_s": r[2],
                               "speedup": r[3], "matched": r[4]} for r in ranked[0]]
    log("advisor: " + reports[0].explain().replace("\n", "\n  "))
    step_done("what_if_recommend", t0)

    # 3. The builder, within its default budget.
    session.conf.set(AC.ENABLED, "true")
    ledger = builder.get_ledger()
    ledger.clear()
    b = hs.adaptive_builder()
    calls, built, build_events = [], [], []
    t0 = time.perf_counter()
    for _ in range(ADVISOR_BUILD_CALLS):
        t1 = time.perf_counter()
        n_events = events_total()
        done = b.run_once(force=True)
        torch.cuda.synchronize()
        calls.append({"built": done["built"], "retired": done["retired"],
                      "seconds": time.perf_counter() - t1})
        build_events += adaptive_actions(n_events, "builder.build")
        log(f"advisor: run_once built {done['built']} in {calls[-1]['seconds']:.3f} s")
        if not done["ran"]:
            raise AssertionError(f"advisor: the builder did not run: {done}")
        built += done["built"]
        if not done["built"]:
            break
    stats = ledger.stats()
    budget = session.hs_conf.adaptive_builder_max_bytes()
    if not built or stats["built"] != built or build_events != built \
            or not 0 < stats["bytes_spent"] < budget or stats["in_progress"]:
        raise AssertionError(f"advisor build: built {built}, events {build_events}, ledger "
                             f"{stats}, budget {budget}")
    kinds = {}
    for name in built:
        entry = hs.index_manager.get_index(name)
        if entry is None or entry.state != "ACTIVE" \
                or not os.path.isdir(os.path.join(system_path, name)):
            raise AssertionError(f"advisor: {name} is not ACTIVE on the system path")
        kinds[name] = entry.derivedDataset.kind
    if "CoveringIndex" not in kinds.values() or "DataSkippingIndex" not in kinds.values():
        raise AssertionError(f"advisor: the builder built {kinds}, not both kinds")
    # What a further pass would build (recommend only; nothing is built).
    left = hs.recommend(top_k=1).recommendations
    next_rec = [{"kind": r.kind, "names": list(r.names), "benefit_s": r.predicted_benefit_s,
                 "speedup": r.predicted_speedup, "matched": r.queries_matched,
                 "indexes": [repr(c) for c in r.configs]} for r in left]
    out["build"] = {"calls": calls, "built": built, "kinds": kinds,
                    "bytes_spent": stats["bytes_spent"], "budget": budget,
                    "next_recommendation": next_rec}
    log(f"advisor: the ledger holds {stats['bytes_spent']:,} bytes of a {budget:,}-byte budget;"
        f" a further pass would build {next_rec}")
    step_done("build", t0)

    # The workload on what the builder built.
    t0 = time.perf_counter()
    plans = {}
    for name, df, _ in workload:
        leaves = session.optimize(df.plan, diagnostic=True).collect_leaves()
        reads = [leaf.index_entry.name for leaf in leaves if isinstance(leaf, IndexScan)]
        narrowed = [leaf for leaf in leaves if isinstance(leaf, Scan) and leaf.skipping_note]
        if not set(reads) & set(built) and not narrowed:
            raise AssertionError(f"advisor {name}: the plan reads no built index: "
                                 f"{[leaf.simple_string() for leaf in leaves]}")
        plans[name] = reads or [leaves[0].simple_string()]
    usage0 = dict(session._index_usage_counts)
    run_workload("built")
    usage = {n: session._index_usage_counts.get(n, 0) - usage0.get(n, 0) for n in built}
    unread = sorted(n for n, u in usage.items() if u == 0)
    if any(kinds[n] == "CoveringIndex" for n in unread):
        raise AssertionError(f"advisor: a built covering index went unread: {usage}")
    out["rerun"] = {"plans": plans, "usage": usage}
    step_done("rerun", t0)

    # 4. Retire: adv_unused, which no query reads.
    t0 = time.perf_counter()
    hs.create_index(od, IndexConfig("adv_unused", ["o_custkey"], ["o_totalprice"]))
    session.conf.set(AC.BUILDER_MAX_BYTES, "1")  # the pass only retires
    session.conf.set(AC.BUILDER_RETIRE_MIN_QUERIES, "8")
    first = b.run_once(force=True)
    if first["built"] or "adv_unused" in first["retired"] or sorted(first["retired"]) != unread:
        raise AssertionError(f"advisor retire: the observing pass gave {first}; unread {unread}")
    for name, df, ref in workload:
        check_answer(f"retire {name}", df.to_arrow(), ref)
    n_events = events_total()
    second = b.run_once(force=True)
    retires = adaptive_actions(n_events, "builder.retire")
    state = {n: hs.index_manager.get_index(n).state for n in ["adv_unused", *built]}
    if second["retired"] != ["adv_unused"] or retires != ["adv_unused"] \
            or state["adv_unused"] != "DELETED" \
            or any(state[n] != "ACTIVE" for n in built if n not in unread):
        raise AssertionError(f"advisor retire: {second}, events {retires}, states {state}")
    hs.restore_index("adv_unused")
    if hs.index_manager.get_index("adv_unused").state != "ACTIVE":
        raise AssertionError("advisor: restore_index did not bring adv_unused back")
    out["retire"] = {"observing_pass": first["retired"], "retired": second["retired"],
                     "states": state}
    step_done("retire", t0)

    # 5. SLO admission.
    t0 = time.perf_counter()
    controller = admission.get_controller()
    controller.reset()
    session.conf.set(TC.SLO_P99_MS, "0.001")
    session.conf.set(TC.SLO_MIN_COUNT, "5")
    for name, df, ref in workload[:5]:
        check_answer(f"slo {name}", df.to_arrow(), ref)
    if not hs.health()["objectives"][slo.OBJECTIVE_P99]["breached"]:
        raise AssertionError(f"advisor: the p99 objective is not breached: {hs.health()}")
    fe = ServingFrontend(session)
    degraded = fe.submit(sum_query).result(timeout=600)
    bound = getattr(degraded, "approx_error_bound", None)
    files = sorted(os.path.join(adv_od, f) for f in os.listdir(adv_od))
    keep = math.ceil(len(files) * ADMISSION_SAMPLE_FRACTION)
    kept = pa.concat_tables(pq.read_table(f, columns=["o_orderdate", "o_totalprice"])
                            for f in files[:keep])
    kept = kept.filter((pc.field("o_orderdate") >= lo) & (pc.field("o_orderdate") <= hi))
    scale = sum(os.path.getsize(f) for f in files) / sum(os.path.getsize(f)
                                                         for f in files[:keep])
    want = float(np.sum(kept.column("o_totalprice").to_numpy())) * scale
    got = degraded.to_arrow().column(0)[0].as_py()
    if bound is None or bound["scaled"] != ["revenue"] or not want > 0 or not close(got, want):
        raise AssertionError(f"advisor degrade: {got} (bound {bound}) against numpy's {want} "
                             f"over the first {keep} files")
    session.conf.set(AC.ADMISSION_MODE, "shed")
    try:
        fe.submit(sum_query)
        raise AssertionError("advisor: a shed submit was admitted")
    except ServingRejectedError:
        pass
    session.conf.set(AC.ADMISSION_MODE, "degrade")
    session.conf.set(TC.SLO_P99_MS, "0")
    if controller.refresh(session, force=True):
        raise AssertionError("advisor: the disarmed objective still reads overloaded")
    exact = fe.submit(sum_query).result(timeout=600)
    fe.drain()
    if getattr(exact, "approx_error_bound", None) is not None \
            or not close(exact.to_arrow().column(0)[0].as_py(), window_sum):
        raise AssertionError("advisor: the first healthy verdict did not answer exactly")
    # The sum window lies in the kept prefix (the files are time-ordered), so
    # the scaled sum is about total/kept bytes times the exact one: recorded
    # beside the bound the answer states, which it need not meet here.
    rel_err = abs(got - window_sum) / window_sum
    log(f"advisor degrade: approx/exact {got / window_sum:.6f}, relative error {rel_err:.6f} "
        f"against the stated {bound['confidence']:.0%} bound {bound['bound']}")
    out["admission"] = {"approx": got, "numpy": want, "exact": window_sum, "bound": bound,
                        "approx_over_exact": got / window_sum, "relative_error": rel_err,
                        "within_stated_bound": rel_err <= bound["bound"],
                        "kept_files": keep, "controller": controller.stats(),
                        "frontend_rejected": fe.stats()["rejected"]}
    step_done("admission", t0)

    # 6. Feedback-corrected planning and the mid-query re-plan on the star.
    t0 = time.perf_counter()
    feedback.get_store().clear()
    session.conf.set(OptimizerConstants.JOIN_REORDER_ENABLED, "true")
    off = ht.Session(system_path=os.path.join(base, "off_indexes"), device="cuda")
    off.conf.set(OptimizerConstants.JOIN_REORDER_ENABLED, "true")
    q_off, ref_rows = [], None
    for _ in range(ADVISOR_OFF_RUNS):
        table = star_three_way(off, star, col).to_arrow()
        q_off.append(star_q_error(off))
        ref_rows = ref_rows or star_rows_on_card(table)
    q_on, replans, replan_events = [], [], []
    for run in range(ADVISOR_FEEDBACK_RUNS):
        n_events = events_total()
        table = star_three_way(session, star, col).to_arrow()
        replan_events += recorded_events(n_events, "ReplanEvent")
        q_on.append(star_q_error(session))
        if not all(torch.equal(x, y) for x, y in zip(star_rows_on_card(table), ref_rows)):
            raise AssertionError(f"advisor feedback run {run}: the answer differs from the "
                                 "switch-off run's")
        replans.append(feedback.get_store().stats()["replans"])
    half = ADVISOR_FEEDBACK_RUNS // 2
    if replans != [1] * ADVISOR_FEEDBACK_RUNS or len(replan_events) != 1 \
            or max(q_on[half:]) > max(q_on[:half]) or len(set(q_off)) != 1:
        raise AssertionError(f"advisor feedback: replans {replans}, events "
                             f"{len(replan_events)}, q-error on {q_on}, off {q_off}")
    out["feedback"] = {"fact_rows": n_od, "answer_rows": table.num_rows, "q_error_on": q_on,
                       "q_error_off": q_off, "replans": replans[-1],
                       "replan_event": replan_events[0], "threshold": REPLAN_ERROR_THRESHOLD,
                       "store": feedback.get_store().stats()}
    log(f"advisor feedback: q-error on {q_on}, off {q_off}; one re-plan")
    step_done("feedback", t0)

    # The process-wide state goes, so no later path meets it.
    out["adaptive_stats"] = hs.adaptive_stats()
    for key in (TC.SLO_P99_MS, TC.SLO_ERROR_RATE):
        session.conf.set(key, "0")
    session.conf.set(AC.ENABLED, "false")
    feedback.get_store().clear()
    controller.reset()
    ledger.clear()
    builder._BUILDER = None
    slo._MONITOR = None
    del session, hs, off, fe
    shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_path


# ---------------------------------------------------------------------------
# The reorder path: cost-based join reordering over the sql path's lake.
# ---------------------------------------------------------------------------

def sorted_answer(table):
    """Rows sorted by their non-float columns (all columns if none)."""
    import pyarrow as pa
    keys = [c for c in table.column_names if not pa.types.is_floating(table.column(c).type)]
    return table.sort_by([(c, "ascending") for c in (keys or table.column_names)])


def run_reorder_path(session, results: dict) -> None:
    """Each TPC-H text optimized with optimizer.joinReorder.enabled off and
    on (hyperspace disabled); every text whose tree changes runs twice
    each way: the warm runs' seconds, the answers equal after sorting
    rows (keys exact, float64 within REL_TOL relative) and equal to the
    numpy reference, each step's estimate against the rows
    ``_join_actuals`` recorded (q-error) and explain's "Join order:"
    section. At least one text must reorder."""
    import torch

    from hyperspace_tpu_torch.optimizer.constants import OptimizerConstants
    from hyperspace_tpu_torch.plananalysis.explain import explain_string

    flag = OptimizerConstants.JOIN_REORDER_ENABLED
    out = results["reorder"] = {"texts": {}, "unchanged": []}
    t_path = time.perf_counter()
    session.disable_hyperspace()
    try:
        for name, text in TPCH_TEXTS.items():
            df = session.sql(text)
            session.conf.set(flag, "false")
            off_plan = session.optimize(df.plan, diagnostic=True).tree_string()
            session.conf.set(flag, "true")
            on_plan = session.optimize(df.plan, diagnostic=True).tree_string()
            if on_plan == off_plan:
                out["unchanged"].append(name)
                continue
            entry = {}
            answers = {}
            for mode in ("off", "on"):
                session.conf.set(flag, "true" if mode == "on" else "false")
                secs = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    answers[mode] = df.to_arrow()
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                entry[f"{mode}_s"] = secs
            records = session._last_join_order
            check_sql_answer(name, answers["off"], REFERENCES["sql"][name], "reorder off")
            check_sql_answer(name, sorted_answer(answers["on"]),
                             as_reference(name, sorted_answer(answers["off"])),
                             "reordered against off")
            steps = []
            for r in records:
                for step in r["steps"]:
                    actual = session._join_actuals.get(step["key"])
                    if actual is None:
                        raise AssertionError(f"reorder {name}: no actual rows for "
                                             f"{step['key']}")
                    est, act = max(step["est_rows"], 1.0), max(actual, 1)
                    steps.append({"right": step["right"], "est_rows": step["est_rows"],
                                  "actual_rows": actual, "q_error": max(est / act, act / est)})
            entry.update(
                order=[(r["labels"], r["order"]) for r in records if r["reordered"]],
                steps=steps, rows=answers["on"].num_rows,
                join_order=explain_string(session, df.plan, diagnostics=False).split(
                    "Join order:", 1)[1].strip())
            out["texts"][name] = entry
            log(f"reorder {name}: off {entry['off_s']} s, on {entry['on_s']} s; "
                f"{entry['order']}; steps {steps}")
    finally:
        session.conf.set(flag, "false")
    if not out["texts"]:
        raise AssertionError("reorder: no TPC-H text was reordered")
    out["seconds"] = time.perf_counter() - t_path


def torch_sync() -> None:
    import torch
    torch.cuda.synchronize()


def card_against_cpu(root: str) -> dict:
    """Q3 and Q17 at PARITY_SCALE on the card and through the port on the
    CPU, indexed and scanned: equal bit for bit, or the largest relative
    difference of a float value (the CPU tests hold the CPU path equal to
    the JAX package's)."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConfig, IndexConstants

    li_dir, od_dir, pt_dir, n_li, _ = make_tpch(os.path.join(root, "parity_data"), PARITY_SCALE)
    out = {}
    tables = {}
    for i, device in enumerate(("cuda", "cpu")):
        session = ht.Session(system_path=os.path.join(root, f"parity_indexes{i}"),
                             device=device)
        session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
        # Route for route: the CPU takes the SPMD dispatch where the card's
        # default (singleDevice auto) takes it.
        session.conf.set(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE, "on")
        hs = ht.Hyperspace(session)
        hs.create_index(session.read.parquet(li_dir), IndexConfig(
            "li_idx", ["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"]))
        hs.create_index(session.read.parquet(od_dir), IndexConfig(
            "od_idx", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_shippriority"]))
        build_join_indexes(session, hs, li_dir, pt_dir, {}, log_it=False)
        for name, df in (("q3", build_q3(session, li_dir, od_dir)),
                         ("q17", build_q17(session, li_dir, pt_dir))):
            for indexed in (True, False):
                (session.enable_hyperspace if indexed else session.disable_hyperspace)()
                tables[(device, name, indexed)] = df.to_arrow()
                session.disable_hyperspace()
    for name in ("q3", "q17"):
        for indexed in (True, False):
            card, cpu = tables[("cuda", name, indexed)], tables[("cpu", name, indexed)]
            rel = 0.0
            for c in cpu.column_names:
                if str(cpu.column(c).type) == "double":
                    for a, b in zip(card.column(c).to_pylist(), cpu.column(c).to_pylist()):
                        rel = max(rel, abs(a - b) / max(abs(b), 1e-300))
            out[f"{name} {'indexed' if indexed else 'scanned'}"] = {
                "bitwise_equal": card.equals(cpu) and float_bits(card) == float_bits(cpu),
                "keys_equal": all(card.column(c).equals(cpu.column(c))
                                  for c in cpu.column_names
                                  if str(cpu.column(c).type) != "double"),
                "max_rel_diff": rel}
    log(f"card against the CPU at scale {PARITY_SCALE} ({n_li} lineitem rows): {out}")
    return out


# ---------------------------------------------------------------------------
# The sql path: TPC-H texts through session.sql on a lake with the TPC-H
# schema's columns at --sql-scale row counts (SQL_SCALE by default).
# ---------------------------------------------------------------------------

# The sql lake's default scale factor. It is smaller than the main lake's:
# the sql path and the four paths on its lake (serving, faults, streaming,
# cluster) read every table again and again, and at SF10 they took about
# 520 s of a whole run that came within reach of its 1,200 s limit on a slow
# host. At SF2 every text still selects rows (Q19 about 300 lineitem rows).
SQL_SCALE = 2.0
# Rows per scale factor and files per table (TPC-H v3.0.1 4.2.5).
TPCH_SQL_ROWS = {"lineitem": 6_000_000, "orders": 1_500_000, "customer": 150_000,
                 "part": 200_000, "partsupp": 800_000, "supplier": 10_000}
TPCH_SQL_FILES = {"lineitem": 4, "orders": 16, "customer": 1, "part": 1, "partsupp": 1,
                  "supplier": 1}
# The value domains of TPC-H v3.0.1 4.2.2.13 and 4.2.3.
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
# (Q19 asks for 'AIR REG', which the domain lacks, as in TPC-H itself.)
SHIP_MODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
SHIP_INSTRUCTS = ("COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN")
TYPE_SYLLABLES = (("ECONOMY", "LARGE", "MEDIUM", "PROMO", "SMALL", "STANDARD"),
                  ("ANODIZED", "BRUSHED", "BURNISHED", "PLATED", "POLISHED"),
                  ("BRASS", "COPPER", "NICKEL", "STEEL", "TIN"))
CONTAINER_SYLLABLES = (("JUMBO", "LG", "MED", "SM", "WRAP"),
                       ("BAG", "BOX", "CAN", "CASE", "DRUM", "JAR", "PACK", "PKG"))
SUPPLIER_COMMENTS = ("blithely regular deposits sleep carefully",
                     "carefully final packages haggle quietly",
                     "even instructions wake furiously among the ideas",
                     "quickly bold requests nag slyly",
                     "slyly express accounts cajole fluffily")
COMPLAINT = "furiously Customer unusual Complaints among the packages"
RECOMMEND = "quietly Customer bold Recommends against the deposits"
CURRENT_DATE = datetime.date(1995, 6, 17)
TPCH_SQL_INDEXES = [
    # Q6's and Q1's columns beside l_shipdate.
    ("lineitem", "sql_li_ship", ["l_shipdate"],
     ["l_extendedprice", "l_discount", "l_quantity", "l_returnflag", "l_linestatus", "l_tax"]),
    # The columns Q14, Q17 and Q19 read of lineitem, and of part.
    ("lineitem", "sql_li_pk", ["l_partkey"],
     ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate", "l_shipmode",
      "l_shipinstruct"]),
    ("part", "sql_pt_pk", ["p_partkey"], ["p_brand", "p_container", "p_type", "p_size"]),
]

# The nine texts of tests/test_tpch_sql.py (scale-1 parameters), verbatim.
TPCH_TEXTS = {
    "q1": """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
 sum(l_extendedprice) as sum_base_price,
 sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
 sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
 avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
 avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    "q3": """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
 o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
 and l_orderkey = o_orderkey
 and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
""",
    "q4": """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
 and o_orderdate < date '1993-07-01' + interval '3' month
 and exists ( select * from lineitem
   where l_orderkey = o_orderkey and l_commitdate < l_receiptdate )
group by o_orderpriority
order by o_orderpriority
""",
    "q6": """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
 and l_shipdate < date '1994-01-01' + interval '1' year
 and l_discount between .06 - 0.01 and .06 + 0.01
 and l_quantity < 24
""",
    "q12": """
select l_shipmode,
 sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
     then 1 else 0 end) as high_line_count,
 sum(case when o_orderpriority <> '1-URGENT'
     and o_orderpriority <> '2-HIGH' then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
 and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
 and l_receiptdate >= date '1994-01-01'
 and l_receiptdate < date '1994-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
""",
    "q14": """
select 100.00 * sum(case when p_type like 'PROMO%'
  then l_extendedprice * (1 - l_discount) else 0 end)
 / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey and l_shipdate >= date '1995-09-01'
 and l_shipdate < date '1995-09-01' + interval '1' month
""",
    "q16": """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#45'
 and p_type not like 'MEDIUM POLISHED%'
 and p_size in (1, 3, 5, 7, 9, 11, 14, 19)
 and ps_suppkey not in ( select s_suppkey from supplier
   where s_comment like '%Customer%Complaints%' )
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
""",
    "q17": """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_brand = 'Brand#23'
 and p_container = 'MED BOX'
 and l_quantity < ( select 0.2 * avg(l_quantity) from lineitem
   where l_partkey = p_partkey )
""",
    "q19": """
select sum(l_extendedprice* (1 - l_discount)) as revenue
from lineitem, part
where ( p_partkey = l_partkey and p_brand = 'Brand#12'
  and p_container in ( 'SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
  and l_quantity >= 1 and l_quantity <= 1 + 10
  and p_size between 1 and 5
  and l_shipmode in ('AIR', 'AIR REG')
  and l_shipinstruct = 'DELIVER IN PERSON' )
 or ( p_partkey = l_partkey and p_brand = 'Brand#23'
  and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
  and l_quantity >= 10 and l_quantity <= 10 + 10
  and p_size between 1 and 10
  and l_shipmode in ('AIR', 'AIR REG')
  and l_shipinstruct = 'DELIVER IN PERSON' )
 or ( p_partkey = l_partkey and p_brand = 'Brand#45'
  and p_container in ( 'LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
  and l_quantity >= 20 and l_quantity <= 20 + 10
  and p_size between 1 and 15
  and l_shipmode in ('AIR', 'AIR REG')
  and l_shipinstruct = 'DELIVER IN PERSON' )
""",
}
# Beside the nine: the outer join of TPC-H Q13 (orders per customer, then
# customers per order count; without Q13's o_comment condition, which the
# grammar's ON clause does not take), and a rank and a running sum over
# each customer's orders, the two best-priced orders of each kept.
SQL_PATH_QUERIES = dict(TPCH_TEXTS, **{
    "q13_outer": """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left outer join orders on c_custkey = o_custkey
      group by c_custkey) as c_orders
group by c_count
order by custdist desc, c_count desc
""",
    "window": """
with w as (select o_custkey, o_orderkey, o_totalprice,
             rank() over (partition by o_custkey order by o_totalprice desc) as price_rank,
             sum(o_totalprice) over (partition by o_custkey order by o_orderdate, o_orderkey
                                     rows between unbounded preceding and current row)
               as running
           from orders)
select o_custkey, o_orderkey, o_totalprice, price_rank, running from w where price_rank <= 2
""",
})
# Plans that must read an index (tests/test_tpch_sql.py asserts the same).
SQL_INDEXED_PLANS = ("q6", "q14", "q17")


def _dict_column(rng, n: int, values, dtype="int8", probs=None):
    """A dictionary-encoded string column drawn from ``values`` (sorted):
    indices and dictionary, never a Python string per row. The first
    len(values) rows take every value once, so a small lake holds each."""
    import numpy as np
    import pyarrow as pa

    values = sorted(values)
    idx = rng.choice(len(values), n, p=probs).astype(dtype) if probs is not None \
        else rng.integers(0, len(values), n).astype(dtype)
    k = min(n, len(values))
    idx[:k] = np.arange(k, dtype=dtype)
    return pa.DictionaryArray.from_arrays(pa.array(idx), pa.array(values))


def make_tpch_sql(root: str, scale: float, seed: int = 0):
    """The TPC-H tables and columns the nine texts read, at ``scale``
    times the SF1 row counts, with TPC-H v3.0.1's value domains: keys from
    1; brands Brand#MN, the 150 p_type syllable triples, the 40
    containers, p_size 1-50 (int32); o_custkey never a multiple of 3 (a
    third of the customers have no orders); 1-7 lines an order, lineitem
    in l_orderkey order; ship 1-121 days after the order, commit 30-90,
    receipt 1-30 after the ship date; return flag and line status from the
    dates; l_extendedprice = quantity * the part's retail price; about
    5 in 10,000 supplier comments hold "Customer ... Complaints" (at least
    one). Strings are written from dictionary indices. Returns ({table:
    dir}, {table: rows})."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    rows = {t: max(int(round(n * scale)), 1) for t, n in TPCH_SQL_ROWS.items()}
    dirs = {}

    def write(name, table):
        from concurrent.futures import ThreadPoolExecutor
        d = os.path.join(root, name)
        os.makedirs(d)
        n, parts = table.num_rows, TPCH_SQL_FILES[name]
        step = n // parts

        def part(i):
            lo, hi = i * step, (i + 1) * step if i < parts - 1 else n
            # No Arrow schema in the files: strings read back as strings,
            # as from any parquet writer.
            pq.write_table(table.slice(lo, hi - lo), os.path.join(d, f"part{i:02d}.parquet"),
                           store_schema=False)

        with ThreadPoolExecutor(min(parts, 8)) as pool:
            list(pool.map(part, range(parts)))
        dirs[name] = d

    def dates(days):
        return pa.array(days.astype(np.int32), type=pa.int32()).cast(pa.date32())

    n_su, n_pt, n_cu = rows["supplier"], rows["part"], rows["customer"]
    n_od, n_li = rows["orders"], rows["lineitem"]
    comments = rng.integers(0, len(SUPPLIER_COMMENTS), n_su).astype(np.int8)
    special = rng.permutation(n_su)
    n_complaints = max(int(round(n_su * 5 / 10_000)), 1)
    comments[special[:n_complaints]] = len(SUPPLIER_COMMENTS)
    comments[special[n_complaints:2 * n_complaints]] = len(SUPPLIER_COMMENTS) + 1
    write("supplier", pa.table({
        "s_suppkey": pa.array(np.arange(1, n_su + 1, dtype=np.int64)),
        "s_comment": pa.DictionaryArray.from_arrays(
            pa.array(comments), pa.array(list(SUPPLIER_COMMENTS) + [COMPLAINT, RECOMMEND]))}))

    p_partkey = np.arange(1, n_pt + 1, dtype=np.int64)
    brands = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
    types = [f"{a} {b} {c}" for a in TYPE_SYLLABLES[0] for b in TYPE_SYLLABLES[1]
             for c in TYPE_SYLLABLES[2]]
    containers = [f"{a} {b}" for a in CONTAINER_SYLLABLES[0] for b in CONTAINER_SYLLABLES[1]]
    p_size = rng.integers(1, 51, n_pt).astype(np.int32)
    p_size[:min(n_pt, 50)] = np.arange(1, min(n_pt, 50) + 1, dtype=np.int32)
    write("part", pa.table({
        "p_partkey": pa.array(p_partkey),
        "p_brand": _dict_column(rng, n_pt, brands),
        "p_type": _dict_column(rng, n_pt, types, "int16"),
        "p_size": pa.array(p_size),
        "p_container": _dict_column(rng, n_pt, containers)}))
    retail = (90_000 + (p_partkey // 10) % 20_001 + 100 * (p_partkey % 1000)) / 100.0

    ps_partkey = np.repeat(p_partkey, 4)
    i = np.tile(np.arange(4, dtype=np.int64), n_pt)
    ps_suppkey = (ps_partkey + i * (n_su // 4 + (ps_partkey - 1) // n_su)) % n_su + 1
    write("partsupp", pa.table({"ps_partkey": pa.array(ps_partkey),
                                "ps_suppkey": pa.array(ps_suppkey)}))
    del ps_partkey, ps_suppkey, i

    write("customer", pa.table({
        "c_custkey": pa.array(np.arange(1, n_cu + 1, dtype=np.int64)),
        "c_mktsegment": _dict_column(rng, n_cu, SEGMENTS)}))

    start = (datetime.date(1992, 1, 1) - EPOCH).days
    end = (datetime.date(1998, 12, 31) - EPOCH).days
    o_orderdate = rng.integers(start, end - 151 + 1, n_od).astype(np.int32)
    o_custkey = rng.integers(1, n_cu + 1, n_od).astype(np.int64)
    o_custkey = np.where(o_custkey % 3 == 0, np.where(o_custkey < n_cu, o_custkey + 1,
                                                      o_custkey - 1), o_custkey)
    o_custkey = np.maximum(o_custkey, 1)
    write("orders", pa.table({
        "o_orderkey": pa.array(np.arange(1, n_od + 1, dtype=np.int64)),
        "o_custkey": pa.array(o_custkey),
        "o_orderdate": dates(o_orderdate),
        "o_orderpriority": _dict_column(rng, n_od, PRIORITIES),
        "o_shippriority": pa.array(np.zeros(n_od, dtype=np.int32)),
        "o_totalprice": pa.array(np.round(rng.uniform(850, 560_000, n_od), 2))}))
    del o_custkey

    # 1-7 lines an order, cut or padded to exactly n_li rows.
    lines = rng.integers(1, 8, n_od)
    l_orderkey = np.repeat(np.arange(1, n_od + 1, dtype=np.int64), lines)
    if l_orderkey.shape[0] >= n_li:
        l_orderkey = l_orderkey[:n_li]
    else:
        extra = np.sort(rng.integers(1, n_od + 1, n_li - l_orderkey.shape[0]))
        l_orderkey = np.sort(np.concatenate([l_orderkey, extra]))
    del lines
    odate = o_orderdate[l_orderkey - 1]
    del o_orderdate
    l_shipdate = odate + rng.integers(1, 122, n_li).astype(np.int32)
    l_commitdate = odate + rng.integers(30, 91, n_li).astype(np.int32)
    del odate
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_li).astype(np.int32)
    current = (CURRENT_DATE - EPOCH).days
    # R or A once received by the current date, else N; O once shipped after it.
    flag = np.where(l_receiptdate <= current, rng.integers(0, 2, n_li) * 2, 1).astype(np.int8)
    l_partkey = rng.integers(1, n_pt + 1, n_li).astype(np.int64)
    l_quantity = rng.integers(1, 51, n_li).astype(np.int64)
    price = np.round(l_quantity * retail[l_partkey - 1], 2)
    write("lineitem", pa.table({
        "l_orderkey": pa.array(l_orderkey),
        "l_partkey": pa.array(l_partkey),
        "l_suppkey": pa.array(rng.integers(1, n_su + 1, n_li).astype(np.int64)),
        "l_quantity": pa.array(l_quantity),
        "l_extendedprice": pa.array(price),
        "l_discount": pa.array(rng.integers(0, 11, n_li) / 100.0),
        "l_tax": pa.array(rng.integers(0, 9, n_li) / 100.0),
        "l_returnflag": pa.DictionaryArray.from_arrays(pa.array(flag),
                                                       pa.array(["A", "N", "R"])),
        "l_linestatus": pa.DictionaryArray.from_arrays(
            pa.array((l_shipdate > current).astype(np.int8)), pa.array(["F", "O"])),
        "l_shipdate": dates(l_shipdate),
        "l_commitdate": dates(l_commitdate),
        "l_receiptdate": dates(l_receiptdate),
        "l_shipinstruct": _dict_column(rng, n_li, SHIP_INSTRUCTS),
        "l_shipmode": _dict_column(rng, n_li, SHIP_MODES)}))
    return dirs, rows


def _read(d: str, columns):
    import pyarrow.parquet as pq
    return pq.read_table(d, columns=list(columns))


def _num(table, name):
    import pyarrow as pa
    arr = table.column(name).combine_chunks()
    if pa.types.is_date32(arr.type):
        arr = arr.cast(pa.int32())
    return arr.to_numpy()


def _codes(table, name):
    """A string column as (int codes, numpy object dictionary)."""
    import numpy as np
    import pyarrow.compute as pc
    enc = pc.dictionary_encode(table.column(name).combine_chunks())
    return enc.indices.to_numpy(), np.asarray(enc.dictionary.to_pylist(), dtype=object)


def _is(codes_dict, pred):
    """Row mask of a string column where ``pred(value)`` holds, evaluated
    once per dictionary entry."""
    import numpy as np
    codes, dictionary = codes_dict
    return np.fromiter((bool(pred(v)) for v in dictionary), bool, len(dictionary))[codes]


def _day(d: datetime.date) -> int:
    return (d - EPOCH).days


def q6_reference(ship, disc, qty, price, year: int = 1994, discount: str = "0.06",
                 quantity: int = 24) -> dict:
    """TPC-H Q6 by numpy for one parameter set (q6_text's). The BETWEEN
    bounds fold as decimals, as in SQL: 0.06 - 0.01 is 0.05."""
    from decimal import Decimal

    import numpy as np
    lo = float(Decimal(discount) - Decimal("0.01"))
    hi = float(Decimal(discount) + Decimal("0.01"))
    m = (ship >= _day(datetime.date(year, 1, 1))) & (ship < _day(datetime.date(year + 1, 1, 1))) \
        & (disc >= lo) & (disc <= hi) & (qty < quantity)
    return {"revenue": np.array([np.sum(price[m] * disc[m])])}


def tpch_sql_references(dirs: dict) -> dict:
    """Every sql-path query answered by numpy and pyarrow from the files:
    {name: {column: numpy array}}, rows in the query's order (the window
    query's by (o_custkey, o_orderkey)). Float sums add in another order
    than the port's."""
    import numpy as np

    li = _read(dirs["lineitem"], [
        "l_orderkey", "l_partkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate", "l_receiptdate",
        "l_shipinstruct", "l_shipmode"])
    od = _read(dirs["orders"], ["o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
                                "o_shippriority", "o_totalprice"])
    cu = _read(dirs["customer"], ["c_custkey", "c_mktsegment"])
    pt = _read(dirs["part"], ["p_partkey", "p_brand", "p_type", "p_size", "p_container"])
    ps = _read(dirs["partsupp"], ["ps_partkey", "ps_suppkey"])
    su = _read(dirs["supplier"], ["s_suppkey", "s_comment"])
    L = {c: _num(li, c) for c in ("l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
                                  "l_discount", "l_tax", "l_shipdate", "l_commitdate",
                                  "l_receiptdate")}
    for c in ("l_returnflag", "l_linestatus", "l_shipinstruct", "l_shipmode"):
        L[c] = _codes(li, c)
    del li
    O = {c: _num(od, c) for c in ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
                                  "o_totalprice")}
    O["o_orderpriority"] = _codes(od, "o_orderpriority")
    P = {c: _num(pt, c) for c in ("p_partkey", "p_size")}
    for c in ("p_brand", "p_type", "p_container"):
        P[c] = _codes(pt, c)
    # Keys are dense from 1: a key's row is key - 1.
    for name, keys in (("orders", O["o_orderkey"]), ("part", P["p_partkey"]),
                       ("customer", _num(cu, "c_custkey"))):
        if not np.array_equal(keys, np.arange(1, keys.shape[0] + 1)):
            raise AssertionError(f"{name} keys are not 1..n in file order")
    n_od, n_pt = O["o_orderkey"].shape[0], P["p_partkey"].shape[0]
    price, disc, qty = L["l_extendedprice"], L["l_discount"], L["l_quantity"]
    ship = L["l_shipdate"]
    out = {}

    def strings(codes_dict, rows):
        codes, dictionary = codes_dict
        return dictionary[codes[rows]]

    # Q1.
    m = ship <= _day(datetime.date(1998, 9, 2))
    rf, ls = L["l_returnflag"], L["l_linestatus"]
    key = np.array([f"{a}|{b}" for a in rf[1] for b in ls[1]], dtype=object)
    gid = rf[0][m].astype(np.int64) * len(ls[1]) + ls[0][m]
    order = sorted((k, i) for i, k in enumerate(key))
    d_price = price[m] * (1 - disc[m])
    charge = d_price * (1 + L["l_tax"][m])
    counts = np.bincount(gid, minlength=len(key))

    def per(v):
        return np.bincount(gid, weights=v, minlength=len(key))

    sums = {"sum_qty": per(qty[m]), "sum_base_price": per(price[m]),
            "sum_disc_price": per(d_price), "sum_charge": per(charge)}
    keep = [i for _, i in order if counts[i] > 0]
    out["q1"] = {
        "l_returnflag": np.array([key[i].split("|")[0] for i in keep], dtype=object),
        "l_linestatus": np.array([key[i].split("|")[1] for i in keep], dtype=object),
        "sum_qty": sums["sum_qty"][keep].astype(np.int64),
        "sum_base_price": sums["sum_base_price"][keep],
        "sum_disc_price": sums["sum_disc_price"][keep],
        "sum_charge": sums["sum_charge"][keep],
        "avg_qty": sums["sum_qty"][keep] / counts[keep],
        "avg_price": sums["sum_base_price"][keep] / counts[keep],
        "avg_disc": per(disc[m])[keep] / counts[keep],
        "count_order": counts[keep].astype(np.int64)}
    del d_price, charge, gid, m

    # Q3.
    building = _is(_codes(cu, "c_mktsegment"), lambda v: v == "BUILDING")
    cutoff = _day(datetime.date(1995, 3, 15))
    order_ok = (O["o_orderdate"] < cutoff) & building[O["o_custkey"] - 1]
    m = (ship > cutoff) & order_ok[L["l_orderkey"] - 1]
    rev = np.bincount(L["l_orderkey"][m] - 1, weights=price[m] * (1 - disc[m]),
                      minlength=n_od)
    hit = np.bincount(L["l_orderkey"][m] - 1, minlength=n_od) > 0
    cand = np.flatnonzero(hit)
    top = cand[np.lexsort((O["o_orderdate"][cand], -rev[cand]))][:10]
    out["q3"] = {"l_orderkey": top + 1, "revenue": rev[top],
                 "o_orderdate": O["o_orderdate"][top],
                 "o_shippriority": O["o_shippriority"][top]}

    # Q4.
    late = np.zeros(n_od, bool)
    late[L["l_orderkey"][L["l_commitdate"] < L["l_receiptdate"]] - 1] = True
    m = (O["o_orderdate"] >= _day(datetime.date(1993, 7, 1))) \
        & (O["o_orderdate"] < _day(datetime.date(1993, 10, 1))) & late
    prio = strings(O["o_orderpriority"], np.flatnonzero(m))
    names, cnt = np.unique(prio.astype(str), return_counts=True)
    out["q4"] = {"o_orderpriority": names.astype(object), "order_count": cnt.astype(np.int64)}

    out["q6"] = q6_reference(ship, disc, qty, price)

    # Q12.
    mode = L["l_shipmode"]
    rec = L["l_receiptdate"]
    m = _is(mode, lambda v: v in ("MAIL", "SHIP")) & (L["l_commitdate"] < rec) \
        & (ship < L["l_commitdate"]) & (rec >= _day(datetime.date(1994, 1, 1))) \
        & (rec < _day(datetime.date(1995, 1, 1)))
    rows = np.flatnonzero(m)
    high = _is(O["o_orderpriority"], lambda v: v in ("1-URGENT", "2-HIGH"))[
        L["l_orderkey"][rows] - 1]
    modes = strings(mode, rows).astype(str)
    names = np.unique(modes)
    out["q12"] = {"l_shipmode": names.astype(object),
                  "high_line_count": np.array([int(np.sum(high[modes == n])) for n in names]),
                  "low_line_count": np.array([int(np.sum(~high[modes == n])) for n in names])}

    # Q14.
    m = (ship >= _day(datetime.date(1995, 9, 1))) & (ship < _day(datetime.date(1995, 10, 1)))
    promo = _is(P["p_type"], lambda v: v.startswith("PROMO"))[L["l_partkey"][m] - 1]
    r = price[m] * (1 - disc[m])
    out["q14"] = {"promo_revenue": np.array([100.0 * np.sum(r[promo]) / np.sum(r)])}

    # Q16.
    sizes = np.zeros(51, bool)
    sizes[[1, 3, 5, 7, 9, 11, 14, 19]] = True
    part_ok = _is(P["p_brand"], lambda v: v != "Brand#45") \
        & _is(P["p_type"], lambda v: not v.startswith("MEDIUM POLISHED")) & sizes[P["p_size"]]
    bad = _num(su, "s_suppkey")[_is(_codes(su, "s_comment"),
                                     lambda v: "Customer" in v
                                     and "Complaints" in v.split("Customer", 1)[1])]
    pk, sk = _num(ps, "ps_partkey"), _num(ps, "ps_suppkey")
    m = part_ok[pk - 1] & ~np.isin(sk, bad)
    pairs = np.unique(np.stack([pk[m] - 1, sk[m]]), axis=1)
    brand, ptype = P["p_brand"], P["p_type"]
    seen: dict = {}
    for b_, t_, s_, supp in zip(brand[1][brand[0][pairs[0]]], ptype[1][ptype[0][pairs[0]]],
                                P["p_size"][pairs[0]].tolist(), pairs[1].tolist()):
        seen.setdefault((b_, t_, s_), set()).add(supp)
    ranked = sorted((-len(v), k) for k, v in seen.items())
    out["q16"] = {"p_brand": np.array([k[0] for _, k in ranked], dtype=object),
                  "p_type": np.array([k[1] for _, k in ranked], dtype=object),
                  "p_size": np.array([k[2] for _, k in ranked], dtype=np.int32),
                  "supplier_cnt": np.array([-c for c, _ in ranked], dtype=np.int64)}

    # Q17.
    tot = np.bincount(L["l_partkey"] - 1, weights=qty, minlength=n_pt)
    cnt = np.bincount(L["l_partkey"] - 1, minlength=n_pt)
    thr = 0.2 * (tot / np.maximum(cnt, 1))
    chosen = _is(P["p_brand"], lambda v: v == "Brand#23") \
        & _is(P["p_container"], lambda v: v == "MED BOX")
    m = chosen[L["l_partkey"] - 1] & (qty < thr[L["l_partkey"] - 1])
    out["q17"] = {"avg_yearly": np.array([np.sum(price[m]) / 7.0])}

    # Q19.
    rows = np.flatnonzero(_is(mode, lambda v: v in ("AIR", "AIR REG"))
                          & _is(L["l_shipinstruct"], lambda v: v == "DELIVER IN PERSON"))
    prow = L["l_partkey"][rows] - 1
    q = qty[rows]
    keep = np.zeros(rows.shape[0], bool)
    for b_, conts, qlo, smax in (("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
                                 ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
                                  10, 10),
                                 ("Brand#45", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
                                  20, 15)):
        pmask = _is(P["p_brand"], lambda v: v == b_) \
            & _is(P["p_container"], lambda v: v in conts) \
            & (P["p_size"] >= 1) & (P["p_size"] <= smax)
        keep |= pmask[prow] & (q >= qlo) & (q <= qlo + 10)
    r = rows[keep]
    out["q19"] = {"revenue": np.array([np.sum(price[r] * (1 - disc[r]))])}

    # Q13's outer join: customers without orders count 0.
    n_cu = cu.num_rows
    per_cust = np.bincount(O["o_custkey"] - 1, minlength=n_cu)
    dist = np.bincount(per_cust)
    c_count = np.flatnonzero(dist)
    order = np.lexsort((-c_count, -dist[c_count]))
    out["q13_outer"] = {"c_count": c_count[order].astype(np.int64),
                        "custdist": dist[c_count][order].astype(np.int64)}

    # The window: rank by price (descending) and the running sum by
    # (date, key), left to right, within each customer.
    ck, ok, tp, odate = O["o_custkey"], O["o_orderkey"], O["o_totalprice"], O["o_orderdate"]
    by_price = np.lexsort((-tp, ck))
    sc, sp = ck[by_price], tp[by_price]
    new_part = np.r_[True, sc[1:] != sc[:-1]]
    new_peer = new_part | np.r_[True, sp[1:] != sp[:-1]]
    idx = np.arange(sc.shape[0])
    part_start = np.maximum.accumulate(np.where(new_part, idx, 0))
    peer_start = np.maximum.accumulate(np.where(new_peer, idx, 0))
    rank = np.empty_like(idx)
    rank[by_price] = peer_start - part_start + 1
    by_date = np.lexsort((ok, odate, ck))
    sc = ck[by_date]
    new_part = np.r_[True, sc[1:] != sc[:-1]]
    pos = idx - np.maximum.accumulate(np.where(new_part, idx, 0))
    run = tp[by_date].copy()
    for j in range(1, int(pos.max()) + 1 if pos.size else 0):
        at = np.flatnonzero(pos == j)
        run[at] = run[at - 1] + run[at]
    running = np.empty_like(run)
    running[by_date] = run
    keep = np.flatnonzero(rank <= 2)
    keep = keep[np.lexsort((ok[keep], ck[keep]))]
    out["window"] = {"o_custkey": ck[keep], "o_orderkey": ok[keep], "o_totalprice": tp[keep],
                     "price_rank": rank[keep].astype(np.int64), "running": running[keep]}
    return out


def check_sql_answer(name: str, got, ref: dict, what: str) -> None:
    """``got`` (a pyarrow table) against a reference of tpch_sql_references:
    the columns and row count equal, keys, counts, dates and strings
    exact, float64 within REL_TOL relative (the window query's rows taken
    in (o_custkey, o_orderkey) order)."""
    import numpy as np
    import pyarrow as pa

    if got.column_names != list(ref):
        raise AssertionError(f"{name} ({what}): columns {got.column_names} != {list(ref)}")
    n = len(next(iter(ref.values())))
    if got.num_rows != n:
        raise AssertionError(f"{name} ({what}): {got.num_rows} rows, the reference {n}")
    got = in_reference_order(name, got)
    for c, want in ref.items():
        col = got.column(c).combine_chunks() if got.num_rows else got.column(c)
        if col.null_count:
            raise AssertionError(f"{name} ({what}): {c} holds {col.null_count} nulls")
        if pa.types.is_date32(col.type):
            col = col.cast(pa.int32())
        have = col.to_numpy(zero_copy_only=False)
        if pa.types.is_floating(col.type):
            want = np.asarray(want, dtype=np.float64)
            bad = np.abs(have - want) > REL_TOL * np.maximum(np.abs(have), np.abs(want))
        else:
            bad = np.asarray(have != np.asarray(want, dtype=have.dtype)) \
                if have.dtype != object else \
                np.array([a != b for a, b in zip(have, want)], dtype=bool)
        if np.any(bad):
            i = int(np.flatnonzero(bad)[0])
            raise AssertionError(f"{name} ({what}): row {i} {c} {have[i]!r} != {want[i]!r}")


def in_reference_order(name: str, table):
    """The window query's rows, unordered in SQL, by (o_custkey,
    o_orderkey) as in its reference; any other result as it is."""
    if name != "window":
        return table
    return table.sort_by([("o_custkey", "ascending"), ("o_orderkey", "ascending")])


def as_reference(name: str, table) -> dict:
    """A result table as a reference of check_sql_answer (dates as days)."""
    import pyarrow as pa
    table = in_reference_order(name, table)
    out = {}
    for c in table.column_names:
        col = table.column(c)
        if pa.types.is_date32(col.type):
            col = col.cast(pa.int32())
        out[c] = col.to_numpy()
    return out


def sql_session(dirs: dict, system_path: str, device: str, n_li: int):
    """A session over the sql lake's temp views, with its covering indexes
    built (32 buckets, in memory). Returns (session, {index: build
    seconds})."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConfig, IndexConstants

    session = ht.Session(system_path=system_path, device=device)
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    session.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, n_li + 1)
    if device == "cpu":
        # Route for route with the card, whose default (singleDevice auto)
        # takes the SPMD dispatch.
        session.conf.set(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE, "on")
    for name, d in dirs.items():
        session.create_temp_view(name, session.read.parquet(d))
    hs = ht.Hyperspace(session)
    builds = {}
    for table, name, indexed, included in TPCH_SQL_INDEXES:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs.create_index(session.table(table), IndexConfig(name, indexed, included))
        if device == "cuda":
            torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t0
    return session, builds


def run_sql_path(root: str, scale: float, results: dict):
    """The TPC-H lake at ``scale``, its covering indexes, then every query
    of SQL_PATH_QUERIES through session.sql, twice indexed and twice
    scanned (the buffer pool emptied before each first run): each result
    equals the numpy reference, indexed equals scanned, Q6, Q14 and Q17
    plan an IndexScan. Host spans of each first run: lowering the text,
    optimizing, parquet reads, the rest of execution. Returns (session,
    {table: dir}): the serving path reuses the lake and its indexes."""
    import torch

    from hyperspace_tpu_torch.execution import buffer_pool, executor
    from hyperspace_tpu_torch.plan.nodes import IndexScan

    out = results["sql"] = {"queries": {}}
    t0 = time.perf_counter()
    dirs, rows = make_tpch_sql(os.path.join(root, "sql_data"), scale)
    out["datagen_s"] = time.perf_counter() - t0
    out["rows"] = rows
    log(f"sql: TPC-H lake {rows} in {out['datagen_s']:.1f} s")
    session, out["builds"] = sql_session(dirs, os.path.join(root, "sql_indexes"), "cuda",
                                         rows["lineitem"])
    log(f"sql: built {out['builds']}")
    t0 = time.perf_counter()
    refs = REFERENCES["sql"] = tpch_sql_references(dirs)
    out["reference_s"] = time.perf_counter() - t0
    log(f"sql: numpy references in {out['reference_s']:.1f} s")
    reads = "parquet read -> device"
    for name, text in SQL_PATH_QUERIES.items():
        t0 = time.perf_counter()
        df = session.sql(text)
        lower_s = time.perf_counter() - t0
        session.enable_hyperspace()
        plan = df.optimized_plan()
        session.disable_hyperspace()
        if name in SQL_INDEXED_PLANS and not any(isinstance(leaf, IndexScan)
                                                 for leaf in plan.collect_leaves()):
            raise AssertionError(f"sql {name}: no IndexScan in\n{plan.tree_string()}")
        entry = {"lower_s": lower_s, "indexes": [n for n in plan_index_names(plan) if n]}
        firsts = {}
        for mode in ("indexed", "scanned"):
            (session.enable_hyperspace if mode == "indexed" else session.disable_hyperspace)()
            try:
                secs, tables = [], []
                for run in range(2):
                    if run == 0:
                        buffer_pool.get_pool().clear()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    spans = Spans([(session, "optimize", "optimize (host)"),
                                   (executor, "read_relation_files", reads),
                                   (executor, "read_parquet", reads)])
                    t0 = time.perf_counter()
                    with spans:
                        tables.append(df.to_arrow())
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    if run == 0:
                        entry[f"{mode}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
                        entry[f"{mode}_cold_spans"] = dict(
                            spans.spans, **{"rest of execution": secs[0] - sum(
                                spans.spans.values())})
            finally:
                session.disable_hyperspace()
            for i, table in enumerate(tables):
                check_sql_answer(name, table, refs[name], f"{mode} run {i + 1}")
            entry[f"{mode}_s"] = secs
            firsts[mode] = tables[0]
        check_sql_answer(name, firsts["scanned"], as_reference(name, firsts["indexed"]),
                         "scanned against indexed")
        entry["rows"] = firsts["indexed"].num_rows
        if firsts["indexed"].num_rows <= 10:
            entry["result"] = firsts["indexed"].to_pydict()
        out["queries"][name] = entry
        log(f"sql {name}: {entry['rows']} rows; indexed {entry['indexed_s']} s, scanned "
            f"{entry['scanned_s']} s; indexes {entry['indexes']}; lowered in {lower_s:.4f} s")
    # From SF1 up the lake selects rows for every text (Q19's three
    # branches meet about one lineitem row in 40,000).
    for name in ("q6", "q14", "q17", "q19") if scale >= 1 else ():
        value = out["queries"][name]["result"]
        if not next(iter(value.values()))[0]:
            raise AssertionError(f"sql {name}: the answer is {value}, the lake selects nothing")
    return session, dirs


def sql_card_against_cpu(root: str) -> dict:
    """The sql path's queries on a lake at PARITY_SCALE, on the card and
    through the port on the CPU, indexed and scanned: every result must be
    equal bit for bit (the CPU tests hold the CPU path to the JAX
    package's staged path)."""
    dirs, rows = make_tpch_sql(os.path.join(root, "sql_parity_data"), PARITY_SCALE)
    tables = {}
    for i, device in enumerate(("cuda", "cpu")):
        session, _ = sql_session(dirs, os.path.join(root, f"sql_parity_indexes{i}"), device,
                                 rows["lineitem"])
        for name, text in SQL_PATH_QUERIES.items():
            df = session.sql(text)
            for indexed in (True, False):
                (session.enable_hyperspace if indexed else session.disable_hyperspace)()
                tables[(device, name, indexed)] = df.to_arrow()
                session.disable_hyperspace()
    out, unequal = {}, []
    for name in SQL_PATH_QUERIES:
        for indexed in (True, False):
            card = tables[("cuda", name, indexed)]
            cpu = tables[("cpu", name, indexed)]
            same = card.equals(cpu) and float_bits(card) == float_bits(cpu)
            out[f"{name} {'indexed' if indexed else 'scanned'}"] = same
            if not same:
                unequal.append(f"{name} {'indexed' if indexed else 'scanned'}")
    log(f"sql: card against the CPU at scale {PARITY_SCALE} ({rows['lineitem']} lineitem "
        f"rows): {'all equal bit for bit' if not unequal else unequal}")
    if unequal:
        raise AssertionError(f"sql: the card and the CPU differ on {unequal}")
    return out


# ---------------------------------------------------------------------------
# The serving path: TPC-H Q6 under its substitution parameters.
# ---------------------------------------------------------------------------

def _q6_params(count: int = 16, seed: int = 6) -> list:
    """``count`` distinct TPC-H Q6 parameter sets (TPC-H specification
    2.4.6.3: DATE the first of January of a year in 1993-1997, DISCOUNT in
    0.02-0.09, QUANTITY 24 or 25), drawn once from ``seed``."""
    import random
    every = [(y, f"0.0{d}", q) for y in range(1993, 1998) for d in range(2, 10)
             for q in (24, 25)]
    return sorted(random.Random(seed).sample(every, count))


Q6_PARAMS = _q6_params()
# The serving path's frontend conf. Each member's input estimate is the
# whole lineitem (2.8 GB of files at SF10): the admission budget must hold
# the 16 of a wave, as a deployment serving such sweeps would set it.
SERVING_CONF = {"hyperspace.tpu.serving.maxConcurrency": "1",
                "hyperspace.tpu.serving.batching.window": "0.3",
                "hyperspace.tpu.serving.batching.maxBatch": "16",
                "hyperspace.tpu.serving.admission.maxBytes": str(64 * 2 ** 30)}


def q6_text(year: int, discount: str, quantity: int) -> str:
    """TPC-H Q6 (tests/test_tpch_sql.py's text) with its parameters."""
    return f"""
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '{year}-01-01'
 and l_shipdate < date '{year}-01-01' + interval '1' year
 and l_discount between {discount} - 0.01 and {discount} + 0.01
 and l_quantity < {quantity}
"""


def _percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _wave(session, texts, fe=None):
    """One submit_wave of the texts through ``fe`` (else a fresh frontend):
    (arrow tables, wall seconds, member latencies, the frontend's stats with
    the wave's mask-kernel launches as ``mask_launches``)."""
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend
    fe = fe or ServingFrontend(session)
    masks0 = ck.LAUNCHES["compare_mask"] + ck.LAUNCHES["range_mask"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = fe.submit_wave([(session.sql(t).plan, session, f"user{i}", None)
                              for i, t in enumerate(texts)])
    for p in pending:
        if isinstance(p, Exception):
            raise p
    tables = [p.result(timeout=600).to_arrow() for p in pending]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fe.drain()
    st = fe.stats()
    st["mask_launches"] = ck.LAUNCHES["compare_mask"] + ck.LAUNCHES["range_mask"] - masks0
    return tables, wall, [p.latency_s for p in pending], st


def _serial(session, texts):
    """Each text alone through to_arrow(): (tables, summed seconds)."""
    import torch
    tables, total = [], 0.0
    for t in texts:
        df = session.sql(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables.append(df.to_arrow())
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return tables, total


def _same_bits(a, b) -> bool:
    return a.equals(b) and float_bits(a) == float_bits(b)


def run_serving_path(session, dirs: dict, results: dict) -> None:
    """The serving tier on the sql path's lake (lineitem and sql_li_ship):
    16 TPC-H Q6 texts under distinct parameter sets (Q6_PARAMS).

    1. Scanned wave: with hyperspace disabled, one submit_wave on a
       frontend at maxConcurrency=1, batching.window=0.3, maxBatch=16: one
       batch of 16 members over one shared scan (15 hits), each member's
       own mask through the mask kernels (at least 16 launches in the
       wave), no member rerun alone; each member's revenue equals the same
       text run alone on the card bit for bit, and the numpy reference
       within REL_TOL.
    2. Indexed wave: with hyperspace enabled every member plans an
       IndexScan on sql_li_ship and runs alone inside the batch (the mask
       kernels on l_shipdate); each equals its own run alone bit for bit
       and the scanned wave within REL_TOL.
    3. Result cache: the indexed texts twice (16 device-tier hits on the
       second pass, equal bytes), then delete_index and restore_index of
       sql_li_ship (the next pass misses every member, equal answers), then
       deviceBytes at one result's size (a pass demotes 15 results to the
       host tier, the next hits them there).
    """
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.plan.nodes import IndexScan
    from hyperspace_tpu_torch.serving.constants import ServingConstants as SC
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend

    t_path = time.perf_counter()
    out = results["serving"] = {"params": Q6_PARAMS}
    texts = [q6_text(*p) for p in Q6_PARAMS]
    li = _read(dirs["lineitem"], ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"])
    cols = [_num(li, c) for c in ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")]
    del li
    refs = [q6_reference(*cols, *p) for p in Q6_PARAMS]
    del cols
    for k, v in SERVING_CONF.items():
        session.conf.set(k, v)
    n = len(texts)

    # 1. The scanned wave.
    session.disable_hyperspace()
    serial, serial_s = _serial(session, texts)
    tables, wall, lat, st = _wave(session, texts)
    if (st["batches"], st["batched_queries"], st["shared_scans"], st["shared_scan_hits"],
            st["member_fallbacks"], st["completed"]) != (1, n, 1, n - 1, 0, n) \
            or st["mask_launches"] < n:
        raise AssertionError(f"serving: the scanned wave did not run as one {n}-member sweep "
                             f"over one shared scan with a mask kernel per member: {st}")
    for i, (got, alone) in enumerate(zip(tables, serial)):
        if not _same_bits(got, alone):
            raise AssertionError(f"serving: member {i} {Q6_PARAMS[i]} {got.to_pydict()} != "
                                 f"its run alone {alone.to_pydict()}")
        check_sql_answer("q6", got, refs[i], f"serving scanned member {i}")
    out["scanned"] = {"wave_s": wall, "serial_s": serial_s, "p50_s": _percentile(lat, 50),
                      "p99_s": _percentile(lat, 99), "stats": st,
                      "revenue": [t.column(0)[0].as_py() for t in tables]}
    scanned = tables
    log(f"serving: scanned wave of {n} in {wall:.3f} s against {serial_s:.3f} s serial; {st}")

    # 2. The indexed wave.
    session.enable_hyperspace()
    try:
        plan = session.sql(texts[0]).optimized_plan()
        if not any(isinstance(leaf, IndexScan) and leaf.index_entry.name == "sql_li_ship"
                   for leaf in plan.collect_leaves()):
            raise AssertionError(f"serving: Q6 plans no sql_li_ship scan:\n{plan.tree_string()}")
        serial, serial_s = _serial(session, texts)
        tables, wall, lat, st = _wave(session, texts)
        if (st["batches"], st["completed"], st["shared_scans"], st["member_fallbacks"]) \
                != (1, n, 0, 0) or st["mask_launches"] < n:
            raise AssertionError(f"serving: the indexed wave's members did not run alone: {st}")
        for i, (got, alone) in enumerate(zip(tables, serial)):
            if not _same_bits(got, alone):
                raise AssertionError(f"serving: indexed member {i} differs from its run alone")
            check_sql_answer("q6", got, as_reference("q6", scanned[i]),
                             f"serving indexed member {i} against scanned")
        out["indexed"] = {"wave_s": wall, "serial_s": serial_s, "p50_s": _percentile(lat, 50),
                          "p99_s": _percentile(lat, 99), "stats": st}
        indexed = tables
        log(f"serving: indexed wave of {n} in {wall:.3f} s against {serial_s:.3f} s serial; {st}")

        # 3. The result cache.
        # The frontend's cross-session cache follows the governing conf.
        session.conf.set(SC.RESULT_CACHE_ENABLED, "true")
        session.conf.set(SC.RESULT_CACHE_MIN_COMPUTE_SECONDS, "0")
        fe = ServingFrontend(session)
        passes = {}

        def cache_pass(name, want):
            tables, wall, lat, st = _wave(session, texts, fe)
            rc = st["shared_result_cache"]
            for i, got in enumerate(tables):
                if not _same_bits(got, indexed[i]):
                    raise AssertionError(f"serving: cache pass {name}, member {i} differs")
            got = {k: rc[k] for k in want}
            if got != want:
                raise AssertionError(f"serving: cache pass {name}: {got} != {want}; {rc}")
            passes[name] = {"wave_s": wall, "p50_s": _percentile(lat, 50),
                            "p99_s": _percentile(lat, 99), "result_cache": rc}
            log(f"serving: cache pass {name} in {wall:.3f} s; {rc}")
            return rc

        cache_pass("cold", {"misses": n, "admissions": n, "hits": 0})
        rc = cache_pass("warm", {"misses": n, "device_hits": n, "host_hits": 0})
        hs = ht.Hyperspace(session)
        hs.delete_index("sql_li_ship")
        hs.restore_index("sql_li_ship")
        cache_pass("after delete and restore", {"misses": 2 * n, "device_hits": n})
        one = rc["device_nbytes"] // rc["device_entries"]
        session.conf.set(SC.RESULT_CACHE_DEVICE_BYTES, str(one))  # a new, empty cache
        cache_pass("demoting", {"misses": n, "demotions": n - 1, "device_entries": 1,
                                "host_entries": n - 1})
        cache_pass("host hits", {"misses": n, "host_hits": n - 1, "device_hits": 1})
        out["cache"] = passes
        # No submission of the path is refused: no SLO objective is armed
        # here, and the advisor path left no admission state behind.
        out["rejected"] = (out["scanned"]["stats"]["rejected"]
                           + out["indexed"]["stats"]["rejected"] + fe.stats()["rejected"])
        if out["rejected"]:
            raise AssertionError(f"serving: {out['rejected']} submissions rejected")
    finally:
        session.disable_hyperspace()
        session.conf.set(SC.RESULT_CACHE_ENABLED, "false")
    out["seconds"] = time.perf_counter() - t_path
    return refs, scanned, indexed


# ---------------------------------------------------------------------------
# The faults path: the robustness tier's fault points, retries, deadline and
# degradation ladders on the serving path's lake, each step held to the same
# step unarmed.
# ---------------------------------------------------------------------------

def _armed(session, specs: dict):
    """Arm ``specs`` ({point: spec}) on the session's conf; returns a
    function that disarms them."""
    from hyperspace_tpu_torch.robustness.constants import RobustnessConstants as RC
    for point, spec in specs.items():
        session.conf.set(f"{RC.FAULTS_PREFIX}.{point}", spec)

    def disarm():
        for point in specs:
            session.conf.unset(f"{RC.FAULTS_PREFIX}.{point}")
    return disarm


def _counter_delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in sorted(set(before) | set(after))
            if after.get(k, 0) != before.get(k, 0)}


def run_faults_path(session, dirs: dict, scanned: list, indexed: list, n_li: int,
                    results: dict) -> None:
    """The robustness tier on the serving path's lake and frontend conf. No
    step changes data; each is held to the same step unarmed (the serving
    path's answers, or a run of its own). Every step records its seconds,
    the process counters it moved and its verdict.

    1. pooled_read: the buffer pool emptied and the reader pool's in-flight
       budget raised past lineitem's files (so their read fans out over the
       pool), the 16 Q6 texts as one scanned wave under one
       ``io.pooled_read=transient:times=2`` registry: each answer bit for bit
       the serving path's scanned one, 2 retries.
    2. worker_death: the 16 texts submitted one by one (one worker,
       batching window 0.3 s) under ``serving.worker=error:times=1``: one
       release, each answer its run alone.
    3. device_put: ``result_cache.device_put=error`` over an indexed wave:
       16 entries in the host tier, none on the device; a second wave hits
       them there; every answer the serving path's indexed one.
    4. spill: device budget 1 byte, host budget one result, a spill dir; two
       texts, the first spilled; its file overwritten; the first again is a
       miss, recomputed to the same bits, one spill corruption.
    5. buffer_load: a warm ``l_shipdate <`` count and sum over sql_li_ship;
       ``buffer.load=error:times=1`` is a silent miss and a re-read with the
       same bits; with ``degrade.enabled=false`` the typed error.
    6. scan_decode and prefetch: ``scan.parquet_decode=error`` on a scanned
       Q6, and ``io.prefetch_produce=error:nth=2`` on a chunked scanned Q6
       (maxChunkRows a quarter of lineitem): InjectedFaultError, as the
       reference raises.
    7. deadline: ``deadlineMs=1`` on a cold Q1, twice: at the default
       configuration (the read on pyarrow's threads, unchecked: the
       QueryDeadlineError comes at the stage's exit, and its overrun past
       the deadline is recorded), then with its read over the reader pool,
       whose wait checks the deadline (QueryDeadlineError at a stage entry
       or the read's wait); two cancellations counted.
    8. rebuild: a covering index on orders (o_orderkey; 16 files, read over
       the pool with its budget raised) built twice, the second time under
       ``io.pooled_read=transient:times=1``: one retry, the same bucket files
       byte for byte; both then deleted and vacuumed. (sql_pt_pk's source,
       part, is one file, whose read is no pooled fan-out.)
    """
    import hashlib

    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConfig, IndexConstants
    from hyperspace_tpu_torch.exceptions import QueryDeadlineError
    from hyperspace_tpu_torch.execution import buffer_pool
    from hyperspace_tpu_torch.robustness import faults
    from hyperspace_tpu_torch.robustness.constants import RobustnessConstants as RC
    from hyperspace_tpu_torch.robustness.faults import FaultRegistry, InjectedFaultError
    from hyperspace_tpu_torch.serving.constants import ServingConstants as SC
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend
    from hyperspace_tpu_torch.serving.result_cache import table_nbytes

    t_path = time.perf_counter()
    out = results["faults"] = {"steps": {}}
    texts = [q6_text(*p) for p in Q6_PARAMS]
    n = len(texts)
    for k, v in SERVING_CONF.items():
        session.conf.set(k, v)
    pool = buffer_pool.get_pool()

    def step(name: str, fn):
        torch.cuda.synchronize()
        before = faults.stats()
        t0 = time.perf_counter()
        detail = fn() or {}
        torch.cuda.synchronize()
        out["steps"][name] = {"seconds": time.perf_counter() - t0,
                              "counters": _counter_delta(before, faults.stats()),
                              "verdict": "ok", **detail}
        log(f"faults {name}: {out['steps'][name]}")
        return out["steps"][name]

    def same_all(tables, want, what):
        for i, (got, ref) in enumerate(zip(tables, want)):
            if not _same_bits(got, ref):
                raise AssertionError(f"faults {what}: member {i} {got.to_pydict()} != "
                                     f"{ref.to_pydict()}")

    def expect_counters(name, want):
        got = {k: out["steps"][name]["counters"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"faults {name}: counters {out['steps'][name]['counters']}, "
                                 f"not {want}")

    def expect_raise(cls, fn, what):
        try:
            fn()
        except cls as e:
            return f"{type(e).__name__}: {e}"
        raise AssertionError(f"faults {what}: no {cls.__name__}")

    session.disable_hyperspace()
    try:
        # 1. Transient faults in the pooled reads of the shared scan.
        def pooled_read():
            # lineitem's files are over the reader pool's default in-flight
            # budget, which sends their read to pyarrow's threads: this step
            # raises the budget so that the read fans out over the pool.
            pool.clear()
            session.conf.set(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES, str(64 << 30))
            reg = FaultRegistry.from_conf_specs({"io.pooled_read": "transient:times=2"})
            try:
                with faults.scope(reg):
                    tables, wall, _, st = _wave(session, texts)
            finally:
                session.conf.unset(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES)
            same_all(tables, scanned, "pooled_read")
            return {"wave_s": wall, "hits": reg.hit_count("io.pooled_read"),
                    "shared_scans": st["shared_scans"]}
        step("pooled_read", pooled_read)
        expect_counters("pooled_read", {"injected": 2, "retries": 2, "retry_failures": 0})

        # 2. A worker dies between popping an entry and running it.
        def worker_death():
            fe = ServingFrontend(session)
            reg = FaultRegistry.from_conf_specs({"serving.worker": "error:times=1"})
            with faults.scope(reg):
                pending = [fe.submit(session.sql(t), client=f"user{i}")
                           for i, t in enumerate(texts)]
            tables = [p.result(timeout=600).to_arrow() for p in pending]
            fe.drain()
            same_all(tables, scanned, "worker_death")
            st = fe.stats()
            if (st["active_workers"], st["queued"], st["inflight_bytes"]) != (0, 0, 0):
                raise AssertionError(f"faults worker_death: the frontend kept state: {st}")
            return {"batches": st["batches"], "completed": st["completed"]}
        step("worker_death", worker_death)
        expect_counters("worker_death", {"injected": 1, "worker_releases": 1})
    finally:
        session.enable_hyperspace()

    try:
        # 3. The result cache's copy onto the device fails: the host tier.
        def device_put():
            session.conf.set(SC.RESULT_CACHE_ENABLED, "true")
            session.conf.set(SC.RESULT_CACHE_MIN_COMPUTE_SECONDS, "0")
            disarm = _armed(session, {"result_cache.device_put": "error"})
            try:
                fe = ServingFrontend(session)
                tables, _, _, st = _wave(session, texts, fe)
                same_all(tables, indexed, "device_put")
                rc = st["shared_result_cache"]
                if (rc["host_entries"], rc["device_entries"]) != (n, 0):
                    raise AssertionError(f"faults device_put: tiers {rc}")
                again, _, _, st2 = _wave(session, texts, fe)
                same_all(again, indexed, "device_put (host hits)")
                if st2["shared_result_cache"]["host_hits"] != n:
                    raise AssertionError(f"faults device_put: {st2['shared_result_cache']}")
            finally:
                disarm()
            return {"host_entries": rc["host_entries"],
                    "host_hits": st2["shared_result_cache"]["host_hits"]}
        step("device_put", device_put)
        expect_counters("device_put", {"injected": n, "degraded_device_put": n})

        # 4. A spilled result's file is corrupt: a miss, then recomputed.
        def spill():
            spill_dir = os.path.join(os.path.dirname(session.hs_conf.system_path()),
                                     "faults_spill")
            one = table_nbytes(session.sql(texts[0]).execute())
            for k, v in {SC.RESULT_CACHE_DEVICE_BYTES: "1", SC.RESULT_CACHE_HOST_BYTES: str(one),
                         SC.RESULT_CACHE_SPILL_DIR: spill_dir}.items():
                session.conf.set(k, v)
            fe = ServingFrontend(session)
            first = fe.submit(session.sql(texts[0])).result(timeout=600).to_arrow()
            fe.submit(session.sql(texts[1])).result(timeout=600)
            cache = fe.result_cache()
            spilled = cache.stats()["spill_entries"]
            path = next(iter(cache._spill.values()))[0]
            with open(path, "wb") as f:
                f.write(b"\x00\x01 not a spilled table")
            again = fe.submit(session.sql(texts[0])).result(timeout=600).to_arrow()
            st = cache.stats()
            fe.drain()
            same_all([first, again], [indexed[0], indexed[0]], "spill")
            if spilled != 1 or st["spill_corruptions"] != 1:
                raise AssertionError(f"faults spill: {spilled} spilled, {st}")
            shutil.rmtree(spill_dir, ignore_errors=True)
            return {"spilled": spilled, "spill_corruptions": st["spill_corruptions"],
                    "misses": st["misses"]}
        step("spill", spill)
        expect_counters("spill", {"spill_corruptions": 1})
    finally:
        for k in (SC.RESULT_CACHE_DEVICE_BYTES, SC.RESULT_CACHE_HOST_BYTES,
                  SC.RESULT_CACHE_SPILL_DIR):
            session.conf.unset(k)
        session.conf.set(SC.RESULT_CACHE_ENABLED, "false")

    # 5. A warm pool entry's load fails: a silent miss and a re-read.
    cutoff_text = ("select count(*) as n, sum(l_extendedprice) as s from lineitem "
                   "where l_shipdate < date '1993-06-01'")

    def buffer_load():
        plan = session.sql(cutoff_text).optimized_plan()
        if "sql_li_ship" not in plan_index_names(plan):
            raise AssertionError(f"faults buffer_load: no sql_li_ship scan:\n"
                                 f"{plan.tree_string()}")
        warm = session.sql(cutoff_text).to_arrow()
        warm = session.sql(cutoff_text).to_arrow()
        p0 = pool.stats()
        disarm = _armed(session, {"buffer.load": "error:times=1"})
        try:
            got = session.sql(cutoff_text).to_arrow()
            session.conf.set(RC.DEGRADE_ENABLED, "false")
            loud = expect_raise(InjectedFaultError, lambda: session.sql(cutoff_text).to_arrow(),
                                "buffer_load with degrade off")
        finally:
            disarm()
            session.conf.unset(RC.DEGRADE_ENABLED)
        p1 = pool.stats()
        same_all([got], [warm], "buffer_load")
        return {"degraded_loads": p1["degraded_loads"] - p0["degraded_loads"],
                "invalidations": p1["invalidations"] - p0["invalidations"],
                "rows": got.column(0)[0].as_py(), "degrade_off": loud}
    st5 = step("buffer_load", buffer_load)
    expect_counters("buffer_load", {"injected": 2, "degraded_buffer_loads": 1})
    if (st5["degraded_loads"], st5["invalidations"]) != (1, 1):
        raise AssertionError(f"faults buffer_load: pool counters {st5}")

    # 6. The scan decode and the prefetch producer: the typed error.
    session.disable_hyperspace()
    try:
        def scan_decode():
            disarm = _armed(session, {"scan.parquet_decode": "error"})
            try:
                err = expect_raise(InjectedFaultError, lambda: session.sql(texts[0]).to_arrow(),
                                   "scan_decode")
            finally:
                disarm()
            return {"error": err}
        step("scan_decode", scan_decode)
        # On the card the scanned Q6 takes the SPMD dispatch (its leaf fits
        # the budget this session sets): the fault fires in the dispatch's
        # read, and the SPMD ladder degrades to the single-device run. There
        # the Aggregate's fused region meets it in its leaf read and, degrade
        # being on, runs staged; the Project-over-Filter below is a region of
        # its own and meets it too; the staged read meets it last and raises
        # the typed error. The reference's single-device run counts the same
        # three.
        from hyperspace_tpu_torch.execution import spmd
        expect_counters("scan_decode", {"injected": 4, "degraded_spmd": 1}
                        if spmd._spmd_eligible(session) else {"injected": 3})

        def prefetch():
            pool.clear()
            session.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, n_li // 4 + 1)
            disarm = _armed(session, {"io.prefetch_produce": "error:nth=2"})
            try:
                err = expect_raise(InjectedFaultError, lambda: session.sql(texts[0]).to_arrow(),
                                   "prefetch")
            finally:
                disarm()
                session.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, n_li + 1)
            return {"error": err}
        step("prefetch", prefetch)
        expect_counters("prefetch", {"injected": 1})

        # 7. A cold Q1 under a 1 ms deadline, twice. The check is
        # cooperative: a plan made within the millisecond passes every
        # stage's entry, and at the default configuration lineitem's read
        # runs on pyarrow's threads, which have no check of their own: the
        # query is cancelled only at the stage's exit, after the whole read
        # (``default``, its overrun past the deadline recorded). Then the
        # reader pool's budget is raised, so the read fans out over the
        # pool, whose wait polls the deadline (``io.read``).
        def deadline():
            runs = {}
            for name, inflight in (("default", None), ("pooled", str(64 << 30))):
                pool.clear()
                session.conf.set(RC.DEADLINE_MS, "1")
                if inflight is not None:
                    session.conf.set(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES, inflight)
                t0 = time.perf_counter()
                try:
                    err = expect_raise(QueryDeadlineError,
                                       lambda: session.sql(TPCH_TEXTS["q1"]).to_arrow(),
                                       f"deadline ({name})")
                finally:
                    session.conf.unset(RC.DEADLINE_MS)
                    session.conf.unset(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES)
                seconds = time.perf_counter() - t0
                runs[name] = {"error": err, "seconds": seconds,
                              "overrun_s": seconds - 0.001}
            return runs
        step("deadline", deadline)
        expect_counters("deadline", {"deadline_cancellations": 2})
    finally:
        session.enable_hyperspace()

    # 8. An orders index built twice, the second time under a transient read
    # fault (part, sql_pt_pk's source, is one file: its read is no pooled
    # fan-out).
    def rebuild():
        hs = ht.Hyperspace(session)
        orders = session.table("orders")
        config = (["o_orderkey"], ["o_orderdate", "o_totalprice"])
        reg = FaultRegistry.from_conf_specs({"io.pooled_read": "transient:times=1"})
        session.conf.set(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES, str(64 << 30))
        try:
            hs.create_index(orders, IndexConfig("faults_od", *config))
            with faults.scope(reg):
                hs.create_index(orders, IndexConfig("faults_od_rb", *config))
        finally:
            session.conf.unset(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES)

        def bucket_files(name):
            entry = hs.index_manager.get_index(name)
            return sorted(hashlib.sha256(file_bytes(f)).hexdigest()
                          for f in entry.content.files if f.endswith(".parquet"))

        first, again = bucket_files("faults_od"), bucket_files("faults_od_rb")
        for name in ("faults_od", "faults_od_rb"):
            hs.delete_index(name)
            hs.vacuum_index(name)
        if first != again or not first:
            raise AssertionError(f"faults rebuild: {len(again)} bucket files differ from the "
                                 f"unarmed build's {len(first)}")
        return {"bucket_files": len(first), "hits": reg.hit_count("io.pooled_read")}
    step("rebuild", rebuild)
    expect_counters("rebuild", {"injected": 1, "retries": 1, "retry_failures": 0})

    session.disable_hyperspace()
    out["robustness"] = faults.stats()
    out["seconds"] = time.perf_counter() - t_path


def faults_summary(fl: dict, launches: dict, card: str) -> dict:
    """The faults line: each step's seconds, the counters it moved and its
    verdict; the process's robustness collector; the path's launches and
    seconds; the card."""
    return {"steps": fl["steps"], "robustness": fl["robustness"], "launches": launches,
            "seconds": fl["seconds"], "card": card}


# ---------------------------------------------------------------------------
# The streaming path: TPC-H New Sales Refresh (RF1) loads into the sql lake.
# ---------------------------------------------------------------------------

# RF1 at scale factor SF inserts SF x 1,500 orders, each with 1-7 lineitems
# (TPC-H specification 2.26.2); the bulk round loads a quarter of each table.
RF1_ORDERS_PER_SF = 1500
# Six rounds, not eight: with the faults and cluster paths the script ran
# past 1,000 s of its 1,200 s limit with eight planned.
STREAMING_ROUNDS = 6
# A slow host still finishes inside the 1200 s limit: past this many
# seconds of the script's clock, no round after the fourth starts. On an
# H100 host where the whole script takes about 980 s the sixth round
# starts before it, so all six run.
STREAMING_MIN_ROUNDS = 4
STREAMING_LATE_S = 650
STREAMING_APPENDERS = 4
STREAMING_CONF = {"hyperspace.tpu.streaming.enabled": "true",
                  "hyperspace.tpu.streaming.groupCommit.windowMs": "50"}
STREAMING_COVERING = {"sql_li_ship": "l_shipdate", "sql_li_pk": "l_partkey"}
STREAMING_SKETCHES = ("st_od_bloom", "st_od_skip")

# The child that dies mid-commit: a port session on the card over the same
# system path appends one batch and commits with a kill at ingest.publish.
CRASH_CHILD = """
import sys
repo, system_path, table, batch = sys.argv[1:5]
sys.path.insert(0, repo)
import pyarrow.parquet as pq
import hyperspace_tpu_torch as ht
session = ht.Session(system_path=system_path, device="cuda", conf={
    "hyperspace.tpu.streaming.enabled": "true",
    "hyperspace.tpu.robustness.faults.ingest.publish": "kill:nth=1"})
hs = ht.Hyperspace(session)
hs.append(table, pq.read_table(batch))
hs.commit(table)
print("CHILD-SURVIVED")
"""


def rf1_tables(rows: dict, schemas: dict, first_orderkey: int, n_orders: int, seed: int):
    """One refresh's new orders (keys from ``first_orderkey``) and their 1-7
    lineitems each, with make_tpch_sql's value domains and formulas, cast
    to the tables' file schemas. Returns (orders, lineitem) arrow tables."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    n_su, n_pt, n_cu = rows["supplier"], rows["part"], rows["customer"]

    def dates(days):
        return pa.array(days.astype(np.int32), type=pa.int32()).cast(pa.date32())

    start = (datetime.date(1992, 1, 1) - EPOCH).days
    end = (datetime.date(1998, 12, 31) - EPOCH).days
    o_orderkey = np.arange(first_orderkey, first_orderkey + n_orders, dtype=np.int64)
    o_orderdate = rng.integers(start, end - 151 + 1, n_orders).astype(np.int32)
    o_custkey = rng.integers(1, n_cu + 1, n_orders).astype(np.int64)
    o_custkey = np.maximum(np.where(o_custkey % 3 == 0, np.where(
        o_custkey < n_cu, o_custkey + 1, o_custkey - 1), o_custkey), 1)
    orders = pa.table({
        "o_orderkey": pa.array(o_orderkey), "o_custkey": pa.array(o_custkey),
        "o_orderdate": dates(o_orderdate),
        "o_orderpriority": _dict_column(rng, n_orders, PRIORITIES),
        "o_shippriority": pa.array(np.zeros(n_orders, dtype=np.int32)),
        "o_totalprice": pa.array(np.round(rng.uniform(850, 560_000, n_orders), 2))})
    lines = rng.integers(1, 8, n_orders)
    l_orderkey = np.repeat(o_orderkey, lines)
    odate = np.repeat(o_orderdate, lines)
    n_li = int(l_orderkey.shape[0])
    l_shipdate = odate + rng.integers(1, 122, n_li).astype(np.int32)
    l_commitdate = odate + rng.integers(30, 91, n_li).astype(np.int32)
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_li).astype(np.int32)
    current = (CURRENT_DATE - EPOCH).days
    flag = np.where(l_receiptdate <= current, rng.integers(0, 2, n_li) * 2, 1).astype(np.int8)
    l_partkey = rng.integers(1, n_pt + 1, n_li).astype(np.int64)
    l_quantity = rng.integers(1, 51, n_li).astype(np.int64)
    retail = (90_000 + (l_partkey // 10) % 20_001 + 100 * (l_partkey % 1000)) / 100.0
    lineitem = pa.table({
        "l_orderkey": pa.array(l_orderkey), "l_partkey": pa.array(l_partkey),
        "l_suppkey": pa.array(rng.integers(1, n_su + 1, n_li).astype(np.int64)),
        "l_quantity": pa.array(l_quantity),
        "l_extendedprice": pa.array(np.round(l_quantity * retail, 2)),
        "l_discount": pa.array(rng.integers(0, 11, n_li) / 100.0),
        "l_tax": pa.array(rng.integers(0, 9, n_li) / 100.0),
        "l_returnflag": pa.DictionaryArray.from_arrays(pa.array(flag), pa.array(["A", "N", "R"])),
        "l_linestatus": pa.DictionaryArray.from_arrays(
            pa.array((l_shipdate > current).astype(np.int8)), pa.array(["F", "O"])),
        "l_shipdate": dates(l_shipdate), "l_commitdate": dates(l_commitdate),
        "l_receiptdate": dates(l_receiptdate),
        "l_shipinstruct": _dict_column(rng, n_li, SHIP_INSTRUCTS),
        "l_shipmode": _dict_column(rng, n_li, SHIP_MODES)})
    return orders.cast(schemas["orders"]), lineitem.cast(schemas["lineitem"])


def table_schemas(dirs: dict) -> dict:
    """The file schema of the sql lake's orders and lineitem (what append()
    holds a batch to)."""
    import pyarrow.parquet as pq
    return {t: pq.read_schema(os.path.join(dirs[t], sorted(
        f for f in os.listdir(dirs[t]) if f.endswith(".parquet"))[0]))
        for t in ("orders", "lineitem")}


def q6_revenues(lineitem) -> list:
    """Q6's revenue for each of Q6_PARAMS over one batch (numpy)."""
    cols = [_num(lineitem, c) for c in ("l_shipdate", "l_discount", "l_quantity",
                                        "l_extendedprice")]
    return [float(q6_reference(*cols, *p)["revenue"][0]) for p in Q6_PARAMS]


def check_deliveries(subs, want_total: int, revenues: list, what: str) -> list:
    """Each subscription delivered exactly ``want_total`` times; its latest
    delivery's revenue within REL_TOL of ``revenues``. Returns the latest
    results as arrow tables."""
    import numpy as np
    import torch
    tables = []
    for i, sub in enumerate(subs):
        sub.wait_for(want_total, timeout=600)
        if sub.delivered_total != want_total:
            raise AssertionError(f"streaming {what}: subscription {i} delivered "
                                 f"{sub.delivered_total} times, not {want_total}")
        d = sub.latest()
        if not d.ok:
            raise AssertionError(f"streaming {what}: subscription {i} failed: {d.error!r}")
        table = d.result.to_arrow()
        check_sql_answer("q6", table, {"revenue": np.array([revenues[i]])},
                         f"streaming {what}, subscription {i}")
        tables.append(table)
    torch.cuda.synchronize()
    return tables


def check_commit(res: dict, updated: list, what: str) -> None:
    if sorted(res["indexes_updated"]) != sorted(updated) or res["indexes_skipped"]:
        raise AssertionError(f"streaming {what}: updated {res['indexes_updated']}, skipped "
                             f"{res['indexes_skipped']}, not {updated}")


def check_deltas(hs, rows: int, what: str) -> None:
    """The newest version of each covering index holds only delta files, each
    with only its bucket's keys, sorted, adding up to ``rows``."""
    for name, key in STREAMING_COVERING.items():
        entry = hs.index_manager.get_index(name)
        marker = f"v__={entry.log_version}{os.sep}"
        files = [f for f in entry.content.files if marker in f]
        got = check_bucket_layout(entry, key, files=files, one_file_per_bucket=False)
        if got != rows:
            raise AssertionError(f"streaming {what}: {name}'s delta holds {got} rows, not {rows}")


def log_entries(path: str) -> int:
    log = os.path.join(path, "_hyperspace_log")
    return len([n for n in os.listdir(log) if n.isdigit()])


def adhoc_q6(session, li_dir: str, texts: list, check_plan: bool) -> list:
    """Each text indexed over a fresh listing of lineitem (the view made
    anew): arrow results. With ``check_plan``, each plan must read
    sql_li_ship through an exact IndexScan (no hybrid note)."""
    import torch

    from hyperspace_tpu_torch.plan.nodes import IndexScan
    session.create_temp_view("lineitem", session.read.parquet(li_dir), replace=True)
    out = []
    for t in texts:
        df = session.sql(t)
        if check_plan:
            plan = df.optimized_plan()
            if not any(isinstance(leaf, IndexScan) and leaf.index_entry.name == "sql_li_ship"
                       for leaf in plan.collect_leaves()) or "hybrid(" in plan.tree_string():
                raise AssertionError(f"streaming: Q6 plans no exact sql_li_ship scan:\n"
                                     f"{plan.tree_string()}")
        out.append(df.to_arrow())
    torch.cuda.synchronize()
    return out


def run_streaming_path(root: str, session, dirs: dict, rows: dict, q6_refs: list,
                       results: dict, late_at: float = float("inf")) -> None:
    """The streaming tier on the sql lake (after the serving path): TPC-H
    RF1 refreshes at the lake's scale, with 16 standing Q6 queries.

    1. Setup: st_od_skip (MinMax o_orderdate) and st_od_bloom (Bloom
       o_orderkey) on orders; streaming on, groupCommit.windowMs=50; the 16
       Q6 texts of Q6_PARAMS subscribed on a frontend, hyperspace enabled.
    2. STREAMING_ROUNDS rounds (seed 100 + round; none after the
       STREAMING_MIN_ROUNDS-th starts once ``time.perf_counter()`` passes
       ``late_at``): four threads append a
       quarter of the round's lineitem each, then commit together; a fifth
       appends and commits the round's orders. Each lineitem round lands as
       one wave (one table-log entry pair, the other committers riders),
       updating sql_li_ship and sql_li_pk (delta files bucket-true and
       sorted); each orders commit the two sketches (one row a file, the
       files' pyarrow min and max); every subscription delivers once per
       lineitem commit, within REL_TOL of the base reference plus numpy
       over the committed batches. After the last round each delivery
       equals an ad-hoc indexed run over a fresh listing bit for bit, and
       that run reads sql_li_ship through an exact IndexScan.
    3. One bulk round: a quarter of each table in one batch; the same checks,
       the prebuild's device and bucket-write seconds and the append's peak
       device memory.
    4. A child on the card appends a batch and dies by SIGKILL at
       ingest.publish; recover() rolls the table back (its key under
       rolled_back, staging swept), rows and an ad-hoc Q6 as before; one
       more append and commit succeeds and the subscriptions deliver.
    5. compact(): entries folded and versions vacuumed per log; ad-hoc Q6
       and two more standing fires bit for bit as before (the first after
       the vacuum emptied the buffer pool, the second with every member's
       read pooled; each timed); no buffer-pool entry names a vacuumed file;
       a second compact() folds nothing.
    """
    import signal

    import pyarrow.parquet as pq
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.actions import create
    from hyperspace_tpu_torch.execution import buffer_pool
    from hyperspace_tpu_torch.ops import index_build
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend
    from hyperspace_tpu_torch.streaming.ingest import get_queue, table_key, table_log_dir

    t_path = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    out = results["streaming"] = {"rounds": []}
    li_dir, od_dir = dirs["lineitem"], dirs["orders"]
    for k, v in STREAMING_CONF.items():
        session.conf.set(k, v)
    hs = ht.Hyperspace(session)
    orders = session.read.parquet(od_dir)
    hs.create_index(orders, ht.DataSkippingIndexConfig("st_od_skip",
                                                       [ht.MinMaxSketch("o_orderdate")]))
    hs.create_index(orders, ht.DataSkippingIndexConfig("st_od_bloom",
                                                       [ht.BloomFilterSketch("o_orderkey")]))
    schemas = table_schemas(dirs)
    texts = [q6_text(*p) for p in Q6_PARAMS]
    totals = [float(r["revenue"][0]) for r in q6_refs]
    session.enable_hyperspace()
    fe = ServingFrontend(session)
    subs = [fe.subscribe(session.sql(t), client=f"standing{i}") for i, t in enumerate(texts)]
    # A continuous source over an empty drop directory polls for the whole
    # path: every poll asks the admission controller whether to pause.
    drop_dir = os.path.join(root, "streaming_drop")
    os.makedirs(drop_dir)
    source = hs.tail_directory(drop_dir, od_dir, name="orders_drop")
    n_rf1 = max(int(round(RF1_ORDERS_PER_SF * rows["orders"] / 1_500_000)), 1)
    next_key = rows["orders"] + 1
    li_log = table_log_dir(session, li_dir)
    # An append holds its table's lock from the backpressure check to its
    # return; the appenders' own clocks also count the wait for it.
    held = HeldLock()
    get_queue()._table_locks[os.path.abspath(li_dir)] = held
    fires = 0
    appends, orders_appends, waves, freshness = [], [], [], []

    def commit_round(batches: list, od_batch, what: str) -> dict:
        """Append ``batches`` on their own threads and the orders batch on
        another, then commit lineitem from every appender at once: the
        commits' results, append and wave seconds, freshness."""
        nonlocal fires
        n = len(batches)
        for b in batches:
            for i, r in enumerate(q6_revenues(b)):
                totals[i] += r
        barrier = threading.Barrier(n + 1)
        res, errs, times = [None] * n, [], {}

        def appender(i):
            try:
                t0 = time.perf_counter()
                hs.append(li_dir, batches[i])
                torch.cuda.synchronize()
                times[f"append{i}"] = time.perf_counter() - t0
                barrier.wait(600)
                res[i] = hs.commit(li_dir)
                times[f"commit{i}"] = time.perf_counter()
            except BaseException as e:
                errs.append(e)
                barrier.abort()

        def orders_loader():
            try:
                t0 = time.perf_counter()
                hs.append(od_dir, od_batch)
                torch.cuda.synchronize()
                times["orders_append"] = time.perf_counter() - t0
                times["orders_commit"] = hs.commit(od_dir)
            except BaseException as e:
                errs.append(e)

        threads = [threading.Thread(target=appender, args=(i,)) for i in range(n)]
        threads.append(threading.Thread(target=orders_loader))
        entries0 = log_entries(li_log) if os.path.isdir(li_log) else 0
        for t in threads:
            t.start()
        try:
            barrier.wait(600)
        except threading.BrokenBarrierError:
            pass
        t_commit = time.perf_counter()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        wave_s = max(times[f"commit{i}"] for i in range(n)) - t_commit
        leaders = [r for r in res if not r.get("joined_wave") and r["committed_batches"]]
        riders = [r for r in res if r.get("joined_wave")]
        if len(leaders) != 1 or leaders[0]["committed_batches"] != n or \
                len(leaders) + len(riders) + sum(1 for r in res if not r["committed_batches"]) \
                != n or log_entries(li_log) - entries0 != 2:
            raise AssertionError(f"streaming {what}: the {n} commits did not publish as one "
                                 f"wave: {res}")
        check_commit(leaders[0], list(STREAMING_COVERING), what)
        check_commit(times["orders_commit"], list(STREAMING_SKETCHES), f"{what} orders")
        fires += 1
        tables = check_deliveries(subs, fires, totals, what)
        fresh = time.perf_counter() - t_commit
        check_deltas(hs, sum(b.num_rows for b in batches), what)
        check_minmax_sketch(hs, od_dir, "st_od_skip")
        return {"append_s": [times[f"append{i}"] for i in range(n)],
                "orders_append_s": times["orders_append"], "wave_s": wave_s,
                "freshness_s": fresh, "riders": len(riders),
                "leader_s": leaders[0]["seconds"], "tables": tables}

    # 2. The RF1 rounds.
    out["rounds_planned"] = STREAMING_ROUNDS
    for r in range(STREAMING_ROUNDS):
        if r >= STREAMING_MIN_ROUNDS and time.perf_counter() > late_at:
            log(f"streaming: the script's clock passed {STREAMING_LATE_S} s; rounds {r}-"
                f"{STREAMING_ROUNDS - 1} are left out so that it ends inside its limit")
            break
        od_batch, li_batch = rf1_tables(rows, schemas, next_key, n_rf1, 100 + r)
        next_key += n_rf1
        step = -(-li_batch.num_rows // STREAMING_APPENDERS)
        quarters = [li_batch.slice(i * step, step) for i in range(STREAMING_APPENDERS)]
        rd = commit_round(quarters, od_batch, f"round {r}")
        appends += rd["append_s"]
        orders_appends.append(rd["orders_append_s"])
        waves.append(rd["wave_s"])
        freshness.append(rd["freshness_s"])
        out["rounds"].append({k: v for k, v in rd.items() if k != "tables"}
                             | {"lineitem_rows": li_batch.num_rows, "orders_rows": n_rf1})
        log(f"streaming round {r}: {li_batch.num_rows} lineitem and {n_rf1} orders rows; "
            f"wave {rd['wave_s']:.3f} s, freshness {rd['freshness_s']:.3f} s, "
            f"{rd['riders']} riders")
    latest = rd["tables"]
    out["append_held_s"] = list(held.seconds)
    t0 = time.perf_counter()
    adhoc = adhoc_q6(session, li_dir, texts, check_plan=True)
    out["adhoc_s"] = time.perf_counter() - t0
    for i, (a, d) in enumerate(zip(adhoc, latest)):
        if not _same_bits(a, d):
            raise AssertionError(f"streaming: Q6 {Q6_PARAMS[i]} ad hoc {a.to_pydict()} != its "
                                 f"last delivery {d.to_pydict()}")

    # 3. The bulk round.
    n_bulk = max(rows["orders"] // 4, 1)
    od_batch, li_batch = rf1_tables(rows, schemas, next_key, n_bulk, 100 + STREAMING_ROUNDS)
    next_key += n_bulk
    for i, r in enumerate(q6_revenues(li_batch)):
        totals[i] += r
    spans = Spans([(index_build, "build_sorted_buckets", "prebuild on the device"),
                   (create, "write_bucket_files", "bucket files")])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bulk_base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with spans:
        hs.append(li_dir, li_batch)
    torch.cuda.synchronize()
    bulk_append_s = time.perf_counter() - t0
    bulk = {"lineitem_rows": li_batch.num_rows, "orders_rows": n_bulk,
            "append_s": bulk_append_s, "rows_per_s": li_batch.num_rows / bulk_append_s,
            "spans": dict(spans.spans),
            "peak_bytes": torch.cuda.max_memory_allocated() - bulk_base}
    t0 = time.perf_counter()
    hs.append(od_dir, od_batch)
    bulk["orders_append_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = hs.commit(li_dir)
    bulk["commit_s"] = time.perf_counter() - t0
    check_commit(res, list(STREAMING_COVERING), "bulk")
    check_commit(hs.commit(od_dir), list(STREAMING_SKETCHES), "bulk orders")
    fires += 1
    check_deliveries(subs, fires, totals, "bulk")
    bulk["freshness_s"] = time.perf_counter() - t0
    check_deltas(hs, li_batch.num_rows, "bulk")
    check_minmax_sketch(hs, od_dir, "st_od_skip")
    out["bulk"] = bulk
    log(f"streaming bulk: {li_batch.num_rows} lineitem rows appended in {bulk_append_s:.2f} s "
        f"({bulk['spans']}), committed in {bulk['commit_s']:.2f} s, peak "
        f"{bulk['peak_bytes']} bytes")
    del li_batch, od_batch

    # 4. Crash and recovery.
    _, crash_batch = rf1_tables(rows, schemas, next_key, n_rf1, 100 + STREAMING_ROUNDS + 1)
    batch_path = os.path.join(root, "streaming_crash_batch.parquet")
    pq.write_table(crash_batch, batch_path)
    rows_before = parquet_rows(li_dir)
    q6_before = adhoc_q6(session, li_dir, texts[:1], check_plan=False)[0]
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", CRASH_CHILD, os.path.dirname(os.path.abspath(__file__)),
         session.hs_conf.system_path(), li_dir, batch_path],
        capture_output=True, text=True, timeout=600)
    out["crash_child_s"] = time.perf_counter() - t0
    if child.returncode != -signal.SIGKILL or "CHILD-SURVIVED" in child.stdout:
        raise AssertionError(f"streaming: the child was not killed at ingest.publish "
                             f"(rc {child.returncode}):\n{child.stdout}\n{child.stderr[-4000:]}")
    t0 = time.perf_counter()
    summary = hs.recover()
    out["recover_s"] = time.perf_counter() - t0
    st = summary["streaming"]
    if summary["errors"] or table_key(li_dir) not in st["rolled_back"] or \
            st["staging_swept"] < 1:
        raise AssertionError(f"streaming: recover() did not roll the crash back: {summary}")
    out["recover"] = {k: summary[k] for k in ("cancelled", "vacuumed", "streaming")}
    if parquet_rows(li_dir) != rows_before or not _same_bits(
            adhoc_q6(session, li_dir, texts[:1], check_plan=False)[0], q6_before):
        raise AssertionError("streaming: the lake after recover() differs from before the crash")
    for i, r in enumerate(q6_revenues(crash_batch)):
        totals[i] += r
    hs.append(li_dir, crash_batch)
    check_commit(hs.commit(li_dir), list(STREAMING_COVERING), "after recovery")
    fires += 1
    before_compaction = check_deliveries(subs, fires, totals, "after recovery")
    log(f"streaming: child killed after {out['crash_child_s']:.1f} s; recover() in "
        f"{out['recover_s']:.2f} s: {st}")

    # 5. Compaction.
    adhoc_before = adhoc_q6(session, li_dir, texts[:1], check_plan=True)
    t0 = time.perf_counter()
    first = hs.compact()
    out["compaction_s"] = time.perf_counter() - t0
    if first["errors"]:
        raise AssertionError(f"streaming: compact() failed: {first['errors']}")
    out["compaction"] = {name: v for name, v in first["compacted"].items()}
    # compact() vacuums only the sketches' versions here, and deleting an
    # index version empties the whole pool, so this holds by construction
    # today: it guards the rule, not the mechanism.
    pool = buffer_pool.get_pool()
    with pool._lock:
        keys = repr(list(pool._device) + list(pool._host))
    gone = [f for f in re.findall(r"'(/[^']+\.parquet)'", keys) if not os.path.exists(f)]
    if gone:
        raise AssertionError(f"streaming: pool entries name deleted files: {gone[:5]}")
    for i, (a, b) in enumerate(zip(adhoc_q6(session, li_dir, texts[:1], check_plan=True),
                                   adhoc_before)):
        if not _same_bits(a, b):
            raise AssertionError(f"streaming: Q6 {Q6_PARAMS[i]} changed across compact()")
    # Two more fires with no commit between: the vacuum emptied the buffer
    # pool, so the first reads every index file again for each member; the
    # second finds each member's read pooled.
    for label in ("fire_cold_s", "fire_warm_s"):
        t0 = time.perf_counter()
        fe.notify_commit(session, li_dir)
        fires += 1
        tables = check_deliveries(subs, fires, totals, f"after compaction ({label})")
        out[label] = time.perf_counter() - t0
        for i, (a, b) in enumerate(zip(tables, before_compaction)):
            if not _same_bits(a, b):
                raise AssertionError(f"streaming: standing Q6 {i} changed across compact()")
    second = hs.compact()
    if second["compacted"]:
        raise AssertionError(f"streaming: a second compact() folded {second['compacted']}")
    log(f"streaming: compact() in {out['compaction_s']:.2f} s: {out['compaction']}")
    for sub in subs:
        sub.unsubscribe()
    src = source.stop()
    out["source"] = {"polls": src["polls"], "pauses": src["pauses"]}
    if src["pauses"] or not src["polls"] or src["errors"]:
        raise AssertionError(f"streaming: the continuous source paused or failed: {src}")
    session.disable_hyperspace()
    fe.drain()
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base_bytes
    out["stats"] = hs.streaming_stats()
    out["subscriptions"] = fe.stats()["subscriptions"]
    out["append_s"] = appends
    out["orders_append_s"] = orders_appends
    out["wave_s"] = waves
    out["freshness_s"] = freshness
    out["fires"] = fires
    out["seconds"] = time.perf_counter() - t_path


def streaming_summary(st: dict, launches: dict, card: str) -> dict:
    """The streaming line: RF1 append (on the appender's clock, the wait
    for the table's append lock included, and from taking the lock to
    letting it go), commit-wave and freshness (commit() called to the 16th
    delivery read) seconds at p50 and p99; the bulk
    round's append (with the prebuild's device seconds and the bucket-file
    writes apart), rows a second, commit and peak device bytes; recover
    and compaction seconds, entries folded and versions vacuumed per log;
    a standing fire's seconds with the buffer pool emptied and warm; the
    continuous source's polls and overload pauses; the path's peak device
    bytes, launches and seconds; the card."""
    def pct(values):
        return {"p50": _percentile(values, 50), "p99": _percentile(values, 99)}
    bulk = st["bulk"]
    return {
        "rounds": len(st["rounds"]), "rounds_planned": st["rounds_planned"],
        "rf1_rows": {"lineitem": st["rounds"][0]["lineitem_rows"],
                     "orders": st["rounds"][0]["orders_rows"]},
        "append_with_lock_wait_s": pct(st["append_s"]),
        "append_held_s": pct(st["append_held_s"]),
        "orders_append_s": pct(st["orders_append_s"]),
        "commit_wave_s": pct(st["wave_s"]), "freshness_s": pct(st["freshness_s"]),
        "bulk": {"lineitem_rows": bulk["lineitem_rows"], "append_s": bulk["append_s"],
                 "rows_per_s": bulk["rows_per_s"],
                 "prebuild_device_s": bulk["spans"].get("prebuild on the device", 0.0),
                 "bucket_write_s": bulk["spans"].get("bucket files", 0.0),
                 "commit_s": bulk["commit_s"], "freshness_s": bulk["freshness_s"],
                 "peak_bytes": bulk["peak_bytes"]},
        "recover_s": st["recover_s"], "crash_child_s": st["crash_child_s"],
        "fire_cold_s": st["fire_cold_s"], "fire_warm_s": st["fire_warm_s"],
        "compaction": {"seconds": st["compaction_s"],
                       "entries_folded": {k: v["entries_folded"]
                                          for k, v in st["compaction"].items()},
                       "versions_vacuumed": {k: v["versions_vacuumed"]
                                             for k, v in st["compaction"].items()}},
        "adhoc_s": st["adhoc_s"], "source": st["source"], "peak_bytes": st["peak_bytes"],
        "launches": launches,
        "seconds": st["seconds"], "card": card}


# ---------------------------------------------------------------------------
# The cluster path: two worker processes and the parent over the sql lake.
# ---------------------------------------------------------------------------

CLUSTER_WORKERS = ("w-a", "w-b")
# The roster's timing: a killed worker drops out of the ring after
# CLUSTER_STALENESS_MS without a heartbeat.
CLUSTER_HEARTBEAT_MS = 250
CLUSTER_STALENESS_MS = 3000
# A worker: the parent's conf with its own identity, on the parent's
# device (the card), the sql lake's views, hyperspace on and one standing Q6. It writes each
# delivery of the standing query, and answers the parent's command files
# (a gather, then exit). Its kernel launches are the "kernels" collector
# of its metrics registry, which its ``metrics`` reply carries.
CLUSTER_WORKER = r'''
import json, os, sys, time
repo, run, wid = sys.argv[1:4]
sys.path.insert(0, repo)
import numpy as np
import pyarrow as pa
import hyperspace_tpu_torch as ht
from hyperspace_tpu_torch.cluster import gather
from hyperspace_tpu_torch.cluster import worker as cw
from hyperspace_tpu_torch.ops import cuda_kernels as ck
from hyperspace_tpu_torch.serving.frontend import get_frontend
from hyperspace_tpu_torch.telemetry import metrics

cfg = json.load(open(os.path.join(run, "cluster.json")))
ck.reset_launches()
metrics.get_registry().register_collector("kernels", lambda: dict(ck.LAUNCHES))
conf = dict(cfg["conf"], **cfg["worker_conf"])
conf["hyperspace.tpu.cluster.worker.id"] = wid
s = ht.Session(system_path=cfg["system_path"], conf=conf, device=cfg["device"])
for name, d in cfg["views"].items():
    s.create_temp_view(name, s.read.parquet(d))
s.enable_hyperspace()
node = cw.get_node(s)
fe = get_frontend(s)
sub = fe.subscribe(s.sql(cfg["standing"]), client=wid)
with open(os.path.join(run, wid + ".ready"), "w") as f:
    f.write(json.dumps({"pid": os.getpid(), "worker": node.worker_id}))
seen = 0
while True:
    for d in sub.deliveries():
        if d.seq > seen:
            seen = d.seq
            t = d.result.to_arrow() if d.ok else None
            sink = pa.BufferOutputStream()
            if t is not None:
                with pa.ipc.new_stream(sink, t.schema) as w:
                    w.write_table(t)
            tmp = os.path.join(run, f"{wid}.fire{d.seq}.tmp")
            with open(tmp, "wb") as f:
                f.write(sink.getvalue().to_pybytes() if t is not None else b"")
            os.replace(tmp, os.path.join(run, f"{wid}.fire{d.seq}"))
    cmd = os.path.join(run, wid + ".gather")
    if os.path.exists(cmd):
        spec = json.load(open(cmd))
        os.remove(cmd)
        gather.init_process(spec["rank"], spec["n"], spec["coordinator"])
        mine = np.array([spec["rows"], node.stats()["forward_served"]], dtype=np.int64)
        stacked = gather.allgather(mine)
        with open(os.path.join(run, wid + ".gathered"), "w") as f:
            f.write(json.dumps(stacked.tolist()))
    if os.path.exists(os.path.join(run, wid + ".exit")):
        cw.shutdown_for_tests()
        sys.exit(0)
    time.sleep(0.05)
'''


def _wait_for(path: str, procs: dict, timeout: float, what: str) -> None:
    deadline = time.time() + timeout
    while not os.path.exists(path):
        for wid, p in procs.items():
            if p.poll() is not None:
                raise AssertionError(f"cluster: worker {wid} exited (rc {p.returncode}) "
                                     f"while waiting for {what}")
        if time.time() > deadline:
            raise AssertionError(f"cluster: no {what} after {timeout} s")
        time.sleep(0.05)


def _ipc_bytes(table) -> bytes:
    import pyarrow as pa
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def run_cluster_path(root: str, session, dirs: dict, rows: dict, results: dict) -> None:
    """The serving cluster on the streaming path's lake: two worker processes
    on the card (CLUSTER_WORKERS, each a Session(device="cuda") over the sql
    system path with ``cluster.enabled``) and the parent as the third
    member, hyperspace on everywhere.

    1. The 16 Q6 texts submitted at the parent with routing on, twice (each
       on a thread of its own, so the two owners execute at once): each
       answer equal, bit for bit, to the same text run at the parent with
       routing off; the forwards and the owners' cache hits equal what a
       locally built HashRing assigns (the second pass answered from the
       owners' result caches).
    2. The same texts under an armed ``cluster.forward``: every one runs at
       the parent, to the same bytes, one fallback each forward.
    3. A host allgather of (lineitem rows, forwards served) over the three
       processes: every rank the same rank-ordered stack.
    4. ``fleet_metrics()``: the three members; each worker's own kernel
       launches (its ``kernels`` collector), range_mask among them.
    5. One RF1 quarter appended and committed at the parent: both workers'
       standing Q6 deliver, each equal bit for bit to the parent's ad-hoc Q6
       after the commit. Then a second small commit under
       ``cluster.broadcast=error:nth=1``: the commit lands, one peer misses
       its fire (w-a, first in roster order), the other delivers.
    6. w-b killed with SIGKILL: after the staleness window the ring drops
       it, and the texts it owned run where the new ring puts them, equal
       to the parent's own runs.
    """
    import contextvars
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants
    from hyperspace_tpu_torch.cluster import gather
    from hyperspace_tpu_torch.cluster import worker as cworker
    from hyperspace_tpu_torch.cluster.constants import VNODES
    from hyperspace_tpu_torch.cluster.constants import ClusterConstants as CC
    from hyperspace_tpu_torch.cluster.hashring import HashRing
    from hyperspace_tpu_torch.parallel import io as pio
    from hyperspace_tpu_torch.robustness import faults
    from hyperspace_tpu_torch.robustness.faults import FaultRegistry
    from hyperspace_tpu_torch.serving.constants import ServingConstants as SC
    from hyperspace_tpu_torch.serving.fingerprint import compute_key
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend

    t_path = time.perf_counter()
    out = results["cluster"] = {}
    li_dir = dirs["lineitem"]
    texts = [q6_text(*p) for p in Q6_PARAMS]
    run = os.path.join(root, "cluster_run")
    os.makedirs(run)
    hs = ht.Hyperspace(session)
    # Another process's commits must show at once, in every member (the
    # key is part of the fingerprint, so every member sets it alike).
    session.conf.set(IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS, "0")
    session.enable_hyperspace()
    session.create_temp_view("lineitem", session.read.parquet(li_dir), replace=True)
    cluster_conf = {CC.HEARTBEAT_MS: str(CLUSTER_HEARTBEAT_MS),
                    CC.STALENESS_MS: str(CLUSTER_STALENESS_MS),
                    CC.FORWARD_TIMEOUT_MS: "600000", CC.ENABLED: "true"}
    with open(os.path.join(run, "cluster.json"), "w") as f:
        json.dump({"conf": session.conf.as_dict(), "system_path": session.hs_conf.system_path(),
                   "device": session.device.type,
                   "views": {"lineitem": li_dir}, "standing": texts[0],
                   "worker_conf": dict(cluster_conf, **{
                       SC.SERVING_ENABLED: "true", SC.RESULT_CACHE_ENABLED: "true",
                       SC.RESULT_CACHE_MIN_COMPUTE_SECONDS: "0"})}, f)
    with open(os.path.join(run, "worker.py"), "w") as f:
        f.write(CLUSTER_WORKER)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, logs = {}, {}
    node = None
    try:
        t0 = time.perf_counter()
        for wid in CLUSTER_WORKERS:
            logs[wid] = open(os.path.join(run, wid + ".log"), "w")
            procs[wid] = subprocess.Popen(
                [sys.executable, os.path.join(run, "worker.py"), repo, run, wid],
                env=env, stdout=logs[wid], stderr=subprocess.STDOUT)
        # The parent's own answers (no routing outside the frontend), while
        # the workers start.
        t1 = time.perf_counter()
        local = [session.sql(t).to_arrow() for t in texts]
        out["local_s"] = time.perf_counter() - t1
        # The parent serves forwards too (a worker's standing fire may route
        # to it).
        for k, v in dict(cluster_conf, **{CC.WORKER_ID: "w-parent",
                                          SC.SERVING_ENABLED: "true"}).items():
            session.conf.set(k, v)
        node = cworker.get_node(session)
        for wid in CLUSTER_WORKERS:
            _wait_for(os.path.join(run, wid + ".ready"), procs, 600, f"{wid} ready")
        deadline = time.time() + 60
        while len(node.membership.live_members()) < 3:
            if time.time() > deadline:
                raise AssertionError(f"cluster: roster {node.membership.live_members()}")
            time.sleep(0.05)
        out["startup_s"] = time.perf_counter() - t0
        ids = [m.worker_id for m in node.membership.live_members()]
        ring = HashRing(ids, vnodes=VNODES)
        owners = [ring.owner(compute_key(session, session.sql(t).plan).digest())
                  for t in texts]
        remote = sum(1 for o in owners if o != "w-parent")
        out["owners"] = {w: owners.count(w) for w in ids}
        fe = ServingFrontend(session)

        def routed_pass(name, scope=None):
            # Every text submitted on a thread of its own (a forward blocks
            # its submitter until the owner answers), each in a copy of this
            # context, so an armed scope reaches every forward.
            t1 = time.perf_counter()
            with faults.scope(scope), ThreadPoolExecutor(len(texts)) as ex:
                futures = [ex.submit(contextvars.copy_context().run, fe.submit,
                                     session.sql(t), client=f"user{i}")
                           for i, t in enumerate(texts)]
                pending = [f.result() for f in futures]
            tables = [p.result(timeout=600).to_arrow() for p in pending]
            torch.cuda.synchronize()
            for i, (got, want) in enumerate(zip(tables, local)):
                if not _same_bits(got, want):
                    raise AssertionError(f"cluster {name}: Q6 {Q6_PARAMS[i]} (owner "
                                         f"{owners[i]}) {got.to_pydict()} != "
                                         f"{want.to_pydict()}")
            st = node.stats()
            log(f"cluster {name}: {time.perf_counter() - t1:.3f} s; {st}")
            return dict(st, seconds=time.perf_counter() - t1)

        # 1-2. Routed passes, then the armed forward.
        first = routed_pass("first pass")
        second = routed_pass("second pass")
        armed = routed_pass("armed forward", FaultRegistry.from_conf_specs(
            {"cluster.forward": "error"}))
        want = {"first": (remote, 0, 0), "second": (2 * remote, remote, 0),
                "armed": (2 * remote, remote, remote)}
        got = {k: (v["forwarded"], v["forward_hits"], v["forward_fallbacks"])
               for k, v in (("first", first), ("second", second), ("armed", armed))}
        if got != want:
            raise AssertionError(f"cluster: forwards {got}, the ring says {want}")
        out["passes"] = {"first": first, "second": second, "armed": armed}

        # 3. The host allgather over the three processes.
        t1 = time.perf_counter()
        li_rows = parquet_rows(li_dir)
        coordinator = f"chip-smoke-cluster-{os.getpid()}-{time.time()}"
        for rank, wid in enumerate(CLUSTER_WORKERS, start=1):
            with open(os.path.join(run, wid + ".gather.tmp"), "w") as f:
                json.dump({"rank": rank, "n": 3, "coordinator": coordinator, "rows": li_rows}, f)
            os.replace(os.path.join(run, wid + ".gather.tmp"), os.path.join(run, wid + ".gather"))
        gather.init_process(0, 3, coordinator)
        with pio.use_session(session):
            stacked = gather.allgather(np.array([li_rows, node.stats()["forward_served"]],
                                                dtype=np.int64))
        stacks = [stacked.tolist()]
        for wid in CLUSTER_WORKERS:
            _wait_for(os.path.join(run, wid + ".gathered"), procs, 120, f"{wid} gather")
            with open(os.path.join(run, wid + ".gathered")) as f:
                stacks.append(json.load(f))
        served = [0] + [out["owners"].get(w, 0) * 2 for w in CLUSTER_WORKERS]
        if any(s != stacks[0] for s in stacks) or \
                [r[0] for r in stacks[0]] != [li_rows] * 3 or \
                [r[1] for r in stacks[0]] != served:
            raise AssertionError(f"cluster: gathers {stacks}, served {served}")
        out["gather"] = {"stack": stacks[0], "seconds": time.perf_counter() - t1}

        # 4. Fleet metrics and the workers' own launches.
        fleet = hs.fleet_metrics()
        out["fleet_workers"] = sorted(fleet["workers"])
        if out["fleet_workers"] != sorted(ids):
            raise AssertionError(f"cluster: fleet {out['fleet_workers']} != roster {ids}")
        out["worker_launches"] = {w: fleet["workers"][w]["collectors"]["kernels"]
                                  for w in CLUSTER_WORKERS}
        for w in CLUSTER_WORKERS:
            cl = fleet["workers"][w]["collectors"]["cluster"]
            if cl["forward_served"] != 2 * out["owners"].get(w, 0) or \
                    cl["forward_cache_hits"] != out["owners"].get(w, 0):
                raise AssertionError(f"cluster: {w} served {cl}, owns "
                                     f"{out['owners'].get(w, 0)}")
            if out["worker_launches"][w]["range_mask"] <= 0:
                raise AssertionError(f"cluster: {w} launched no range_mask: "
                                     f"{out['worker_launches'][w]}")

        # 5. A commit at the parent fires both workers' standing Q6.
        schemas = table_schemas(dirs)
        n_rf1 = max(int(round(RF1_ORDERS_PER_SF * rows["orders"] / 1_500_000)), 1)
        _, li_batch = rf1_tables(rows, schemas, 3 * rows["orders"] + 1, n_rf1, 300)
        quarter = li_batch.slice(0, -(-li_batch.num_rows // STREAMING_APPENDERS))
        t1 = time.perf_counter()
        hs.append(li_dir, quarter)
        res = hs.commit(li_dir)
        check_commit(res, list(STREAMING_COVERING), "cluster commit")
        for wid in CLUSTER_WORKERS:
            _wait_for(os.path.join(run, f"{wid}.fire1"), procs, 600, f"{wid} fire 1")
        out["commit_s"] = time.perf_counter() - t1
        adhoc = _ipc_bytes(adhoc_q6(session, li_dir, texts[:1], check_plan=False)[0])
        for wid in CLUSTER_WORKERS:
            if file_bytes(os.path.join(run, f"{wid}.fire1")) != adhoc:
                raise AssertionError(f"cluster: {wid}'s delivery differs from the parent's "
                                     f"ad-hoc Q6 after the commit")
        sent = node.stats()["broadcasts_sent"]
        reg = FaultRegistry.from_conf_specs({"cluster.broadcast": "error:nth=1"})
        hs.append(li_dir, quarter.slice(0, 1000))
        with faults.scope(reg):
            res = hs.commit(li_dir)
        if res["committed_batches"] != 1:
            raise AssertionError(f"cluster: the commit under a broadcast fault: {res}")
        _wait_for(os.path.join(run, "w-b.fire2"), procs, 600, "w-b fire 2")
        time.sleep(1.0)
        st = node.stats()
        if os.path.exists(os.path.join(run, "w-a.fire2")) or \
                st["broadcasts_sent"] - sent != 1 or st["broadcast_failures"] != 1:
            raise AssertionError(f"cluster: the broadcast fault reached the wrong peers: {st}")
        out["broadcast"] = {"sent": st["broadcasts_sent"], "failures": st["broadcast_failures"],
                            "received_by": sorted(w for w in CLUSTER_WORKERS if os.path.exists(
                                os.path.join(run, f"{w}.fire2")))}

        # 6. A worker killed: the ring drops it after the staleness window.
        t1 = time.perf_counter()
        os.kill(procs["w-b"].pid, signal.SIGKILL)
        procs["w-b"].wait(timeout=60)
        dead = procs.pop("w-b")
        del dead
        deadline = time.time() + 60
        while "w-b" in [m.worker_id for m in node.membership.live_members()]:
            if time.time() > deadline:
                raise AssertionError("cluster: w-b never left the roster")
            time.sleep(0.05)
        out["dropped_after_s"] = time.perf_counter() - t1
        orphaned = [t for t, o in zip(texts, owners) if o == "w-b"]
        session.create_temp_view("lineitem", session.read.parquet(li_dir), replace=True)
        before = node.stats()
        routed = [fe.submit(session.sql(t)).result(timeout=600).to_arrow() for t in orphaned]
        session.conf.set(CC.ROUTING_ENABLED, "false")
        mine = [session.sql(t).to_arrow() for t in orphaned]
        session.conf.unset(CC.ROUTING_ENABLED)
        after = node.stats()
        for i, (a, b) in enumerate(zip(routed, mine)):
            if not _same_bits(a, b):
                raise AssertionError(f"cluster: w-b's text {i} after the kill differs")
        if after["forward_fallbacks"] != before["forward_fallbacks"]:
            raise AssertionError(f"cluster: a forward went to the dead worker: {after}")
        out["after_kill"] = {"orphaned": len(orphaned), "members": after["members"],
                             "forwarded": after["forwarded"] - before["forwarded"]}
        fe.drain()
    finally:
        for wid, p in procs.items():
            with open(os.path.join(run, wid + ".exit"), "w"):
                pass
        for wid, p in procs.items():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=60)
        for f in logs.values():
            f.close()
        if node is not None:
            cworker.shutdown_for_tests()
        gather.reset_for_tests()
        for k in list(cluster_conf) + [CC.WORKER_ID, SC.SERVING_ENABLED]:
            session.conf.unset(k)
        session.conf.unset(IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS)
        session.disable_hyperspace()
    out["robustness"] = {k: v for k, v in faults.stats().items() if k.startswith("cluster")}
    out["seconds"] = time.perf_counter() - t_path


def cluster_summary(cl: dict, launches: dict, card: str) -> dict:
    """The cluster line: the members' start-up, the ring's owners, each
    routed pass's forwards, owners' cache hits, fallbacks and seconds, the
    gather's stack, the workers' own launches, the commit's fan-out and the
    broadcast fault, the seconds until a killed worker left the ring, the
    parent's launches, the path's seconds and the card."""
    passes = {k: {f: v[f] for f in ("forwarded", "forward_hits", "forward_fallbacks",
                                    "seconds")} for k, v in cl["passes"].items()}
    return {"startup_s": cl["startup_s"], "local_s": cl["local_s"], "owners": cl["owners"],
            "passes": passes,
            "gather": cl["gather"], "fleet_workers": cl["fleet_workers"],
            "worker_launches": cl["worker_launches"], "commit_s": cl["commit_s"],
            "broadcast": cl["broadcast"], "dropped_after_s": cl["dropped_after_s"],
            "after_kill": cl["after_kill"], "launches": launches, "seconds": cl["seconds"],
            "card": card}


# ---------------------------------------------------------------------------
# The mutations path: appends, deletes, refreshes, optimize, the chunked
# build and Hybrid Scan at the default device budget.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The mesh path: the SPMD dispatch on the card's one-device mesh.
# ---------------------------------------------------------------------------

# TPC-H SF1: the largest lineitem the dispatch's own budget (maxChunkRows,
# 8,388,608 rows) takes whole; above it the reference falls back too.
MESH_SCALE = 1.0
MESH_RUNS = 3
MESH_Q6 = (datetime.date(1994, 1, 1), datetime.date(1994, 12, 31))
MESH_TOP = 100


class MeshEventLog:
    """The mesh path's event sink, loaded by dotted name
    (``chip_smoke.MeshEventLog``): that import is another module object
    than the running script, so read it through :func:`mesh_events`."""

    events = []

    def log_event(self, event):
        MeshEventLog.events.append(event)


def mesh_events() -> list:
    import importlib
    return importlib.import_module("chip_smoke").MeshEventLog.events


def mesh_queries(session, li_dir: str, od_dir: str, pt_dir: str) -> dict:
    """The mesh path's six queries: name -> (DataFrame, the ShardedExecution
    mode its dispatch must take)."""
    from hyperspace_tpu_torch.plan.expr import col, count, sum_

    li = session.read.parquet(li_dir)
    od = session.read.parquet(od_dir)
    ship = col("l_shipdate")
    q6 = li.filter(((ship >= MESH_Q6[0]) & (ship <= MESH_Q6[1]))
                   & ((col("l_discount") >= 0.05) & (col("l_discount") <= 0.07))
                   & (col("l_quantity") < 24)) \
        .agg(sum_(col("l_extendedprice") * col("l_discount")).alias("revenue"))
    cutoff = li.filter(ship > CUTOFF) \
        .select("l_orderkey", "l_extendedprice", "l_shipdate") \
        .sort(("l_extendedprice", False), "l_orderkey").limit(MESH_TOP)
    left = od.join(li, on=col("o_orderkey") == col("l_orderkey"), how="left") \
        .agg(count(None).alias("rows"), count(col("l_orderkey")).alias("matched"),
             sum_(col("l_quantity")).alias("qty"))
    anti = od.join(li, on=col("o_orderkey") == col("l_orderkey"), how="anti") \
        .select("o_orderkey", "o_orderdate")
    # On one card the cutoff's Sort runs over the gathered rows (the sample
    # sort needs several devices; run_mesh_path forces it once).
    return {"q6": (q6, "global-agg"), "cutoff_sort": (cutoff, "stream"),
            "q3": (build_q3(session, li_dir, od_dir), "grouped-agg"),
            "q17": (build_q17(session, li_dir, pt_dir), "global-agg"),
            "left_outer": (left, "global-agg"), "anti": (anti, "stream")}


def mesh_references(li_dir: str, od_dir: str, pt_dir: str) -> dict:
    """Each mesh query by pyarrow alone."""
    import pyarrow.compute as pc
    import pyarrow.dataset as ds

    li = ds.dataset(li_dir, format="parquet").to_table(
        columns=["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_shipdate"])
    od = ds.dataset(od_dir, format="parquet").to_table(columns=["o_orderkey", "o_orderdate"])
    ship = li["l_shipdate"]
    keep = pc.and_(pc.and_(pc.greater_equal(ship, MESH_Q6[0]), pc.less_equal(ship, MESH_Q6[1])),
                   pc.and_(pc.and_(pc.greater_equal(li["l_discount"], 0.05),
                                   pc.less_equal(li["l_discount"], 0.07)),
                           pc.less(li["l_quantity"], 24)))
    q6 = li.filter(keep)
    after = li.filter(pc.greater(ship, CUTOFF)).select(
        ["l_orderkey", "l_extendedprice", "l_shipdate"])
    top = after.sort_by([("l_extendedprice", "descending"), ("l_orderkey", "ascending")]) \
        .slice(0, MESH_TOP)
    matched = od.join(li.select(["l_orderkey", "l_quantity"]), keys="o_orderkey",
                      right_keys="l_orderkey", join_type="inner")
    has_items = pc.is_in(od["o_orderkey"], value_set=pc.unique(li["l_orderkey"]))
    alone = od.filter(pc.invert(has_items))
    return {
        "q6": pc.sum(pc.multiply(q6["l_extendedprice"], q6["l_discount"])).as_py(),
        "cutoff_sort": top.to_pydict(),
        "q3": q3_reference(li_dir, od_dir),
        "q17": q17_reference(li_dir, pt_dir),
        "left_outer": {"rows": matched.num_rows + alone.num_rows,
                       "matched": matched.num_rows,
                       "qty": pc.sum(matched["l_quantity"]).as_py()},
        "anti": alone.to_pydict(),
    }


def check_mesh_answer(name: str, got, ref, what: str) -> None:
    """A mesh query against its pyarrow reference: keys and counts exact,
    float64 within REL_TOL."""
    if name == "q3":
        check_q3(got, ref[0], ref[1], what)
        return
    if name == "q17":
        check_q17(got, ref, what)
        return
    d = got.to_pydict()
    if name == "q6":
        if len(d["revenue"]) != 1 or not close(d["revenue"][0], ref):
            raise AssertionError(f"mesh {what}: q6 revenue {d['revenue']} against {ref}")
        return
    if name == "left_outer":
        if {k: v[0] for k, v in d.items()} != ref:
            raise AssertionError(f"mesh {what}: left outer {d} against {ref}")
        return
    if name == "cutoff_sort":
        if d["l_orderkey"] != ref["l_orderkey"] or len(d["l_extendedprice"]) != MESH_TOP \
                or any(not close(a, b) for a, b in zip(d["l_extendedprice"],
                                                       ref["l_extendedprice"])) \
                or any(x <= CUTOFF for x in d["l_shipdate"]):
            raise AssertionError(f"mesh {what}: the cutoff's top {MESH_TOP} differ")
        return
    if d != ref:
        raise AssertionError(f"mesh {what}: {name} differs from its reference "
                             f"({got.num_rows} rows against {len(ref['o_orderkey'])})")


def same_but_floats(a, b) -> bool:
    """Keys, counts and order equal; float64 values within REL_TOL."""
    if a.column_names != b.column_names or a.num_rows != b.num_rows:
        return False
    for c in a.column_names:
        if str(a.column(c).type) == "double":
            if any(not close(x, y) for x, y in zip(a.column(c).to_pylist(),
                                                   b.column(c).to_pylist())):
                return False
        elif not a.column(c).equals(b.column(c)):
            return False
    return True


def mesh_card_against_cpu(root: str) -> dict:
    """The mesh path's queries at PARITY_SCALE on the card (singleDevice
    auto) and through the port on the CPU with singleDevice=on: both take
    the SPMD dispatch, and every answer must be equal bit for bit."""
    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants
    from hyperspace_tpu_torch.execution import fusion, spmd

    li_dir, od_dir, pt_dir, n_li, _ = make_tpch(os.path.join(root, "mesh_parity"),
                                                PARITY_SCALE)
    tables, routes = {}, {}
    for i, device in enumerate(("cuda", "cpu")):
        session = ht.Session(system_path=os.path.join(root, f"mesh_parity_ix{i}"),
                             device=device)
        if device == "cpu":
            session.conf.set(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE, "on")
        for name, (df, _mode) in mesh_queries(session, li_dir, od_dir, pt_dir).items():
            before = spmd.DISPATCH_COUNT
            tables[(device, name)] = df.to_arrow()
            if spmd.DISPATCH_COUNT == before:
                raise AssertionError(f"mesh parity: {name} on the {device} did not dispatch")
            if device == "cpu":
                # The route the card's singleDevice=off run must take.
                session.conf.set(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE, "off")
                f0, fb0 = fusion.DISPATCH_COUNT, fusion.stats()["fallbacks"]
                df.to_arrow()
                routes[name] = fusion_route(fb0, f0)
                session.conf.set(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE, "on")
    out, unequal = {}, []
    for (device, name) in list(tables):
        if device != "cuda":
            continue
        card, cpu = tables[("cuda", name)], tables[("cpu", name)]
        out[name] = card.equals(cpu) and float_bits(card) == float_bits(cpu)
        if not out[name]:
            unequal.append(name)
    log(f"mesh: card against the CPU at scale {PARITY_SCALE} ({n_li} lineitem rows): "
        f"{'all equal bit for bit' if not unequal else unequal}")
    if unequal:
        raise AssertionError(f"mesh: the card and the CPU differ on {unequal}")
    return out, routes


def same_bits(a, b) -> bool:
    """Equal tables, float64 columns bit for bit."""
    return a.schema == b.schema and a.equals(b) and float_bits(a) == float_bits(b)


def fusion_route(before: dict, fused0: int) -> dict:
    """A run's route through execution/fusion.py: the regions it fused and
    the boundary kinds it noted since ``before`` (the fallbacks counts) and
    ``fused0`` (DISPATCH_COUNT)."""
    from hyperspace_tpu_torch.execution import fusion
    after = fusion.stats()["fallbacks"]
    return {"fused": fusion.DISPATCH_COUNT - fused0,
            "boundaries": sorted(k for k in after if after[k] != before.get(k, 0))}


def fused_program_errors() -> int:
    """Fused regions in this process that failed and, degrade being on,
    ran staged. A failure outside an armed fault hides a fault of the
    port's fused body behind the staged answer."""
    from hyperspace_tpu_torch.execution import fusion
    return fusion.stats()["fallbacks"].get("fused-program-error", 0)


def mesh_empty_aggregate(root: str, device: str) -> dict:
    """A global SUM and MIN of a nullable float64 column under a filter that
    keeps no row, fused (the default) and staged (fusion.enabled=false) at
    singleDevice=off: {route: answer as a dict}."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants
    from hyperspace_tpu_torch.plan.expr import col, min_, sum_

    d = os.path.join(root, "mesh_empty")
    if not os.path.isdir(d):
        os.makedirs(d)
        rng = np.random.default_rng(18)
        n = 10_000
        pq.write_table(pa.table({"k": rng.integers(0, 1000, n).astype("int64"),
                                 "v": pa.array(rng.uniform(-1, 1, n), mask=rng.random(n) < 0.1)}),
                       os.path.join(d, "part0.parquet"))
    session = ht.Session(system_path=os.path.join(root, f"mesh_empty_ix_{device}"),
                         device=device)
    session.conf.set(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE, "off")
    out = {}
    for route, on in (("fused", "true"), ("staged", "false")):
        session.conf.set(IndexConstants.TPU_FUSION_ENABLED, on)
        out[route] = session.read.parquet(d).filter(col("k") > 5000).agg(
            sum_(col("v")).alias("s"), min_(col("v")).alias("m")).to_arrow().to_pydict()
    return out


def run_mesh_path(root: str, results: dict) -> None:
    """The SPMD dispatch on the card: TPC-H SF1 under the default conf
    (singleDevice auto), six queries each dispatched with the right mode;
    at singleDevice=off the fused route where the region planner takes the
    plan (the regions and boundary kinds the CPU run at PARITY_SCALE
    shows), and with fusion off the staged route; the three routes equal
    bit for bit and equal to a pyarrow reference, their warm seconds each;
    an empty-filter global aggregate of a nullable column, NULL fused and
    the staged values staged, on the card as on the CPU; the
    sample sort forced on the one card, giving the cutoff's rows; an
    armed spmd.dispatch fault degrading with its event and raising with
    degrade off; the mesh build on a mesh of the one card against the
    single-device build; and the card against the CPU at PARITY_SCALE."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConstants
    from hyperspace_tpu_torch.execution import fusion, spmd
    from hyperspace_tpu_torch.execution.columnar import Table, read_parquet
    from hyperspace_tpu_torch.ops import cuda_kernels as ck
    from hyperspace_tpu_torch.ops import index_build
    from hyperspace_tpu_torch.parallel import distributed_build
    from hyperspace_tpu_torch.parallel.mesh import Mesh
    from hyperspace_tpu_torch.plananalysis.explain import explain_string
    from hyperspace_tpu_torch.robustness import faults
    from hyperspace_tpu_torch.robustness.constants import RobustnessConstants

    t_path = time.perf_counter()
    out = {"scale": MESH_SCALE, "queries": {}}
    t0 = time.perf_counter()
    li_dir, od_dir, pt_dir, n_li, n_od = make_tpch(os.path.join(root, "mesh_data"), MESH_SCALE)
    out["rows"] = {"lineitem": n_li, "orders": n_od}
    out["datagen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = mesh_references(li_dir, od_dir, pt_dir)
    out["reference_s"] = time.perf_counter() - t0
    session = ht.Session(system_path=os.path.join(root, "mesh_indexes"), device="cuda")
    session.conf.set(IndexConstants.EVENT_LOGGER_CLASS, "chip_smoke.MeshEventLog")
    if session.hs_conf.distributed_single_device() != "auto" \
            or not spmd._spmd_eligible(session):
        raise AssertionError("mesh: the default conf does not take the dispatch on the card")
    degraded0 = faults.stats()["degraded_spmd"]
    fused_errors0 = fused_program_errors()
    queries = mesh_queries(session, li_dir, od_dir, pt_dir)
    answers = {}

    def timed(df):
        torch.cuda.synchronize()
        t = time.perf_counter()
        table = df.to_arrow()
        torch.cuda.synchronize()
        return table, time.perf_counter() - t

    for name, (df, mode) in queries.items():
        q = {}
        events = mesh_events()
        events.clear()
        d0, s0 = spmd.DISPATCH_COUNT, spmd.SORT_DISPATCH_COUNT
        on, q["cold_on_s"] = timed(df)
        counter = spmd.SORT_DISPATCH_COUNT - s0 if mode == "sort" else spmd.DISPATCH_COUNT - d0
        modes = [e.mode for e in events if type(e).__name__ == "ShardedExecutionEvent"]
        faulted = [e.reason for e in events if type(e).__name__ == "DistributedFallbackEvent"
                   and e.reason.startswith("fault:")]
        if counter < 1 or mode not in modes or faulted:
            raise AssertionError(f"mesh {name}: dispatches {counter}, modes {modes}, "
                                 f"fault fallbacks {faulted}")
        q["dispatches"] = spmd.DISPATCH_COUNT - d0
        q["modes"] = modes
        q["collectives"] = spmd.last_collectives()
        check_mesh_answer(name, on, refs[name], f"{name} dispatched")
        runs_on = [timed(df)[1] for _ in range(MESH_RUNS)]
        # singleDevice=off: the fused route where the region planner takes
        # the plan, its mask kernels counted; then fusion off: staged.
        session.conf.set(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE, "off")
        d1 = spmd.DISPATCH_COUNT
        masks0 = {k: ck.LAUNCHES[k] for k in ("compare_mask", "range_mask")}
        f0, fb0 = fusion.DISPATCH_COUNT, fusion.stats()["fallbacks"]
        off, q["cold_off_s"] = timed(df)
        q["route_off"] = fusion_route(fb0, f0)
        runs_off = [timed(df)[1] for _ in range(MESH_RUNS)]
        q["fused_mask_launches"] = {k: ck.LAUNCHES[k] - v for k, v in masks0.items()}
        session.conf.set(IndexConstants.TPU_FUSION_ENABLED, "false")
        f1 = fusion.DISPATCH_COUNT
        staged, q["cold_staged_s"] = timed(df)
        runs_staged = [timed(df)[1] for _ in range(MESH_RUNS)]
        session.conf.unset(IndexConstants.TPU_FUSION_ENABLED)
        session.conf.unset(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE)
        if spmd.DISPATCH_COUNT != d1 or fusion.DISPATCH_COUNT != f1:
            raise AssertionError(f"mesh {name}: singleDevice=off still dispatched, or "
                                 "fusion.enabled=false still fused")
        if not (same_bits(on, off) and same_bits(off, staged)):
            raise AssertionError(f"mesh {name}: the dispatched, fused and staged answers "
                                 "differ")
        check_mesh_answer(name, off, refs[name], f"{name} at singleDevice=off")
        check_mesh_answer(name, staged, refs[name], f"{name} staged")
        q["warm_on_s"] = sorted(runs_on)[MESH_RUNS // 2]
        q["warm_off_s"] = sorted(runs_off)[MESH_RUNS // 2]
        q["warm_staged_s"] = sorted(runs_staged)[MESH_RUNS // 2]
        q["rows"] = on.num_rows
        answers[name] = on
        out["queries"][name] = q
        log(f"mesh {name}: {modes} dispatched; at singleDevice=off {q['route_off']}; warm "
            f"dispatched / fused / staged {q['warm_on_s']:.4f} / {q['warm_off_s']:.4f} / "
            f"{q['warm_staged_s']:.4f} s (median of {MESH_RUNS}); cold {q['cold_on_s']:.3f} / "
            f"{q['cold_off_s']:.3f} / {q['cold_staged_s']:.3f} s")
    out["fused_mask_launches"] = {
        k: sum(q["fused_mask_launches"][k] for q in out["queries"].values())
        for k in ("compare_mask", "range_mask")}
    if min(out["fused_mask_launches"].values()) < 1:
        raise AssertionError(f"mesh: fused regions launched the mask kernels "
                             f"{out['fused_mask_launches']}")
    t0 = time.perf_counter()
    out["empty_aggregate"] = mesh_empty_aggregate(root, "cuda")
    want = {"fused": {"s": [None], "m": [None]}, "staged": {"s": [0.0], "m": [float("inf")]}}
    cpu = mesh_empty_aggregate(root, "cpu")
    if out["empty_aggregate"] != want or cpu != want:
        raise AssertionError(f"mesh: the empty global aggregate gives {out['empty_aggregate']} "
                             f"on the card and {cpu} on the CPU, not {want}")
    out["empty_aggregate_s"] = time.perf_counter() - t0
    log(f"mesh: empty-filter global SUM/MIN of a nullable column: {out['empty_aggregate']}, "
        "as on the CPU")

    # The sample sort: a mesh of several cards takes it for an ORDER BY; on
    # one card the gathered rows are sorted once instead. Forced here, it
    # runs on the card and must give the cutoff's rows.
    df = queries["cutoff_sort"][0]
    use_spmd_sort = spmd._use_spmd_sort
    spmd._use_spmd_sort = lambda session=None: True
    try:
        s0 = spmd.SORT_DISPATCH_COUNT
        forced, cold_s = timed(df)
        runs = [timed(df)[1] for _ in range(MESH_RUNS)]
        sorts = spmd.SORT_DISPATCH_COUNT - s0
    finally:
        spmd._use_spmd_sort = use_spmd_sort
    if sorts != MESH_RUNS + 1 or not same_but_floats(forced, answers["cutoff_sort"]):
        raise AssertionError(f"mesh sample sort: {sorts} sort dispatches, or its rows "
                             "differ from the one-card sort's")
    out["sample_sort"] = {"warm_s": sorted(runs)[MESH_RUNS // 2], "cold_s": cold_s,
                          "sort_dispatches": sorts}
    log(f"mesh sample sort (forced on one card): warm {out['sample_sort']['warm_s']:.4f} s, "
        f"the cutoff's rows")

    # An armed spmd.dispatch fault: degraded with its event and the same
    # answer, and raised with degrade off.
    t0 = time.perf_counter()
    df = queries["q6"][0]
    fault_key = "hyperspace.tpu.robustness.faults.spmd.dispatch"
    before = faults.stats()["degraded_spmd"]
    fused_errors_before = fused_program_errors()
    events = mesh_events()
    events.clear()
    session.conf.set(fault_key, "error")
    degraded = df.to_arrow()
    reasons = [e.reason for e in events if type(e).__name__ == "DistributedFallbackEvent"]
    moved = faults.stats()["degraded_spmd"] - before
    check_mesh_answer("q6", degraded, refs["q6"], "q6 under the armed fault")
    if moved != 1 or not any(r.startswith("fault:") for r in reasons):
        raise AssertionError(f"mesh fault: degraded_spmd moved {moved}, reasons {reasons}")
    session.conf.set(RobustnessConstants.DEGRADE_ENABLED, "false")
    try:
        df.to_arrow()
        raise AssertionError("mesh fault: degrade off did not raise")
    except AssertionError:
        raise
    except Exception as e:
        raised = type(e).__name__
    session.conf.unset(RobustnessConstants.DEGRADE_ENABLED)
    session.conf.unset(fault_key)
    out["fault"] = {"degraded_spmd": moved, "reason": reasons[0], "raised_with_degrade_off":
                    raised, "fused_program_error": fused_program_errors() - fused_errors_before,
                    "seconds": time.perf_counter() - t0}
    degraded_total = faults.stats()["degraded_spmd"] - degraded0
    if degraded_total != moved:
        raise AssertionError(f"mesh: degraded_spmd moved {degraded_total} outside the armed "
                             f"step's {moved}")

    # The mesh build on a mesh of the one card against the single-device
    # build (_use_mesh_build declines one device, so it is called here).
    t0 = time.perf_counter()
    table = read_parquet(sorted(os.path.join(li_dir, f) for f in os.listdir(li_dir)),
                         ["l_orderkey", "l_partkey", "l_extendedprice"], "cuda")
    b0 = distributed_build.DISPATCH_COUNT
    tables, bids = distributed_build.distributed_build_sorted_buckets(
        table, ["l_orderkey"], 32, Mesh([torch.device("cuda", 0)]))
    whole, bounds = index_build.build_sorted_buckets(table, ["l_orderkey"], 32)
    got_bounds = torch.searchsorted(bids[0].to(torch.int64),
                                    torch.arange(33, device=bids[0].device)).cpu().numpy()
    same = all(torch.equal(tables[0].column(c).data, whole.column(c).data)
               for c in whole.names) and (got_bounds == bounds).all()
    if distributed_build.DISPATCH_COUNT != b0 + 1 or not same:
        raise AssertionError("mesh build: the one-card mesh build differs from the "
                             "single-device build")
    torch.cuda.synchronize()
    out["build"] = {"rows": table.num_rows, "buckets": 32, "bucket_for_bucket_equal": True,
                    "collectives": distributed_build.last_collectives(),
                    "seconds": time.perf_counter() - t0}
    del table, tables, whole
    out["stats"] = ht.Hyperspace(session).spmd_stats()
    text = explain_string(session, queries["q6"][0].plan)
    section = text[text.index("Distributed:") - 61:].split("\n\n")[0]
    log("mesh: spmd_stats " + json.dumps(out["stats"]))
    log("mesh: explain's section\n" + section)
    out["explain"] = section
    session.conf.unset(IndexConstants.EVENT_LOGGER_CLASS)
    del session
    shutil.rmtree(os.path.join(root, "mesh_data"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "mesh_indexes"), ignore_errors=True)
    t0 = time.perf_counter()
    out["card_against_cpu"], cpu_routes = mesh_card_against_cpu(root)
    out["card_against_cpu_s"] = time.perf_counter() - t0
    routes = {k: q["route_off"] for k, q in out["queries"].items()}
    if routes != cpu_routes:
        raise AssertionError(f"mesh: the fused routes at singleDevice=off differ from the "
                             f"CPU's: card {routes}, CPU {cpu_routes}")
    log(f"mesh: each query's route at singleDevice=off equals the CPU's: {routes}")
    for d in ("mesh_parity", "mesh_empty", "mesh_empty_ix_cuda", "mesh_empty_ix_cpu"):
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    out["fused_program_error"] = {"path": fused_program_errors() - fused_errors0,
                                  "armed": out["fault"]["fused_program_error"]}
    if out["fused_program_error"]["path"] != out["fused_program_error"]["armed"]:
        raise AssertionError(f"mesh: fused-program-error moved "
                             f"{out['fused_program_error']['path']} outside the armed step")
    log(f"mesh: fused-program-error {out['fused_program_error']}")
    out["seconds"] = time.perf_counter() - t_path
    results["mesh"] = out


def mesh_summary(ms: dict, launches: dict, card: str) -> dict:
    return {"seconds": ms["seconds"], "card": card, "launches": launches,
            "rows": ms["rows"], "datagen_s": ms["datagen_s"],
            "queries": {k: {f: v[f] for f in ("warm_on_s", "warm_off_s", "warm_staged_s",
                                              "cold_on_s", "cold_off_s", "cold_staged_s",
                                              "route_off", "fused_mask_launches", "modes",
                                              "rows")}
                        for k, v in ms["queries"].items()},
            "fused_mask_launches": ms["fused_mask_launches"],
            "empty_aggregate": ms["empty_aggregate"],
            "fused_program_error": ms["fused_program_error"],
            "sample_sort": ms["sample_sort"], "fault": ms["fault"], "build": ms["build"],
            "card_against_cpu": ms["card_against_cpu"], "stats": ms["stats"],
            "bank": ms["bank"]}


def append_lineitem_files(li_dir: str, n_li: int, seed: int = 99) -> int:
    """BASELINE config #5's append, as bench.py makes it: about 5% new rows
    in one fresh part file (inside the 0.3 Hybrid Scan appended-bytes
    ratio)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    n_new = max(n_li // 20, 1000)
    base = (datetime.date(1992, 1, 1) - datetime.date(1970, 1, 1)).days
    t = pa.table({
        "l_orderkey": pa.array(rng.integers(0, max(n_li // 4, 1), n_new)
                               .astype("int64")),
        "l_partkey": pa.array(rng.integers(0, max(n_li // 30, 200), n_new)
                              .astype("int64")),
        "l_quantity": pa.array(rng.integers(1, 51, n_new).astype("int64")),
        "l_extendedprice": pa.array(
            (rng.uniform(900, 105000, n_new)).round(2)),
        "l_discount": pa.array((rng.uniform(0, 0.1, n_new)).round(2)),
        "l_shipdate": pa.array((rng.integers(0, 2520, n_new) + base)
                               .astype("int32"), type=pa.int32())
        .cast(pa.date32()),
    })
    pq.write_table(t, os.path.join(li_dir, "part-appended.parquet"))
    return n_new


def append_orders_file(od_dir: str, n_rows: int, first_key: int, part: int,
                       seed: int) -> str:
    """One more orders file of ``n_rows`` rows: new keys from ``first_key``
    on and the newest dates (after every existing file's)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    base = (datetime.date(1992, 1, 1) - EPOCH).days + 2400 + 30 * part
    path = os.path.join(od_dir, f"part{part:02d}.parquet")
    pq.write_table(pa.table({
        "o_orderkey": pa.array(np.arange(first_key, first_key + n_rows, dtype=np.int64)),
        "o_custkey": pa.array(rng.integers(0, max(n_rows // 10, 1), n_rows).astype(np.int64)),
        "o_orderdate": pa.array(np.sort(rng.integers(0, 30, n_rows) + base).astype(np.int32),
                                type=pa.int32()).cast(pa.date32()),
        "o_shippriority": pa.array(np.zeros(n_rows, dtype=np.int32)),
        "o_totalprice": pa.array(np.round(rng.uniform(1000, 400000, n_rows), 2)),
    }), path)
    return path


class Spans:
    """Host-clock seconds per label around the wrapped functions, the
    device synchronized before and after each call; a generator's time is
    counted per item it yields. With ``outermost`` a call made inside
    another wrapped call is not counted again, so the spans add up to no
    more than the wall time."""

    def __init__(self, patches, outermost: bool = False):
        self.patches = patches
        self.spans: dict = {}
        self.outermost = outermost
        self._depth = threading.local()

    def _add(self, label, t0):
        import torch
        torch.cuda.synchronize()
        self.spans[label] = self.spans.get(label, 0.0) + time.perf_counter() - t0

    def _wrap(self, label, fn):
        import inspect

        import torch

        def gen(it):
            while True:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    self._add(label, t0)
                    return
                self._add(label, t0)
                yield item

        def wrapper(*a, **k):
            depth = getattr(self._depth, "n", 0)
            if self.outermost and depth:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._depth.n = depth + 1
            try:
                out = fn(*a, **k)
            finally:
                self._depth.n = depth
                self._add(label, t0)
            return gen(out) if inspect.isgenerator(out) else out
        return wrapper

    def __enter__(self):
        self.saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in self.patches]
        for (obj, attr, label), (_, _, orig) in zip(self.patches, self.saved):
            setattr(obj, attr, self._wrap(label, orig))
        return self

    def __exit__(self, *exc):
        for obj, attr, orig in self.saved:
            setattr(obj, attr, orig)


class HeldLock:
    """A lock that keeps the host-clock seconds of each hold, the device
    synchronized before it is let go."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: list = []

    def __enter__(self):
        self._lock.acquire()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - self._t0)
        self._lock.release()


def check_bucket_layout(entry, key: str, files=None, one_file_per_bucket=True) -> int:
    """Every file of the index (or ``files``) holds only its own bucket's
    keys (bucket ids recomputed on the card by the plain torch hash, not by
    the kernel that built the files), with rows sorted by the key, and one
    file per bucket if asked. Returns the rows."""
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch.execution.columnar import Table
    from hyperspace_tpu_torch.ops import cuda_kernels, index_build, kernels

    files = list(entry.content.files) if files is None else files
    buckets = [index_build.bucket_id_from_file(f) for f in files]
    if one_file_per_bucket and len(set(buckets)) != len(buckets):
        raise AssertionError(f"{entry.name}: a bucket holds several files: {sorted(files)}")
    rows = 0
    for f, b in zip(files, buckets):
        t = Table.from_arrow(pq.ParquetFile(f).read(columns=[key]), "cuda")
        c = t.column(key)
        _, bids = cuda_kernels.hash_bucket_plain(
            [kernels.fold_u32(c.data, c.dtype, c.dictionary).contiguous()], entry.num_buckets)
        if not bool((bids == b).all()):
            raise AssertionError(f"{entry.name}: {f} holds keys of another bucket")
        if c.data.shape[0] > 1 and not bool((c.data[1:] >= c.data[:-1]).all()):
            raise AssertionError(f"{entry.name}: {f} is not sorted by {key}")
        rows += t.num_rows
    torch.cuda.synchronize()
    return rows


def parquet_rows(data_dir: str) -> int:
    import pyarrow.parquet as pq
    return sum(pq.ParquetFile(os.path.join(data_dir, f)).metadata.num_rows
               for f in os.listdir(data_dir) if f.endswith(".parquet"))


def timed_step(steps: dict, name: str, fn, rows: int) -> None:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps[name] = {"seconds": secs, "rows": rows, "rows_per_s": rows / secs}
    log(f"mutations: {name}: {secs:.3f} s ({rows:,} rows, {rows / secs:,.0f} rows/s)")


def leaf_strings(session, df) -> list:
    session.enable_hyperspace()
    try:
        return [leaf.simple_string() for leaf in df.optimized_plan().collect_leaves()]
    finally:
        session.disable_hyperspace()


def chunked_build_parity(root: str) -> dict:
    """One lineitem index over a small lake, built on the card chunked at
    the default ``io.threads`` (the spill read-back double-buffered on the
    reader pool), chunked at ``io.threads=1``, and in memory: the two
    chunked builds' bucket files must be byte-equal, and equal tables to
    the in-memory build's."""
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConfig, IndexConstants
    from hyperspace_tpu_torch.ops import index_build

    li_dir, _, _, n_li, _ = make_tpch(os.path.join(root, "chunk_parity_data"), PARITY_SCALE)
    dirs = {}
    for mode, budget, threads in (("chunked", n_li // 7, "0"),
                                  ("chunked_sequential", n_li // 7, "1"),
                                  ("in_memory", n_li, "0")):
        system_path = os.path.join(root, f"chunk_parity_{mode}")
        s = ht.Session(system_path=system_path, device="cuda")
        s.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
        s.conf.set(IndexConstants.TPU_MAX_CHUNK_ROWS, budget)
        s.conf.set(IndexConstants.TPU_IO_THREADS, threads)
        index_build.CHUNK_STATS.update(max_device_rows=0, chunks=0)
        ht.Hyperspace(s).create_index(s.read.parquet(li_dir), IndexConfig(
            "li_idx", ["l_orderkey"], ["l_extendedprice", "l_discount", "l_shipdate"]))
        if (index_build.CHUNK_STATS["chunks"] > 0) != mode.startswith("chunked"):
            raise AssertionError(f"chunk parity: the {mode} build took the wrong route")
        dirs[mode] = os.path.join(system_path, "li_idx", "v__=0")
    files = sorted(os.listdir(dirs["chunked"]))
    if files != sorted(os.listdir(dirs["in_memory"])) or len(files) != 32 \
            or files != sorted(os.listdir(dirs["chunked_sequential"])):
        raise AssertionError(f"chunk parity: bucket files differ: {files}")
    for f in files:
        a = pq.ParquetFile(os.path.join(dirs["chunked"], f)).read()
        b = pq.ParquetFile(os.path.join(dirs["in_memory"], f)).read()
        if not a.equals(b):
            raise AssertionError(f"chunk parity: {f} differs between the chunked and the "
                                 "in-memory build")
        if file_bytes(os.path.join(dirs["chunked"], f)) != \
                file_bytes(os.path.join(dirs["chunked_sequential"], f)):
            raise AssertionError(f"chunk parity: {f} differs between io.threads 1 and the "
                                 "default")
    return {"rows": n_li, "budget": n_li // 7, "files": len(files)}


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# The io path: the reader pool, prefetch, the buffer pool and the index
# cache, on the SF10 lake.
# ---------------------------------------------------------------------------

def check_reference(name: str, got, what: str) -> None:
    kind, ref = REFERENCES[name]
    if kind == "q3":
        check_q3(got, ref[0], ref[1], what)
    elif kind == "q17":
        check_q17(got, ref, what)
    elif not same_rows(got, ref):
        raise AssertionError(f"{name} ({what}): result differs from the pyarrow reference")


def same_bytes(a, b) -> bool:
    """Equal tables, float64 columns bit for bit."""
    import numpy as np
    return a.equals(b) and all(
        np.array_equal(a.column(n).to_numpy().view(np.int64),
                       b.column(n).to_numpy().view(np.int64))
        for n in a.column_names if str(a.column(n).type) == "double")


def pool_counts(stats: dict) -> dict:
    return {k: stats[k] for k in ("hits", "misses", "transfers", "admissions", "demotions",
                                  "evictions", "promotions")}


def read_split(session, files: list, columns: list, repeats: int) -> dict:
    """One multi-file read to the card at ``io.threads=1``, at the defaults,
    with ``io.enabled=false`` (pyarrow's own threads) and with an in-flight
    budget that lets the pool read at its full width, ``repeats`` times
    each, split into the parquet decode and the encoding and pinned copy
    that follow it on the calling thread (numpy, under the GIL for
    strings)."""
    from hyperspace_tpu_torch import IndexConstants
    from hyperspace_tpu_torch.execution import columnar
    from hyperspace_tpu_torch.parallel import io as pio

    out = {"files": len(files), "columns": columns}
    spans_of = [(columnar, "_read_parquet_pooled", "decode"),
                (columnar.Table, "from_arrow", "encode + copy (calling thread)")]
    for label, key, value in (("threads=1", IndexConstants.TPU_IO_THREADS, "1"),
                              ("default", None, None),
                              ("io off", IndexConstants.TPU_IO_ENABLED, "false"),
                              ("pool, 64 GiB in flight", IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES,
                               str(64 << 30))):
        if key:
            session.conf.set(key, value)
        runs = []
        try:
            with pio.use_session(session):
                for _ in range(repeats):
                    pooled = pio.pool_stats()["pooled_reads"]
                    with Spans(spans_of) as timer:
                        t0 = time.perf_counter()
                        table = columnar.read_parquet(files, columns, "cuda")
                        torch_sync()
                        runs.append({"seconds": time.perf_counter() - t0, **timer.spans,
                                     "pooled": pio.pool_stats()["pooled_reads"] > pooled})
        finally:
            session.conf.set(IndexConstants.TPU_IO_THREADS,
                             IndexConstants.TPU_IO_THREADS_DEFAULT)
            session.conf.set(IndexConstants.TPU_IO_ENABLED,
                             IndexConstants.TPU_IO_ENABLED_DEFAULT)
            session.conf.set(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES,
                             IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES_DEFAULT)
        out["rows"] = table.num_rows
        out[label] = runs
    return out


def read_splits(root: str, session, li_dir: str, pt_dir: str) -> dict:
    """``read_split`` over three reads: part's two string columns copied into
    16 files (whether the pool overlaps anything on string columns), the
    cache route's read of li_idx (Q3's four columns of its 32 bucket files)
    and Q17's read of lineitem's four source files."""
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as ht

    part = pq.read_table([os.path.join(pt_dir, f) for f in sorted(os.listdir(pt_dir))],
                         columns=["p_brand", "p_container"])
    out_dir = os.path.join(root, "io_strings")
    os.makedirs(out_dir)
    step = -(-part.num_rows // ORDERS_PARTS)
    strings = []
    for i in range(ORDERS_PARTS):
        strings.append(os.path.join(out_dir, f"part{i:02d}.parquet"))
        pq.write_table(part.slice(i * step, step), strings[-1])
    li_idx = sorted(ht.Hyperspace(session).index_manager.get_index("li_idx").content.files)
    lineitem = [os.path.join(li_dir, f) for f in sorted(os.listdir(li_dir))]
    out = {"strings": read_split(session, strings, ["p_brand", "p_container"], 3),
           "li_idx": read_split(session, li_idx, ["l_orderkey", "l_extendedprice",
                                                  "l_discount", "l_shipdate"], 2),
           "lineitem": read_split(session, lineitem, ["l_partkey", "l_quantity",
                                                      "l_extendedprice"], 2)}
    for name, split in out.items():
        log(f"io: read split {name} ({split['rows']:,} rows, {split['files']} files): " +
            "; ".join(f"{k}: " + ", ".join(
                ", ".join(f"{a} {b:.3f}" if isinstance(b, float) else f"{a} {b}"
                          for a, b in r.items()) for r in runs)
                for k, runs in split.items() if isinstance(runs, list) and k != "columns"))
    return out


def run_io_path(root: str, session, queries: dict, li_dir: str, od_dir: str, pt_dir: str,
                n_od: int, results: dict) -> None:
    """Each query of IO_QUERIES, indexed and scanned, three ways: cold (the
    buffer pool emptied and the reader pool's counters zeroed first), warm
    (again), and sequential (``io.threads=1``, the buffer pool disabled and
    emptied: the JAX package's baseline setting). The three results must be
    byte-equal and equal the phases' pyarrow references, and every warm run
    must hit the pool. Then od_skip and od_bloom built at ``io.threads`` 1
    and the default into two lakes give byte-equal sketch tables, and the
    small lake's chunked builds give byte-equal bucket files."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import (BloomFilterSketch, DataSkippingIndexConfig,
                                      IndexConstants, MinMaxSketch)
    from hyperspace_tpu_torch.execution import buffer_pool, executor
    from hyperspace_tpu_torch.parallel import io as pio

    out = {"queries": {}}
    results["io"] = out
    read_spans = [(executor, "read_parquet", "parquet read -> device"),
                  (executor, "read_relation_files", "parquet read -> device"),
                  (executor, "iter_dataset_chunks", "parquet read -> device")]

    def timed(df, indexed: bool):
        (session.enable_hyperspace if indexed else session.disable_hyperspace)()
        try:
            before = buffer_pool.pool_stats()
            reader_before = pio.pool_stats()
            with Spans(read_spans) as spans:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                table = df.to_arrow()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            after = buffer_pool.pool_stats()
            reader = pio.pool_stats()
            return table, {
                "seconds": secs, "read_s": spans.spans.get("parquet read -> device", 0.0),
                "peak_bytes": torch.cuda.max_memory_allocated() - base,
                "peak_abs": torch.cuda.max_memory_allocated(),
                "pool": {k: v - pool_counts(before)[k] for k, v in pool_counts(after).items()},
                "reader": {k: reader[k] - reader_before[k]
                           for k in ("pooled_reads", "read_tasks", "read_seconds",
                                     "wait_seconds", "prefetch_streams")}}
        finally:
            session.disable_hyperspace()

    io_base, io_peak = torch.cuda.memory_allocated(), 0
    t_queries = time.perf_counter()
    # The most the pool held after any warm run, against its budgets.
    stats = buffer_pool.pool_stats()
    residency = {"device_nbytes": 0, "host_nbytes": 0, "device_entries": 0, "host_entries": 0,
                 "device_bytes": stats["device_bytes"], "host_bytes": stats["host_bytes"]}
    for name in IO_QUERIES:
        for mode in ("indexed", "scanned"):
            df, indexed = queries[name], mode == "indexed"
            buffer_pool.get_pool().clear()
            pio.reset_stats()
            cold, c = timed(df, indexed)
            warm, w = timed(df, indexed)
            stats = buffer_pool.pool_stats()
            for k in ("device_nbytes", "host_nbytes", "device_entries", "host_entries"):
                residency[k] = max(residency[k], stats[k])
            if stats["device_nbytes"] > stats["device_bytes"] \
                    or stats["host_nbytes"] > stats["host_bytes"]:
                raise AssertionError(f"io: the buffer pool holds more than its budgets: {stats}")
            buffer_pool.get_pool().clear()
            session.conf.set(IndexConstants.TPU_IO_THREADS, 1)
            session.conf.set(IndexConstants.TPU_BUFFER_POOL_ENABLED, "false")
            try:
                seq, q = timed(df, indexed)
            finally:
                session.conf.set(IndexConstants.TPU_IO_THREADS,
                                 IndexConstants.TPU_IO_THREADS_DEFAULT)
                session.conf.set(IndexConstants.TPU_BUFFER_POOL_ENABLED,
                                 IndexConstants.TPU_BUFFER_POOL_ENABLED_DEFAULT)
            io_peak = max(io_peak, c.pop("peak_abs"), w.pop("peak_abs"), q.pop("peak_abs"))
            for what, t in (("cold", cold), ("warm", warm), ("sequential", seq)):
                check_reference(name, t, f"{mode}, {what}")
            if not (same_bytes(cold, warm) and same_bytes(cold, seq)):
                raise AssertionError(f"io {name} ({mode}): cold, warm and sequential results "
                                     "differ in their bytes")
            if w["pool"]["hits"] <= 0:
                raise AssertionError(f"io {name} ({mode}): the warm run found nothing in the "
                                     f"buffer pool: {w['pool']}")
            out["queries"][f"{name} {mode}"] = {"rows": cold.num_rows, "cold": c, "warm": w,
                                                "sequential": q}
            log(f"io: {name} {mode}: {cold.num_rows} rows; cold {c['seconds']:.3f} s (read "
                f"{c['read_s']:.3f}), warm {w['seconds']:.3f} s (read {w['read_s']:.3f}; pool "
                f"{w['pool']}), sequential {q['seconds']:.3f} s (read {q['read_s']:.3f}); peak "
                f"{c['peak_bytes']} / {w['peak_bytes']} / {q['peak_bytes']} bytes")
    out["queries_s"] = time.perf_counter() - t_queries
    out["residency"] = residency
    out["reader_pool"] = pio.pool_stats()
    out["peak_bytes"] = io_peak - io_base
    log(f"io: queries in {out['queries_s']:.1f} s; pool residency {out['residency']}; "
        f"peak device bytes above the path's base {out['peak_bytes']}")

    out["read_splits"] = read_splits(root, session, li_dir, pt_dir)
    # Sketch tables at io.threads 1 and the default.
    tables = {}
    t0 = time.perf_counter()
    for threads in ("1", IndexConstants.TPU_IO_THREADS_DEFAULT):
        lake = os.path.join(root, f"io_sketches_{threads}")
        s = ht.Session(system_path=lake, device="cuda")
        s.conf.set(IndexConstants.TPU_IO_THREADS, threads)
        h = ht.Hyperspace(s)
        od = s.read.parquet(od_dir)
        h.create_index(od, DataSkippingIndexConfig("od_skip", [MinMaxSketch("o_orderdate")]))
        h.create_index(od, DataSkippingIndexConfig("od_bloom", [BloomFilterSketch(
            "o_orderkey", expected_items=max(n_od // ORDERS_PARTS, 100_000))]))
        tables[threads] = {n: file_bytes(os.path.join(lake, n, "v__=0", "sketches.parquet"))
                           for n in ("od_skip", "od_bloom")}
    if tables["1"] != tables[IndexConstants.TPU_IO_THREADS_DEFAULT]:
        raise AssertionError("io: sketch tables differ between io.threads 1 and the default")
    out["sketch_builds_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["chunked_build_parity"] = chunked_build_parity(root)
    out["chunked_build_parity"]["seconds"] = time.perf_counter() - t0
    log(f"io: sketch tables byte-equal at io.threads 1 and the default "
        f"({out['sketch_builds_s']:.1f} s); chunked builds byte-equal and equal to the "
        f"in-memory build: {out['chunked_build_parity']}")


def run_mutations_path(root: str, system_path: str, li_dir: str, od_dir: str, n_li: int,
                       n_od: int, results: dict) -> None:
    """Appends, deletes, every refresh, optimize, the chunked build and
    Hybrid Scan, through a session at the JAX package's default device
    budget (so builds and filtered scans above 8,388,608 rows stream in
    chunks)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch import IndexConfig, IndexConstants, col
    from hyperspace_tpu_torch.execution import buffer_pool, executor
    from hyperspace_tpu_torch.index.data_manager import IndexDataManager
    from hyperspace_tpu_torch.ops import index_build

    session = ht.Session(system_path=system_path, device="cuda")
    session.conf.set(IndexConstants.INDEX_FILTER_RULE_USE_BUCKET_SPEC, "true")
    session.conf.set(IndexConstants.INDEX_ROW_GROUP_SIZE, max(4096, int(n_li / 32 / 8)))
    hs = ht.Hyperspace(session)
    budget = session.hs_conf.max_chunk_rows()
    out = {"budget": budget, "steps": {}, "queries": {}}
    steps = out["steps"]
    results["mutations"] = out

    def hybrid(on: bool):
        session.conf.set(IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true" if on else "false")

    def versions(name):
        return IndexDataManager(os.path.join(system_path, name)).get_all_version_ids()

    def entry(name):
        return hs.index_manager.get_index(name)

    # Lineitem: BASELINE config #5, one appended file.
    n_new = append_lineitem_files(li_dir, n_li)
    n_li_now = n_li + n_new
    out["lineitem_appended_rows"] = n_new
    log(f"mutations: appended {n_new:,} lineitem rows")
    hybrid(True)
    li = session.read.parquet(li_dir)
    shipdate = pc.field("l_shipdate")
    filters = {
        "range": (li.filter(col("l_shipdate").between(RANGE_LO, RANGE_HI))
                  .select("l_orderkey", "l_extendedprice"),
                  (shipdate >= RANGE_LO) & (shipdate <= RANGE_HI)),
        "cutoff": (li.filter(col("l_shipdate") > CUTOFF).select("l_orderkey", "l_extendedprice"),
                   shipdate > CUTOFF)}
    columns = ["l_orderkey", "l_extendedprice"]
    suffix = "hybrid(+1 appended, -0 deleted files)"
    for name, (df, pa_cond) in filters.items():
        leaves = leaf_strings(session, df)
        if not any("Name: li_ship_idx," in s and suffix in s for s in leaves):
            raise AssertionError(f"hybrid {name}: no Hybrid Scan of li_ship_idx: {leaves}")
        before = buffer_pool.pool_stats()["misses"]
        indexed, i_secs, i_peak = run_twice(session, df, True)
        if name == "range":
            # The appended file's stream was never read: the first Hybrid
            # query after the append misses the buffer pool there.
            out["first_hybrid_pool_misses"] = buffer_pool.pool_stats()["misses"] - before
            if out["first_hybrid_pool_misses"] <= 0:
                raise AssertionError("hybrid range: no buffer pool miss after the append")
        scanned, s_secs, s_peak = run_twice(session, df, False)
        ref = reference(li_dir, pa_cond, columns)
        for t in indexed + scanned:
            if not same_rows(t, ref):
                raise AssertionError(f"hybrid {name}: result differs from the pyarrow reference")
        out["queries"][f"hybrid {name}"] = {
            "rows": ref.num_rows, "indexed_s": i_secs, "scanned_s": s_secs,
            "peak_bytes_indexed": i_peak, "peak_bytes_scanned": s_peak, "leaves": leaves}
        log(f"mutations: hybrid {name}: {ref.num_rows} rows; indexed {i_secs} s, scanned "
            f"{s_secs} s; peak {i_peak} / {s_peak} bytes")
    q3 = build_q3(session, li_dir, od_dir)
    session.enable_hyperspace()
    q3_plan = q3.optimized_plan()
    session.disable_hyperspace()
    check_q3_plan(q3_plan)
    li_leaf = [leaf for leaf in q3_plan.collect_leaves()
               if getattr(leaf, "index_entry", None) and leaf.index_entry.name == "li_idx"][0]
    if suffix not in li_leaf.simple_string():
        raise AssertionError(f"hybrid Q3: li_idx is not a Hybrid Scan:\n{q3_plan.tree_string()}")
    merges, fast = executor.HYBRID_MERGE_COUNT, executor.FAST_JOIN_COUNT
    indexed, i_secs, i_peak = run_twice(session, q3, True)
    merges, fast = executor.HYBRID_MERGE_COUNT - merges, executor.FAST_JOIN_COUNT - fast
    scanned, s_secs, s_peak = run_twice(session, q3, False)
    ref, tied_last = q3_reference(li_dir, od_dir)
    for t in indexed + scanned:
        check_q3(t, ref, tied_last, "hybrid")
    if merges < 2 or fast < 2:
        raise AssertionError(f"hybrid Q3: {merges} order-preserving merges and {fast} "
                             "shuffle-free joins in two indexed runs")
    out["queries"]["hybrid q3"] = {
        "indexed_s": i_secs, "scanned_s": s_secs, "peak_bytes_indexed": i_peak,
        "peak_bytes_scanned": s_peak, "hybrid_merges": merges, "fast_joins": fast,
        "plan": q3_plan.tree_string()}
    log(f"mutations: hybrid Q3: indexed {i_secs} s, scanned {s_secs} s; {merges} merges, "
        f"{fast} shuffle-free joins; peak {i_peak} / {s_peak} bytes")

    # Quick refresh: metadata only; then incremental: eight new files.
    range_df, range_cond = filters["range"]
    range_ref = reference(li_dir, range_cond, columns)
    timed_step(steps, "quick refresh li_ship_idx",
               lambda: hs.refresh_index("li_ship_idx", "quick"), n_new)
    if versions("li_ship_idx") != [0] or not entry("li_ship_idx").appended_files:
        raise AssertionError(f"quick refresh wrote data or recorded no append: "
                             f"{versions('li_ship_idx')}")
    session.enable_hyperspace()
    got = range_df.to_arrow()
    session.disable_hyperspace()
    if not same_rows(got, range_ref):
        raise AssertionError("range after the quick refresh differs from the reference")
    timed_step(steps, "incremental refresh li_ship_idx",
               lambda: hs.refresh_index("li_ship_idx", "incremental"), n_new)
    hybrid(False)
    e = entry("li_ship_idx")
    new_files = [f for f in e.content.files if "/v__=1/" in f]
    if versions("li_ship_idx") != [0, 1] or len(new_files) != 8:
        raise AssertionError(f"incremental refresh: versions {versions('li_ship_idx')}, "
                             f"{len(new_files)} new files")
    if check_bucket_layout(e, "l_shipdate", new_files) != n_new:
        raise AssertionError("incremental refresh: the new files do not hold the appended rows")
    leaves = leaf_strings(session, range_df)
    if not any("Name: li_ship_idx," in s and "hybrid" not in s for s in leaves):
        raise AssertionError(f"range after the incremental refresh is not rewritten: {leaves}")
    session.enable_hyperspace()
    got = range_df.to_arrow()
    session.disable_hyperspace()
    if not same_rows(got, range_ref):
        raise AssertionError("range after the incremental refresh differs from the reference")

    # The chunked build at the default budget, with its spans.
    spans = Spans([(index_build, "iter_parquet_chunks", "chunk read (host decode -> device)"),
                   (index_build, "build_sorted_buckets", "hash + sort (device)"),
                   (index_build, "_spill_runs", "spill write (device -> host, parquet)"),
                   (index_build, "read_parquet", "spill read (parquet -> device)"),
                   (index_build, "_sort_batch", "final sort (device)"),
                   (index_build, "_write_batch", "bucket write (device -> host, parquet)")])
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
    index_build.CHUNK_STATS.update(max_device_rows=0, chunks=0, spill_bytes=0)
    with spans:
        timed_step(steps, "chunked build li_chunk_idx", lambda: hs.create_index(
            li, IndexConfig("li_chunk_idx", ["l_orderkey"],
                            ["l_extendedprice", "l_discount", "l_shipdate"])), n_li_now)
    stats = dict(index_build.CHUNK_STATS)
    steps["chunked build li_chunk_idx"].update(spans_s=spans.spans, chunk_stats=stats)
    log(f"mutations: chunked build spans {spans.spans}; {stats}")
    if stats["max_device_rows"] > budget or stats["chunks"] != -(-n_li_now // budget):
        raise AssertionError(f"chunked build: {stats} at a budget of {budget}")
    if check_bucket_layout(entry("li_chunk_idx"), "l_orderkey") != n_li_now:
        raise AssertionError("chunked build: the bucket files do not hold every source row")

    # Orders, with lineage: one file deleted and one appended.
    session.conf.set(IndexConstants.INDEX_LINEAGE_ENABLED, "true")
    od = session.read.parquet(od_dir)
    timed_step(steps, "chunked build od_lin_idx (lineage)", lambda: hs.create_index(
        od, IndexConfig("od_lin_idx", ["o_orderkey"], ["o_orderdate", "o_totalprice"])), n_od)
    session.conf.set(IndexConstants.INDEX_LINEAGE_ENABLED, "false")
    if check_bucket_layout(entry("od_lin_idx"), "o_orderkey") != n_od:
        raise AssertionError("od_lin_idx: the bucket files do not hold every source row")
    per_file = n_od // ORDERS_PARTS
    os.remove(os.path.join(od_dir, "part00.parquet"))
    append_orders_file(od_dir, per_file, n_od, ORDERS_PARTS, seed=101)
    keys = [per_file // 2, n_od // 2, n_od + per_file // 2]  # deleted, kept, appended.
    ocols = ["o_orderkey", "o_orderdate", "o_totalprice"]

    def check_point(what: str, hybrid_on: bool, versions_want=None, files_want=None):
        # A fresh read: a relation lists its files once.
        point_df = session.read.parquet(od_dir).filter(col("o_orderkey").isin(keys)) \
            .select(*ocols)
        hybrid(hybrid_on)
        leaves = leaf_strings(session, point_df)
        ok = [s for s in leaves if "Name: od_lin_idx," in s]
        want = "hybrid(+1 appended, -1 deleted files)" if hybrid_on else None
        if not ok or (want and want not in ok[0]) or (not want and "hybrid" in ok[0]):
            raise AssertionError(f"orders {what}: not the expected scan of od_lin_idx: {leaves}")
        indexed, i_secs, _ = run_twice(session, point_df, True)
        ref = sorted_table(reference(od_dir, pc.field("o_orderkey").isin(keys), ocols))
        for t in indexed:
            if not sorted_table(t).equals(ref):
                raise AssertionError(f"orders {what}: result differs from the reference")
        if ref.num_rows != 2 or keys[0] in ref.column("o_orderkey").to_pylist():
            raise AssertionError(f"orders {what}: reference holds {ref.to_pydict()}")
        out["queries"][f"orders point ({what})"] = {"indexed_s": i_secs, "leaves": leaves}
        hybrid(False)
        if versions_want is not None and versions("od_lin_idx") != versions_want:
            raise AssertionError(f"orders {what}: versions {versions('od_lin_idx')}")
        if files_want is not None and len(entry("od_lin_idx").content.files) != files_want:
            raise AssertionError(f"orders {what}: {len(entry('od_lin_idx').content.files)} "
                                 f"files, not {files_want}")

    check_point("hybrid", True, [0], 32)

    # The sketch refreshes; their queries as in the orders path.
    timed_step(steps, "incremental refresh od_skip",
               lambda: hs.refresh_index("od_skip", "incremental"), per_file)
    timed_step(steps, "full refresh od_bloom",
               lambda: hs.refresh_index("od_bloom", "full"), n_od)
    current = sorted(os.path.join(od_dir, f) for f in os.listdir(od_dir))
    od = session.read.parquet(od_dir)
    sk_files = pa.concat_tables([pq.read_table(f, partitioning=None)
                                 for f in entry("od_skip").content.files]
                                ).column("_file").to_pylist()
    if sorted(sk_files) != current:
        raise AssertionError(f"od_skip after its refresh sketches {sorted(sk_files)}")
    check_minmax_sketch(hs, od_dir)
    sketch_queries = {
        "skipping": (od.filter(col("o_orderdate").between(SKIP_LO, SKIP_HI))
                     .select("o_orderkey", "o_custkey"),
                     (pc.field("o_orderdate") >= SKIP_LO) & (pc.field("o_orderdate") <= SKIP_HI),
                     ["o_orderkey", "o_custkey"],
                     files_meeting(od_dir, "o_orderdate", lambda c: (
                         pc.min(c).as_py() <= SKIP_HI and pc.max(c).as_py() >= SKIP_LO))),
        "bloom": (od.filter(col("o_orderkey").isin(keys[1:])).select("o_orderkey", "o_custkey"),
                  pc.field("o_orderkey").isin(keys[1:]), ["o_orderkey", "o_custkey"],
                  files_meeting(od_dir, "o_orderkey", lambda c: pc.any(
                      pc.is_in(c, value_set=pa.array(keys[1:]))).as_py()))}
    for name, (df, pa_cond, cols, holding) in sketch_queries.items():
        session.enable_hyperspace()
        leaves = df.optimized_plan().collect_leaves()
        got = df.to_arrow()
        session.disable_hyperspace()
        if len(leaves) != 1 or not getattr(leaves[0], "skipping_note", None):
            raise AssertionError(f"{name} after the sketch refresh: not narrowed: "
                                 f"{[leaf.simple_string() for leaf in leaves]}")
        kept = leaves[0].relation.all_files()
        if (name == "skipping" and kept != holding) or set(holding) - set(kept) \
                or len(kept) >= len(current):
            raise AssertionError(f"{name} after the sketch refresh kept {kept}; holding "
                                 f"{holding}")
        if not sorted_table(got).equals(sorted_table(reference(od_dir, pa_cond, cols))):
            raise AssertionError(f"{name} after the sketch refresh differs from the reference")
        out["queries"][f"{name} after refresh"] = {"files_kept": len(kept),
                                                   "note": leaves[0].skipping_note}

    # od_lin_idx through every refresh and optimize.
    n_now = parquet_rows(od_dir)
    timed_step(steps, "quick refresh od_lin_idx",
               lambda: hs.refresh_index("od_lin_idx", "quick"), per_file)
    check_point("after quick refresh", True, [0], 32)
    timed_step(steps, "incremental refresh od_lin_idx (deletes)",
               lambda: hs.refresh_index("od_lin_idx", "incremental"), n_now)
    check_point("after the masked rebuild", False, [0, 1], 32)
    if check_bucket_layout(entry("od_lin_idx"), "o_orderkey") != n_now:
        raise AssertionError("od_lin_idx after the masked rebuild: rows do not add up")
    append_orders_file(od_dir, per_file, n_od + per_file, ORDERS_PARTS + 1, seed=102)
    n_now = parquet_rows(od_dir)
    timed_step(steps, "incremental refresh od_lin_idx (appends)",
               lambda: hs.refresh_index("od_lin_idx", "incremental"), per_file)
    check_point("after the append-only refresh", False, [0, 1, 2], 64)
    if check_bucket_layout(entry("od_lin_idx"), "o_orderkey",
                           one_file_per_bucket=False) != n_now:
        raise AssertionError("od_lin_idx after the append-only refresh: rows do not add up")
    timed_step(steps, "optimize od_lin_idx (quick)",
               lambda: hs.optimize_index("od_lin_idx", "quick"), n_now)
    check_point("after optimize", False, [0, 1, 2, 3], 32)
    if check_bucket_layout(entry("od_lin_idx"), "o_orderkey") != n_now:
        raise AssertionError("od_lin_idx after optimize: rows do not add up")
    os.remove(os.path.join(od_dir, "part01.parquet"))
    n_now = parquet_rows(od_dir)
    timed_step(steps, "full refresh od_lin_idx",
               lambda: hs.refresh_index("od_lin_idx", "full"), n_now)
    keys[0] = per_file + per_file // 2  # part01's, deleted now.
    check_point("after the full refresh", False, [0, 1, 2, 3, 4], 32)
    if check_bucket_layout(entry("od_lin_idx"), "o_orderkey") != n_now:
        raise AssertionError("od_lin_idx after the full refresh: rows do not add up")


# ---------------------------------------------------------------------------
# Phase 6: timing.
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20, rounds: int = 1):
    """Mean ms per call of ``iters`` back-to-back calls, by CUDA events
    around them (so a call that costs the host more than the card is
    measured at the host's pace), after 3 warm-up calls. With ``rounds`` >
    1: (median of the rounds, max - min of the rounds)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    if rounds == 1:
        return times[0]
    return sorted(times)[rounds // 2], max(times) - min(times)


def device_profile(fn, iters: int = 20, name=None) -> dict:
    """The card's own time per call (ms) and the device records each call
    puts on the stream: torch.profiler over ``iters`` calls after 3 warm-up
    calls, device-side records only (kernels, memsets and copies).
    ``name``: the kernel whose wrapper ``fn`` calls; its launch count
    during the session tells a session that dropped a record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # A profiling session now and then comes back without device records,
    # or without one of its kernels' records (fewer kernel records than
    # the wrapper counted launches); it is repeated, up to five times in
    # all, and then the run fails. Each discarded session is kept in the
    # result as (kernel records, launches counted), so a retry shows.
    discarded = []
    for _ in range(5):
        launched = ck.LAUNCHES.get(name, 0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launched = ck.LAUNCHES.get(name, 0) - launched
        records = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
                   and e.key != "Activity Buffer Request"]
        kernels = sum(c for k, c, _ in records if not k.startswith(("Memset", "Memcpy")))
        if records and kernels >= launched:
            break
        discarded.append((kernels, launched))
    if not records:
        raise AssertionError("torch.profiler gave no device records in five sessions")
    if kernels < launched:
        raise AssertionError(f"torch.profiler recorded {kernels} kernels of {launched} "
                             f"launches in each of five sessions")
    memsets = sum(c for k, c, _ in records if k.startswith("Memset"))
    copies = sum(c for k, c, _ in records if k.startswith("Memcpy"))
    return {"device_ms": sum(t for _, _, t in records) / 1e3 / iters,
            "kernels_per_call": (sum(c for _, c, _ in records) - memsets - copies) / iters,
            "memsets_per_call": memsets / iters, "copies_per_call": copies / iters,
            "device_records": [(k[:120], c) for k, c, _ in records],
            "profile_sessions": len(discarded) + 1, "discarded_sessions": discarded}


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_32BIT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(li_dir: str, od_dir: str):
    """The inputs each kernel got on the main path (the filter kernels see
    the rows the parquet reader kept; masked_minmax one orders file's
    o_orderdate), and full-size columns."""
    import pyarrow.compute as pc

    from hyperspace_tpu_torch.execution.columnar import read_parquet
    from hyperspace_tpu_torch.ops import index_build, kernels

    files = sorted(os.path.join(li_dir, f) for f in os.listdir(li_dir))
    full = read_parquet(files, ["l_orderkey", "l_shipdate"], "cuda")
    shipdate = pc.field("l_shipdate")
    range_x = read_parquet(files, ["l_shipdate"], "cuda",
                           filters=(shipdate >= RANGE_LO) & (shipdate <= RANGE_HI))
    cut_x = read_parquet(files, ["l_shipdate"], "cuda", filters=shipdate > CUTOFF)
    orderkey = full.column("l_orderkey")
    folded = kernels.fold_u32(orderkey.data, orderkey.dtype).contiguous()
    bids = index_build.bucket_ids_for(full, ["l_orderkey"], 32)
    od_files = sorted(os.path.join(od_dir, f) for f in os.listdir(od_dir))
    return {
        "orderdate_file": read_parquet(od_files[:1], ["o_orderdate"], "cuda")
        .column("o_orderdate").data,
        "orderdate_full": read_parquet(od_files, ["o_orderdate"], "cuda")
        .column("o_orderdate").data,
        "shipdate_full": full.column("l_shipdate").data,
        "shipdate_range": range_x.column("l_shipdate").data,
        "shipdate_cutoff": cut_x.column("l_shipdate").data,
        "folded_orderkey": folded,
        "bids32": bids,
    }


def time_kernels(inputs: dict, launches: dict, errors: dict):
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck
    from hyperspace_tpu_torch.shapes import padded_length

    lo, hi = (RANGE_LO - EPOCH).days, (RANGE_HI - EPOCH).days
    cut = (CUTOFF - EPOCH).days

    def result(r):
        """A wrapper's result as one tensor: (None, ids) -> ids and
        (min, max) -> stacked."""
        if not isinstance(r, tuple):
            return r
        r = [t for t in r if t is not None]
        return r[0] if len(r) == 1 else torch.stack(r)

    pending = []  # (entry, call): profiled once every host-paced time is read

    def entry(name, x_desc, fn, plain, library, n_bytes, n_ops):
        check_equal(name, result(fn()), result(plain()), errors)
        b, by = bound(n_bytes, n_ops)
        ms, spread = time_ms(fn, rounds=3)
        e = {"name": name, "route": "cuda",
             "source": f"hyperspace_tpu_torch/csrc/{ck.SOURCES[name]}",
             "replaces": REPLACES[name],
             "launches": sum(by_path[name] for by_path in launches.values()),
             "launches_by_path": {path: by_path[name] for path, by_path in launches.items()},
             "max_abs_err": errors.get(name, 0.0),
             "ms": ms, "ms_spread": spread,
             "plain_ms": time_ms(plain), "bound_ms": b, "bound_by": by,
             "library_ms": None if library is None else time_ms(library), "input": x_desc}
        pending.append((e, fn))
        return e

    def range_entry(x, tag):
        n = x.shape[0]
        return entry("range_mask", f"l_shipdate int32[{n}] ({tag})",
                     lambda: ck.range_mask(x, lo, hi),
                     lambda: ck.range_mask_plain(x, lo, hi),
                     lambda: (x >= lo) & (x <= hi), n * 5, n * 2)

    def compare_entry(x, tag):
        n = x.shape[0]
        return entry("compare_mask", f"l_shipdate int32[{n}] ({tag})",
                     lambda: ck.compare_mask(x, ">", cut),
                     lambda: ck.compare_mask_plain(x, ">", cut),
                     lambda: x > cut, n * 5, n)

    def minmax_entry(x, tag):
        # The call the MinMax sketch makes (ops/sketches.py minmax_values):
        # the kernel's output words, with the sentinel rule of the JAX
        # package's length classes. Beside it, the public (min, max) call,
        # which adds two 0-d views.
        n = x.shape[0]
        pad = padded_length(n) != n or ck.pallas_pads(n)
        e = entry("masked_minmax", f"o_orderdate int32[{n}], no mask ({tag}); "
                  "masked_minmax_words as minmax_values calls it",
                  lambda: ck.masked_minmax_words(x, None, pad),
                  lambda: ck.masked_minmax_words_plain(x, None, pad),
                  lambda: torch.aminmax(x), n * 4 + 16, n * 2)
        e["public_call_ms"], _ = time_ms(lambda: ck.masked_minmax(x), rounds=3)
        return e

    folded, bids = inputs["folded_orderkey"], inputs["bids32"]
    n = folded.shape[0]
    main_path = [
        entry("hash_bucket", f"folded l_orderkey int32[{n}], 32 buckets",
              lambda: ck.hash_bucket([folded], 32),
              lambda: ck.hash_bucket_plain([folded], 32),
              None, n * 8, n * 12),
        entry("bucket_histogram", f"bucket ids int32[{n}], 32 buckets",
              lambda: ck.bucket_histogram(bids, 32),
              lambda: ck.bucket_histogram_plain(bids, 32),
              lambda: torch.bincount(bids, minlength=32), n * 4 + 32 * 4, n * 2),
        range_entry(inputs["shipdate_range"], "range query's rows"),
        compare_entry(inputs["shipdate_cutoff"], "cutoff query's rows"),
        minmax_entry(inputs["orderdate_file"], "one orders file"),
    ]
    full = [range_entry(inputs["shipdate_full"], "all rows"),
            compare_entry(inputs["shipdate_full"], "all rows"),
            minmax_entry(inputs["orderdate_full"], "all orders rows")]
    copy = copy_rate(inputs["shipdate_full"])
    host = host_path_us(inputs["orderdate_file"])
    # The profiler comes last: after a profiling session every host path
    # in the process runs slower (a plain allocation too), which would
    # inflate the host-paced times above.
    for e, fn in pending:
        prof = device_profile(fn, name=e["name"])
        if e["name"] in ONE_KERNEL_A_CALL and (prof["kernels_per_call"] != 1
                                               or prof["memsets_per_call"]
                                               or prof["copies_per_call"]):
            raise AssertionError(f"{e['name']} ({e['input']}): a call put "
                                 f"{prof['device_records']} on the stream, not one kernel")
        e.update(device_ms=prof["device_ms"], kernels_per_call=prof["kernels_per_call"],
                 memsets_per_call=prof["memsets_per_call"],
                 device_records=prof["device_records"],
                 profile_sessions=prof["profile_sessions"],
                 discarded_sessions=prof["discarded_sessions"])
    return main_path, full, copy, host


def host_path_us(x, iters: int = 3000) -> dict:
    """Microseconds per call on the int32 column x, median of 5 rounds,
    synchronized only between rounds (at this size the card's work per
    call is shorter than the host's, so the host sets the pace). The
    pieces of a wrapper's host path: host clock over ``iters`` calls. Whole
    calls beside their library calls: the host clock and CUDA events
    around the same loop, over 20 calls (as ``ms``) and over ``iters``."""
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    dev = x.get_device()
    out = x.new_empty(4)
    launch = ck._entry("masked_minmax")
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = ck._scratch(dev, stream)
    n = x.shape[0]
    pieces = {
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.empty(n, bool)": lambda: torch.empty(n, dtype=torch.bool, device=x.device),
        "x.new_empty(4)": lambda: x.new_empty(4),
        "two 0-d views": lambda: (out[0], out[1]),
        "ctypes call with the launch": lambda: launch(x.data_ptr(), None, 0, n, 1,
                                                      out.data_ptr(), scratch, stream),
    }
    calls = {
        "masked_minmax_words": lambda: ck.masked_minmax_words(x, None, True),
        "masked_minmax": lambda: ck.masked_minmax(x),
        "torch.aminmax": lambda: torch.aminmax(x),
        "range_mask": lambda: ck.range_mask(x, 9000, 9030),
        "(x >= lo) & (x <= hi)": lambda: (x >= 9000) & (x <= 9030),
    }

    def median_of_5(fn, k):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        host, event = [], []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(k):
                fn()
            stop.record()
            host.append((time.perf_counter() - t0) / k * 1e6)
            torch.cuda.synchronize()
            event.append(start.elapsed_time(stop) / k * 1e3)
        return sorted(host)[2], sorted(event)[2]

    result = {name: median_of_5(fn, iters)[0] for name, fn in pieces.items()}
    for name, fn in calls.items():
        for k in (20, iters):
            result[f"{name}: host, {k} calls"], result[f"{name}: events, {k} calls"] = \
                median_of_5(fn, k)
    log("us a call: " + "; ".join(f"{k} {v:.2f}" for k, v in result.items()))
    return result


def copy_rate(x) -> dict:
    """The memory rate this card reaches in practice: a device-to-device
    copy of the column (torch's copy_), read and written once, timed as
    the kernels are."""
    import torch

    dst = torch.empty_like(x)
    copy_ms = time_ms(lambda: dst.copy_(x))
    n_bytes = 2 * x.numel() * x.element_size()
    out = {"ms": copy_ms, "bytes": n_bytes, "bytes_per_s": n_bytes / (copy_ms / 1e3)}
    log(f"copy of the column: {copy_ms:.4f} ms, {out['bytes_per_s'] / 1e12:.3f} TB/s")
    return out


# ---------------------------------------------------------------------------
# Phase 7: where the time goes.
# ---------------------------------------------------------------------------

# Phase 7 only measures: it checks no answer and no launch. It is left out
# when the script's clock has passed this many seconds at its start, so that
# a slow host ends inside the 1200 s limit. On H100 hosts the check has come
# at 823-899 s since the faults and cluster paths were added, and phase 7
# took about 50 s there, what follows it (the mutations path and the card
# against the CPU) 75-86 s: from 900 s, those at 1.3 times their durations
# end near 1065 s.
BREAKDOWN_LATE_S = 900

def breakdown(session, hs, queries, li_dir: str, od_dir: str, pt_dir: str,
              n_od: int) -> dict:
    """Host timers around the layers of rebuilds of li_ship_idx, li_pk_idx,
    pt_idx, od_skip and od_bloom and of the cutoff, range, skipping, bloom,
    Q3 and Q17 queries (each timer synchronizes the device; "index log
    reads" is the session's cached index listing, every call of it), the
    peak device memory
    of the timed run, then torch.profiler over the same work for the
    device's own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hyperspace_tpu_torch import (BloomFilterSketch, DataSkippingIndexConfig,
                                      IndexConfig, IndexConstants, MinMaxSketch)
    from hyperspace_tpu_torch.actions import create, create_skipping
    from hyperspace_tpu_torch.execution import buffer_pool, executor, spmd
    from hyperspace_tpu_torch.execution.columnar import Table
    from hyperspace_tpu_torch.index.manager import CachingIndexCollectionManager
    from hyperspace_tpu_torch.ops import cuda_kernels, index_build, kernels, sketches
    from hyperspace_tpu_torch.rules import data_skipping_rule

    def drop(name, buckets=8):
        hs.delete_index(name)
        hs.vacuum_index(name)
        session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, buckets)

    def rebuild(src, name, indexed, included):
        return lambda: hs.create_index(session.read.parquet(src),
                                       IndexConfig(name, indexed, included))

    def cold():
        # Each query's timed and profiled runs read their files: the buffer
        # pool is emptied first (the io path times warm runs).
        buffer_pool.get_pool().clear()

    def run(name, indexed):
        (session.enable_hyperspace if indexed else session.disable_hyperspace)()
        try:
            return queries[name].to_arrow()
        finally:
            session.disable_hyperspace()

    od = session.read.parquet(od_dir)
    skip_config = DataSkippingIndexConfig("od_skip", [MinMaxSketch("o_orderdate")])
    bloom_config = DataSkippingIndexConfig("od_bloom", [BloomFilterSketch(
        "o_orderkey", expected_items=max(n_od // ORDERS_PARTS, 100_000))])
    sketch_spans = [(create_skipping, "read_parquet", "read file -> device"),
                    (sketches, "to_host", "device -> host"),
                    (create_skipping, "write_sketch_table", "write sketch table")]
    covering_spans = [(create, "read_relation_files", "read source -> device"),
                      (index_build, "build_sorted_buckets", "hash + sort + histogram (device)"),
                      (Table, "to_host", "device -> host"),
                      (create, "write_bucket_files", "write bucket parquet files")]
    work = [("build li_ship_idx", lambda: drop("li_ship_idx"),
             rebuild(li_dir, "li_ship_idx", ["l_shipdate"], ["l_orderkey", "l_extendedprice"]),
             covering_spans),
            ("build li_pk_idx", lambda: drop("li_pk_idx", 32),
             rebuild(li_dir, "li_pk_idx", ["l_partkey"], ["l_quantity", "l_extendedprice"]),
             covering_spans),
            ("build pt_idx", lambda: drop("pt_idx", 32),
             rebuild(pt_dir, "pt_idx", ["p_partkey"], ["p_brand", "p_container"]),
             covering_spans),
            ("build od_skip", lambda: drop("od_skip"),
             lambda: hs.create_index(od, skip_config),
             sketch_spans + [(cuda_kernels, "masked_minmax_words",
                              "minmax reduction (device)")]),
            ("build od_bloom", lambda: drop("od_bloom"),
             lambda: hs.create_index(od, bloom_config),
             sketch_spans + [(sketches, "bloom_bits", "bloom hash + scatter + pack (device)")])]
    # The SPMD dispatch's own stages (every main-path query whose leaf fits
    # maxChunkRows takes it on the card): the body's filter masks, its
    # joins, its partials and merges, the sample sort.
    spmd_spans = [(spmd, "eval_predicate_mask", "filter (device)"),
                  (spmd, "_broadcast_probe", "join: broadcast probe (device, dispatch)"),
                  (spmd, "_exchange_join", "join: exchange (device, dispatch)"),
                  (spmd._AggSpec, "partials", "aggregate (device)"),
                  (spmd, "_grouped_partials", "aggregate (device)"),
                  (spmd, "_merge_global", "aggregate (device)"),
                  (spmd, "_merge_grouped", "aggregate (device)"),
                  (spmd, "_sample_sort", "sort + limit (device)")]
    join_spans = [(executor, "_probe_keys", "join: keys, null drop, composite or sort (device)"),
                  (kernels, "merge_join_indices", "join: bounds + expansion (device)"),
                  (executor, "_gather_join_output", "join: gathers (device)"),
                  (executor, "_execute_aggregate", "aggregate (device)"),
                  (executor, "_execute_sort", "sort + limit (device)"),
                  (executor, "_execute_limit", "sort + limit (device)")]
    for name in ("cutoff", "range", "skipping", "bloom", "q3", "q17"):
        for indexed in (True, False):
            spans_of = [(executor, "read_parquet", "parquet read -> device"),
                        (executor, "read_relation_files", "parquet read -> device"),
                        (executor, "_filter_table", "filter (device)"),
                        (Table, "to_arrow", "result -> host arrow")] + spmd_spans
            if name in ("q3", "q17"):
                spans_of += join_spans
            if indexed:
                spans_of.append((CachingIndexCollectionManager, "get_indexes",
                                 "index log reads (host)"))
            if indexed and name in ("skipping", "bloom"):
                spans_of.append((data_skipping_rule, "evaluate_sketch_predicate",
                                 "sketch probe (host)"))
            work.append((f"{name} {'indexed' if indexed else 'scanned'}", cold,
                         lambda n=name, i=indexed: run(n, i), spans_of))
    out = {}
    for label, prep, fn, patches in work:
        with Spans(patches, outermost=True) as timer:
            if prep:
                prep()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
        spans = timer.spans
        # The profiled run is timed on its own: the busy share compares the
        # device's time with the wall time of the same run.
        if prep:
            prep()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        # Device-side records only (kernels and copies): an operator's own
        # entry repeats the time of the kernels it launched, and CUPTI's
        # buffer requests are the profiler's overhead.
        device = sorted(((e.key[:160], e.self_device_time_total / 1e6)
                         for e in prof.key_averages()
                         if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
                         and e.key != "Activity Buffer Request"),
                        key=lambda kv: -kv[1])
        busy = sum(t for _, t in device)
        out[label] = {"wall_s": wall, "spans_s": dict(spans), "peak_bytes": peak,
                      "other_s": wall - sum(spans.values()),
                      "profiled_wall_s": prof_wall,
                      "device_s": busy if device else None,
                      "device_busy_share": busy / prof_wall if device else None,
                      "top_device_ops": device[:6]}
        log(f"breakdown {label}: wall {wall:.3f} s; peak {peak / 2 ** 30:.3f} GiB; " + "; ".join(
            f"{k} {v:.3f}" for k, v in spans.items()) +
            (f"; device busy {busy:.3f} s of {prof_wall:.3f} s profiled "
             f"({busy / prof_wall:.1%})" if device else "; device time not measured"))
    return out


def _stage_nodes(plan) -> list:
    """The plan's nodes that execute as a stage of their own, in pre-order:
    a scan under a Filter is read by the Filter's stage."""
    out = [plan.node_name]
    for child in plan.children:
        if plan.node_name == "Filter" and not child.children:
            continue
        out.extend(_stage_nodes(child))
    return out


def _dispatched_stage_nodes(plan) -> list:
    """The stages of a plan whose Aggregate takes the SPMD dispatch: the
    nodes down to the Aggregate, then inside its ``spmd.dispatch`` the
    stream leaf's read (Q3's is not narrowed by its filter, so it is a
    stage of its own) and each join's other side, bottom-up. The chain's
    filters, projects and joins run inside the program."""
    if plan.node_name != "Aggregate":
        return [plan.node_name] + [n for c in plan.children
                                   for n in _dispatched_stage_nodes(c)]
    node, joins = plan.child, []
    while node.children:
        if node.node_name == "Join":
            joins.append(node)
        node = node.children[0]
    return ["Aggregate", node.node_name] + [n for j in reversed(joins)
                                             for n in _stage_nodes(j.right)]


def check_q3_trace(trace, optimized) -> int:
    """The cold Q3's span tree: the query root over plan.normalize,
    rewrite.index_rules and one exec.stage span per executed plan node (in
    plan order; with the SPMD dispatch, which a CUDA session takes by
    default, the stages of :func:`_dispatched_stage_nodes` under one
    spmd.dispatch span), with an io.read span under each scan's stage.
    Returns the span count."""
    from hyperspace_tpu_torch.telemetry import span_names as SN

    root = trace.root
    if root is None or root.name != SN.QUERY:
        raise AssertionError(f"telemetry: the trace's root is {root}, not a query span")
    by_id = {s.span_id: s for s in trace.spans}
    kids = {}
    for s in trace.spans:
        kids.setdefault(s.parent_id, []).append(s)
    top = [s.name for s in kids.get(root.span_id, [])]
    for name in (SN.PLAN_NORMALIZE, SN.INDEX_REWRITE, SN.EXEC_STAGE):
        if name not in top:
            raise AssertionError(f"telemetry: no {name} span under the query root: {top}")
    stages = []

    def walk(span):
        if span.name == SN.EXEC_STAGE:
            stages.append(span.attrs.get("node"))
        for k in kids.get(span.span_id, []):
            walk(k)

    walk(root)
    dispatched = trace.find(SN.SPMD_DISPATCH)
    want = _dispatched_stage_nodes(optimized) if dispatched else _stage_nodes(optimized)
    if len(dispatched) > 1:
        raise AssertionError(f"telemetry: {len(dispatched)} spmd.dispatch spans in Q3")
    if stages != want:
        raise AssertionError(f"telemetry: exec.stage spans {stages}, plan nodes {want}")
    reads = trace.find(SN.IO_READ)
    scans = sum(1 for leaf in optimized.collect_leaves())
    if len(reads) < scans or any(by_id[r.parent_id].name != SN.EXEC_STAGE for r in reads):
        raise AssertionError(f"telemetry: {len(reads)} io.read spans for {scans} scans, "
                             f"not each under a stage")
    return len(trace.spans)


def trace_arms(session, df, runs: int, cold: bool) -> dict:
    """Wall seconds of ``runs`` runs of ``df`` with tracing off and as many
    with it on, the settings alternating run by run (each pair in the
    other order than the last, so a drift falls on both); ``cold`` empties
    the buffer pool before each run. Every answer must equal the first."""
    import torch

    from hyperspace_tpu_torch.execution import buffer_pool
    from hyperspace_tpu_torch.telemetry.constants import TelemetryConstants as TC

    want = df.to_arrow()
    secs = {"off": [], "on": []}
    for i in range(runs):
        for arm in ("off", "on") if i % 2 == 0 else ("on", "off"):
            session.conf.set(TC.TRACE_ENABLED, "true" if arm == "on" else "false")
            if cold:
                buffer_pool.get_pool().clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = df.to_arrow()
            torch.cuda.synchronize()
            secs[arm].append(time.perf_counter() - t)
            if not same_bytes(got, want):
                raise AssertionError(f"telemetry: tracing {arm} gives another answer")
    off, on = statistics.median(secs["off"]), statistics.median(secs["on"])
    return {"untraced_median_s": off, "traced_median_s": on,
            "overhead_pct": (on - off) / off * 100.0,
            "untraced_s": secs["off"], "traced_s": secs["on"]}


def run_telemetry_path(session, hs, queries: dict, results: dict) -> None:
    """The telemetry path's first part, on the main path's session: the
    traced-against-untraced medians of indexed Q3 and the cutoff filter
    indexed, warm and cold, alternating the switch run by run; one cold
    traced Q3's span tree; the report surfaces."""
    from hyperspace_tpu_torch.execution import buffer_pool
    from hyperspace_tpu_torch.telemetry import flight_recorder
    from hyperspace_tpu_torch.telemetry.constants import TelemetryConstants as TC

    t0 = time.perf_counter()
    out = results["telemetry"] = {"runs": TELEMETRY_RUNS, "cold_runs": TELEMETRY_COLD_RUNS}
    session.enable_hyperspace()
    try:
        for key, runs, cold in (("overhead", TELEMETRY_RUNS, False),
                                ("cold_overhead", TELEMETRY_COLD_RUNS, True)):
            arms = out[key] = {}
            for name in ("q3", "cutoff"):
                arms[name] = a = trace_arms(session, queries[name], runs, cold)
                log(f"telemetry: {name} {'cold' if cold else 'warm'} median untraced "
                    f"{a['untraced_median_s']:.5f} s, traced {a['traced_median_s']:.5f} s "
                    f"({a['overhead_pct']:+.2f}%)")
        session.conf.set(TC.TRACE_ENABLED, "true")

        # One cold traced Q3 (the buffer pool emptied: its scans read),
        # with the events it rang into the flight recorder (emitted
        # whether or not a trace is open).
        buffer_pool.get_pool().clear()
        session._last_trace = None
        events = flight_recorder.get_recorder().stats()["event_total"]
        queries["q3"].to_arrow()
        out["q3_cold_events"] = flight_recorder.get_recorder().stats()["event_total"] - events
        trace = hs.last_trace()
        if trace is None:
            raise AssertionError("telemetry: a traced Q3 left no trace")
        out["q3_cold_spans"] = check_q3_trace(trace, queries["q3"].optimized_plan())
        out["q3_cold_ms"] = trace.duration_s() * 1000.0

        report = hs.explain_analyze(queries["q3"])
        if "== Explain Analyze ==" not in report or "exec.stage" not in report:
            raise AssertionError(f"telemetry: explain_analyze(Q3) rendered {report[:400]}")
        text = hs.metrics_text()
        if "hst_trace_sampled_total" not in text or not text.endswith("# EOF\n"):
            raise AssertionError("telemetry: metrics_text() holds no trace.sampled")
        dump = json.loads(hs.dump_flight_recorder())
        health = hs.health()
        if "healthy" not in health or not dump["otherData"]["trace_ids"]:
            raise AssertionError("telemetry: health() or the flight recorder is empty")
        out["surfaces"] = {"explain_analyze_lines": len(report.splitlines()),
                           "metrics_text_bytes": len(text),
                           "flight_recorder_traces": len(dump["otherData"]["trace_ids"]),
                           "health": {k: health[k] for k in ("healthy", "count", "errors")}}
    finally:
        session.conf.set(TC.TRACE_ENABLED, "true")
        session.disable_hyperspace()
    out["seconds"] = time.perf_counter() - t0
    log(f"telemetry: cold Q3 {out['q3_cold_spans']} spans; {out['seconds']:.1f} s")


def captured_kernels(path: str) -> dict:
    """Label -> calls of each CAPTURED_KERNELS kernel among the CUDA kernel
    events of an exported chrome trace; fails on a trace with no CUDA
    kernel event."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    if not names:
        raise AssertionError(f"telemetry: the capture {path} holds no CUDA kernel event")
    return {label: sum(1 for n in names if all(part in n for part in parts))
            for label, parts in CAPTURED_KERNELS.items()}


def telemetry_capture(root: str, session, hs, queries: dict, od_dir: str, pt_dir: str,
                      results: dict) -> None:
    """The telemetry path's second part, after every host-paced timing
    (a profiling session slows the process's host path for good): the
    armed one-shot capture (telemetry.profiler.enabled and .dir) of a cold
    range query, then one capture (telemetry.trace.profile_into, the same
    exporter) around a cold cutoff query and the rebuilds of pt_idx and
    od_skip. The captures must hold every kernel of the repo."""
    import glob

    from hyperspace_tpu_torch import (DataSkippingIndexConfig, IndexConfig, IndexConstants,
                                      MinMaxSketch)
    from hyperspace_tpu_torch.execution import buffer_pool
    from hyperspace_tpu_torch.telemetry import trace as _trace
    from hyperspace_tpu_torch.telemetry.constants import TelemetryConstants as TC

    t0 = time.perf_counter()
    out = results["telemetry"]
    armed_dir = os.path.join(root, "telemetry_capture", "armed")
    session.conf.set(TC.PROFILER_ENABLED, "true")
    session.conf.set(TC.PROFILER_DIR, armed_dir)
    _trace.reset_profiler()
    session.enable_hyperspace()
    try:
        buffer_pool.get_pool().clear()
        queries["range"].to_arrow()
        queries["range"].to_arrow()  # one-shot: not captured
    finally:
        session.conf.set(TC.PROFILER_ENABLED, "false")
        session.disable_hyperspace()
    armed = glob.glob(os.path.join(armed_dir, "*.json"))
    if len(armed) != 1:
        raise AssertionError(f"telemetry: the one-shot capture wrote {len(armed)} files")
    with _trace.profile_into(os.path.join(root, "telemetry_capture", "work")) as work:
        session.enable_hyperspace()
        try:
            buffer_pool.get_pool().clear()
            queries["cutoff"].to_arrow()
        finally:
            session.disable_hyperspace()
        hs.delete_index("pt_idx")
        hs.vacuum_index("pt_idx")
        session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 32)
        hs.create_index(session.read.parquet(pt_dir),
                        IndexConfig("pt_idx", ["p_partkey"], ["p_brand", "p_container"]))
        hs.delete_index("od_skip")
        hs.vacuum_index("od_skip")
        hs.create_index(session.read.parquet(od_dir),
                        DataSkippingIndexConfig("od_skip", [MinMaxSketch("o_orderdate")]))
    check_minmax_sketch(hs, od_dir)
    seen = {"armed": captured_kernels(armed[0]), "work": captured_kernels(work)}
    missing = [label for label in CAPTURED_KERNELS
               if not any(counts[label] for counts in seen.values())]
    if seen["armed"]["mask_kernel (range)"] == 0:
        missing.append("mask_kernel (range) in the armed capture")
    if missing:
        raise AssertionError(f"telemetry: the captures miss {missing}: {seen}")
    out["captured_kernels"] = seen
    out["capture_s"] = time.perf_counter() - t0
    out["seconds"] += out["capture_s"]
    log(f"telemetry: captured {seen}; {out['capture_s']:.1f} s")


def telemetry_summary(tm: dict, launches: dict, card: str) -> dict:
    return {**{key: {name: {k: v[k] for k in ("untraced_median_s", "traced_median_s",
                                              "overhead_pct")}
                     for name, v in tm[key].items()}
               for key in ("overhead", "cold_overhead")},
            "runs": tm["runs"], "cold_runs": tm["cold_runs"],
            "q3_cold_spans": tm["q3_cold_spans"], "q3_cold_ms": tm["q3_cold_ms"],
            "q3_cold_events": tm["q3_cold_events"],
            "captured_kernels": sorted(label for label in CAPTURED_KERNELS
                                       if any(c[label] for c in tm["captured_kernels"].values())),
            "capture_s": tm["capture_s"], "seconds": tm["seconds"], "launches": launches,
            "card": card}


def serving_summary(sv: dict, launches: dict, card: str) -> dict:
    """The serving line: members, batches, shared scans and their hits,
    member reruns, rejections and mask-kernel launches of each wave; the
    result cache's hits and misses by tier and its device bytes; the
    path's rejected submissions (SLO admission included);
    each wave's wall time against its 16 serial runs; member latency p50
    and p99; the program bank's counters' delta over the path; the path's
    seconds; the card."""
    waves = {}
    for name in ("scanned", "indexed"):
        w = sv[name]
        waves[name] = {"members": w["stats"]["batched_queries"], "batches": w["stats"]["batches"],
                       "shared_scans": w["stats"]["shared_scans"],
                       "shared_scan_hits": w["stats"]["shared_scan_hits"],
                       "member_fallbacks": w["stats"]["member_fallbacks"],
                       "rejected": w["stats"]["rejected"],
                       "mask_launches": w["stats"]["mask_launches"], "wave_s": w["wave_s"],
                       "serial_s": w["serial_s"], "p50_s": w["p50_s"], "p99_s": w["p99_s"]}
    cache = {name: {"wave_s": p["wave_s"], "p50_s": p["p50_s"], "p99_s": p["p99_s"],
                    **{k: p["result_cache"][k] for k in (
                        "device_hits", "host_hits", "spill_hits", "misses", "demotions",
                        "device_nbytes", "host_nbytes")}}
             for name, p in sv["cache"].items()}
    return {"waves": waves, "result_cache": cache, "rejected": sv["rejected"],
            "launches": launches, "seconds": sv["seconds"], "bank": sv["bank"], "card": card}


# ---------------------------------------------------------------------------
# The artifacts path: the kernel libraries through the lake's artifact store.
# ---------------------------------------------------------------------------

# The artifacts path's own small lake (lineitem 300,000 rows): its work
# launches every kernel once a library is loaded, in seconds.
ARTIFACTS_SCALE = 0.05
# The kernel whose blob the second child finds corrupt.
ARTIFACTS_CORRUPT = "compare_mask"
ARTIFACTS_CONF = {"hyperspace.tpu.artifacts.enabled": "true",
                  "hyperspace.tpu.artifacts.usage.flushMs": "0"}


def artifacts_work(session, li_dir: str, od_dir: str) -> dict:
    """The cutoff and range filters (compare_mask, range_mask), a covering
    index build (hash_bucket, bucket_histogram) and a MinMax sketch build
    (masked_minmax) on the artifacts lake, and an indexed point query and
    skipping query over them. Returns name -> arrow table and the first
    query's seconds."""
    import torch

    from hyperspace_tpu_torch import (DataSkippingIndexConfig, Hyperspace, IndexConfig,
                                      IndexConstants, MinMaxSketch, col)
    hs = Hyperspace(session)
    li = session.read.parquet(li_dir)
    od = session.read.parquet(od_dir)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["cutoff"] = li.filter(col("l_shipdate") > CUTOFF).select(
        "l_orderkey", "l_extendedprice").to_arrow()
    torch.cuda.synchronize()
    first_query_s = time.perf_counter() - t0
    out["range"] = li.filter(col("l_shipdate").between(RANGE_LO, RANGE_HI)).select(
        "l_orderkey", "l_extendedprice").to_arrow()
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 8)
    hs.create_index(li, IndexConfig("art_li_idx", ["l_orderkey"], ["l_extendedprice"]))
    hs.create_index(od, DataSkippingIndexConfig("art_od_skip", [MinMaxSketch("o_orderdate")]))
    session.enable_hyperspace()
    try:
        out["point"] = li.filter(col("l_orderkey") == 7).select("l_extendedprice").to_arrow()
        out["skipping"] = od.filter(col("o_orderdate").between(SKIP_LO, SKIP_HI)).select(
            "o_orderkey", "o_orderdate").to_arrow()
    finally:
        session.disable_hyperspace()
    return {name: sorted_table(t) for name, t in out.items()}, first_query_s


def check_store_kernels(errors: dict) -> int:
    """Every kernel against its plain version at phase 2's sizes (1, 4,097
    and 1,000,003 rows, and 8,650,755 for the masks), on a reduced grid of
    phase 2's parameters: the libraries this process loaded from the
    artifact store."""
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck
    from hyperspace_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    checks = 0
    for n in (1, 4097, 1_000_003, 8_650_755):
        checks += check_masks(n, g, errors)
        if n > 1_000_003:
            continue
        words = [kernels.to_words(torch.randint(0, 2 ** 32, (n + 1,), generator=g,
                                                device=dev, dtype=torch.int64))
                 for _ in range(8)]
        for ncols, nb in ((1, 37), (8, 200)):
            for offset in (0, 1):
                cols = [w[offset:offset + n] for w in words[:ncols]]
                h, b = ck.hash_bucket(cols, nb, with_hash=True)
                ph, pb = ck.hash_bucket_plain(cols, nb, with_hash=True)
                check_equal("hash_bucket", h, ph, errors)
                check_equal("hash_bucket", b, pb, errors)
                checks += 2
        for nb in (37, 12289):
            bids = torch.randint(-1, nb + 2, (n + 1,), generator=g, device=dev,
                                 dtype=torch.int64).to(torch.int32)
            for offset in (0, 1):
                x = bids[offset:offset + n]
                check_equal("bucket_histogram", ck.bucket_histogram(x, nb),
                            ck.bucket_histogram_plain(x, nb), errors)
                checks += 1
        col = torch.randn(n + 1, generator=g, device=dev) * 100
        col[n // 2] = float("nan")
        valid = torch.rand(n + 1, generator=g, device=dev) < 0.5
        ints = torch.randint(-2 ** 31, 2 ** 31, (n + 1,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
        for offset in (0, 1):
            for x in (col[offset:offset + n], ints[offset:offset + n]):
                for v in (None, valid[offset:offset + n]):
                    for pad in (None, True):
                        got = ck.masked_minmax_words(x, v, pad)
                        want = ck.masked_minmax_words_plain(x, v, pad)
                        torch.cuda.synchronize()
                        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                            raise AssertionError(f"masked_minmax from the store: "
                                                 f"{got.view(torch.int32).tolist()} != plain "
                                                 f"{want.view(torch.int32).tolist()}")
                        errors["masked_minmax"] = errors.get("masked_minmax", 0.0)
                        checks += 1
    return checks


def artifacts_child(store_dir: str, build_root: str, data: dict, out_path: str,
                    kill_at_write: bool) -> None:
    """One fresh process on the artifact store ``store_dir`` (its indexes
    in a system path of its own): an empty build directory,
    ``artifacts.preload.enabled``, ``warmup()``, the work of
    :func:`artifacts_work` and, in the first child, every kernel against
    its plain version. Writes its record to ``out_path``; with
    ``kill_at_write``, then arms ``artifacts.write`` with a kill and
    publishes a probe, dying at the point."""
    import pyarrow as pa
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.artifacts import manager, store
    from hyperspace_tpu_torch.ops import cuda_kernels as ck
    from hyperspace_tpu_torch.robustness import faults

    ck.BUILD_ROOT = build_root
    events0 = events_total()
    conf = dict(ARTIFACTS_CONF, **{"hyperspace.tpu.artifacts.preload.enabled": "true",
                                   "hyperspace.tpu.artifacts.dir": store_dir})
    torch.cuda.init()
    t0 = time.perf_counter()
    session = ht.Session(system_path=os.path.join(os.path.dirname(out_path), "indexes"),
                         device="cuda", conf=conf)
    session_s = time.perf_counter() - t0
    hs = ht.Hyperspace(session)
    t0 = time.perf_counter()
    warm = hs.warmup()
    warmup_s = session_s + time.perf_counter() - t0
    ck.reset_launches()
    tables, first_query_s = artifacts_work(session, data["li"], data["od"])
    launches = dict(ck.LAUNCHES)
    for name, t in tables.items():
        with pa.OSFile(os.path.join(os.path.dirname(out_path), f"child_{name}.arrow"),
                       "wb") as f:
            with pa.ipc.new_file(f, t.schema) as w:
                w.write_table(t)
    errors: dict = {}
    checks = 0 if kill_at_write else check_store_kernels(errors)
    record = {"session_s": session_s, "warmup_s": warmup_s, "warmup": warm,
              "first_query_s": first_query_s, "stats": hs.artifact_stats(),
              "builds": dict(ck.BUILD_STATS), "built": sorted(ck.BUILD_LOG),
              "compile_events": len(recorded_events(events0, "KernelCompileEvent")),
              "launches": launches, "checks": checks, "errors": errors,
              "corruptions": faults.stats()["artifact_corruptions"]}
    with open(out_path, "w") as f:
        json.dump(record, f, default=str)
    if kill_at_write:
        session.conf.set("hyperspace.tpu.robustness.faults.artifacts.write", "kill:nth=1")
        probe = store.key_fields("write-probe", "none")
        with faults.scope_for(session.hs_conf):
            manager.manager_for(session).store.publish(probe, b"probe")
        raise AssertionError("the armed artifacts.write kill did not fire")


def _run_artifacts_child(root: str, lake: str, data: dict, name: str,
                         kill_at_write: bool) -> tuple:
    build_root = os.path.join(root, f"{name}_build")
    os.makedirs(build_root)
    out_dir = os.path.join(root, name)
    os.makedirs(out_dir)
    out_path = os.path.join(out_dir, "record.json")
    store_dir = os.path.join(lake, "_hst_artifacts")
    code = (f"import chip_smoke; chip_smoke.artifacts_child({store_dir!r}, {build_root!r}, "
            f"{data!r}, {out_path!r}, {kill_at_write!r})")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    if not os.path.exists(out_path) or (proc.returncode != 0 and not kill_at_write):
        raise AssertionError(f"artifacts {name}: child failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    with open(out_path) as f:
        record = json.load(f)
    import pyarrow as pa
    tables = {}
    for t in os.listdir(out_dir):
        if t.startswith("child_"):
            with pa.memory_map(os.path.join(out_dir, t)) as src:
                tables[t[len("child_"):-len(".arrow")]] = pa.ipc.open_file(src).read_all()
    record["process_s"] = seconds
    return record, tables, proc.returncode


def run_artifacts_path(root: str, results: dict, errors: dict) -> None:
    """Phase 2b. The main process publishes phase 1's five libraries to an
    artifacts lake. A child with an empty build directory preloads them,
    runs no nvcc, launches all five on the artifacts work (answers equal
    this process's) and holds each against its plain version. One blob is
    then corrupted: a second child quarantines it, builds that kernel alone
    with nvcc, and dies at an armed ``artifacts.write``; ``compact()``
    sweeps the temp it left."""
    import torch

    import hyperspace_tpu_torch as ht
    from hyperspace_tpu_torch.artifacts import manager, store
    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    t_path = time.perf_counter()
    base = os.path.join(root, "artifacts")
    li_dir, od_dir, _pt, n_li, n_od = make_tpch(os.path.join(base, "data"), ARTIFACTS_SCALE)
    lake = os.path.join(base, "lake")
    session = ht.Session(system_path=lake, device="cuda", conf=dict(ARTIFACTS_CONF))
    mgr = manager.manager_for(session)
    landed = mgr.publish_kernels()
    if landed != len(ck.SOURCES) or mgr.stats()["blobs"] != len(ck.SOURCES):
        raise AssertionError(f"artifacts: {landed} blobs published, {mgr.stats()['blobs']} "
                             f"resident, for {len(ck.SOURCES)} kernels")
    blob_bytes = mgr.stats()["resident_bytes"]
    ck.reset_launches()
    want, main_first_s = artifacts_work(session, li_dir, od_dir)
    if not all(want[n].num_rows for n in ("cutoff", "range", "point", "skipping")):
        raise AssertionError(f"artifacts: an empty answer {[(n, t.num_rows) for n, t in want.items()]}")
    data = {"li": li_dir, "od": od_dir}

    first, tables, _ = _run_artifacts_child(base, lake, data, "child1", False)
    st = first["stats"]
    if first["builds"]["builds"] or first["built"] or first["compile_events"]:
        raise AssertionError(f"artifacts child 1 ran nvcc: {first['builds']}, "
                             f"{first['built']}, {first['compile_events']} KernelCompileEvents")
    if st["hits"] < len(ck.SOURCES) or st["misses"] or first["warmup"]["loaded"] \
            + st["preloaded"] < len(ck.SOURCES):
        raise AssertionError(f"artifacts child 1: store {st}, warmup {first['warmup']}")
    missing = [k for k, n in first["launches"].items() if n <= 0]
    if missing:
        raise AssertionError(f"artifacts child 1 launched no {missing}")
    for name, t in want.items():
        if not tables[name].equals(t):
            raise AssertionError(f"artifacts child 1: {name} differs from the main process's")
    for k, v in first["errors"].items():
        errors[k] = max(errors.get(k, 0.0), v)

    digest = store.key_digest(ck.artifact_fields(ARTIFACTS_CORRUPT))
    with open(mgr.store.blob_path(digest), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    second, tables2, rc = _run_artifacts_child(base, lake, data, "child2", True)
    st2 = second["stats"]
    if rc != -9:
        raise AssertionError(f"artifacts child 2 ended with {rc}, not killed at artifacts.write")
    if second["built"] != [ARTIFACTS_CORRUPT] or second["builds"]["builds"] != 1 \
            or second["compile_events"] != 1:
        raise AssertionError(f"artifacts child 2 built {second['built']} "
                             f"({second['compile_events']} KernelCompileEvents), not "
                             f"{ARTIFACTS_CORRUPT} alone")
    if st2["corrupt"] != 1 or st2["misses"] < 1 or second["corruptions"] != 1:
        raise AssertionError(f"artifacts child 2: store {st2}, corruptions "
                             f"{second['corruptions']}")
    for name, t in want.items():
        if not tables2[name].equals(t):
            raise AssertionError(f"artifacts child 2: {name} differs from the main process's")
    temps = [n for n in os.listdir(mgr.store.version_dir) if n.startswith(store.TMP_PREFIX)]
    if len(temps) != 1:
        raise AssertionError(f"artifacts: the killed publisher left {temps}")
    swept = ht.Hyperspace(session).compact()["artifacts"]
    if swept.get("tmp_removed") != 1:
        raise AssertionError(f"artifacts: compact() swept {swept}")
    torch.cuda.synchronize()
    results["artifacts"] = {
        "cold_nvcc_s": results["build_s"], "blobs": landed, "blob_bytes": blob_bytes,
        "main_first_query_s": main_first_s,
        "child1": {k: first[k] for k in ("process_s", "session_s", "warmup_s", "first_query_s",
                                         "warmup", "stats", "launches", "checks")},
        "child2": {k: second[k] for k in ("process_s", "session_s", "warmup_s",
                                          "first_query_s", "stats", "built", "builds")},
        "compact": swept, "rows": {"lineitem": n_li, "orders": n_od},
        "seconds": time.perf_counter() - t_path}
    shutil.rmtree(base, ignore_errors=True)


def artifacts_summary(a: dict, card: str) -> dict:
    c1, c2 = a["child1"], a["child2"]
    return {"card": card, "seconds": a["seconds"], "cold_nvcc_s": a["cold_nvcc_s"],
            "blobs": a["blobs"], "blob_bytes": a["blob_bytes"],
            "store_warmup_s": c1["warmup_s"], "store_first_query_s": c1["first_query_s"],
            "main_first_query_s": a["main_first_query_s"],
            "hits": c1["stats"]["hits"], "misses": c1["stats"]["misses"],
            "preloaded": c1["stats"]["preloaded"], "loaded_bytes": c1["stats"]["preload_bytes"],
            "child_process_s": [c1["process_s"], c2["process_s"]],
            "kernel_checks": c1["checks"],
            "corrupt": {"built": c2["built"], "build_s": c2["builds"]["build_seconds"],
                        "misses": c2["stats"]["misses"], "corrupt": c2["stats"]["corrupt"],
                        "first_query_s": c2["first_query_s"]},
            "compact": a["compact"]}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scale", type=float, default=10.0,
                        help="TPC-H scale factor (10 = 60M lineitem and 15M orders rows)")
    parser.add_argument("--sql-scale", type=float, default=SQL_SCALE,
                        help="TPC-H scale factor of the sql lake, on which the sql, serving, "
                             "faults, streaming and cluster paths run (at most --scale)")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke.json"),
                        help="where to write the full result record")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    t_start = time.perf_counter()
    from hyperspace_tpu_torch.robustness import faults
    from hyperspace_tpu_torch.serving.program_bank import get_bank
    from hyperspace_tpu_torch.telemetry.exposition import delta as metric_delta
    degraded_at_start = faults.stats()["degraded_spmd"]
    bank_degraded_at_start = faults.stats()["degraded_bank_compile"]
    fused_errors_at_start = fused_program_errors()
    card = gpu_line()
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "scale": args.scale, "sql_scale": min(args.sql_scale, args.scale)}
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    ck.build()
    results["build_s"] = time.perf_counter() - t0
    log(f"phase 1: built {len(ck.SOURCES)} kernels in {results['build_s']:.1f} s")
    for name, text in ck.BUILD_LOG.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  {name}: {len(regs)} instantiations, at most {max(regs, default=0)} "
            f"registers, {spills} bytes of spill stores")

    errors: dict = {}
    t0 = time.perf_counter()
    results["kernel_checks"] = check_kernels(errors)
    log(f"phase 2: {results['kernel_checks']} kernel checks equal their plain "
        f"versions ({time.perf_counter() - t0:.1f} s)")

    root = tempfile.mkdtemp(prefix="hs_chip_smoke_")
    try:
        run_artifacts_path(root, results, errors)
        art = results["artifacts"]
        log(f"phase 2b: artifacts path in {art['seconds']:.1f} s: {art['blobs']} blobs "
            f"({art['blob_bytes']:,} bytes); a fresh process preloaded them in "
            f"{art['child1']['warmup_s']:.3f} s and ran no nvcc (cold nvcc "
            f"{art['cold_nvcc_s']:.1f} s), {art['child1']['checks']} kernel checks from the "
            f"store; a corrupt blob rebuilt {art['child2']['built']} alone")

        t0 = time.perf_counter()
        li_dir, od_dir, pt_dir, n_li, n_od = make_tpch(os.path.join(root, "data"), args.scale)
        results["lineitem_rows"], results["orders_rows"] = n_li, n_od
        results["datagen_s"] = time.perf_counter() - t0
        log(f"phase 3: lineitem {n_li:,} rows, orders {n_od:,} rows, part "
            f"{max(n_li // 30, 200):,} rows in {results['datagen_s']:.1f} s")

        # Each path runs with the counts at 0 and is read just after.
        ck.reset_launches()
        session, hs, queries = run_main_path(li_dir, n_li, os.path.join(root, "indexes"),
                                             results)
        launches = {"lineitem": dict(ck.LAUNCHES)}
        ck.reset_launches()
        queries.update(run_orders_path(session, hs, od_dir, n_od, results))
        launches["orders"] = dict(ck.LAUNCHES)
        ck.reset_launches()
        queries.update(run_joins_path(session, hs, li_dir, od_dir, pt_dir, results))
        launches["joins"] = dict(ck.LAUNCHES)
        ck.reset_launches()
        t0 = time.perf_counter()
        run_sources_path(root, session, hs, od_dir, queries, results)
        launches["sources"] = dict(ck.LAUNCHES)
        results["sources"]["seconds"] = time.perf_counter() - t0
        log(f"sources: launches {launches['sources']}; "
            f"{results['sources']['seconds']:.1f} s")
        ck.reset_launches()
        t0 = time.perf_counter()
        run_io_path(root, session, queries, li_dir, od_dir, pt_dir, n_od, results)
        launches["io"] = dict(ck.LAUNCHES)
        results["io"]["seconds"] = time.perf_counter() - t0
        log(f"io: launches {launches['io']}; {results['io']['seconds']:.1f} s")
        ck.reset_launches()
        t0 = time.perf_counter()
        run_formats_path(root, li_dir, od_dir, n_li, n_od, results)
        launches["formats"] = dict(ck.LAUNCHES)
        results["formats"]["seconds"] = time.perf_counter() - t0
        log(f"formats: launches {launches['formats']}; "
            f"{results['formats']['seconds']:.1f} s")
        ck.reset_launches()
        t0 = time.perf_counter()
        run_lake_path(root, od_dir, n_od, results)
        launches["lake"] = dict(ck.LAUNCHES)
        results["lake"]["seconds"] = time.perf_counter() - t0
        log(f"lake: launches {launches['lake']}; {results['lake']['seconds']:.1f} s")
        ck.reset_launches()
        run_advisor_path(root, od_dir, n_od, results)
        launches["advisor"] = dict(ck.LAUNCHES)
        log(f"advisor: launches {launches['advisor']}; "
            f"{results['advisor']['seconds']:.1f} s")
        ck.reset_launches()
        t0 = time.perf_counter()
        sql_session_, sql_dirs = run_sql_path(root, results["sql_scale"], results)
        launches["sql"] = dict(ck.LAUNCHES)
        results["sql"]["seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        results["sql"]["peak_bytes"] = max(
            max(q["indexed_peak_bytes"], q["scanned_peak_bytes"])
            for q in results["sql"]["queries"].values())
        log(f"sql: launches {launches['sql']}; {results['sql']['seconds']:.1f} s")
        ck.reset_launches()
        run_reorder_path(sql_session_, results)
        launches["reorder"] = dict(ck.LAUNCHES)
        log(f"reorder: launches {launches['reorder']}; "
            f"{results['reorder']['seconds']:.1f} s")
        ck.reset_launches()
        bank0 = get_bank().stats()
        q6_refs, q6_scanned, q6_indexed = run_serving_path(sql_session_, sql_dirs, results)
        results["serving"]["bank"] = metric_delta(bank0, get_bank().stats())
        launches["serving"] = dict(ck.LAUNCHES)
        masks = launches["serving"]["compare_mask"] + launches["serving"]["range_mask"]
        if masks < len(Q6_PARAMS):
            raise AssertionError(f"serving: {masks} mask-kernel launches, fewer than one per "
                                 f"indexed member")
        log(f"serving: launches {launches['serving']}; "
            f"{results['serving']['seconds']:.1f} s")
        ck.reset_launches()
        degraded_before_faults = faults.stats()["degraded_spmd"]
        fused_errors_before_faults = fused_program_errors()
        run_faults_path(sql_session_, sql_dirs, q6_scanned, q6_indexed,
                        results["sql"]["rows"]["lineitem"], results)
        degraded_armed = faults.stats()["degraded_spmd"] - degraded_before_faults
        fused_errors_armed = fused_program_errors() - fused_errors_before_faults
        launches["faults"] = dict(ck.LAUNCHES)
        log(f"faults: launches {launches['faults']}; {results['faults']['seconds']:.1f} s")
        ck.reset_launches()
        run_streaming_path(root, sql_session_, sql_dirs, results["sql"]["rows"], q6_refs,
                           results, late_at=t_start + STREAMING_LATE_S)
        launches["streaming"] = dict(ck.LAUNCHES)
        log(f"streaming: launches {launches['streaming']}; "
            f"{results['streaming']['seconds']:.1f} s")
        ck.reset_launches()
        run_cluster_path(root, sql_session_, sql_dirs, results["sql"]["rows"], results)
        launches["cluster"] = dict(ck.LAUNCHES)
        log(f"cluster: launches {launches['cluster']}; {results['cluster']['seconds']:.1f} s")
        ck.reset_launches()
        bank0 = get_bank().stats()
        run_mesh_path(root, results)
        results["mesh"]["bank"] = metric_delta(bank0, get_bank().stats())
        launches["mesh"] = dict(ck.LAUNCHES)
        log(f"mesh: launches {launches['mesh']}; {results['mesh']['seconds']:.1f} s")
        ck.reset_launches()
        run_telemetry_path(session, hs, queries, results)
        launches["telemetry"] = dict(ck.LAUNCHES)
        del sql_session_
        shutil.rmtree(os.path.join(root, "sql_data"), ignore_errors=True)
        shutil.rmtree(os.path.join(root, "sql_indexes"), ignore_errors=True)
        results["launches"] = launches
        log(f"phases 4-5: launches on the main path {launches}")
        missing = [f"{k} ({path})" for path in launches for k in PATH_KERNELS[path]
                   if launches[path][k] <= 0 and path != "telemetry"]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: {missing}")
        if launches["orders"]["masked_minmax"] != ORDERS_PARTS:
            raise AssertionError(f"masked_minmax launched {launches['orders']['masked_minmax']}"
                                 f" times by the od_skip build, not once per file")

        t0 = time.perf_counter()
        inputs = kernel_inputs(li_dir, od_dir)
        main_path, full, results["copy"], results["host_path_us"] = time_kernels(
            inputs, launches, errors)
        results["kernels_full_rows"] = full
        log(f"phase 6: timed in {time.perf_counter() - t0:.1f} s")
        del inputs
        # The capture's launches count with the telemetry path's.
        ck.reset_launches()
        telemetry_capture(root, session, hs, queries, od_dir, pt_dir, results)
        for k, n in ck.LAUNCHES.items():
            launches["telemetry"][k] += n
        missing = [k for k in PATH_KERNELS["telemetry"] if launches["telemetry"][k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the telemetry path: {missing}")
        for e in main_path:
            e["launches_by_path"]["telemetry"] = launches["telemetry"][e["name"]]
            e["launches"] = sum(e["launches_by_path"].values())
        late = time.perf_counter() - t_start
        if late > BREAKDOWN_LATE_S:
            log(f"phase 7 left out: the script's clock is at {late:.0f} s, past "
                f"{BREAKDOWN_LATE_S} s")
            results["breakdown"] = {"left_out_at_s": late}
        else:
            results["breakdown"] = breakdown(session, hs, queries, li_dir, od_dir, pt_dir,
                                             n_od)
        # The appends invalidate every earlier path's signatures: this path
        # runs after them all.
        t0 = time.perf_counter()
        ck.reset_launches()
        run_mutations_path(root, os.path.join(root, "indexes"), li_dir, od_dir, n_li, n_od,
                           results)
        launches["mutations"] = dict(ck.LAUNCHES)
        results["mutations"]["seconds"] = time.perf_counter() - t0
        log(f"mutations: launches {launches['mutations']}; "
            f"{results['mutations']['seconds']:.1f} s")
        missing = [k for k in PATH_KERNELS["mutations"] if launches["mutations"][k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the mutations path: {missing}")
        for e in main_path:
            e["launches_by_path"]["mutations"] = launches["mutations"][e["name"]]
            e["launches"] = sum(e["launches_by_path"].values())
        results["card_against_cpu"] = card_against_cpu(root)
        results["sql_card_against_cpu"] = sql_card_against_cpu(root)
        # The SPMD ladder may degrade only under an armed fault (the faults
        # path's steps and the mesh path's armed step): a degradation
        # anywhere else hides a fault of the port on the card.
        degraded_armed += results["mesh"]["fault"]["degraded_spmd"]
        degraded = faults.stats()["degraded_spmd"] - degraded_at_start
        if degraded != degraded_armed:
            raise AssertionError(f"degraded_spmd moved {degraded} in the run, "
                                 f"{degraded_armed} of them under armed faults")
        # So may a fused region fail and run staged: anywhere else, a fault
        # of the port's fused body would hide behind the staged answer.
        fused_errors_armed += results["mesh"]["fault"]["fused_program_error"]
        fused_errors = fused_program_errors() - fused_errors_at_start
        results["mesh"]["fused_program_error"].update(run=fused_errors,
                                                      run_armed=fused_errors_armed)
        if fused_errors != fused_errors_armed:
            raise AssertionError(f"fused-program-error moved {fused_errors} in the run, "
                                 f"{fused_errors_armed} of them under armed faults")
        # No step arms bank.compile: a degraded bank lookup would be a
        # fault of the port's bank.
        bank_degraded = faults.stats()["degraded_bank_compile"] - bank_degraded_at_start
        if bank_degraded:
            raise AssertionError(f"degraded_bank_compile moved {bank_degraded} with no "
                                 f"bank.compile fault armed")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    results["kernels"] = main_path
    results["total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    for k in main_path + full:
        log(f"{k['name']}: {k['input']}: {k['ms']:.4f} ms (spread {k['ms_spread']:.4f}; "
            f"device {k['device_ms']}, {k['kernels_per_call']} kernels and "
            f"{k['memsets_per_call']} memsets a call, {k['profile_sessions']} profiling "
            f"sessions, discarded {k['discarded_sessions']}; plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f}"
            + (f"; public call {k['public_call_ms']:.4f}" if "public_call_ms" in k else "")
            + ")")
    mutations = {k: v for k, v in results["mutations"].items() if k != "queries"}
    mutations["queries"] = {k: {f: v[f] for f in ("indexed_s", "scanned_s", "hybrid_merges",
                                                  "fast_joins", "files_kept") if f in v}
                            for k, v in results["mutations"]["queries"].items()}
    sources = {k: v for k, v in results["sources"].items() if k != "introspection"}
    io = {k: v for k, v in results["io"].items() if k != "queries"}
    io["queries"] = {k: {run: v[run]["seconds"] for run in ("cold", "warm", "sequential")}
                     for k, v in results["io"]["queries"].items()}
    sql = {k: results["sql"][k] for k in ("rows", "datagen_s", "builds", "reference_s",
                                          "seconds", "peak_bytes")}
    sql["launches"] = launches["sql"]
    sql["queries"] = {k: {f: v[f] for f in ("indexed_s", "scanned_s", "indexes", "rows")}
                      for k, v in results["sql"]["queries"].items()}
    sql["card_against_cpu"] = results["sql_card_against_cpu"]
    print(json.dumps({"builds": results["builds"], "queries": results["queries"],
                      "sources": sources, "io": io, "sql": sql, "mutations": mutations,
                      "card_against_cpu": results["card_against_cpu"],
                      "total_s": results["total_s"]}, default=str))
    print(json.dumps({"artifacts": artifacts_summary(results["artifacts"], card)},
                     default=str))
    print(json.dumps({"formats": dict(results["formats"], launches=launches["formats"],
                                      card=card)}, default=str))
    print(json.dumps({"lake": dict(results["lake"], launches=launches["lake"], card=card)},
                     default=str))
    print(json.dumps({"advisor": dict(results["advisor"], launches=launches["advisor"],
                                      card=card)}, default=str))
    print(json.dumps({"reorder": dict(results["reorder"], launches=launches["reorder"],
                                      card=card)}, default=str))
    print(json.dumps({"serving": serving_summary(results["serving"], launches["serving"],
                                                 card)}, default=str))
    print(json.dumps({"faults": faults_summary(results["faults"], launches["faults"], card)},
                     default=str))
    print(json.dumps({"streaming": streaming_summary(results["streaming"],
                                                     launches["streaming"], card)},
                     default=str))
    print(json.dumps({"cluster": cluster_summary(results["cluster"], launches["cluster"],
                                                 card)}, default=str))
    print(json.dumps({"mesh": mesh_summary(results["mesh"], launches["mesh"], card)},
                     default=str))
    print(json.dumps({"telemetry": telemetry_summary(results["telemetry"],
                                                     launches["telemetry"], card)},
                     default=str))
    print(json.dumps({"kernels": main_path}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
