#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hyperspace_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 10] [--out chiprun_out/chip_smoke.json]

Phases, each of which fails the run on any error:

1. build   -- compile every CUDA kernel from hyperspace_tpu_torch/csrc/
              (one nvcc per source, all started together);
2. kernels -- each kernel against its plain torch version on the card,
              at several sizes and edge shapes, exact equality (bit for
              bit for masked_minmax's signed zeros and NaN);
3. datagen -- TPC-H lineitem and orders at ``--scale`` (SF10: 60,000,000
              lineitem rows in 4 parquet files, 15,000,000 orders rows in
              16 time-ordered files), the repository's benchmark generator
              (bench.py make_tpch_like, same formulas and seed), copied here;
4. build   -- through the public API: the covering indexes li_idx
              (l_orderkey; 32 buckets), li_ship_idx (l_shipdate; 8
              buckets) and od_idx (o_orderkey; 32 buckets), and the
              data-skipping indexes od_skip (MinMax on o_orderdate) and
              od_bloom (Bloom on o_orderkey); od_skip's sketch table must
              hold each file's pyarrow min and max;
5. queries -- the range, cutoff and point queries over lineitem, and the
              skipping (o_orderdate BETWEEN) and bloom (o_orderkey IN)
              queries over orders, indexed and scanned: results equal a
              pyarrow reference, every lineitem plan holds an IndexScan,
              and each orders plan is a Scan narrowed by its sketches
              (MinMax to exactly the files whose date range meets the
              filter, Bloom to a superset of the files holding a key,
              both to fewer than 16);
6. timing  -- each kernel beside its plain version and one PyTorch call
              computing the same function, at the inputs the main path
              gave it and at full-size columns;
7. breakdown -- host spans and the profiler's device time for rebuilds
              of li_ship_idx, od_skip and od_bloom and for the four
              filter queries, indexed and scanned.

Launch counters are reset just before each path (lineitem, then orders)
of phases 4-5 and read just after it.
The last lines of standard output are the ``kernels`` JSON object, the
card's name and power limit as nvidia-smi reports them, and the status
object ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

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
}
SKIP_LO, SKIP_HI = datetime.date(1994, 6, 1), datetime.date(1994, 7, 31)

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
    """TPC-H-shaped lineitem (4 parquet files) and orders (16 files,
    time-ordered: each file covers a range of o_orderdate). Returns
    (lineitem dir, orders dir, lineitem rows, orders rows)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    n_li = max(int(6_000_000 * scale), 10_000)
    n_od = max(n_li // 4, 2_500)
    n_pt = max(n_li // 30, 200)
    base = (datetime.date(1992, 1, 1) - EPOCH).days

    def write_parts(table, out_dir, n_parts, name):
        os.makedirs(out_dir)
        n = table.num_rows
        step = n // n_parts
        for i in range(n_parts):
            lo, hi = i * step, (i + 1) * step if i < n_parts - 1 else n
            pq.write_table(table.slice(lo, hi - lo), os.path.join(out_dir, name(i)))

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
    return li_dir, od_dir, n_li, n_od


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
        # Masks: int32, uint32 and float32 (with NaN, +-0.0 and +-inf).
        i32 = ints(n + 1, -1000, 1000).to(torch.int32)
        f32 = (torch.randn(n + 1, generator=g, device=dev) * 100).to(torch.float32)
        specials = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                                 -float("inf"), 3.0], device=dev)
        f32[: min(6, n + 1)] = specials[: min(6, n + 1)]
        columns = [
            (i32, [0, 3, -1000, 999, 2 ** 31 - 1]),
            (i32.view(torch.uint32), [0, 3, 2 ** 32 - 1, 2 ** 31]),
            (f32, [0.0, -0.0, 3.0, 0.1, float("inf"), float("nan")]),
        ]
        for col, lits in columns:
            for offset in (0, 1):
                x = col[offset:offset + n]
                for v in lits:
                    for op in ck.OPS:
                        check_equal("compare_mask", ck.compare_mask(x, op, v),
                                    ck.compare_mask_plain(x, op, v), errors)
                        checks += 1
                    hi = lits[-2]
                    for lo_incl in (True, False):
                        for hi_incl in (True, False):
                            check_equal("range_mask",
                                        ck.range_mask(x, v, hi, lo_incl, hi_incl),
                                        ck.range_mask_plain(x, v, hi, lo_incl, hi_incl),
                                        errors)
                            checks += 1
    return checks + check_minmax(errors)


def check_minmax(errors: dict) -> int:
    """masked_minmax against its plain version, bit for bit (torch.equal
    would take NaN != NaN and -0.0 == 0.0): int32 and float32, no mask, a
    random mask, an all-invalid mask and a mask that hides the NaNs; signed
    zeros in both orders, +-inf, +-FLT_MAX and NaN; aligned and unaligned."""
    import torch

    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    fmax = torch.finfo(torch.float32).max
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), fmax, -fmax],
                            device=dev)
    checks = 0

    def check(x, valid):
        nonlocal checks
        got = torch.stack(ck.masked_minmax(x, valid))
        want = torch.stack(ck.masked_minmax_plain(x, valid))
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(
                f"masked_minmax: kernel {got.tolist()} != plain {want.tolist()} "
                f"({x.dtype}[{x.shape[0]}], mask {valid is not None})")
        errors["masked_minmax"] = errors.get("masked_minmax", 0.0)
        checks += 1

    for n in (1, 2, 3, 4, 5, 130, 4097, 32769, 1_000_003):
        m = n + 1
        pos = torch.randint(0, m, (8,), generator=g, device=dev)
        base = torch.randn(m, generator=g, device=dev) * 100
        with_specials = base.clone()
        with_specials[pos[:6]] = specials
        with_nan = with_specials.clone()
        with_nan[pos[6]] = float("nan")
        signed_zeros = torch.where(torch.rand(m, generator=g, device=dev) < 0.5,
                                   torch.tensor(0.0, device=dev), torch.tensor(-0.0, device=dev))
        floats = [base, with_specials, with_nan, signed_zeros,
                  signed_zeros.flip(0), torch.full((m,), float("inf"), device=dev),
                  torch.full((m,), -float("inf"), device=dev)]
        ints = torch.randint(-2 ** 31, 2 ** 31, (m,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
        int_edges = ints.clone()
        int_edges[pos[:2]] = torch.tensor([2 ** 31 - 1, -2 ** 31], device=dev,
                                          dtype=torch.int32)
        random_mask = torch.rand(m, generator=g, device=dev) < 0.5
        no_nan_mask = ~torch.isnan(with_nan)
        for offset in (0, 1):
            masks = [None, random_mask[offset:offset + n],
                     torch.zeros(n, dtype=torch.bool, device=dev),
                     no_nan_mask[offset:offset + n]]
            for col in floats + [ints, int_edges]:
                x = col[offset:offset + n]
                for valid in masks:
                    check(x, valid)
    return checks


# ---------------------------------------------------------------------------
# Phases 4-5: the main path.
# ---------------------------------------------------------------------------

def sorted_table(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


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
        times = {}
        tables = {}
        for mode in ("indexed", "scanned"):
            if mode == "indexed":
                session.enable_hyperspace()
            else:
                session.disable_hyperspace()
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tables[mode] = df.to_arrow()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            times[mode] = runs
        session.disable_hyperspace()
        ref = sorted_table(reference(li_dir, pa_cond, columns))
        if not sorted_table(tables["indexed"]).equals(sorted_table(tables["scanned"])):
            raise AssertionError(f"{name}: indexed result differs from scanned result")
        if not sorted_table(tables["scanned"]).equals(ref):
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


def check_minmax_sketch(hs, od_dir: str) -> None:
    """od_skip's sketch table holds each file's pyarrow min and max of
    o_orderdate: the masked_minmax results of the build, one row a file."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    path = [f for f in hs.index_manager.get_index("od_skip").content.files
            if f.endswith("sketches.parquet")][0]
    table = pq.read_table(path, partitioning=None).to_pydict()
    got = {f: (lo, hi) for f, lo, hi in zip(table["_file"], table["minmax__o_orderdate__min"],
                                            table["minmax__o_orderdate__max"])}
    for f in sorted(os.listdir(od_dir)):
        full = os.path.join(od_dir, f)
        mm = pc.min_max(pq.read_table(full, columns=["o_orderdate"]).column(0)).as_py()
        if got.get(full) != (mm["min"], mm["max"]):
            raise AssertionError(f"od_skip sketch of {f}: {got.get(full)} != pyarrow's "
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
            (session.enable_hyperspace if mode == "indexed" else session.disable_hyperspace)()
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tables[mode] = df.to_arrow()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            times[mode] = runs
        session.disable_hyperspace()
        ref = sorted_table(reference(od_dir, pa_cond, columns))
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
# Phase 6: timing.
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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

    lo, hi = (RANGE_LO - EPOCH).days, (RANGE_HI - EPOCH).days
    cut = (CUTOFF - EPOCH).days

    def result(r):
        """A wrapper's result as one tensor: (None, ids) -> ids and
        (min, max) -> stacked."""
        if not isinstance(r, tuple):
            return r
        r = [t for t in r if t is not None]
        return r[0] if len(r) == 1 else torch.stack(r)

    def entry(name, x_desc, fn, plain, library, n_bytes, n_ops):
        check_equal(name, result(fn()), result(plain()), errors)
        b, by = bound(n_bytes, n_ops)
        return {"name": name, "route": "cuda",
                "source": f"hyperspace_tpu_torch/csrc/{ck.SOURCES[name]}",
                "replaces": REPLACES[name],
                "launches": sum(by_path[name] for by_path in launches.values()),
                "launches_by_path": {path: by_path[name]
                                     for path, by_path in launches.items()},
                "max_abs_err": errors.get(name, 0.0),
                "ms": time_ms(fn), "plain_ms": time_ms(plain), "bound_ms": b,
                "bound_by": by, "library_ms": None if library is None else time_ms(library),
                "input": x_desc}

    def filter_entries(x, tag):
        n = x.shape[0]
        return [
            entry("range_mask", f"l_shipdate int32[{n}] ({tag})",
                  lambda: ck.range_mask(x, lo, hi),
                  lambda: ck.range_mask_plain(x, lo, hi),
                  lambda: (x >= lo) & (x <= hi), n * 5, n * 2),
            entry("compare_mask", f"l_shipdate int32[{n}] ({tag})",
                  lambda: ck.compare_mask(x, ">", cut),
                  lambda: ck.compare_mask_plain(x, ">", cut),
                  lambda: x > cut, n * 5, n),
        ]

    folded, bids = inputs["folded_orderkey"], inputs["bids32"]
    n = folded.shape[0]
    build_entries = [
        entry("hash_bucket", f"folded l_orderkey int32[{n}], 32 buckets",
              lambda: ck.hash_bucket([folded], 32),
              lambda: ck.hash_bucket_plain([folded], 32),
              None, n * 8, n * 12),
        entry("bucket_histogram", f"bucket ids int32[{n}], 32 buckets",
              lambda: ck.bucket_histogram(bids, 32),
              lambda: ck.bucket_histogram_plain(bids, 32),
              lambda: torch.bincount(bids, minlength=32), n * 4 + 32 * 4, n * 2),
    ]
    def minmax_entry(x, tag):
        n = x.shape[0]
        return entry("masked_minmax", f"o_orderdate int32[{n}], no mask ({tag})",
                     lambda: ck.masked_minmax(x), lambda: ck.masked_minmax_plain(x),
                     lambda: torch.aminmax(x), n * 4 + 8, n * 2)

    main_path = build_entries + [
        filter_entries(inputs["shipdate_range"], "range query's rows")[0],
        filter_entries(inputs["shipdate_cutoff"], "cutoff query's rows")[1],
        minmax_entry(inputs["orderdate_file"], "one orders file"),
    ]
    full = filter_entries(inputs["shipdate_full"], "all rows") + [
        minmax_entry(inputs["orderdate_full"], "all orders rows")]
    return main_path, full


# ---------------------------------------------------------------------------
# Phase 7: where the time goes.
# ---------------------------------------------------------------------------

def breakdown(session, hs, queries, li_dir: str, od_dir: str, n_od: int) -> dict:
    """Host timers around the layers of rebuilds of li_ship_idx, od_skip
    and od_bloom and of the cutoff, range, skipping and bloom queries (each
    timer synchronizes the device), then torch.profiler over the same work
    for the device's own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hyperspace_tpu_torch import (BloomFilterSketch, DataSkippingIndexConfig,
                                      IndexConfig, IndexConstants, MinMaxSketch)
    from hyperspace_tpu_torch.actions import create, create_skipping
    from hyperspace_tpu_torch.execution import executor
    from hyperspace_tpu_torch.execution.columnar import Table
    from hyperspace_tpu_torch.index.manager import IndexCollectionManager
    from hyperspace_tpu_torch.ops import cuda_kernels, index_build, sketches
    from hyperspace_tpu_torch.rules import data_skipping_rule

    spans: dict = {}

    def timed(label, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spans[label] = spans.get(label, 0.0) + time.perf_counter() - t0
        return wrapper

    def drop(name):
        hs.delete_index(name)
        hs.vacuum_index(name)
        session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 8)

    def rebuild():
        hs.create_index(session.read.parquet(li_dir),
                        IndexConfig("li_ship_idx", ["l_shipdate"],
                                    ["l_orderkey", "l_extendedprice"]))

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
    work = [("build li_ship_idx", lambda: drop("li_ship_idx"), rebuild,
             [(create, "read_parquet", "read source -> device"),
              (index_build, "build_sorted_buckets", "hash + sort + histogram (device)"),
              (Table, "to_host", "device -> host"),
              (create, "write_bucket_files", "write bucket parquet files")]),
            ("build od_skip", lambda: drop("od_skip"),
             lambda: hs.create_index(od, skip_config),
             sketch_spans + [(cuda_kernels, "masked_minmax", "minmax reduction (device)")]),
            ("build od_bloom", lambda: drop("od_bloom"),
             lambda: hs.create_index(od, bloom_config),
             sketch_spans + [(sketches, "bloom_bits", "bloom hash + scatter + pack (device)")])]
    for name in ("cutoff", "range", "skipping", "bloom"):
        for indexed in (True, False):
            spans_of = [(executor, "read_parquet", "parquet read -> device"),
                        (executor, "_filter_table", "filter (device)"),
                        (Table, "to_arrow", "result -> host arrow")]
            if indexed:
                spans_of.append((IndexCollectionManager, "get_indexes",
                                 "index log reads (host)"))
            if indexed and name in ("skipping", "bloom"):
                spans_of.append((data_skipping_rule, "evaluate_sketch_predicate",
                                 "sketch probe (host)"))
            work.append((f"{name} {'indexed' if indexed else 'scanned'}", None,
                         lambda n=name, i=indexed: run(n, i), spans_of))
    out = {}
    for label, prep, fn, patches in work:
        spans.clear()
        saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
        for (obj, attr, span), (_, _, orig) in zip(patches, saved):
            setattr(obj, attr, timed(span, orig))
        try:
            if prep:
                prep()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for obj, attr, orig in saved:
                setattr(obj, attr, orig)
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
        out[label] = {"wall_s": wall, "spans_s": dict(spans),
                      "other_s": wall - sum(spans.values()),
                      "profiled_wall_s": prof_wall,
                      "device_s": busy if device else None,
                      "device_busy_share": busy / prof_wall if device else None,
                      "top_device_ops": device[:6]}
        log(f"breakdown {label}: wall {wall:.3f} s; " + "; ".join(
            f"{k} {v:.3f}" for k, v in spans.items()) +
            (f"; device busy {busy:.3f} s of {prof_wall:.3f} s profiled "
             f"({busy / prof_wall:.1%})" if device else "; device time not measured"))
    return out


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scale", type=float, default=10.0,
                        help="TPC-H scale factor (10 = 60M lineitem and 15M orders rows)")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke.json"),
                        help="where to write the full result record")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from hyperspace_tpu_torch.ops import cuda_kernels as ck

    t_start = time.perf_counter()
    card = gpu_line()
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "scale": args.scale}
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
        t0 = time.perf_counter()
        li_dir, od_dir, n_li, n_od = make_tpch(os.path.join(root, "data"), args.scale)
        results["lineitem_rows"], results["orders_rows"] = n_li, n_od
        results["datagen_s"] = time.perf_counter() - t0
        log(f"phase 3: lineitem {n_li:,} rows, orders {n_od:,} rows in "
            f"{results['datagen_s']:.1f} s")

        # Each path runs with the counts at 0 and is read just after.
        ck.reset_launches()
        session, hs, queries = run_main_path(li_dir, n_li, os.path.join(root, "indexes"),
                                             results)
        launches = {"lineitem": dict(ck.LAUNCHES)}
        ck.reset_launches()
        queries.update(run_orders_path(session, hs, od_dir, n_od, results))
        launches["orders"] = dict(ck.LAUNCHES)
        results["launches"] = launches
        log(f"phases 4-5: launches on the main path {launches}")
        missing = [f"{k} ({path})" for path, names in PATH_KERNELS.items()
                   for k in names if launches[path][k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: {missing}")
        if launches["orders"]["masked_minmax"] != ORDERS_PARTS:
            raise AssertionError(f"masked_minmax launched {launches['orders']['masked_minmax']}"
                                 f" times by the od_skip build, not once per file")

        t0 = time.perf_counter()
        inputs = kernel_inputs(li_dir, od_dir)
        main_path, full = time_kernels(inputs, launches, errors)
        results["kernels_full_rows"] = full
        log(f"phase 6: timed in {time.perf_counter() - t0:.1f} s")
        del inputs
        results["breakdown"] = breakdown(session, hs, queries, li_dir, od_dir, n_od)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    results["kernels"] = main_path
    results["total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    for k in full:
        log(f"full-size {k['name']}: {k['input']}: {k['ms']:.4f} ms "
            f"(plain {k['plain_ms']:.4f}, library {k['library_ms']:.4f}, "
            f"bound {k['bound_ms']:.4f})")
    print(json.dumps({"builds": results["builds"], "queries": results["queries"],
                      "total_s": results["total_s"]}))
    print(json.dumps({"kernels": main_path}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
