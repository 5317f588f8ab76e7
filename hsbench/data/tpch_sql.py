"""The TPC-H tables and columns of the nine SQL texts, and of Q3 and Q17 over
the covering-index lake.

A frozen copy of the smoke script's ``make_tpch_sql`` and its value
domains (TPC-H v3.0.1 4.2.2.13 and 4.2.3), with the seed taken from
``--seed``: the same formulas in the same order of draws. Later changes
to the program or to the smoke script do not move this generator.

Row counts are ``scale`` times TPC-H's SF1 counts (4.2.5).
"""

from __future__ import annotations

import datetime
import os

EPOCH = datetime.date(1970, 1, 1)
# Rows per scale factor and files per table (TPC-H v3.0.1 4.2.5).
TPCH_SQL_ROWS = {"lineitem": 6_000_000, "orders": 1_500_000, "customer": 150_000,
                 "part": 200_000, "partsupp": 800_000, "supplier": 10_000}
TPCH_SQL_FILES = {"lineitem": 4, "orders": 16, "customer": 1, "part": 1, "partsupp": 1,
                  "supplier": 1}
# The value domains of TPC-H v3.0.1 4.2.2.13 and 4.2.3.
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
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
BRANDS = tuple(f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6))
CONTAINERS = tuple(f"{a} {b}" for a in CONTAINER_SYLLABLES[0] for b in CONTAINER_SYLLABLES[1])


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


def make_tpch_sql(root: str, scale: float, seed: int = 0, tables: dict = None):
    """The TPC-H tables and columns the nine texts read, at ``scale``
    times the SF1 row counts, with TPC-H v3.0.1's value domains: keys from
    1; brands Brand#MN, the 150 p_type syllable triples, the 40
    containers, p_size 1-50 (int32); o_custkey never a multiple of 3 (a
    third of the customers have no orders); 1-7 lines an order, lineitem
    in l_orderkey order; ship 1-121 days after the order, commit 30-90,
    receipt 1-30 after the ship date; return flag and line status from the
    dates; l_extendedprice = quantity * the part's retail price; about
    5 in 10,000 supplier comments hold "Customer ... Complaints" (at least
    one). Strings are written from dictionary indices. With ``tables``
    ({table: [columns]}) only those tables and columns are written; every
    value is drawn all the same, so a written column holds what it holds
    in the whole lake. Returns ({table: dir}, {table: rows})."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    rows = {t: max(int(round(n * scale)), 1) for t, n in TPCH_SQL_ROWS.items()}
    dirs = {}

    def write(name, table):
        from concurrent.futures import ThreadPoolExecutor
        if tables is not None:
            if name not in tables:
                return
            table = table.select(tables[name])
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


def make(root: str, config: dict, seed: int) -> dict:
    """Write the tables under ``root`` (only those of ``config["tables"]``,
    where it lists them). Returns {"dirs": {table: dir}, "rows": {table:
    rows}}."""
    dirs, rows = make_tpch_sql(root, float(config["scale"]), seed, config.get("tables"))
    return {"dirs": dirs, "rows": {t: rows[t] for t in dirs}}
