"""TPC-H Q3 through ``session.sql`` (the shipping priority query).
Literals: ``segment`` (2.4.3.3: one of the five) and ``date`` (a day in
1995-03-01..1995-03-31)."""

from __future__ import annotations

import numpy as np

from hsbench.refdata import day

FLOATS = ("revenue",)
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"lineitem": ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"],
         "orders": ["o_orderdate", "o_custkey", "o_shippriority"],
         "customer": ["c_mktsegment"]}
TOP_K = 10
TIE = "revenue"


def text(p: dict) -> str:
    d = p["date"].isoformat()
    return f"""
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
 o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = '{p["segment"]}' and c_custkey = o_custkey
 and l_orderkey = o_orderkey
 and o_orderdate < date '{d}' and l_shipdate > date '{d}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""


def reference(ref, p: dict, fdt) -> dict:
    """Keys are dense from 1: a key's row is key - 1. TOP_K + 1 rows."""
    okey = ref.col("lineitem", "l_orderkey")
    odate = ref.col("orders", "o_orderdate")
    n_od = odate.shape[0]
    term = ref.memo(("sql_q3.term", fdt), lambda: ref.col("lineitem", "l_extendedprice")
                    .astype(fdt) * (fdt(1) - ref.col("lineitem", "l_discount").astype(fdt)))
    seg = ref.where("customer", "c_mktsegment", lambda v: v == p["segment"])
    c = day(p["date"])
    order_ok = (odate < c) & seg[ref.col("orders", "o_custkey") - 1]
    m = (ref.col("lineitem", "l_shipdate") > c) & order_ok[okey - 1]
    rev = np.bincount(okey[m] - 1, weights=term[m], minlength=n_od).astype(fdt)
    cand = np.flatnonzero(np.bincount(okey[m] - 1, minlength=n_od) > 0)
    top = cand[np.lexsort((odate[cand], -rev[cand].astype(np.float64)))][:TOP_K + 1]
    return {"l_orderkey": (top + 1).astype(np.int64), "revenue": rev[top].astype(np.float64),
            "o_orderdate": odate[top], "o_shippriority": ref.col("orders", "o_shippriority")[top]}
