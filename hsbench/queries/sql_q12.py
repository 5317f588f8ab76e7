"""TPC-H Q12 through ``session.sql`` (the shipping modes and order
priority query). Literals (2.4.12.3): ``modes`` (two distinct ship modes)
and ``year`` (1993..1997)."""

from __future__ import annotations

import datetime

import numpy as np

from hsbench.refdata import day

FLOATS = ()
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"lineitem": ["l_receiptdate", "l_commitdate", "l_shipmode", "l_shipdate", "l_orderkey"],
         "orders": ["o_orderpriority"]}


def text(p: dict) -> str:
    m1, m2 = p["modes"]
    y = int(p["year"])
    return f"""
select l_shipmode,
 sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
     then 1 else 0 end) as high_line_count,
 sum(case when o_orderpriority <> '1-URGENT'
     and o_orderpriority <> '2-HIGH' then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('{m1}', '{m2}')
 and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
 and l_receiptdate >= date '{y}-01-01'
 and l_receiptdate < date '{y}-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
"""


def reference(ref, p: dict, fdt) -> dict:
    y = int(p["year"])
    modes = set(p["modes"])
    rec = ref.col("lineitem", "l_receiptdate")
    commit = ref.col("lineitem", "l_commitdate")
    m = ref.where("lineitem", "l_shipmode", lambda v: v in modes) & (commit < rec) \
        & (ref.col("lineitem", "l_shipdate") < commit) \
        & (rec >= day(datetime.date(y, 1, 1))) & (rec < day(datetime.date(y + 1, 1, 1)))
    rows = np.flatnonzero(m)
    high = ref.where("orders", "o_orderpriority", lambda v: v in ("1-URGENT", "2-HIGH"))[
        ref.col("lineitem", "l_orderkey")[rows] - 1]
    got = ref.strings("lineitem", "l_shipmode", rows).astype(str)
    names = np.unique(got)
    return {"l_shipmode": names.astype(object),
            "high_line_count": np.array([int(np.sum(high[got == n])) for n in names],
                                        dtype=np.int64),
            "low_line_count": np.array([int(np.sum(~high[got == n])) for n in names],
                                       dtype=np.int64)}
