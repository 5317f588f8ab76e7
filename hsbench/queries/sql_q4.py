"""TPC-H Q4 through ``session.sql`` (the order priority checking query,
an EXISTS as a semi join). Literal: ``date`` (2.4.4.3: the first day of a
month in 1993-01..1997-10)."""

from __future__ import annotations

import datetime

import numpy as np

from hsbench.refdata import day

FLOATS = ()
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"orders": ["o_orderdate", "o_orderpriority"],
         "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"]}


def text(p: dict) -> str:
    d = p["date"].isoformat()
    return f"""
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '{d}'
 and o_orderdate < date '{d}' + interval '3' month
 and exists ( select * from lineitem
   where l_orderkey = o_orderkey and l_commitdate < l_receiptdate )
group by o_orderpriority
order by o_orderpriority
"""


def reference(ref, p: dict, fdt) -> dict:
    odate = ref.col("orders", "o_orderdate")

    def late_orders():
        late = np.zeros(odate.shape[0], bool)
        okey = ref.col("lineitem", "l_orderkey")
        late[okey[ref.col("lineitem", "l_commitdate")
                  < ref.col("lineitem", "l_receiptdate")] - 1] = True
        return late

    late = ref.memo("sql_q4.late", late_orders)
    d = p["date"]
    end = datetime.date(d.year + (d.month + 2) // 12, (d.month + 2) % 12 + 1, 1)
    m = (odate >= day(d)) & (odate < day(end)) & late
    prio = ref.strings("orders", "o_orderpriority", np.flatnonzero(m)).astype(str)
    names, cnt = np.unique(prio, return_counts=True)
    return {"o_orderpriority": names.astype(object), "order_count": cnt.astype(np.int64)}
