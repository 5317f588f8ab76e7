"""TPC-H Q14 through ``session.sql`` (the promotion effect query).
Literal: ``date`` (2.4.14.3: the first day of a month in 1993..1997)."""

from __future__ import annotations

import datetime

import numpy as np

from hsbench.refdata import day

FLOATS = ("promo_revenue",)
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"lineitem": ["l_shipdate", "l_partkey", "l_extendedprice", "l_discount"],
         "part": ["p_type"]}


def text(p: dict) -> str:
    d = p["date"].isoformat()
    return f"""
select 100.00 * sum(case when p_type like 'PROMO%'
  then l_extendedprice * (1 - l_discount) else 0 end)
 / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey and l_shipdate >= date '{d}'
 and l_shipdate < date '{d}' + interval '1' month
"""


def reference(ref, p: dict, fdt) -> dict:
    d = p["date"]
    end = datetime.date(d.year + d.month // 12, d.month % 12 + 1, 1)
    ship = ref.col("lineitem", "l_shipdate")
    m = (ship >= day(d)) & (ship < day(end))
    promo = ref.where("part", "p_type", lambda v: v.startswith("PROMO"))[
        ref.col("lineitem", "l_partkey")[m] - 1]
    r = ref.col("lineitem", "l_extendedprice")[m].astype(fdt) \
        * (fdt(1) - ref.col("lineitem", "l_discount")[m].astype(fdt))
    num = fdt(np.sum(r[promo], dtype=np.float64))
    den = fdt(np.sum(r, dtype=np.float64))
    return {"promo_revenue": np.array([fdt(100.0) * num / den]).astype(np.float64)}
