"""TPC-H Q1 through ``session.sql`` (the pricing summary report).
Literal: ``delta``, days (2.4.1.3: 60..120)."""

from __future__ import annotations

import datetime

import numpy as np

from hsbench.refdata import day

FLOATS = ("sum_base_price", "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
          "avg_disc")
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"lineitem": ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount", "l_tax"]}


def text(p: dict) -> str:
    return f"""
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
 sum(l_extendedprice) as sum_base_price,
 sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
 sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
 avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
 avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '{int(p["delta"])}' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""


def reference(ref, p: dict, fdt) -> dict:
    cutoff = day(datetime.date(1998, 12, 1) - datetime.timedelta(days=int(p["delta"])))
    m = ref.col("lineitem", "l_shipdate") <= cutoff
    rf, rf_dict = ref.codes("lineitem", "l_returnflag")
    ls, ls_dict = ref.codes("lineitem", "l_linestatus")
    gid = rf[m] * len(ls_dict) + ls[m]
    n = len(rf_dict) * len(ls_dict)
    qty = ref.col("lineitem", "l_quantity")[m]
    price = ref.col("lineitem", "l_extendedprice")[m].astype(fdt)
    disc = ref.col("lineitem", "l_discount")[m].astype(fdt)
    d_price = price * (fdt(1) - disc)
    charge = d_price * (fdt(1) + ref.col("lineitem", "l_tax")[m].astype(fdt))
    counts = np.bincount(gid, minlength=n)

    def per(v):
        return np.bincount(gid, weights=v, minlength=n).astype(fdt).astype(np.float64)

    keys = sorted((str(rf_dict[g // len(ls_dict)]), str(ls_dict[g % len(ls_dict)]), g)
                  for g in range(n) if counts[g] > 0)
    g = np.array([k[2] for k in keys], dtype=np.int64)
    sum_qty, sum_price, sum_disc = per(qty)[g], per(price)[g], per(disc)[g]
    c = counts[g]
    return {"l_returnflag": np.array([k[0] for k in keys], dtype=object),
            "l_linestatus": np.array([k[1] for k in keys], dtype=object),
            "sum_qty": sum_qty.astype(np.int64), "sum_base_price": sum_price,
            "sum_disc_price": per(d_price)[g], "sum_charge": per(charge)[g],
            "avg_qty": (sum_qty / c).astype(fdt).astype(np.float64),
            "avg_price": (sum_price / c).astype(fdt).astype(np.float64),
            "avg_disc": (sum_disc / c).astype(fdt).astype(np.float64),
            "count_order": c.astype(np.int64)}
