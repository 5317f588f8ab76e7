"""TPC-H Q17 through ``session.sql`` (the small-quantity-order revenue
query, a correlated subquery decorrelated into a group-by). Literals
(2.4.17.3): ``brand`` and ``container``."""

from __future__ import annotations

import numpy as np

FLOATS = ("avg_yearly",)
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"lineitem": ["l_partkey", "l_quantity", "l_extendedprice"],
         "part": ["p_partkey", "p_brand", "p_container"]}


def text(p: dict) -> str:
    return f"""
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_brand = '{p["brand"]}'
 and p_container = '{p["container"]}'
 and l_quantity < ( select 0.2 * avg(l_quantity) from lineitem
   where l_partkey = p_partkey )
"""


def reference(ref, p: dict, fdt) -> dict:
    """Part keys are dense from 1: a key's row is key - 1."""
    pk = ref.col("lineitem", "l_partkey")
    n_pt = ref.col("part", "p_partkey").shape[0]

    def per_part():
        qty = ref.col("lineitem", "l_quantity")
        tot = np.bincount(pk - 1, weights=qty, minlength=n_pt)
        cnt = np.bincount(pk - 1, minlength=n_pt)
        thr = fdt(0.2) * (tot / np.maximum(cnt, 1)).astype(fdt)
        keep = qty.astype(fdt) < thr[pk - 1]
        price = ref.col("lineitem", "l_extendedprice").astype(fdt)
        return np.bincount(pk[keep] - 1, weights=price[keep], minlength=n_pt).astype(fdt)

    sums = ref.memo(("sql_q17.per_part", fdt), per_part)
    chosen = ref.where("part", "p_brand", lambda v: v == p["brand"]) \
        & ref.where("part", "p_container", lambda v: v == p["container"])
    total = fdt(np.sum(sums[chosen], dtype=fdt))
    return {"avg_yearly": np.array([total / fdt(7.0)], dtype=fdt).astype(np.float64)}
