"""TPC-H Q6 through ``session.sql`` (the forecasting revenue change
query). Literals (2.4.6.3): ``year`` (1993..1997), ``discount``
(0.02..0.09) and ``quantity`` (24 or 25)."""

from __future__ import annotations

import datetime
from decimal import Decimal

import numpy as np

from hsbench.refdata import day

FLOATS = ("revenue",)
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"lineitem": ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]}


def text(p: dict) -> str:
    return f"""
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '{int(p["year"])}-01-01'
 and l_shipdate < date '{int(p["year"])}-01-01' + interval '1' year
 and l_discount between {p["discount"]} - 0.01 and {p["discount"]} + 0.01
 and l_quantity < {int(p["quantity"])}
"""


def reference(ref, p: dict, fdt) -> dict:
    """The BETWEEN bounds fold as decimals, as in SQL: 0.06 - 0.01 is 0.05."""
    lo = float(Decimal(p["discount"]) - Decimal("0.01"))
    hi = float(Decimal(p["discount"]) + Decimal("0.01"))
    year = int(p["year"])
    ship = ref.col("lineitem", "l_shipdate")
    disc = ref.col("lineitem", "l_discount")
    m = (ship >= day(datetime.date(year, 1, 1))) & (ship < day(datetime.date(year + 1, 1, 1))) \
        & (disc >= lo) & (disc <= hi) & (ref.col("lineitem", "l_quantity") < int(p["quantity"]))
    v = ref.col("lineitem", "l_extendedprice")[m].astype(fdt) * disc[m].astype(fdt)
    return {"revenue": np.array([np.sum(v, dtype=np.float64)]).astype(fdt).astype(np.float64)}
