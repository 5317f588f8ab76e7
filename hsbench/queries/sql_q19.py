"""TPC-H Q19 through ``session.sql`` (the discounted revenue query, three
ORed branches of a join). Literals (2.4.19.3): ``q1`` (1..10), ``q2``
(10..20), ``q3`` (20..30) and ``brand1``..``brand3``."""

from __future__ import annotations

import numpy as np

FLOATS = ("revenue",)
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"lineitem": ["l_shipmode", "l_shipinstruct", "l_partkey", "l_quantity", "l_extendedprice", "l_discount"],
         "part": ["p_size", "p_brand", "p_container"]}
BRANCHES = ((("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 5),
            (("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10),
            (("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 15))


def _brands(p: dict) -> list:
    return [p["brand1"], p["brand2"], p["brand3"]]


def _quantities(p: dict) -> list:
    return [int(p["q1"]), int(p["q2"]), int(p["q3"])]


def text(p: dict) -> str:
    parts = []
    for brand, q, (containers, smax) in zip(_brands(p), _quantities(p), BRANCHES):
        conts = ", ".join(f"'{c}'" for c in containers)
        parts.append(f"""( p_partkey = l_partkey and p_brand = '{brand}'
  and p_container in ( {conts})
  and l_quantity >= {int(q)} and l_quantity <= {int(q)} + 10
  and p_size between 1 and {smax}
  and l_shipmode in ('AIR', 'AIR REG')
  and l_shipinstruct = 'DELIVER IN PERSON' )""")
    return ("\nselect sum(l_extendedprice* (1 - l_discount)) as revenue\nfrom lineitem, part\n"
            "where " + "\n or ".join(parts) + "\n")


def reference(ref, p: dict, fdt) -> dict:
    rows = np.flatnonzero(ref.where("lineitem", "l_shipmode", lambda v: v in ("AIR", "AIR REG"))
                          & ref.where("lineitem", "l_shipinstruct",
                                      lambda v: v == "DELIVER IN PERSON"))
    prow = ref.col("lineitem", "l_partkey")[rows] - 1
    q = ref.col("lineitem", "l_quantity")[rows]
    p_size = ref.col("part", "p_size")
    keep = np.zeros(rows.shape[0], bool)
    for brand, qlo, (containers, smax) in zip(_brands(p), _quantities(p), BRANCHES):
        pmask = ref.where("part", "p_brand", lambda v, b=brand: v == b) \
            & ref.where("part", "p_container", lambda v, c=containers: v in c) \
            & (p_size >= 1) & (p_size <= smax)
        keep |= pmask[prow] & (q >= int(qlo)) & (q <= int(qlo) + 10)
    r = rows[keep]
    v = ref.col("lineitem", "l_extendedprice")[r].astype(fdt) \
        * (fdt(1) - ref.col("lineitem", "l_discount")[r].astype(fdt))
    return {"revenue": np.array([np.sum(v, dtype=np.float64)]).astype(fdt).astype(np.float64)}
