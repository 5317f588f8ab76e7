"""TPC-H Q16 through ``session.sql`` (the parts/supplier relationship
query: NOT LIKE, NOT IN as an anti join, COUNT DISTINCT). Literals
(2.4.16.3): ``brand``, ``type`` (two syllables) and ``sizes`` (eight
distinct sizes)."""

from __future__ import annotations

import numpy as np

FLOATS = ()
ORDERED = True
# The columns the reference reads, by table (read in one pass each).
READS = {"part": ["p_size", "p_brand", "p_type"],
         "supplier": ["s_suppkey", "s_comment"],
         "partsupp": ["ps_partkey", "ps_suppkey"]}


def text(p: dict) -> str:
    sizes = ", ".join(str(int(s)) for s in p["sizes"])
    return f"""
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> '{p["brand"]}'
 and p_type not like '{p["type"]}%'
 and p_size in ({sizes})
 and ps_suppkey not in ( select s_suppkey from supplier
   where s_comment like '%Customer%Complaints%' )
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
"""


def reference(ref, p: dict, fdt) -> dict:
    sizes = np.zeros(51, bool)
    sizes[[int(s) for s in p["sizes"]]] = True
    p_size = ref.col("part", "p_size")
    part_ok = ref.where("part", "p_brand", lambda v: v != p["brand"]) \
        & ref.where("part", "p_type", lambda v: not v.startswith(p["type"])) & sizes[p_size]
    bad = ref.col("supplier", "s_suppkey")[ref.where(
        "supplier", "s_comment",
        lambda v: "Customer" in v and "Complaints" in v.split("Customer", 1)[1])]
    pk, sk = ref.col("partsupp", "ps_partkey"), ref.col("partsupp", "ps_suppkey")
    m = part_ok[pk - 1] & ~np.isin(sk, bad)
    pairs = np.unique(np.stack([pk[m] - 1, sk[m]]), axis=1)
    brand = ref.strings("part", "p_brand", pairs[0])
    ptype = ref.strings("part", "p_type", pairs[0])
    seen: dict = {}
    for b_, t_, s_, supp in zip(brand, ptype, p_size[pairs[0]].tolist(), pairs[1].tolist()):
        seen.setdefault((b_, t_, s_), set()).add(supp)
    ranked = sorted((-len(v), k) for k, v in seen.items())
    return {"p_brand": np.array([k[0] for _, k in ranked], dtype=object),
            "p_type": np.array([k[1] for _, k in ranked], dtype=object),
            "p_size": np.array([k[2] for _, k in ranked], dtype=np.int32),
            "supplier_cnt": np.array([-c for c, _ in ranked], dtype=np.int64)}
