"""TPC-H Q17 (the small-quantity-order revenue query) over the
covering-index lake, built as a DataFrame: the per-part average quantity
as a group-by joined back; lineitem of one brand and container below a
fifth of its part's average; the yearly price. Literals (2.4.17.3):
``brand`` (one of the 25) and ``container`` (one of the 40). The answer
and its reference are those of the SQL text (``sql_q17``).
"""

from __future__ import annotations

from hsbench.queries.sql_q17 import FLOATS, ORDERED, READS, reference  # noqa: F401


def build(session, dirs: dict, p: dict):
    from hyperspace_tpu_torch import avg, col, sum_

    li = session.read.parquet(dirs["lineitem"])
    pt = session.read.parquet(dirs["part"])
    thr = (li.group_by("l_partkey")
           .agg(avg(col("l_quantity")).alias("avg_qty"))
           .select(col("l_partkey").alias("t_partkey"),
                   (col("avg_qty") * 0.2).alias("qty_thr")))
    return (li.join(pt.filter((col("p_brand") == p["brand"])
                              & (col("p_container") == p["container"])),
                    on=col("l_partkey") == col("p_partkey"))
            .join(thr, on=col("l_partkey") == col("t_partkey"))
            .filter(col("l_quantity") < col("qty_thr"))
            .agg(sum_(col("l_extendedprice")).alias("price_sum"))
            .select((col("price_sum") / 7.0).alias("avg_yearly")))
