"""TPC-H Q3 (the shipping priority query) over the covering-index lake,
built as a DataFrame: lineitem shipped after the date joined to orders
placed before it (the join the covering indexes on the order key serve),
then to the customers of one market segment; revenue per (order, date,
priority), the ten largest, in the text's column order. Literals (2.4.3.3): ``segment`` (one of the
five) and ``date`` (a day in 1995-03-01..1995-03-31). The answer and its
reference are those of the SQL text (``sql_q3``).
"""

from __future__ import annotations

from hsbench.queries.sql_q3 import FLOATS, ORDERED, READS, TIE, TOP_K, reference  # noqa: F401


def build(session, dirs: dict, p: dict):
    from hyperspace_tpu_torch import col, sum_

    d = p["date"]
    li = session.read.parquet(dirs["lineitem"])
    od = session.read.parquet(dirs["orders"])
    cu = session.read.parquet(dirs["customer"])
    return (li.filter(col("l_shipdate") > d)
            .join(od.filter(col("o_orderdate") < d),
                  on=col("l_orderkey") == col("o_orderkey"))
            .join(cu.filter(col("c_mktsegment") == p["segment"]),
                  on=col("o_custkey") == col("c_custkey"))
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(sum_(col("l_extendedprice") * (1 - col("l_discount"))).alias("revenue"))
            .sort(("revenue", False), "o_orderdate")
            .limit(TOP_K)
            .select("l_orderkey", "revenue", "o_orderdate", "o_shippriority"))
