"""The frozen generator reproduces from the seed, at a tiny scale, and
writes only the tables and columns a configuration lists."""

import os

import pyarrow.parquet as pq
import pytest

from hsbench.data import tpch_sql

BIG_SEED = 2 ** 33 + 12345  # larger than 32 signed bits hold
SUBSET = {"lineitem": ["l_orderkey", "l_shipdate"], "customer": ["c_custkey", "c_mktsegment"]}


def tables(root: str, dirs: dict) -> dict:
    return {t: pq.read_table(d) for t, d in sorted(dirs.items())}


@pytest.mark.parametrize("subset", [None, SUBSET], ids=["whole", "subset"])
def test_same_seed_same_tables(subset, tmp_path):
    config = {"scale": 0.002} if subset is None else {"scale": 0.002, "tables": subset}
    a = tpch_sql.make(str(tmp_path / "a"), config, BIG_SEED)
    b = tpch_sql.make(str(tmp_path / "b"), config, BIG_SEED)
    c = tpch_sql.make(str(tmp_path / "c"), config, BIG_SEED + 1)
    assert a["rows"] == b["rows"] == c["rows"]
    ta, tb, tc = (tables(str(tmp_path), x["dirs"]) for x in (a, b, c))
    assert all(ta[t].equals(tb[t]) for t in ta)
    assert not all(ta[t].equals(tc[t]) for t in ta)
    for t, d in a["dirs"].items():
        assert sorted(os.listdir(d)) == sorted(os.listdir(b["dirs"][t]))


def test_subset_holds_what_the_whole_lake_holds(tmp_path):
    whole = tpch_sql.make(str(tmp_path / "w"), {"scale": 0.01}, 3)
    part = tpch_sql.make(str(tmp_path / "s"), {"scale": 0.01, "tables": SUBSET}, 3)
    assert part["rows"] == {"lineitem": 60_000, "customer": 1_500}
    assert sorted(part["dirs"]) == sorted(SUBSET)
    assert len(os.listdir(part["dirs"]["lineitem"])) == tpch_sql.TPCH_SQL_FILES["lineitem"]
    for t, cols in SUBSET.items():
        got = pq.read_table(part["dirs"][t])
        assert got.column_names == cols
        assert got.equals(pq.read_table(whole["dirs"][t], columns=cols))
