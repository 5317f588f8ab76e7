"""Literal draws repeat for a seed and stay inside their domains."""

import datetime

from hsbench import harness, params

DOMAINS = {
    "cutoff": {"date": ["1995-03-01", "1995-03-31"]},
    "month": {"month": ["1993-01", "1997-10"]},
    "key": {"int": [0, 999]},
    "brand": {"choice": ["Brand#11", "Brand#23"]},
    "sizes": {"sample": list(range(1, 51)), "k": 8},
    "discount": {"decimal": ["0.02", "0.09", "0.01"]},
}


def draws(seed: int, client: int, n: int = 50) -> list:
    rng = params.client_rng(seed, client)
    return [params.draw(DOMAINS, rng) for _ in range(n)]


def test_draws_repeat_for_a_seed():
    assert draws(2 ** 33 + 1, 0) == draws(2 ** 33 + 1, 0)
    assert draws(2 ** 33 + 1, 0) != draws(2 ** 33 + 2, 0)
    assert draws(5, 0) != draws(5, 1)


def test_draws_stay_in_their_domains():
    for p in draws(11, 3, 400):
        assert datetime.date(1995, 3, 1) <= p["cutoff"] <= datetime.date(1995, 3, 31)
        assert p["month"].day == 1 and (1993, 1) <= (p["month"].year, p["month"].month) <= (1997, 10)
        assert 0 <= p["key"] <= 999
        assert len(set(p["sizes"])) == 8 and all(1 <= s <= 50 for s in p["sizes"])
        assert p["discount"] in {f"0.0{d}" for d in range(2, 10)}


def test_every_workload_draws_from_its_own_file():
    """Each cell's domains draw, and a client's stream of literals repeats
    for a seed."""
    for name in ("tpch_sf10.join_indexed", "tpch_sql_sf2.streams"):
        work, config = harness.load_cell(name)
        for entry in work["mix"]:
            a = [params.draw(entry["params"], params.client_rng(9, 1)) for _ in range(3)]
            b = [params.draw(entry["params"], params.client_rng(9, 1)) for _ in range(3)]
            assert a == b
