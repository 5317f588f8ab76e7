"""Literal draws from the parameter domains a workload file states.

A domain is a small JSON object; a template reads the drawn values by
name. The kinds:

- ``{"date": ["1995-03-01", "1995-03-31"]}``: a day, uniform, both ends in;
- ``{"month": ["1993-01", "1997-10"]}``: the first day of a uniform month;
- ``{"int": [lo, hi]}``: an integer, uniform, both ends in;
- ``{"choice": [...]}``: one value, uniform;
- ``{"sample": [...], "k": n}``: n distinct values, in the order drawn;
- ``{"decimal": ["0.02", "0.09", "0.01"]}``: a decimal string on the grid
  lo, lo + step, ..., hi, uniform.

Every draw takes its randomness from the ``random.Random`` it is given, so
one seed gives one sequence of literals.
"""

from __future__ import annotations

import datetime
import random
from decimal import Decimal


def _date(text: str) -> datetime.date:
    return datetime.date.fromisoformat(text)


def draw_one(domain: dict, rng: random.Random):
    (kind, arg), = ((k, v) for k, v in domain.items() if k != "k")
    if kind == "date":
        lo, hi = _date(arg[0]), _date(arg[1])
        return lo + datetime.timedelta(days=rng.randint(0, (hi - lo).days))
    if kind == "month":
        (y0, m0), (y1, m1) = (map(int, s.split("-")) for s in arg)
        i = rng.randint(0, (y1 - y0) * 12 + m1 - m0)
        return datetime.date(y0 + (m0 - 1 + i) // 12, (m0 - 1 + i) % 12 + 1, 1)
    if kind == "int":
        return rng.randint(int(arg[0]), int(arg[1]))
    if kind == "choice":
        return rng.choice(list(arg))
    if kind == "sample":
        return rng.sample(list(arg), int(domain["k"]))
    if kind == "decimal":
        lo, hi, step = (Decimal(s) for s in arg)
        return str(lo + step * rng.randint(0, int((hi - lo) / step)))
    raise ValueError(f"unknown domain kind {kind!r}")


def draw(domains: dict, rng: random.Random) -> dict:
    """One value for each named domain, in the order the file lists them."""
    return {name: draw_one(domain, rng) for name, domain in domains.items()}


def client_rng(seed: int, client: int) -> random.Random:
    """The literal stream of one client: fixed by the run's seed and the
    client's number (string seeds hash the same in every process)."""
    return random.Random(f"hsbench:{seed}:{client}")
