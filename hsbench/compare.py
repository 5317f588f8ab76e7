"""The comparison that decides ``correct``: one answer against the plain
reference's.

An answer is a pyarrow table; the reference's is ``{column: numpy
array}`` in the query's column order. A template names its computed float
columns (sums, averages): those are held within a relative limit, and
every other column, floats passed through from the data included, must
be equal. Rows are compared in order where the query orders them, else
both sides are sorted by every column first. For a top-k query the
reference gives k + 1 rows, and two neighbouring rows whose ``tie``
values lie within ``tie_rel`` of each other may come in either order.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa


class Result:
    """The outcome of one comparison: whether an exact part differs, the
    largest relative gap of a computed float, and what differed first."""

    __slots__ = ("mismatch", "rel_err", "why")

    def __init__(self, mismatch: bool, rel_err: float, why: str = ""):
        self.mismatch = mismatch
        self.rel_err = rel_err
        self.why = why


def to_numpy(table) -> dict:
    """Each column as numpy: dates as int32 days, strings as objects."""
    out = {}
    for name in table.column_names:
        arr = table.column(name).combine_chunks() if table.num_rows else \
            pa.array([], type=table.column(name).type)
        if pa.types.is_dictionary(arr.type):
            arr = arr.dictionary_decode()
        if pa.types.is_date32(arr.type):
            arr = arr.cast(pa.int32())
        if pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type):
            out[name] = np.asarray(arr.to_pylist(), dtype=object)
        else:
            out[name] = arr.to_numpy(zero_copy_only=False)
    return out


def rel_gap(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| over the larger magnitude; 0 where both are 0."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = np.maximum(np.abs(got), np.abs(want))
    gap = np.abs(got - want)
    return np.where(scale > 0, gap / np.where(scale > 0, scale, 1.0), 0.0)


def _sorted(cols: dict) -> dict:
    names = list(cols)
    if not names or len(cols[names[0]]) == 0:
        return cols
    keys = []
    for n in reversed(names):
        c = cols[n]
        if c.dtype == object:
            _, c = np.unique(c.astype(str), return_inverse=True)
        keys.append(c)
    order = np.lexsort(keys)
    return {n: c[order] for n, c in cols.items()}


def _equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.dtype == object or b.dtype == object:
        return np.array([x == y for x, y in zip(a, b)], dtype=bool)
    return np.asarray(a == b.astype(a.dtype, copy=False))


def compare(got, want: dict, floats=(), ordered: bool = True, top_k: int = 0,
            tie: str = "", tie_rel: float = 0.0) -> Result:
    if got.column_names != list(want):
        return Result(True, 0.0, f"columns {got.column_names} != {list(want)}")
    have = to_numpy(got)
    n_want = len(next(iter(want.values()))) if want else 0
    if top_k:
        n_want = min(n_want, top_k)
    if got.num_rows != n_want:
        return Result(True, 0.0, f"{got.num_rows} rows, the reference {n_want}")
    if not ordered:
        have, want = _sorted(have), _sorted(want)
    exact = [c for c in want if c not in floats]
    same = np.ones(n_want, dtype=bool)
    for c in exact:
        same &= _equal(have[c][:n_want], want[c][:n_want])
    match = np.arange(n_want)
    for i in np.flatnonzero(~same):
        # A neighbour within the tie limit may stand in this place.
        j = next((k for k in (i - 1, i + 1)
                  if tie and 0 <= k < len(want[tie])
                  and rel_gap(want[tie][k], want[tie][i]) <= tie_rel
                  and all(_equal(have[c][i:i + 1], want[c][k:k + 1])[0] for c in exact)),
                 None)
        if j is None:
            c = next(c for c in exact if not _equal(have[c][i:i + 1], want[c][i:i + 1])[0])
            return Result(True, 0.0, f"row {i} {c}: {have[c][i]!r} != {want[c][i]!r}")
        match[i] = j
    rel = 0.0
    for c in floats:
        if n_want:
            rel = max(rel, float(np.max(rel_gap(have[c][:n_want], want[c][match]))))
    return Result(False, rel)
