"""Predicate pushdown to the parquet reader (counterpart of
``hyperspace_tpu/execution/pushdown.py``).

Conjuncts of the form Col <op> Literal and Col IN (literals), and ORs of
them, become pyarrow expressions handed to the parquet reader, which skips
row groups whose min/max statistics cannot match. The device Filter stays
in the plan: pushdown is an IO optimization, not a semantic transfer. This
is where the covering index's within-bucket sort pays off: index files are
sorted by the indexed columns, so row-group statistics are tight.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..plan import expr as E
from ..schema import DATE, FLOAT32, Schema

_OPS = {
    "EqualTo": lambda f, v: f == v,
    "LessThan": lambda f, v: f < v,
    "LessThanOrEqual": lambda f, v: f <= v,
    "GreaterThan": lambda f, v: f > v,
    "GreaterThanOrEqual": lambda f, v: f >= v,
}

_FLIP = {
    "EqualTo": "EqualTo",
    "LessThan": "GreaterThan",
    "LessThanOrEqual": "GreaterThanOrEqual",
    "GreaterThan": "LessThan",
    "GreaterThanOrEqual": "LessThanOrEqual",
}

_CMP_TYPES = tuple(getattr(E, n) for n in _OPS)


def _literal(value, column: str, schema: Schema):
    dtype = schema.field(column).dtype if column in schema else None
    # Date columns accept ISO strings in the expression language; parquet
    # statistics need a real date value.
    if dtype == DATE and isinstance(value, str):
        return datetime.date.fromisoformat(value)
    if dtype == FLOAT32 and isinstance(value, (int, float)):
        # The device mask compares a float32 column with the literal
        # rounded to float32 (the JAX package's weak-scalar rule; +-inf past
        # its range, NaN kept). pyarrow would compare a Python float in
        # float64, where 1.1f != 1.1, and drop rows the mask keeps.
        with np.errstate(over="ignore"):
            return pa.scalar(np.float32(float(value)), pa.float32())
    return value


def _zero_twins(values) -> list:
    """pyarrow's is_in hashes its value set, so -0.0 and 0.0 do not match
    each other there, while every comparison (the device mask's too) holds
    them equal: a float zero brings its twin into the set."""
    out = []
    for v in values:
        py = v.as_py() if isinstance(v, pa.Scalar) else v
        if isinstance(py, float) and py == 0.0:
            out.append(pa.scalar(-py, v.type) if isinstance(v, pa.Scalar) else -py)
    return out


def _translate(e: E.Expr, schema: Schema, allow_nested: bool):
    def field(column: str):
        # A dotted name is a flattened struct leaf. In source files the
        # physical column is the root struct, and pc.field("a.b") raises
        # against it; index files store the leaves as flat dotted columns.
        if "." in column and not allow_nested:
            return None
        return pc.field(column)

    if isinstance(e, _CMP_TYPES):
        op = type(e).__name__
        left, right = e.left, e.right
        if isinstance(left, E.Lit) and isinstance(right, E.Col):
            left, right = right, left
            op = _FLIP[op]
        if isinstance(left, E.Col) and isinstance(right, E.Lit):
            f = field(left.column)
            if f is None:
                return None
            return _OPS[op](f, _literal(right.value, left.column, schema))
        return None
    if isinstance(e, E.In) and isinstance(e.value, E.Col):
        values = [_literal(o.value, e.value.column, schema)
                  for o in e.options if isinstance(o, E.Lit)]
        if len(values) == len(e.options):
            f = field(e.value.column)
            return None if f is None else f.isin(values + _zero_twins(values))
        return None
    if isinstance(e, E.Or):
        left = _translate(e.left, schema, allow_nested)
        right = _translate(e.right, schema, allow_nested)
        if left is not None and right is not None:
            return left | right
    return None


def filter_constrains(condition: E.Expr, schema: Schema, column: str) -> bool:
    """True when a pushable conjunct references ``column`` alone."""
    for conjunct in E.split_conjunctive_predicates(condition):
        if conjunct.references == [column] \
                and _translate(conjunct, schema, True) is not None:
            return True
    return False


def prefers_pruned_read(entry, condition: E.Expr, schema: Schema) -> bool:
    """A pushable conjunct on the leading indexed column makes row-group
    statistics tight (the index sorts on it within each bucket): a pruned
    parquet read costs about the selectivity of the file, far less than
    masking the whole cached table. The other filters read the cache."""
    return (entry.derivedDataset.kind == "CoveringIndex"
            and bool(entry.indexed_columns)
            and filter_constrains(condition, schema, entry.indexed_columns[0]))


def pruned_index_read_filter(entry, condition: E.Expr,
                             schema: Schema) -> Optional[pc.Expression]:
    """The pyarrow filter to read a covering index with instead of the
    cache, or None to read the cache."""
    if not prefers_pruned_read(entry, condition, schema):
        return None
    return pushable_filter(condition, schema)


def pushable_filter(condition: E.Expr, schema: Schema,
                    allow_nested: bool = True) -> Optional[pc.Expression]:
    """AND of the translatable conjuncts, or None. Pushing a subset is
    sound: each conjunct is a necessary condition, and the full device
    filter still runs afterward. ``allow_nested=False`` leaves out dotted
    (struct-leaf) columns, as a source scan must."""
    out = None
    for conjunct in E.split_conjunctive_predicates(condition):
        t = _translate(conjunct, schema, allow_nested)
        if t is not None:
            out = t if out is None else (out & t)
    return out
