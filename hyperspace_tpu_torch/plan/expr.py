"""Expression tree for the logical plan IR (counterpart of
``hyperspace_tpu/plan/expr.py``, trimmed to column references, literals,
the five comparisons, IN lists, boolean algebra, arithmetic, aliases and
the Sum/Count/Min/Max/Avg aggregates).

Every expression evaluates to a whole column (vectorized).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

from ..exceptions import HyperspaceException


class Expr:
    """Base class. Operators build trees; `references` lists column names."""

    def __eq__(self, other):  # == builds an expression, not a bool.
        return EqualTo(self, _wrap(other))

    def __ne__(self, other):
        return Not(EqualTo(self, _wrap(other)))

    def __lt__(self, other):
        return LessThan(self, _wrap(other))

    def __le__(self, other):
        return LessThanOrEqual(self, _wrap(other))

    def __gt__(self, other):
        return GreaterThan(self, _wrap(other))

    def __ge__(self, other):
        return GreaterThanOrEqual(self, _wrap(other))

    def __and__(self, other):
        return And(self, _wrap(other))

    def __or__(self, other):
        return Or(self, _wrap(other))

    def __invert__(self):
        return Not(self)

    def __add__(self, other):
        return Add(self, _wrap(other))

    def __radd__(self, other):
        return Add(_wrap(other), self)

    def __sub__(self, other):
        return Subtract(self, _wrap(other))

    def __rsub__(self, other):
        return Subtract(_wrap(other), self)

    def __mul__(self, other):
        return Multiply(self, _wrap(other))

    def __rmul__(self, other):
        return Multiply(_wrap(other), self)

    def __truediv__(self, other):
        return Divide(self, _wrap(other))

    def __hash__(self):
        return hash(repr(self))

    def isin(self, values: Sequence[Any]):
        return In(self, [_wrap(v) for v in values])

    def between(self, low, high):
        return And(GreaterThanOrEqual(self, _wrap(low)),
                   LessThanOrEqual(self, _wrap(high)))

    def alias(self, name: str):
        return Alias(self, name)

    @property
    def references(self) -> List[str]:
        out: List[str] = []
        for c in self.children:
            out.extend(c.references)
        # De-dup preserving order.
        seen = set()
        return [x for x in out if not (x in seen or seen.add(x))]

    @property
    def children(self) -> List["Expr"]:
        return []

    @property
    def name(self) -> str:
        """Output column name when projected."""
        return repr(self)


def _wrap(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    return Lit(v)


@dataclass(frozen=True, eq=False, repr=False)
class Col(Expr):
    column: str

    @property
    def references(self) -> List[str]:
        return [self.column]

    @property
    def name(self) -> str:
        return self.column

    def __repr__(self):
        return f"col({self.column})"


@dataclass(frozen=True, eq=False, repr=False)
class Lit(Expr):
    value: Any

    def __post_init__(self):
        v = self.value
        if not isinstance(v, (int, float, bool, str, datetime.date, type(None))) \
                or isinstance(v, datetime.datetime):
            raise HyperspaceException(f"Unsupported literal type: {type(v)}")

    def __repr__(self):
        return f"lit({self.value!r})"


class _Binary(Expr):
    op_name = "?"
    symbol = "?"

    def __init__(self, left: Expr, right: Expr):
        self.left = left
        self.right = right

    @property
    def children(self) -> List[Expr]:
        return [self.left, self.right]

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class EqualTo(_Binary):
    op_name, symbol = "EqualTo", "="


class LessThan(_Binary):
    op_name, symbol = "LessThan", "<"


class LessThanOrEqual(_Binary):
    op_name, symbol = "LessThanOrEqual", "<="


class GreaterThan(_Binary):
    op_name, symbol = "GreaterThan", ">"


class GreaterThanOrEqual(_Binary):
    op_name, symbol = "GreaterThanOrEqual", ">="


class And(_Binary):
    op_name, symbol = "And", "AND"


class Or(_Binary):
    op_name, symbol = "Or", "OR"


class Add(_Binary):
    op_name, symbol = "Add", "+"


class Subtract(_Binary):
    op_name, symbol = "Subtract", "-"


class Multiply(_Binary):
    op_name, symbol = "Multiply", "*"


class Divide(_Binary):
    op_name, symbol = "Divide", "/"


class Not(Expr):
    op_name = "Not"

    def __init__(self, child: Expr):
        self.child = child

    @property
    def children(self) -> List[Expr]:
        return [self.child]

    def __repr__(self):
        return f"NOT({self.child!r})"


class In(Expr):
    op_name = "In"

    def __init__(self, value: Expr, options: List[Expr]):
        self.value = value
        self.options = options

    @property
    def children(self) -> List[Expr]:
        return [self.value] + list(self.options)

    def __repr__(self):
        return f"{self.value!r} IN ({', '.join(map(repr, self.options))})"


@dataclass(frozen=True, eq=False, repr=False)
class Alias(Expr):
    child: Expr
    alias_name: str

    @property
    def children(self) -> List[Expr]:
        return [self.child]

    @property
    def name(self) -> str:
        return self.alias_name

    def __repr__(self):
        return f"{self.child!r} AS {self.alias_name}"


# ---------------------------------------------------------------------------
# Aggregates.
# ---------------------------------------------------------------------------

class AggExpr(Expr):
    agg_name = "?"

    def __init__(self, child: Optional[Expr]):
        self.child = child

    @property
    def children(self) -> List[Expr]:
        return [self.child] if self.child is not None else []

    @property
    def name(self) -> str:
        inner = self.child.name if self.child is not None else "*"
        return f"{self.agg_name.lower()}({inner})"

    def __repr__(self):
        return self.name


class Sum(AggExpr):
    agg_name = "Sum"


class Count(AggExpr):
    agg_name = "Count"


class Min(AggExpr):
    agg_name = "Min"


class Max(AggExpr):
    agg_name = "Max"


class Avg(AggExpr):
    agg_name = "Avg"


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def sum_(e) -> Sum:
    return Sum(_wrap(e))


def count(e=None) -> Count:
    return Count(None if e is None else _wrap(e))


def min_(e) -> Min:
    return Min(_wrap(e))


def max_(e) -> Max:
    return Max(_wrap(e))


def avg(e) -> Avg:
    return Avg(_wrap(e))


def rename_columns(e: Expr, rename) -> Expr:
    """Rebuild ``e`` with every Col reference passed through ``rename``
    (a str -> str mapping): the DataFrame API's case-insensitive
    resolution rewrites user spellings to the schema's."""
    if isinstance(e, Col):
        new = rename(e.column)
        return e if new == e.column else Col(new)
    return map_children(e, lambda c: rename_columns(c, rename))


def map_children(e: Expr, fn) -> Expr:
    """Rebuild ``e`` with every direct child replaced by ``fn(child)``."""
    if isinstance(e, (Col, Lit)):
        return e
    if isinstance(e, _Binary):
        return type(e)(fn(e.left), fn(e.right))
    if isinstance(e, Not):
        return Not(fn(e.child))
    if isinstance(e, In):
        return In(fn(e.value), [fn(o) for o in e.options])
    if isinstance(e, Alias):
        return Alias(fn(e.child), e.alias_name)
    if isinstance(e, AggExpr):
        return e if e.child is None else type(e)(fn(e.child))
    raise HyperspaceException(f"Cannot rewrite expression {e!r}")


def split_conjunctive_predicates(e: Expr) -> List[Expr]:
    """Flatten nested ANDs into a list (CNF top level)."""
    if isinstance(e, And):
        return split_conjunctive_predicates(e.left) + split_conjunctive_predicates(e.right)
    return [e]


def conjoin(parts: Sequence[Expr]) -> Expr:
    """Left-fold a non-empty predicate list back into one AND tree."""
    out = parts[0]
    for p in parts[1:]:
        out = out & p
    return out


def extract_equi_join_keys(condition: Expr) -> Optional[List[Tuple[str, str]]]:
    """The (left, right) column-name pairs of a conjunction of column =
    column equalities, or None for any other condition."""
    pairs: List[Tuple[str, str]] = []
    for pred in split_conjunctive_predicates(condition):
        if isinstance(pred, EqualTo) and isinstance(pred.left, Col) \
                and isinstance(pred.right, Col):
            pairs.append((pred.left.column, pred.right.column))
        else:
            return None
    return pairs
