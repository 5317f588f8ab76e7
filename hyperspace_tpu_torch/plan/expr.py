"""Expression tree for the logical plan IR (counterpart of
``hyperspace_tpu/plan/expr.py``): column references, literals,
comparisons, IN lists, boolean algebra, arithmetic, aliases, LIKE, IS
NULL, CASE, date parts, substring, upper/lower/trim, concat, the typed
NULL, sqrt, the Sum/Count/Min/Max/Avg/CountDistinct aggregates and the
window functions.

Every expression evaluates to a whole column (vectorized). ``repr``
matches the JAX package's: plan tree strings embed it.
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

    def like(self, pattern: str):
        """SQL LIKE (% = any run, _ = any one char), full-string match."""
        return Like(self, pattern)

    def is_null(self):
        return IsNull(self)

    def is_not_null(self):
        return IsNull(self, negated=True)

    def substr(self, start: int, length: Optional[int] = None):
        """SQL SUBSTRING: 1-based ``start``, optional ``length``."""
        return Substring(self, start, length)

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
        if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
            object.__setattr__(self, "value", v)
        elif not isinstance(v, (int, float, bool, str, type(None))):
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


class Like(Expr):
    """SQL LIKE predicate. The reference inherits Spark's full expression
    surface (rules/FilterIndexRule.scala:165-186 matches ANY Filter
    condition); LIKE is the workhorse of TPC-H/TPC-DS string predicates
    (e.g. tpcds/queries' p_type filters). Evaluated over the
    order-preserving string dictionary, so the per-row cost is one gather.
    """

    op_name = "Like"

    def __init__(self, child: Expr, pattern: str, negated: bool = False):
        if not isinstance(pattern, str):
            raise HyperspaceException("LIKE pattern must be a string literal")
        self.child = child
        self.pattern = pattern
        self.negated = negated

    @property
    def children(self) -> List[Expr]:
        return [self.child]

    def __repr__(self):
        return (f"{self.child!r} {'NOT ' if self.negated else ''}"
                f"LIKE {self.pattern!r}")


class IsNull(Expr):
    """IS [NOT] NULL predicate (never yields null itself)."""

    op_name = "IsNull"

    def __init__(self, child: Expr, negated: bool = False):
        self.child = child
        self.negated = negated

    @property
    def children(self) -> List[Expr]:
        return [self.child]

    def __repr__(self):
        return f"{self.child!r} IS {'NOT ' if self.negated else ''}NULL"


class CaseWhen(Expr):
    """CASE WHEN c1 THEN v1 [WHEN ...]* [ELSE e] END. A null/false
    condition falls through; no matching branch and no ELSE yields null
    (SQL semantics)."""

    op_name = "CaseWhen"

    def __init__(self, branches: Sequence[Tuple[Expr, Expr]],
                 else_value: Optional[Expr] = None):
        if not branches:
            raise HyperspaceException("CASE requires at least one WHEN")
        self.branches = [(c, _wrap(v)) for c, v in branches]
        self.else_value = _wrap(else_value) if else_value is not None \
            and not isinstance(else_value, Expr) else else_value

    @property
    def children(self) -> List[Expr]:
        out: List[Expr] = []
        for c, v in self.branches:
            out.extend((c, v))
        if self.else_value is not None:
            out.append(self.else_value)
        return out

    def __repr__(self):
        parts = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self.branches)
        tail = f" ELSE {self.else_value!r}" if self.else_value is not None else ""
        return f"CASE {parts}{tail} END"


_DATE_PARTS = ("year", "month", "day", "quarter")


class DatePart(Expr):
    """EXTRACT(part FROM date) — year/month/day/quarter as int64."""

    op_name = "DatePart"

    def __init__(self, part: str, child: Expr):
        part = part.lower()
        if part not in _DATE_PARTS:
            raise HyperspaceException(
                f"EXTRACT supports {_DATE_PARTS}, got {part!r}")
        self.part = part
        self.child = child

    @property
    def children(self) -> List[Expr]:
        return [self.child]

    def __repr__(self):
        return f"EXTRACT({self.part} FROM {self.child!r})"


class Substring(Expr):
    """SQL SUBSTRING with 1-based literal start/length (evaluated on the
    string dictionary, one re-encode + gather per column)."""

    op_name = "Substring"

    def __init__(self, child: Expr, start: int, length: Optional[int] = None):
        if not isinstance(start, int) or \
                (length is not None and not isinstance(length, int)):
            raise HyperspaceException(
                "SUBSTRING start/length must be integer literals")
        self.child = child
        self.start = start
        self.length = length

    @property
    def children(self) -> List[Expr]:
        return [self.child]

    def __repr__(self):
        tail = f", {self.length}" if self.length is not None else ""
        return f"SUBSTRING({self.child!r}, {self.start}{tail})"


class StringTransform(Expr):
    """UPPER/LOWER/TRIM — per-dictionary-entry host transform + gather."""

    _FNS = ("upper", "lower", "trim")
    op_name = "StringTransform"

    def __init__(self, fn: str, child: Expr):
        fn = fn.lower()
        if fn not in self._FNS:
            raise HyperspaceException(
                f"String function must be one of {self._FNS}, got {fn!r}")
        self.fn = fn
        self.child = child

    @property
    def children(self) -> List[Expr]:
        return [self.child]

    def __repr__(self):
        return f"{self.fn.upper()}({self.child!r})"


# ---------------------------------------------------------------------------
# Aggregates.
# ---------------------------------------------------------------------------

class Concat(Expr):
    """String concatenation with at most ONE column operand (the TPC-DS
    q5 ``concat('store', s_store_id)`` shape): evaluates as a pure
    dictionary rewrite — codes never change, the per-value strings do."""

    def __init__(self, parts: Sequence[Expr]):
        if sum(1 for p in parts if not isinstance(p, Lit)) > 1:
            raise HyperspaceException(
                "concat() supports at most one column operand "
                "(literal affixes rewrite the dictionary; general "
                "column-column concat would need a cross dictionary)")
        self.parts = list(parts)

    @property
    def children(self) -> List[Expr]:
        return list(self.parts)

    @property
    def name(self) -> str:
        return "concat(" + ", ".join(p.name for p in self.parts) + ")"

    def __repr__(self):
        return "concat(" + ", ".join(repr(p) for p in self.parts) + ")"


class NullLit(Expr):
    """A typed all-NULL constant column (the ROLLUP lowering's filler for
    rolled-up grouping keys; a bare ``Lit(None)`` has no type)."""

    def __init__(self, dtype: str):
        self.dtype = dtype

    @property
    def name(self) -> str:
        return f"null:{self.dtype}"

    def __repr__(self):
        return f"null({self.dtype})"


class Sqrt(Expr):
    """Square root (needed by the STDDEV lowering; the reference gets it
    from Spark SQL's function library)."""

    def __init__(self, child: Expr):
        self.child = child

    @property
    def children(self) -> List[Expr]:
        return [self.child]

    @property
    def name(self) -> str:
        return f"sqrt({self.child.name})"

    def __repr__(self):
        return f"sqrt({self.child!r})"


def sqrt(e) -> Sqrt:
    return Sqrt(_wrap(e))


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


class WindowExpr(Expr):
    """``fn([arg]) OVER (PARTITION BY p... [ORDER BY o [ASC|DESC]...]
    [frame])`` — the analytic-function marker the SQL front-end lowers to
    a Window plan node (the reference inherits these from Spark SQL; the
    TPC-DS corpus uses rank/sum/avg-over — e.g. queries q51/q53/q63/q89).

    ``fn``: 'rank' | 'dense_rank' | 'row_number' | 'sum' | 'avg' | 'min' |
    'max' | 'count'. ``frame``: 'partition' (whole partition — the SQL
    default without ORDER BY), 'range' (running aggregate including order
    peers — the default with ORDER BY), or 'rows' (running, row at a
    time — ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)."""

    RANK_FNS = ("rank", "dense_rank", "row_number")
    AGG_FNS = ("sum", "avg", "min", "max", "count")

    def __init__(self, fn: str, arg: Optional[Expr],
                 partition: Sequence[Expr],
                 orders: Sequence[Tuple[Expr, bool]],
                 frame: str = None):
        if fn not in self.RANK_FNS + self.AGG_FNS:
            raise HyperspaceException(f"Unknown window function {fn!r}")
        self.fn = fn
        self.arg = arg
        self.partition = list(partition)
        self.orders = [(e, bool(asc)) for e, asc in orders]
        if fn in self.RANK_FNS and not self.orders:
            raise HyperspaceException(
                f"window function {fn}() requires ORDER BY")
        if fn in ("sum", "avg", "min", "max") and arg is None:
            raise HyperspaceException(
                f"window function {fn}() requires an argument")
        if frame is None:
            frame = "range" if self.orders else "partition"
        if frame not in ("partition", "range", "rows"):
            raise HyperspaceException(f"Unknown window frame {frame!r}")
        self.frame = frame

    @property
    def children(self) -> List[Expr]:
        out = [] if self.arg is None else [self.arg]
        out.extend(self.partition)
        out.extend(e for e, _ in self.orders)
        return out

    @property
    def name(self) -> str:
        inner = "" if self.arg is None else self.arg.name
        return f"{self.fn}({inner}) OVER"

    def __repr__(self):
        parts = []
        if self.partition:
            parts.append("PARTITION BY "
                         + ", ".join(repr(p) for p in self.partition))
        if self.orders:
            parts.append("ORDER BY " + ", ".join(
                f"{e!r} {'ASC' if asc else 'DESC'}" for e, asc in self.orders))
        if self.frame == "rows":
            parts.append("ROWS UNBOUNDED PRECEDING")
        inner = "" if self.arg is None else repr(self.arg)
        return f"{self.fn}({inner}) OVER ({' '.join(parts)})"


def window(fn: str, arg=None, partition_by=(), order_by=(),
           frame: str = None) -> WindowExpr:
    """Public constructor: ``order_by`` items are exprs/names or
    (expr, ascending) pairs."""
    orders = []
    for o in order_by:
        if isinstance(o, tuple):
            e, asc = o
        else:
            e, asc = o, True
        orders.append((Col(e) if isinstance(e, str) else _wrap(e), asc))
    part = [Col(p) if isinstance(p, str) else _wrap(p) for p in partition_by]
    return WindowExpr(fn, None if arg is None else (
        Col(arg) if isinstance(arg, str) else _wrap(arg)), part, orders,
        frame)


class CountDistinct(AggExpr):
    """COUNT(DISTINCT child). Deliberately NOT a Count subclass: distinct
    counts are not decomposable (run partials cannot combine), so the
    two-phase and SPMD paths must not treat it as a plain count."""

    agg_name = "CountDistinct"

    def __init__(self, child: Expr):
        if child is None:
            raise ValueError("count_distinct requires a column expression")
        super().__init__(child)


# Public helpers (the pyspark-like functions module).

def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def sum_(e) -> Sum:
    return Sum(_wrap(e) if not isinstance(e, Expr) else e)


def count(e=None) -> Count:
    return Count(_wrap(e) if e is not None and not isinstance(e, Expr) else e)


def min_(e) -> Min:
    return Min(_wrap(e) if not isinstance(e, Expr) else e)


def max_(e) -> Max:
    return Max(_wrap(e) if not isinstance(e, Expr) else e)


def avg(e) -> Avg:
    return Avg(_wrap(e) if not isinstance(e, Expr) else e)


def count_distinct(e) -> CountDistinct:
    if e is None:
        # count(None) means COUNT(*); the distinct analogue has no meaning.
        raise ValueError("count_distinct requires a column expression")
    return CountDistinct(_wrap(e) if not isinstance(e, Expr) else e)


def case_when(branches: Sequence[Tuple[Expr, Any]],
              else_value: Any = None) -> CaseWhen:
    return CaseWhen([(c, _wrap(v)) for c, v in branches],
                    _wrap(else_value) if else_value is not None else None)


def year(e) -> DatePart:
    return DatePart("year", _wrap(e))


def month(e) -> DatePart:
    return DatePart("month", _wrap(e))


def dayofmonth(e) -> DatePart:
    return DatePart("day", _wrap(e))


def quarter(e) -> DatePart:
    return DatePart("quarter", _wrap(e))


def substring(e, start: int, length: Optional[int] = None) -> Substring:
    return Substring(_wrap(e), start, length)


def upper(e) -> StringTransform:
    return StringTransform("upper", _wrap(e))


def lower(e) -> StringTransform:
    return StringTransform("lower", _wrap(e))


def trim(e) -> StringTransform:
    return StringTransform("trim", _wrap(e))


# ---------------------------------------------------------------------------
# Predicate utilities used by the rewrite rules.
# ---------------------------------------------------------------------------

def map_children(e: Expr, fn) -> Expr:
    """Rebuild ``e`` with every direct child replaced by ``fn(child)``.
    The single structural-rewrite primitive: rename_columns, the SQL
    front-end's alias resolution, and the rules' substitution walkers all
    ride on it, so a new Expr kind only needs one case here."""
    if isinstance(e, (Col, Lit, NullLit)):
        return e
    if isinstance(e, _Binary):
        return type(e)(fn(e.left), fn(e.right))
    if isinstance(e, Not):
        return Not(fn(e.child))
    if isinstance(e, In):
        return In(fn(e.value), [fn(o) for o in e.options])
    if isinstance(e, Alias):
        return Alias(fn(e.child), e.alias_name)
    if isinstance(e, Like):
        return Like(fn(e.child), e.pattern, e.negated)
    if isinstance(e, IsNull):
        return IsNull(fn(e.child), e.negated)
    if isinstance(e, CaseWhen):
        return CaseWhen([(fn(c), fn(v)) for c, v in e.branches],
                        fn(e.else_value) if e.else_value is not None else None)
    if isinstance(e, DatePart):
        return DatePart(e.part, fn(e.child))
    if isinstance(e, Substring):
        return Substring(fn(e.child), e.start, e.length)
    if isinstance(e, StringTransform):
        return StringTransform(e.fn, fn(e.child))
    if isinstance(e, Sqrt):
        return Sqrt(fn(e.child))
    if isinstance(e, Concat):
        return Concat([fn(p) for p in e.parts])
    if isinstance(e, AggExpr):
        if e.child is None:
            return e
        return type(e)(fn(e.child))
    if isinstance(e, WindowExpr):
        return WindowExpr(e.fn, None if e.arg is None else fn(e.arg),
                          [fn(p) for p in e.partition],
                          [(fn(o), asc) for o, asc in e.orders], e.frame)
    raise HyperspaceException(f"Cannot rewrite expression {e!r}")


def rename_columns(e: Expr, rename) -> Expr:
    """Rebuild ``e`` with every Col reference passed through ``rename``
    (a str -> str mapping). Used by the DataFrame API's case-insensitive
    resolution: user-spelled names are rewritten to the schema's spelling
    before plan construction. Nodes without Col descendants are returned
    as-is (Exprs are immutable, sharing is safe)."""
    if isinstance(e, Col):
        new = rename(e.column)
        return e if new == e.column else Col(new)
    return map_children(e, lambda c: rename_columns(c, rename))


def split_conjunctive_predicates(e: Expr) -> List[Expr]:
    """Flatten nested ANDs into a list (CNF top level)."""
    if isinstance(e, And):
        return split_conjunctive_predicates(e.left) + split_conjunctive_predicates(e.right)
    return [e]


def conjoin(parts: Sequence[Expr]) -> Expr:
    """Left-fold a non-empty predicate list back into one AND tree (the
    inverse of split_conjunctive_predicates for left-associated input)."""
    out = parts[0]
    for p in parts[1:]:
        out = out & p
    return out


def extract_equi_join_keys(condition: Expr) -> Optional[List[Tuple[str, str]]]:
    """If ``condition`` is a conjunction of column=column equalities, return
    the (left, right) column-name pairs; else None.

    Parity: JoinIndexRule's isJoinConditionSupported (reference
    rules/JoinIndexRule.scala:135) — only CNF of EqualTo over direct column
    refs is supported.
    """
    if condition is None:  # cross join: no keys
        return None
    pairs: List[Tuple[str, str]] = []
    for pred in split_conjunctive_predicates(condition):
        if isinstance(pred, EqualTo) and isinstance(pred.left, Col) \
                and isinstance(pred.right, Col):
            pairs.append((pred.left.column, pred.right.column))
        else:
            return None
    return pairs
