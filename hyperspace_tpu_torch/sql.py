"""A SQL SELECT front-end over registered temp views (counterpart of
``hyperspace_tpu/sql.py``, the same grammar and the same lowering onto
this package's DataFrame API and ``plan/expr``).

The reference's users write Spark SQL; this framework's primary surface is
the DataFrame IR, and `session.sql(...)` lowers a practical SELECT subset
onto it — so every index rewrite, skipping rule, and execution path behaves
exactly as for the equivalent DataFrame query. The grammar is wide enough
to run the verbatim TPC-H texts the reference exercises through Spark
(goldstandard/TPCDSBase.scala pattern; tests/test_tpch_sql.py runs the
actual query texts).

Supported grammar (case-insensitive keywords):

    query      := select [UNION ALL select]*
    select     := SELECT [DISTINCT] <*| expr [AS name], ...>
                  FROM table_ref [[AS] alias] [, table_ref [[AS] alias]]*
                  [ [INNER|LEFT|RIGHT|FULL] JOIN table_ref ON a = b [AND ...] ]*
                  [WHERE <predicate>]
                  [GROUP BY col, ...] [HAVING <predicate>]
                  [ORDER BY col|expr [ASC|DESC], ...] [LIMIT n]
                  (an ORDER BY expression must restate a SELECT item)
    table_ref  := <view> | ( select ) [AS name]

Comma-separated FROM lists are lowered to inner joins using the WHERE
clause's equality predicates (single-table conjuncts pre-filter their
table; predicates common to every branch of a top-level OR are factored
out first, so the TPC-H Q19 shape finds its join key).

Expressions: identifiers (optionally alias-qualified: ``l.l_orderkey``),
integer/float/string literals, DATE 'yyyy-mm-dd', INTERVAL n|'n'
DAY[S]|MONTH[S]|YEAR[S] (folded into date literals at parse time),
CAST(x AS DATE|INT|BIGINT|DOUBLE) (literals fold; date-typed expressions
pass through), + - * /, comparisons
(= != <> < <= > >=), [NOT] BETWEEN x AND y, [NOT] IN (...), [NOT] LIKE,
IS [NOT] NULL, CASE [x] WHEN ... THEN ... [ELSE ...] END (ELSE NULL END
elides to the no-ELSE form),
EXTRACT(YEAR|MONTH|DAY|QUARTER FROM x), SUBSTRING/SUBSTR(x FROM a [FOR b])
or SUBSTRING/SUBSTR(x, a, b), UPPER/LOWER/TRIM, AND/OR/NOT, and aggregates
SUM/AVG/MIN/MAX/COUNT(*)/COUNT(x)/COUNT(DISTINCT x) — including
arithmetic OVER aggregates (``100 * sum(a) / sum(b)``).

Subqueries in WHERE (as top-level conjuncts):
  * ``x [NOT] IN (SELECT col FROM t [WHERE ...])``      → semi/anti join
  * ``[NOT] EXISTS (SELECT ... FROM t WHERE corr)``     → semi/anti join
  * ``expr <op> (SELECT <agg> FROM t WHERE corr)``      → decorrelated
    group-by + join (the TPC-H Q17 shape)
Correlation must be equality predicates; the subquery body is a single
optionally-filtered table. Everything else raises a clear error naming
the unsupported construct.

NOT IN follows the non-null convention (a null in the subquery result
does not veto every row) — documented divergence from three-valued SQL,
matching the TPC-H data contract where join keys are non-null.
"""

from __future__ import annotations

import datetime
import re
from typing import Dict, List, Optional, Tuple

from .exceptions import HyperspaceException
from .plan import expr as E

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<date>DATE\s*'(\d{4}-\d{2}-\d{2})')
    | (?P<str>'(?:[^']|'')*')
    | (?P<num>\d+\.\d+|\.\d+|\d+)
    | (?P<bident>`[^`]*`)
    | (?P<ident>[A-Za-z_][A-Za-z_0-9.]*)
    | (?P<op><>|!=|<=|>=|=|<|>|\(|\)|,|\*|/|\+|-|;)
    )""", re.VERBOSE | re.IGNORECASE)

_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "ON", "AS", "AND",
    "OR", "NOT", "IN", "BETWEEN", "ASC", "DESC", "DATE", "DISTINCT",
    "UNION", "ALL", "WITH", "INTERSECT", "EXCEPT", "ROLLUP", "GROUPING",
    "SUM", "AVG", "MIN", "MAX", "COUNT",
    "LIKE", "IS", "NULL", "CASE", "WHEN", "THEN", "ELSE", "END",
    "EXTRACT", "INTERVAL", "DAY", "MONTH", "YEAR", "QUARTER",
    "EXISTS", "SUBSTRING", "SUBSTR", "FOR", "UPPER", "LOWER", "TRIM",
    "CAST", "COALESCE",
    "OVER", "PARTITION", "ROWS", "RANGE", "UNBOUNDED", "PRECEDING",
    "FOLLOWING", "CURRENT", "ROW", "RANK", "DENSE_RANK", "ROW_NUMBER",
    "ABS", "STDDEV", "STDDEV_SAMP", "SQRT", "CONCAT",
}

# Words that are only meaningful in specific grammar positions (EXTRACT's
# field, INTERVAL's unit, SUBSTRING's FOR, function names before '(').
# Everywhere else they are ordinary identifiers — Spark SQL reserves almost
# nothing, so a column named ``year`` must stay reachable.
_SOFT_KEYWORDS = {
    "YEAR", "MONTH", "DAY", "QUARTER", "FOR",
    "UPPER", "LOWER", "TRIM", "SUBSTRING", "SUBSTR", "EXTRACT", "CAST",
    "COALESCE", "OVER", "PARTITION", "ROWS", "RANGE", "UNBOUNDED",
    "PRECEDING", "FOLLOWING", "CURRENT", "ROW", "RANK", "DENSE_RANK",
    "ROW_NUMBER", "ABS", "STDDEV", "STDDEV_SAMP", "SQRT", "GROUPING",
    "ROLLUP", "CONCAT",
}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    # SQL line comments (``-- ...``): stripped before tokenizing, except
    # inside string literals (a '--' in a LIKE pattern must survive).
    text = re.sub(r"('(?:[^']|'')*')|--[^\n]*",
                  lambda m: m.group(1) or " ", text)
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            rest = text[pos:].strip()
            if not rest:
                break
            raise HyperspaceException(
                f"SQL: cannot tokenize near {rest[:25]!r}")
        pos = m.end()
        if m.group("date"):
            out.append(("DATE_LIT", m.group(2)))
        elif m.group("str"):
            out.append(("STR", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("num"):
            out.append(("NUM", m.group("num")))
        elif m.group("bident"):
            # Backtick-quoted identifier: spaces and symbols allowed,
            # never a keyword (the TPC-DS house style for aliases).
            out.append(("IDENT", m.group("bident")[1:-1]))
        elif m.group("ident"):
            # KW tokens keep the RAW spelling: soft keywords double as
            # identifiers (take_name) and must preserve the user's case
            # for output aliases. Comparisons normalize in the helpers.
            word = m.group("ident")
            if word.upper() in _KEYWORDS:
                out.append(("KW", word))
            else:
                out.append(("IDENT", word))
        else:
            out.append(("OP", m.group("op")))
    # Statement terminator: legal only in the trailing position. A ';'
    # anywhere else stays a token the grammar will reject — silently
    # dropping it would splice two statements into one.
    while out and out[-1] == ("OP", ";"):
        out.pop()
    out.append(("EOF", ""))
    return out


# ---------------------------------------------------------------------------
# Subquery / interval parse-time markers (never reach the execution engine).
# ---------------------------------------------------------------------------

class _SubQ:
    """Structural (unanalyzed) subquery: SELECT items FROM one table
    [WHERE expr]. Kept unresolved because correlated references would not
    validate against the inner schema until the transform classifies them."""

    def __init__(self, items, star: bool, table: str, alias: Optional[str],
                 where: Optional[E.Expr]):
        self.items = items  # [(expr, alias)]
        self.star = star
        self.table = table
        self.alias = alias
        self.where = where


class _ScalarSubquery(E.Expr):
    def __init__(self, subq: _SubQ):
        self.subq = subq

    def __repr__(self):
        return "(scalar subquery)"


class _InSubquery(E.Expr):
    def __init__(self, value: E.Expr, subq: _SubQ, negated: bool):
        self.value = value
        self.subq = subq
        self.negated = negated

    @property
    def children(self):
        return [self.value]

    def __repr__(self):
        return f"{self.value!r} {'NOT ' if self.negated else ''}IN (subquery)"


class _ExistsSubquery(E.Expr):
    def __init__(self, subq: _SubQ, negated: bool):
        self.subq = subq
        self.negated = negated

    def __repr__(self):
        return f"{'NOT ' if self.negated else ''}EXISTS (subquery)"


_SUBQUERY_MARKERS = (_ScalarSubquery, _InSubquery, _ExistsSubquery)


def _contains_subquery(e: E.Expr) -> bool:
    if isinstance(e, _SUBQUERY_MARKERS):
        return True
    return any(_contains_subquery(c) for c in e.children)


class _IntervalLit(E.Expr):
    """INTERVAL 'n' DAY|MONTH|YEAR — only valid added to / subtracted from
    a date literal, folded at parse time."""

    def __init__(self, n: int, unit: str):
        self.n = n
        self.unit = unit

    def __repr__(self):
        return f"INTERVAL '{self.n}' {self.unit}"


def _shift_date(d: datetime.date, n: int, unit: str) -> datetime.date:
    if unit == "DAY":
        return d + datetime.timedelta(days=n)
    months = n * (12 if unit == "YEAR" else 1)
    m0 = d.month - 1 + months
    y, m = d.year + m0 // 12, m0 % 12 + 1
    # Clamp to month length (SQL date arithmetic convention).
    last = [31, 29 if (y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)) else 28,
            31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m - 1]
    return datetime.date(y, m, min(d.day, last))


class _Scope:
    """Alias/table-name → DataFrame bindings (chained for subqueries).
    ``renames`` maps (alias, column) → mangled output name for duplicate
    table instances in one FROM list (``date_dim d1, date_dim d2`` — the
    q25/q29/q50 shape), where the later instances' columns are renamed to
    keep the join output unambiguous."""

    def __init__(self, parent: Optional["_Scope"] = None):
        self.bindings: Dict[str, object] = {}
        self.renames: Dict[str, Dict[str, str]] = {}
        self.parent = parent

    def bind(self, name: str, df) -> None:
        self.bindings[name.lower()] = df

    def lookup(self, prefix: str):
        s = self
        while s is not None:
            if prefix.lower() in s.bindings:
                return s.bindings[prefix.lower()]
            s = s.parent
        return None

    def rename_for(self, prefix: str) -> Optional[Dict[str, str]]:
        s = self
        while s is not None:
            if prefix.lower() in s.renames:
                return s.renames[prefix.lower()]
            s = s.parent
        return None


def _has_col(df, name: str) -> bool:
    return df._spelling(name) in df.plan.schema.names


class _Parser:
    def __init__(self, session, text: str):
        self.session = session
        self.toks = _tokenize(text)
        self.i = 0
        self._sq_counter = 0
        self._win_counter = 0
        # WITH-clause bindings (CTEs): name → DataFrame. Checked before
        # session temp views everywhere a table name resolves.
        self._ctes: Dict[str, object] = {}

    def _table(self, name: str):
        """Resolve a table reference: CTE bindings shadow temp views
        (standard SQL scoping; the reference inherits WITH from Spark —
        its first TPC-DS golden needs it, tpcds/queries/q1.sql)."""
        df = self._ctes.get(name.lower())
        if df is not None:
            return df
        return self.session.table(name)

    # -- token helpers ---------------------------------------------------
    @staticmethod
    def _norm(k: str, v: str) -> str:
        """Comparison form of a token value (keywords case-fold)."""
        return v.upper() if k == "KW" else v

    def peek(self, kind: str = None, value: str = None) -> bool:
        k, v = self.toks[self.i]
        if kind is not None and k != kind:
            return False
        if value is not None and self._norm(k, v) != value:
            return False
        return True

    def peek2(self, kind: str, value: str = None) -> bool:
        if self.i + 1 >= len(self.toks):
            return False
        k, v = self.toks[self.i + 1]
        return k == kind and (value is None or self._norm(k, v) == value)

    def take(self, kind: str = None, value: str = None) -> str:
        k, v = self.toks[self.i]
        if (kind is not None and k != kind) or \
                (value is not None and self._norm(k, v) != value):
            raise HyperspaceException(
                f"SQL: expected {value or kind} but found {v or k!r}")
        self.i += 1
        return self._norm(k, v)

    def accept(self, kind: str, value: str = None) -> bool:
        if self.peek(kind, value):
            self.i += 1
            return True
        return False

    def peek_name(self) -> bool:
        """True when the next token can serve as an identifier — a plain
        IDENT or a soft keyword used outside its special position."""
        k, v = self.toks[self.i]
        return k == "IDENT" or (k == "KW" and v.upper() in _SOFT_KEYWORDS)

    def take_name(self) -> str:
        k, v = self.toks[self.i]
        if k == "KW" and v.upper() in _SOFT_KEYWORDS:
            self.i += 1
            return v  # raw spelling: identifiers keep the user's case
        return self.take("IDENT")

    # -- expressions -----------------------------------------------------
    def expr(self) -> E.Expr:
        return self._or()

    def _or(self) -> E.Expr:
        e = self._and()
        while self.accept("KW", "OR"):
            e = e | self._and()
        return e

    def _and(self) -> E.Expr:
        e = self._not()
        while self.accept("KW", "AND"):
            e = e & self._not()
        return e

    def _not(self) -> E.Expr:
        if self.peek("KW", "NOT") and self.peek2("KW", "EXISTS"):
            self.take("KW", "NOT")
            self.take("KW", "EXISTS")
            return _ExistsSubquery(self._exists_body(), negated=True)
        if self.accept("KW", "EXISTS"):
            return _ExistsSubquery(self._exists_body(), negated=False)
        if self.accept("KW", "NOT"):
            return ~self._not()
        return self._comparison()

    def _exists_body(self) -> _SubQ:
        self.take("OP", "(")
        sub = self._subquery_struct()
        self.take("OP", ")")
        return sub

    def _comparison(self) -> E.Expr:
        left = self._additive()
        if self.accept("KW", "IS"):
            negated = self.accept("KW", "NOT")
            self.take("KW", "NULL")
            return E.IsNull(left, negated)
        if self.accept("KW", "LIKE"):
            return E.Like(left, self.take("STR"))
        if self.accept("KW", "BETWEEN"):
            lo = self._additive()
            self.take("KW", "AND")
            hi = self._additive()
            return left.between(_lit_value(lo), _lit_value(hi))
        negated = False
        if self.peek("KW", "NOT"):
            # Postfix negations: NOT IN / NOT LIKE / NOT BETWEEN (prefix
            # NOT is handled one level up).
            self.take("KW", "NOT")
            if self.accept("KW", "LIKE"):
                return E.Like(left, self.take("STR"), negated=True)
            if self.accept("KW", "BETWEEN"):
                lo = self._additive()
                self.take("KW", "AND")
                hi = self._additive()
                return ~left.between(_lit_value(lo), _lit_value(hi))
            self.take("KW", "IN")
            negated = True
        elif self.accept("KW", "IN"):
            pass
        else:
            for op, make in (("=", lambda a, b: a == b),
                             ("!=", lambda a, b: a != b),
                             ("<>", lambda a, b: a != b),
                             ("<=", lambda a, b: a <= b),
                             (">=", lambda a, b: a >= b),
                             ("<", lambda a, b: a < b),
                             (">", lambda a, b: a > b)):
                if self.accept("OP", op):
                    return make(left, self._additive())
            return left
        self.take("OP", "(")
        if self.peek("KW", "SELECT"):
            sub = self._subquery_struct()
            self.take("OP", ")")
            return _InSubquery(left, sub, negated)
        values = [_lit_value(self._additive())]
        while self.accept("OP", ","):
            values.append(_lit_value(self._additive()))
        self.take("OP", ")")
        e = left.isin(values)
        return ~e if negated else e

    def _additive(self) -> E.Expr:
        e = self._multiplicative()
        while True:
            if self.accept("OP", "+"):
                e = self._add_or_shift(e, self._multiplicative(), +1)
            elif self.accept("OP", "-"):
                e = self._add_or_shift(e, self._multiplicative(), -1)
            else:
                return e

    def _add_or_shift(self, a: E.Expr, b: E.Expr, sign: int) -> E.Expr:
        if isinstance(b, _IntervalLit):
            if not (isinstance(a, E.Lit)
                    and isinstance(a.value, datetime.date)):
                raise HyperspaceException(
                    "SQL: INTERVAL arithmetic is only supported against "
                    "DATE literals")
            return E.lit(_shift_date(a.value, sign * b.n, b.unit))
        if isinstance(a, _IntervalLit):
            raise HyperspaceException(
                "SQL: INTERVAL must follow a DATE literal")
        if sign > 0:
            return _fold(a, b, lambda x, y: x + y, lambda x, y: x + y)
        return _fold(a, b, lambda x, y: x - y, lambda x, y: x - y)

    def _multiplicative(self) -> E.Expr:
        e = self._atom()
        while True:
            if self.accept("OP", "*"):
                e = _fold(e, self._atom(), lambda a, b: a * b,
                          lambda a, b: a * b)
            elif self.accept("OP", "/"):
                e = _fold(e, self._atom(), lambda a, b: a / b,
                          lambda a, b: a / b)
            else:
                return e

    def _atom(self) -> E.Expr:
        if self.accept("OP", "-"):
            # Unary minus: folds for literals, 0 - x otherwise.
            return _fold(E.lit(0), self._atom(), lambda a, b: a - b,
                         lambda a, b: a - b)
        if self.accept("OP", "("):
            if self.peek("KW", "SELECT"):
                sub = self._subquery_struct()
                self.take("OP", ")")
                return _ScalarSubquery(sub)
            e = self.expr()
            self.take("OP", ")")
            return e
        if self.accept("KW", "CASE"):
            return self._case()
        # Function-named soft keywords act as functions only when a '('
        # follows; bare they fall through to the identifier branch below
        # (a column named ``extract`` or ``trim`` stays reachable).
        if self.peek("KW", "EXTRACT") and self.peek2("OP", "("):
            self.take("KW")
            self.take("OP", "(")
            part = self.take("KW")
            if part not in ("YEAR", "MONTH", "DAY", "QUARTER"):
                raise HyperspaceException(
                    f"SQL: EXTRACT supports YEAR/MONTH/DAY/QUARTER, "
                    f"got {part}")
            self.take("KW", "FROM")
            inner = self.expr()
            self.take("OP", ")")
            return E.DatePart(part.lower(), inner)
        if (self.peek("KW", "SUBSTRING") or self.peek("KW", "SUBSTR")) \
                and self.peek2("OP", "("):
            self.take("KW")
            return self._substring()
        if self.peek("KW", "CAST") and self.peek2("OP", "("):
            self.take("KW")
            return self._cast()
        for fn in ("UPPER", "LOWER", "TRIM"):
            if self.peek("KW", fn) and self.peek2("OP", "("):
                self.take("KW")
                self.take("OP", "(")
                inner = self.expr()
                self.take("OP", ")")
                return E.StringTransform(fn.lower(), inner)
        if self.peek("KW", "ABS") and self.peek2("OP", "("):
            self.take("KW")
            self.take("OP", "(")
            inner = self.expr()
            self.take("OP", ")")
            # Parse-time rewrite: abs(x) = CASE WHEN x < 0 THEN -x ELSE x
            # END (null in → null out, via CaseWhen's null propagation).
            return E.CaseWhen([(E.LessThan(inner, E.lit(0)),
                                _fold(E.lit(0), inner, lambda a, b: a - b,
                                      lambda a, b: a - b))], inner)
        if self.peek("KW", "COALESCE") and self.peek2("OP", "("):
            self.take("KW")
            self.take("OP", "(")
            args = [self.expr()]
            while self.accept("OP", ","):
                args.append(self.expr())
            self.take("OP", ")")
            if len(args) < 2:
                raise HyperspaceException(
                    "SQL: COALESCE takes at least two arguments")
            # Parse-time rewrite onto CASE (first non-null argument).
            e = args[-1]
            for a in reversed(args[:-1]):
                e = E.CaseWhen([(E.IsNull(a, negated=True), a)], e)
            return e
        if self.peek("KW", "GROUPING") and self.peek2("OP", "("):
            self.take("KW")
            self.take("OP", "(")
            name = self.take_name()
            self.take("OP", ")")
            # GROUPING(c) is a per-grouping-set constant; the ROLLUP
            # lowering materializes it as a hidden 0/1 column per branch
            # (q27/q36/q70/q86). The double-underscore suffix keeps it
            # inside the SELECT-* hidden-name filter.
            return E.col(f"__grouping__{name.split('.')[-1].lower()}__")
        if self.peek("KW", "CONCAT") and self.peek2("OP", "("):
            self.take("KW")
            self.take("OP", "(")
            parts = [self.expr()]
            while self.accept("OP", ","):
                parts.append(self.expr())
            self.take("OP", ")")
            return E.Concat(parts)
        if self.peek("KW", "SQRT") and self.peek2("OP", "("):
            self.take("KW")
            self.take("OP", "(")
            inner = self.expr()
            self.take("OP", ")")
            return E.Sqrt(inner)
        for sd in ("STDDEV", "STDDEV_SAMP"):
            if self.peek("KW", sd) and self.peek2("OP", "("):
                self.take("KW")
                self.take("OP", "(")
                x = self.expr()
                self.take("OP", ")")
                # Parse-time rewrite onto decomposable aggregates (the
                # q17/q39 shape): stddev_samp(x) =
                # sqrt((sum(x*x) - sum(x)^2/n) / (n - 1)), NULL for n < 2
                # (matching SQL; the n=1 denominator would divide by 0).
                # Computed in float64 like Spark — sum(x)^2 over an int
                # column would silently wrap int64.
                xf = E.Multiply(x, E.lit(1.0))
                n = E.count(x)
                sx = E.sum_(xf)
                sxx = E.sum_(E.Multiply(xf, xf))
                var = E.Divide(E.Subtract(sxx, E.Divide(
                    E.Multiply(sx, sx), n)), E.Subtract(n, E.lit(1)))
                # Clamp float cancellation error: a variance of -1e-12
                # must yield 0, not NULL-from-sqrt(-x).
                var = E.CaseWhen([(E.LessThan(var, E.lit(0)), E.lit(0.0))],
                                 var)
                return E.CaseWhen(
                    [(E.GreaterThan(n, E.lit(1)), E.Sqrt(var))], None)
        for rank_fn in ("RANK", "DENSE_RANK", "ROW_NUMBER"):
            if self.peek("KW", rank_fn) and self.peek2("OP", "("):
                self.take("KW")
                self.take("OP", "(")
                self.take("OP", ")")
                return self._window_spec(rank_fn.lower(), None)
        if self.accept("KW", "INTERVAL"):
            if self.peek("STR"):
                raw = self.take("STR")
                if not raw.strip().lstrip("-").isdigit():
                    raise HyperspaceException(
                        f"SQL: INTERVAL takes an integer, got {raw!r}")
                n = int(raw)
            else:
                n = self._int_literal("INTERVAL expects")
            # Unit: keyword (DAY) or identifier (days — the TPC-DS
            # spelling), singular or plural.
            unit = self.take().upper().rstrip("S")
            if unit not in ("DAY", "MONTH", "YEAR"):
                raise HyperspaceException(
                    f"SQL: INTERVAL unit must be DAY/MONTH/YEAR, got {unit}")
            return _IntervalLit(n, unit)
        if self.peek("KW") and self.toks[self.i][1].upper() in (
                "SUM", "AVG", "MIN", "MAX", "COUNT"):
            agg = self._aggregate()
            if self.peek("KW", "OVER"):
                # ``agg(x) OVER (...)`` is a window, not a group aggregate:
                # the aggregate's argument becomes the window argument
                # (``avg(sum(x)) OVER`` keeps the inner sum as the arg —
                # it is lifted to a hidden aggregate column at lowering).
                base = agg
                if isinstance(base, E.CountDistinct):
                    raise HyperspaceException(
                        "SQL: COUNT(DISTINCT ...) OVER is not supported")
                fn = {E.Sum: "sum", E.Avg: "avg", E.Min: "min",
                      E.Max: "max", E.Count: "count"}[type(base)]
                return self._window_spec(fn, base.child)
            return agg
        if self.peek_name():
            return E.col(self.take_name())
        if self.peek("NUM"):
            raw = self.take("NUM")
            return E.lit(float(raw) if "." in raw else int(raw))
        if self.peek("STR"):
            return E.lit(self.take("STR"))
        if self.peek("DATE_LIT"):
            return E.lit(datetime.date.fromisoformat(self.take("DATE_LIT")))
        if self.peek("KW", "NULL"):
            self.take("KW", "NULL")
            return E.lit(None)
        raise HyperspaceException(
            f"SQL: unexpected token {self.toks[self.i][1]!r}")

    def _case(self) -> E.Expr:
        operand = None
        if not self.peek("KW", "WHEN"):
            operand = self.expr()  # simple CASE: CASE x WHEN v THEN r ...
        branches = []
        while self.accept("KW", "WHEN"):
            c = self.expr()
            if operand is not None:
                c = E.EqualTo(operand, c)
            self.take("KW", "THEN")
            branches.append((c, self.expr()))
        if not branches:
            raise HyperspaceException("SQL: CASE requires at least one WHEN")
        else_v = None
        if self.accept("KW", "ELSE"):
            if self.peek("KW", "NULL") and self.peek2("KW", "END"):
                self.take("KW")  # ELSE NULL END ≡ no ELSE (SQL: both null)
            else:
                else_v = self.expr()
        self.take("KW", "END")
        return E.CaseWhen(branches, else_v)

    def _substring(self) -> E.Expr:
        self.take("OP", "(")
        inner = self.expr()
        length = None
        if self.accept("KW", "FROM"):
            start = self._int_literal()
            if self.accept("KW", "FOR"):
                length = self._int_literal()
        else:
            self.take("OP", ",")
            start = self._int_literal()
            if self.accept("OP", ","):
                length = self._int_literal()
        self.take("OP", ")")
        return E.Substring(inner, start, length)

    def _cast(self) -> E.Expr:
        """CAST(x AS type). DATE casts fold string literals to date
        literals and pass date-typed expressions through (the TPC-DS
        texts cast already-date columns defensively); INT/BIGINT and
        DOUBLE casts fold numeric literals. Anything else is a clear
        error naming the unsupported target."""
        self.take("OP", "(")
        inner = self.expr()
        self.take("KW", "AS")
        ty = self.take().upper()
        if ty == "DECIMAL" and self.peek("OP", "("):
            # DECIMAL(p,s): both engine paths compute in float64, so the
            # cast is an identity here (same-engine disable-and-compare
            # keeps the oracle sound); literals fold to float below.
            self.take("OP", "(")
            self._int_literal("DECIMAL precision expects")
            if self.accept("OP", ","):
                self._int_literal("DECIMAL scale expects")
            self.take("OP", ")")
            ty = "DOUBLE"
        elif self.peek("OP", "("):
            # Other parameterized targets (CHAR(16), VARCHAR(20), ...):
            # name the target in the error instead of a bare parse failure.
            raise HyperspaceException(
                f"SQL: unsupported CAST target {ty}(...)")
        self.take("OP", ")")
        if ty == "DATE":
            if isinstance(inner, E.Lit):
                if not isinstance(inner.value, str):
                    raise HyperspaceException(
                        f"SQL: CAST({inner.value!r} AS DATE): only "
                        "yyyy-mm-dd string literals fold to dates")
                try:
                    y, m, d = inner.value.split("-")
                    return E.lit(datetime.date(int(y), int(m), int(d)))
                except ValueError:
                    raise HyperspaceException(
                        f"SQL: CAST({inner.value!r} AS DATE): not a "
                        "yyyy-mm-dd literal")
            return inner  # date-typed expression: identity
        if ty in ("INT", "INTEGER", "BIGINT", "DOUBLE", "FLOAT"):
            conv = int if ty in ("INT", "INTEGER", "BIGINT") else float
            if isinstance(inner, E.Lit):
                try:
                    return E.lit(conv(inner.value))
                except (TypeError, ValueError):
                    raise HyperspaceException(
                        f"SQL: CAST({inner.value!r} AS {ty}): literal "
                        "does not convert")
            return inner
        raise HyperspaceException(f"SQL: unsupported CAST target {ty}")

    def _int_literal(self, what: str = "") -> int:
        neg = self.accept("OP", "-")
        raw = self.take("NUM")
        if "." in raw:
            raise HyperspaceException(
                f"SQL: {what or 'expected'} an integer, found {raw!r}")
        return -int(raw) if neg else int(raw)

    def _aggregate(self) -> E.Expr:
        fn = self.take("KW")
        self.take("OP", "(")
        if fn == "COUNT":
            if self.accept("OP", "*"):
                self.take("OP", ")")
                return E.count(None)
            if self.accept("KW", "DISTINCT"):
                inner = self.expr()
                self.take("OP", ")")
                return E.count_distinct(inner)
            inner = self.expr()
            self.take("OP", ")")
            return E.count(inner)
        inner = self.expr()
        self.take("OP", ")")
        return {"SUM": E.sum_, "AVG": E.avg,
                "MIN": E.min_, "MAX": E.max_}[fn](inner)

    def _window_spec(self, fn: str, arg: Optional[E.Expr]) -> E.Expr:
        """OVER ( [PARTITION BY e, ...] [ORDER BY e [ASC|DESC], ...]
        [ROWS|RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW] )."""
        self.take("KW", "OVER")
        self.take("OP", "(")
        partition: List[E.Expr] = []
        orders: List[Tuple[E.Expr, bool]] = []
        frame = None
        if self.peek("KW", "PARTITION"):
            self.take("KW")
            self.take("KW", "BY")
            partition.append(self.expr())
            while self.accept("OP", ","):
                partition.append(self.expr())
        if self.accept("KW", "ORDER"):
            self.take("KW", "BY")
            while True:
                e = self.expr()
                asc = True
                if self.accept("KW", "DESC"):
                    asc = False
                else:
                    self.accept("KW", "ASC")
                orders.append((e, asc))
                if not self.accept("OP", ","):
                    break
        if self.peek("KW", "ROWS") or self.peek("KW", "RANGE"):
            kind = self.take("KW")
            self.take("KW", "BETWEEN")
            if not (self.accept("KW", "UNBOUNDED")
                    and self.accept("KW", "PRECEDING")):
                raise HyperspaceException(
                    "SQL: only BETWEEN UNBOUNDED PRECEDING AND CURRENT "
                    "ROW window frames are supported")
            self.take("KW", "AND")
            self.take("KW", "CURRENT")
            self.take("KW", "ROW")
            frame = "rows" if kind == "ROWS" else "range"
        self.take("OP", ")")
        return E.WindowExpr(fn, arg, partition, orders, frame)

    # -- subquery structure ----------------------------------------------
    def _subquery_struct(self) -> _SubQ:
        """SELECT <*|items> FROM <table> [[AS] alias] [WHERE expr] — the
        body stays structural (no DataFrame ops yet: correlated references
        would not resolve against the inner schema)."""
        self.take("KW", "SELECT")
        items, star = [], False
        if self.accept("OP", "*"):
            star = True
        else:
            items.append(self._select_item())
            while self.accept("OP", ","):
                items.append(self._select_item())
        self.take("KW", "FROM")
        if self.peek("OP", "("):
            raise HyperspaceException(
                "SQL: subqueries over derived tables are not supported")
        table = self.take_name()
        alias = None
        if self.accept("KW", "AS"):
            alias = self.take_name()
        elif self.peek_name():
            alias = self.take_name()
        where = self.expr() if self.accept("KW", "WHERE") else None
        if self.peek("KW") and self.toks[self.i][1].upper() in ("GROUP", "ORDER",
                                                        "HAVING", "JOIN"):
            raise HyperspaceException(
                f"SQL: {self.toks[self.i][1]} inside subqueries is not "
                "supported (single filtered table only)")
        return _SubQ(items, star, table, alias, where)

    # -- qualified-name resolution ----------------------------------------
    def _resolve_quals(self, e: E.Expr, scope: _Scope) -> E.Expr:
        """Strip alias qualifiers (``l.l_orderkey`` → ``l_orderkey``) once
        the FROM clause has bound them. Unknown prefixes pass through (they
        may be flattened struct leaves like ``detail.price``)."""
        if isinstance(e, E.Col):
            return E.Col(self._resolve_qual_name(e.column, scope))
        if isinstance(e, (_ScalarSubquery, _ExistsSubquery)):
            return e  # inner names resolve at transform time
        if isinstance(e, _InSubquery):
            return _InSubquery(self._resolve_quals(e.value, scope),
                               e.subq, e.negated)
        return E.map_children(e, lambda c: self._resolve_quals(c, scope))

    def _resolve_qual_name(self, name: str, scope: _Scope) -> str:
        if "." not in name:
            return name
        prefix, rest = name.split(".", 1)
        rename = scope.rename_for(prefix)
        if rename is not None and rest.lower() in rename:
            return rename[rest.lower()]
        df = scope.lookup(prefix)
        if df is None:
            return name  # struct leaf or unknown: downstream error names it
        if not _has_col(df, rest):
            raise HyperspaceException(
                f"SQL: {name!r}: table alias {prefix!r} has no column "
                f"{rest!r}; available: {df.plan.schema.names}")
        return df._spelling(rest)

    # -- query -----------------------------------------------------------
    def query(self):
        self._with_clause()
        df = self._query_body()
        self.take("EOF")
        return df

    def _with_clause(self):
        """WITH name AS ( query-body ) [, name2 AS ( ... )]* — each body
        is any supported query (joins, group-by, unions, windows, its own
        ORDER BY/LIMIT); later CTEs may reference earlier ones."""
        if not self.accept("KW", "WITH"):
            return
        while True:
            name = self.take_name()
            self.take("KW", "AS")
            self.take("OP", "(")
            df = self._query_body()
            self.take("OP", ")")
            self._ctes[name.lower()] = df
            if not self.accept("OP", ","):
                break

    def _query_body(self):
        """select [UNION ALL | INTERSECT | EXCEPT select]*
        [ORDER BY ...] [LIMIT n] — a trailing ORDER BY/LIMIT binds to the
        WHOLE compound (standard SQL), INTERSECT binds tighter than
        UNION/EXCEPT, and the same production serves derived tables."""
        df = self._intersect_term()
        while True:
            if self.peek("KW", "UNION"):
                self.take("KW", "UNION")
                if self.accept("KW", "ALL"):
                    df = df.union(self._intersect_term())
                else:
                    # UNION without ALL deduplicates (standard SQL;
                    # positional — a later UNION ALL may re-add rows).
                    df = df.union(self._intersect_term()).distinct()
            elif self.accept("KW", "EXCEPT"):
                df = self._set_op(df, self._intersect_term(), anti=True)
            else:
                break
        return self._order_limit(df)

    def _intersect_term(self):
        df = self._set_operand()
        while self.accept("KW", "INTERSECT"):
            df = self._set_op(df, self._set_operand(), anti=False)
        return df

    def _set_operand(self):
        # Parenthesized set-op operands: ``(SELECT ...) EXCEPT
        # (SELECT ...)`` — the q8/q87 house style.
        if self.peek("OP", "(") and self.peek2("KW", "SELECT"):
            self.take("OP", "(")
            inner = self._query_body()
            self.take("OP", ")")
            return inner
        return self._select_stmt()

    def _set_op(self, left, right, anti: bool):
        """INTERSECT / EXCEPT with SQL's DISTINCT semantics, lowered to
        distinct + semi/anti join on every column positionally (the
        q8/q14/q38/q87 shapes). Divergence from three-valued SQL: set
        ops treat NULL keys as equal, the join's equality never matches
        them — same documented convention as NOT IN; the conformance
        corpus' set-op keys are non-null."""
        lnames = left.plan.schema.names
        rnames = right.plan.schema.names
        if len(lnames) != len(rnames):
            raise HyperspaceException(
                f"SQL: {'EXCEPT' if anti else 'INTERSECT'} sides have "
                f"{len(lnames)} vs {len(rnames)} columns")
        i = self._sq_counter
        self._sq_counter += 1
        sel = [E.col(rn).alias(f"__set{i}_k{j}")
               for j, rn in enumerate(rnames)]
        probe = right.select(*sel)
        cond = None
        for j, ln in enumerate(lnames):
            eq = E.col(ln) == E.col(f"__set{i}_k{j}")
            cond = eq if cond is None else (cond & eq)
        return left.distinct().join(probe, on=cond,
                                    how="anti" if anti else "semi")

    def _order_limit(self, df):
        if self.accept("KW", "ORDER"):
            self.take("KW", "BY")
            orders = [self._order_item()]
            while self.accept("OP", ","):
                orders.append(self._order_item())
            df = self._sort_maybe_hidden(df, orders)
        if self.accept("KW", "LIMIT"):
            n = self._int_literal("LIMIT expects")
            if n < 0:
                raise HyperspaceException(
                    f"SQL: LIMIT expects a non-negative integer, got {n}")
            df = df.limit(n)
        return df

    def _sort_maybe_hidden(self, df, orders):
        """ORDER BY may reference input/grouping columns the SELECT list
        dropped (standard SQL; the q98/q20 shape sorts by a grouped
        i_item_id that is not projected) or an arbitrary expression over
        output columns (the q89 shape). Both lower to hidden columns:
        widen, sort, re-project."""
        exprs = [(n, asc) for n, asc in orders if isinstance(n, E.Expr)]
        if exprs:
            out_names = list(df.plan.schema.names)
            resolved = []
            hidden_i = 0
            for n, asc in orders:
                if isinstance(n, E.Expr):
                    hn = f"__sort{hidden_i}"
                    hidden_i += 1
                    df = df.with_column(hn, n)
                    resolved.append((hn, asc))
                else:
                    resolved.append((n, asc))
            return df.sort(*resolved).select(*out_names)
        have = set(df.plan.schema.names)
        missing = [n for n, _ in orders if df._spelling(n) not in have]
        if not missing:
            return df.sort(*orders)
        parent = getattr(self, "_sortable_parent", None)
        if parent is None or parent[2] is not df:
            return df.sort(*orders)  # original error names the column
        child_df, out_cols, _ = parent
        hidden = []
        for n in missing:
            sp = child_df._spelling(n)
            if sp not in child_df.plan.schema.names:
                return df.sort(*orders)  # truly unknown: clear error below
            if sp not in hidden:
                hidden.append(sp)
        out_names = list(df.plan.schema.names)
        widened = child_df.select(*(list(out_cols) + hidden))
        return widened.sort(*orders).select(*out_names)

    def _table_ref(self, scope: _Scope):
        """One FROM-list entry: returns (df, bound-name or None). The
        binding (alias if given, else the table name) feeds qualified-name
        resolution."""
        if self.accept("OP", "("):
            # Derived table: ( query-body ) [AS name] — may itself contain
            # UNION ALL and its own ORDER BY/LIMIT.
            inner = self._query_body()
            self.take("OP", ")")
            alias = None
            if self.accept("KW", "AS"):
                alias = self.take_name()
            elif self.peek_name():
                alias = self.take_name()
            if alias:
                scope.bind(alias, inner)
            return inner, alias
        name = self.take_name()
        df = self._table(name)
        alias = None
        if self.accept("KW", "AS"):
            alias = self.take_name()
        elif self.peek_name():
            alias = self.take_name()
        scope.bind(alias or name, df)
        return df, alias or name

    def _select_stmt(self):
        self.take("KW", "SELECT")
        distinct = self.accept("KW", "DISTINCT")
        items: List[Tuple[Optional[E.Expr], Optional[str]]] = []
        star = False
        if self.accept("OP", "*"):
            star = True
        else:
            items.append(self._select_item())
            while self.accept("OP", ","):
                items.append(self._select_item())

        scope = _Scope()
        self.take("KW", "FROM")
        refs = [self._table_ref(scope)]
        while self.accept("OP", ","):
            refs.append(self._table_ref(scope))

        if len(refs) == 1:
            df = refs[0][0]
            while self.peek("KW") and self.toks[self.i][1].upper() in (
                    "JOIN", "INNER", "LEFT", "RIGHT", "FULL"):
                df = self._join(df, scope)
            if self.accept("KW", "WHERE"):
                cond = self._resolve_quals(self.expr(), scope)
                if _contains_subquery(cond):
                    df = self._apply_where_with_subqueries(df, cond, scope)
                else:
                    df = df.filter(cond)
        else:
            if self.peek("KW") and self.toks[self.i][1].upper() in (
                    "JOIN", "INNER", "LEFT", "RIGHT", "FULL"):
                raise HyperspaceException(
                    "SQL: mixing comma-joins with explicit JOIN syntax is "
                    "not supported")
            cond = None
            if self.accept("KW", "WHERE"):
                # Resolution happens inside _build_implicit_joins, after
                # duplicate-table instances are renamed (qualifiers must
                # survive until then — the q25 ``date_dim d1, d2`` shape).
                cond = self.expr()
            df = self._build_implicit_joins(refs, cond, scope)

        # Resolve alias-qualified names in the select list now that the
        # FROM clause has bound the aliases. An unaliased qualified column
        # of a renamed duplicate-table instance (``SELECT d2.d_moy``) keeps
        # its user-visible name as the output alias — the mangled internal
        # spelling must never surface in results.
        def _item_resolve(e, alias):
            if e is None:
                return None, alias
            r = self._resolve_quals(e, scope)
            if alias is None and isinstance(e, E.Col) and "." in e.column \
                    and isinstance(r, E.Col) and r.column != e.column \
                    and r.column.startswith("__"):
                alias = e.column.split(".", 1)[1]
            return r, alias

        items = [_item_resolve(e, alias) for e, alias in items]

        group_cols: List[str] = []
        group_exprs: List[Tuple[E.Expr, str]] = []

        def group_item() -> str:
            # Parse a full expression: a plain [qualified] column is the
            # fast path that falls out of it, and anything else
            # (``GROUP BY substr(x, 1, 20)``, ``GROUP BY a + b`` — the
            # TPC-DS house style) must restate a SELECT item; it is
            # materialized by a pre-projection under that item's output
            # name and grouped as a plain column.
            e = self._resolve_quals(self.expr(), scope)
            if isinstance(e, E.Col):
                return e.column
            for ie, alias in items:
                if ie is not None and repr(ie) == repr(e):
                    name = alias or ie.name
                    if all(nm != name for _, nm in group_exprs):
                        group_exprs.append((e, name))
                    return name
            raise HyperspaceException(
                f"SQL: GROUP BY expression {e!r} must restate an item "
                "of the SELECT list")

        rollup_cols: List[str] = []
        if self.accept("KW", "GROUP"):
            self.take("KW", "BY")

            def one_group_entry():
                # ROLLUP(c1, ..., cn): the trailing keys become grouping
                # sets (prefixes) — lowered below as a union of per-set
                # aggregations (the reference inherits ROLLUP from Spark
                # SQL; TPC-DS q5/q18/q22/q27/q67/q77/q80 use it).
                if self.peek("KW", "ROLLUP") and self.peek2("OP", "("):
                    self.take("KW")
                    self.take("OP", "(")
                    rollup_cols.append(group_item())
                    while self.accept("OP", ","):
                        rollup_cols.append(group_item())
                    self.take("OP", ")")
                    return
                g = group_item()
                if g not in group_cols:
                    group_cols.append(g)

            one_group_entry()
            while self.accept("OP", ","):
                one_group_entry()
            # A key listed BOTH plainly and inside ROLLUP stays grouped
            # in every grouping set (Spark: GROUP BY a, ROLLUP(a, b)
            # never rolls `a` up): it leaves the rollup list.
            rollup_cols = [c for c in rollup_cols if c not in group_cols]
            for g in rollup_cols:
                group_cols.append(g)

        orig_items = items
        if group_exprs:
            # Materialize the expression keys; existing columns pass
            # through (later column pruning drops the dead ones) except
            # ones SHADOWED by a synthesized key name (the q8 shape:
            # ``SELECT substr(ca_zip, 1, 5) AS ca_zip``). The expressions
            # still read the pre-projection INPUT, so shadowing only
            # hides the original from stages above — which is why an
            # aggregate referencing the shadowed original is refused.
            synth = {nm for _, nm in group_exprs}
            for ie, _alias in items:
                if ie is not None and _contains_agg(ie) \
                        and synth & set(ie.references) \
                        & set(df.plan.schema.names):
                    raise HyperspaceException(
                        "SQL: an aggregate references a column shadowed "
                        f"by a GROUP BY expression alias ({sorted(synth & set(ie.references))})")
            df = df.select(*(
                [E.col(n) for n in df.plan.schema.names if n not in synth]
                + [e.alias(nm) for e, nm in group_exprs]))
            by_repr = {repr(e): nm for e, nm in group_exprs}
            items = [(E.col(by_repr[repr(e)])
                      if e is not None and repr(e) in by_repr else e, alias)
                     for e, alias in items]

        has_agg = any(_contains_agg(e) for e, _ in items if e is not None)
        if group_cols or has_agg:
            if star:
                raise HyperspaceException(
                    "SQL: SELECT * cannot be combined with aggregation")
            # Resolve spellings once (the API is case-insensitive; raw
            # string comparison here must be too).
            spell = df._spelling
            group_resolved = [spell(g) for g in group_cols]
            aggs, out_cols, out_names = [], [], []
            aliased = False
            compound = False
            for e, alias in items:
                if _contains_agg(e) or _contains_window(e):
                    base = e.child if isinstance(e, E.Alias) else e
                    if isinstance(base, E.AggExpr):
                        named = e.alias(alias) if alias else e
                        aggs.append(named)
                        out_cols.append(named.name)
                        out_names.append(named.name)
                    else:
                        # Arithmetic over aggregates (``100*sum(a)/sum(b)``):
                        # materialize each aggregate as a hidden column and
                        # compute the arithmetic in a post-projection.
                        compound = True
                        rewritten, hidden = _lift_aggs(
                            e, f"__item_{len(out_cols)}")
                        aggs.extend(hidden)
                        named = rewritten.alias(alias) if alias \
                            else rewritten.alias(e.name)
                        out_cols.append(named)
                        out_names.append(named.name)
                else:
                    if isinstance(e, E.Lit):
                        # Constant select item in a grouped query
                        # (``'s' sale_type`` — the q4/q11/q74 style):
                        # projected after aggregation.
                        compound = True
                        named = e.alias(alias) if alias else e.alias(e.name)
                        out_cols.append(named)
                        out_names.append(named.name)
                        continue
                    if not isinstance(e, E.Col) or \
                            e.column.startswith("__grouping__"):
                        # Non-aggregate EXPRESSIONS over grouping keys /
                        # GROUPING() flags (standard SQL; the q27
                        # ``grouping(a) + grouping(b) AS lochierarchy``
                        # shape): projected after aggregation.
                        refs = set(e.references)
                        if refs and all(
                                spell(r) in group_resolved
                                or r.startswith("__grouping__")
                                for r in refs):
                            compound = True
                            named = e.alias(alias) if alias \
                                else e.alias(e.name)
                            out_cols.append(named)
                            out_names.append(named.name)
                            continue
                        raise HyperspaceException(
                            "SQL: non-aggregate select items must be "
                            "plain grouped columns or expressions over "
                            "them")
                    spelled = spell(e.column)
                    if spelled not in group_resolved:
                        raise HyperspaceException(
                            f"SQL: column {e.column!r} must appear in "
                            "GROUP BY or inside an aggregate")
                    if alias:
                        # SELECT g AS grp: the output carries the alias.
                        aliased = True
                        out_cols.append(E.col(spelled).alias(alias))
                    else:
                        out_cols.append(spelled)
                    out_names.append(spelled)
            n_visible = len(aggs)
            visible_agg_names = [a.name for a in aggs]
            # HAVING may reference aggregates inline (standard SQL):
            # materialize them as hidden columns, filter, then project the
            # SELECT list (which also drops the hidden columns and fixes
            # the output order to the SELECT order).
            having: Optional[E.Expr] = None
            if self.accept("KW", "HAVING"):
                if rollup_cols:
                    raise HyperspaceException(
                        "SQL: HAVING with ROLLUP is not supported")
                having = self._resolve_quals(self.expr(), scope)
                having, hidden = _lift_aggs(having, f"__having_{n_visible}")
                aggs.extend(hidden)
            if rollup_cols:
                df = self._rollup_union(
                    df, [g for g in group_cols if g not in rollup_cols],
                    rollup_cols, aggs)
            else:
                df = (df.group_by(*group_cols).agg(*aggs) if group_cols
                      else df.agg(*aggs))
            if having is not None:
                df = df.filter(having)
            # Window functions evaluate AFTER grouping (standard SQL): by
            # now every inner aggregate is a hidden column, so the window
            # specs reference plain aggregate outputs / group columns.
            windowed = any(isinstance(c, E.Expr) and _contains_window(c)
                           for c in out_cols)
            if windowed:
                df, out_cols = self._apply_windows_mixed(df, out_cols)
            # Project only when the SELECT list differs from the
            # aggregate's natural output (group cols then aggregates) —
            # a redundant Project would make SQL plans diverge from the
            # equivalent DataFrame plans. Aliases on group columns,
            # compound aggregate items, and hidden HAVING aggregates
            # always force the projection.
            natural = group_resolved + visible_agg_names
            if aliased or compound or windowed or bool(rollup_cols) \
                    or out_names != natural or len(aggs) != n_visible:
                pre = df
                df = df.select(*out_cols)
                self._sortable_parent = (pre, list(out_cols), df)
        elif not star:
            sel = [e.alias(alias) if alias else e for e, alias in items]
            if any(_contains_window(e) for e in sel):
                df, sel = self._apply_windows_mixed(df, sel)
            pre = df
            df = df.select(*sel)
            self._sortable_parent = (pre, list(sel), df)
            if self.accept("KW", "HAVING"):
                raise HyperspaceException(
                    "SQL: HAVING requires GROUP BY or aggregates")

        if star:
            # Hidden helper columns must not surface through SELECT *:
            # scalar-subquery keys (__sqN_*) and duplicate-table renames
            # (__<alias>__<col>).
            hidden_re = r"__sq\d+_|__\w+__"
            leaked = [n for n in df.plan.schema.names
                      if re.match(hidden_re, n)]
            if leaked:
                df = df.select(*[n for n in df.plan.schema.names
                                 if not re.match(hidden_re, n)])

        if distinct:
            df = df.distinct()

        # ORDER BY resolution state. Assigned on the way OUT so a derived
        # table's inner select (which runs this method re-entrantly
        # mid-FROM) can't leave ITS scope/items behind as the binding for
        # the outer query's ORDER BY.
        self._last_scope = scope
        # ORDER BY matches against the ORIGINAL spellings (a GROUP BY
        # expression rewrite must not hide ``ORDER BY substr(...)``).
        self._last_items = orig_items if not star else []
        return df

    def _select_item(self):
        e = self.expr()
        alias = None
        if self.accept("KW", "AS"):
            alias = self.take_name()
        elif self.peek_name():
            alias = self.take_name()
        return e, alias

    def _order_item(self):
        scope = getattr(self, "_last_scope", None) or _Scope()
        # Parse a full expression. A plain [qualified] column (or output
        # alias, which resolves to itself) is the common case; any other
        # expression (``ORDER BY sum(x) DESC``, ``ORDER BY a * b`` — the
        # TPC-DS house style) must restate a SELECT item, and the sort
        # key is that item's output column.
        e = self._resolve_quals(self.expr(), scope)
        if isinstance(e, E.Col):
            name = e.column
        else:
            name = None
            for item, alias in getattr(self, "_last_items", []):
                if item is not None and repr(item) == repr(e):
                    name = alias or item.name
                    break
            if name is None:
                # Arbitrary sort expression over output columns (the q89
                # ``ORDER BY sum_sales - avg_monthly_sales`` shape):
                # materialized as a hidden column by _sort_maybe_hidden.
                name = e
        if self.accept("KW", "DESC"):
            return (name, False)
        self.accept("KW", "ASC")
        return (name, True)

    def _join(self, df, scope: _Scope):
        how = "inner"
        if self.accept("KW", "LEFT"):
            how = "left"
        elif self.accept("KW", "RIGHT"):
            how = "right"
        elif self.accept("KW", "FULL"):
            how = "full"
        else:
            self.accept("KW", "INNER")
        self.accept("KW", "OUTER")
        self.take("KW", "JOIN")
        other, alias2 = self._table_ref(scope)
        overlap = set(n.lower() for n in df.plan.schema.names) & \
            set(n.lower() for n in other.plan.schema.names)
        if overlap:
            # Columns shared by both JOIN sides (CTEs joined to CTEs —
            # the q77 ``ss LEFT JOIN sr ON ss.s_store_sk =
            # sr.s_store_sk`` shape): rename the right side's shared
            # columns internally; qualified references resolve through
            # scope.renames, unqualified references to them would be
            # ambiguous SQL anyway.
            if alias2 is None:
                raise HyperspaceException(
                    "SQL: JOIN sides share columns "
                    f"{sorted(overlap)}; alias the right side")
            other = self._mangle_columns(other, alias2, overlap, scope)
        self.take("KW", "ON")
        cond = self._resolve_quals(self._join_condition(), scope)
        return df.join(other, on=cond, how=how)

    def _mangle_columns(self, df, label: str, cols_lower, scope: _Scope):
        """Rename ``df``'s columns in ``cols_lower`` to
        ``__<label>__<col>`` and register the mapping with the scope —
        the ONE rename convention shared by duplicate-table comma joins
        and overlapping explicit JOIN sides."""
        mapping = {}
        sel = []
        for c in df.plan.schema.names:
            if c.lower() in cols_lower:
                mangled = f"__{label.lower()}__{c}"
                mapping[c.lower()] = mangled
                sel.append(E.col(c).alias(mangled))
            else:
                sel.append(E.col(c))
        out = df.select(*sel)
        scope.bind(label, out)
        scope.renames[label.lower()] = mapping
        return out

    def _join_condition(self) -> E.Expr:
        cond = self._join_term()
        while self.accept("KW", "AND"):
            cond = cond & self._join_term()
        return cond

    def _join_term(self) -> E.Expr:
        # Parentheses at any level (``ON (a.k = b.k AND a.j = b.j)``,
        # ``ON (a.k = b.k) AND (a.j = b.j)`` — both appear in the TPC-DS
        # texts, e.g. q97).
        if self.accept("OP", "("):
            inner = self._join_condition()
            self.take("OP", ")")
            return inner
        return self._join_eq()

    def _join_eq(self) -> E.Expr:
        left = E.col(self.take_name())
        self.take("OP", "=")
        return left == E.col(self.take_name())

    # -- implicit joins (comma-separated FROM) ---------------------------
    def _build_implicit_joins(self, refs, cond: Optional[E.Expr],
                              scope: _Scope):
        """Lower ``FROM a, b, c WHERE ...`` to inner joins: single-table
        conjuncts pre-filter their table, two-table equality conjuncts
        become join conditions, the rest (and subquery conjuncts) apply
        after the joins. Predicates common to all branches of a top-level
        OR are factored out first (the Q19 shape: the join key equality
        is repeated inside each OR branch)."""
        dfs = [r[0] for r in refs]
        labels = [r[1] or f"table#{i}" for i, r in enumerate(refs)]
        # Duplicate table instances (``date_dim d1, date_dim d2, ...``):
        # rename the later instances' columns so the join output stays
        # unambiguous; qualified references resolve through scope.renames.
        seen_cols: set = set()
        for i, d in enumerate(dfs):
            cols = list(d.plan.schema.names)
            if set(cols) & seen_cols:
                label = refs[i][1]
                if label is None:
                    raise HyperspaceException(
                        "SQL: duplicate table in FROM list requires an "
                        f"alias (columns {sorted(set(cols) & seen_cols)} "
                        "repeat)")
                dfs[i] = self._mangle_columns(
                    d, label, {c.lower() for c in cols}, scope)
            seen_cols.update(dfs[i].plan.schema.names)
        if cond is not None:
            cond = self._resolve_quals(cond, scope)
        conjuncts: List[E.Expr] = []
        if cond is not None:
            for c in E.split_conjunctive_predicates(cond):
                conjuncts.extend(_factor_common_or(c))

        def owner(refs_set):
            """Index of the unique table containing all refs, else None
            (ambiguous references stay post-join, where the Join
            constructor's duplicate-column check gives a clear error)."""
            hits = [i for i, d in enumerate(dfs)
                    if all(_has_col(d, r) for r in refs_set)]
            return hits[0] if len(hits) == 1 else None

        pre: Dict[int, List[E.Expr]] = {}
        edges: List[Tuple[int, int, E.Expr]] = []
        post: List[E.Expr] = []
        subs: List[E.Expr] = []
        for c in conjuncts:
            if _contains_subquery(c):
                subs.append(c)
                continue
            refs_set = set(c.references)
            if isinstance(c, E.EqualTo) and isinstance(c.left, E.Col) \
                    and isinstance(c.right, E.Col):
                li = owner({c.left.column})
                ri = owner({c.right.column})
                if li is not None and ri is not None and li != ri:
                    edges.append((li, ri, c))
                    continue
            o = owner(refs_set) if refs_set else None
            if o is not None:
                pre.setdefault(o, []).append(c)
            else:
                post.append(c)

        for i, preds in pre.items():
            dfs[i] = dfs[i].filter(_conjoin(preds))

        joined = {0}
        cur = dfs[0]
        remaining = set(range(1, len(dfs)))
        while remaining:
            pick = None
            for t in sorted(remaining):
                conds = [p for (a, b, p) in edges
                         if (a in joined and b == t)
                         or (b in joined and a == t)]
                if conds:
                    pick = (t, conds)
                    break
            if pick is None:
                # Single-row cross join: comma-joined global aggregates
                # carry no join keys (the q28/q61/q88/q90 shape — derived
                # tables that are each one aggregate row). General cross
                # joins stay rejected.
                singles = [t for t in sorted(remaining)
                           if _is_single_row(dfs[t].plan)]
                if singles:
                    t = singles[0]
                    cur = cur.cross_join(dfs[t])
                    joined.add(t)
                    remaining.remove(t)
                    continue
                missing = ", ".join(labels[t] for t in sorted(remaining))
                raise HyperspaceException(
                    f"SQL: no equality predicate joins {missing} to the "
                    "rest of the FROM list (cross joins are not supported)")
            t, conds = pick
            cur = cur.join(dfs[t], on=_conjoin(conds), how="inner")
            joined.add(t)
            remaining.remove(t)

        for c in post:
            cur = cur.filter(c)
        for c in subs:
            cur = self._apply_subquery_conjunct(cur, c, scope)
        return cur

    # -- ROLLUP lowering ---------------------------------------------------
    def _rollup_union(self, df, plain: List[str], roll: List[str], aggs):
        """GROUP BY [plain,] ROLLUP(r1..rn) as a UNION ALL of the n+1
        grouping sets (prefixes of the rollup list), each aggregated
        from the SAME pre-aggregation input — exact for every aggregate
        (including avg and count-distinct, which cannot be re-aggregated
        from the finest set). Rolled-up keys become typed NULL columns;
        per-branch constant ``__grouping__<col>__`` flag columns carry
        GROUPING() (dropped by the hidden-name filter unless selected).
        Parity: Spark SQL's rollup, inherited by the reference — TPC-DS
        q5/q18/q22/q27/q67/q77/q80 and the grouping() family."""
        schema = df.plan.schema
        agg_names = [a.name for a in aggs]
        flag_names = [f"__grouping__{c.lower()}__" for c in roll]
        out_names = plain + roll + agg_names + flag_names
        branches = []
        for k in range(len(roll), -1, -1):
            keys = plain + roll[:k]
            part = (df.group_by(*keys).agg(*aggs) if keys
                    else df.agg(*aggs))
            for c in roll[k:]:
                sp = df._spelling(c)
                part = part.with_column(
                    c, E.NullLit(schema.field(sp).dtype))
            for j, c in enumerate(roll):
                part = part.with_column(flag_names[j],
                                        E.lit(1 if j >= k else 0))
            branches.append(part.select(*out_names))
        out = branches[0]
        for b in branches[1:]:
            out = out.union(b)
        return out

    # -- window lowering ---------------------------------------------------
    def _apply_windows_mixed(self, df, cols):
        """Rewrite a projection list (strings or exprs) so every embedded
        WindowExpr becomes a reference to a hidden window output column.
        All specs land in ONE Window plan node, so exprs sharing a
        (partition, order) spec share one sort in the executor."""
        specs: List[Tuple[str, E.WindowExpr]] = []

        def rewrite(node: E.Expr) -> E.Expr:
            if isinstance(node, E.WindowExpr):
                name = f"__win{self._win_counter}"
                self._win_counter += 1
                specs.append((name, node))
                return E.col(name)
            return E.map_children(node, rewrite)

        out = [rewrite(c) if isinstance(c, E.Expr) and _contains_window(c)
               else c for c in cols]
        if specs:
            df = self._attach_windows(df, specs)
        return df, out

    def _attach_windows(self, df, specs):
        """Materialize non-column window sub-expressions (argument,
        partition keys, order keys) as hidden projected columns, then add
        one Window node carrying every spec. Hidden columns are dropped
        by the enclosing SELECT's final projection."""
        from .plan.nodes import Window

        def mat(sub, name, tag):
            nonlocal df
            if sub is None or isinstance(sub, E.Col):
                return sub
            hidden = f"{name}_{tag}"
            df = df.with_column(hidden, sub)
            return E.col(hidden)

        prepared = []
        for name, w in specs:
            arg = mat(w.arg, name, "a")
            part = [mat(p, name, f"p{i}") for i, p in enumerate(w.partition)]
            orders = [(mat(o, name, f"o{i}"), asc)
                      for i, (o, asc) in enumerate(w.orders)]
            prepared.append((name, df._resolve_expr(
                E.WindowExpr(w.fn, arg, part, orders, w.frame))))
        return type(df)(df.session, Window(prepared, df.plan))

    # -- subquery lowering ------------------------------------------------
    def _apply_where_with_subqueries(self, df, cond: E.Expr, scope: _Scope):
        plain: List[E.Expr] = []
        subs: List[E.Expr] = []
        for c in E.split_conjunctive_predicates(cond):
            (subs if _contains_subquery(c) else plain).append(c)
        if plain:
            df = df.filter(_conjoin(plain))
        for c in subs:
            df = self._apply_subquery_conjunct(df, c, scope)
        return df

    def _apply_subquery_conjunct(self, df, c: E.Expr, scope: _Scope):
        if isinstance(c, _ExistsSubquery):
            return self._lower_semi_anti(df, c.subq, scope,
                                         value=None, negated=c.negated)
        if isinstance(c, _InSubquery):
            if not isinstance(c.value, E.Col):
                raise HyperspaceException(
                    "SQL: [NOT] IN (SELECT ...) requires a plain column "
                    f"on the left, got {c.value!r}")
            return self._lower_semi_anti(df, c.subq, scope,
                                         value=c.value, negated=c.negated)
        if isinstance(c, E._Binary) and not isinstance(c, (E.And, E.Or)):
            sides = [c.left, c.right]
            marks = [isinstance(s, _ScalarSubquery) for s in sides]
            if sum(marks) == 1:
                return self._lower_scalar(df, c, scope)
        raise HyperspaceException(
            "SQL: subqueries are only supported as top-level WHERE "
            f"conjuncts (EXISTS / IN / scalar comparison); got {c!r}")

    def _analyze_subquery(self, subq: _SubQ, scope: _Scope, outer_df):
        """Split the subquery's WHERE into local predicates and correlated
        equality pairs (inner column, outer column).

        Side classification happens on the still-QUALIFIED names: when the
        subquery reads the same table as the outer query (the TPC-H Q21
        family), ``t2.g = t.g`` must stay a correlation even though both
        sides strip to the same bare column."""
        inner = self._table(subq.table)
        child = _Scope(parent=scope)
        inner_name = (subq.alias or subq.table).lower()
        child.bind(inner_name, inner)

        def side(col: E.Col) -> str:
            """'inner' | 'outer' | 'unknown' for one column reference,
            honoring explicit qualifiers before schema membership."""
            name = col.column
            if "." in name:
                prefix, rest = name.split(".", 1)
                if prefix.lower() == inner_name:
                    return "inner" if _has_col(inner, rest) else "unknown"
                if scope.lookup(prefix) is not None:
                    d = scope.lookup(prefix)
                    return "outer" if _has_col(d, rest) else "unknown"
                # Unknown prefix: maybe a struct leaf of the inner table.
                return "inner" if _has_col(inner, name) else (
                    "outer" if _has_col(outer_df, name) else "unknown")
            if _has_col(inner, name):
                return "inner"  # inner scope shadows outer (SQL scoping)
            if _has_col(outer_df, name):
                return "outer"
            return "unknown"

        def bare(col: E.Col) -> str:
            return self._resolve_qual_name(col.column, child)

        local: List[E.Expr] = []
        corr: List[Tuple[str, str]] = []
        conjuncts = [] if subq.where is None else \
            E.split_conjunctive_predicates(subq.where)
        for c in conjuncts:
            if _contains_subquery(c):
                raise HyperspaceException(
                    "SQL: nested subqueries are not supported")
            if isinstance(c, E.EqualTo) and isinstance(c.left, E.Col) \
                    and isinstance(c.right, E.Col):
                ls, rs = side(c.left), side(c.right)
                if ls == "inner" and rs == "outer":
                    corr.append((inner._spelling(bare(c.left)),
                                 outer_df._spelling(bare(c.right))))
                    continue
                if ls == "outer" and rs == "inner":
                    corr.append((inner._spelling(bare(c.right)),
                                 outer_df._spelling(bare(c.left))))
                    continue
            resolved = self._resolve_quals(c, child)
            refs = set(resolved.references)
            cols = _collect_cols(c)
            if all(_has_col(inner, r) for r in refs) \
                    and all(side(col) != "outer" for col in cols):
                local.append(resolved)
                continue
            raise HyperspaceException(
                "SQL: unsupported correlated predicate in subquery "
                f"(only equality correlation): {c!r}")
        if local:
            inner = inner.filter(_conjoin(local))
        return inner, corr, child

    def _lower_semi_anti(self, df, subq: _SubQ, scope: _Scope,
                         value: Optional[E.Col], negated: bool):
        """[NOT] IN / [NOT] EXISTS → semi/anti join (the TPU engine's
        existence probe keeps the left side's row and bucket order)."""
        inner, corr, child = self._analyze_subquery(subq, scope, df)
        i = self._sq_counter
        self._sq_counter += 1
        keys: List[Tuple[str, str]] = []  # (inner col, outer col)
        if value is not None:
            if subq.star or len(subq.items) != 1 \
                    or not isinstance(subq.items[0][0], E.Col):
                raise HyperspaceException(
                    "SQL: IN subqueries must select exactly one column")
            inner_col = self._resolve_qual_name(subq.items[0][0].column,
                                                child)
            if not _has_col(inner, inner_col):
                raise HyperspaceException(
                    f"SQL: subquery selects unknown column {inner_col!r}")
            keys.append((inner._spelling(inner_col),
                         df._spelling(value.column)))
        keys.extend(corr)
        if not keys:
            raise HyperspaceException(
                "SQL: EXISTS subqueries must be correlated by at least "
                "one equality predicate")
        sel = [E.col(k_in).alias(f"__sq{i}_k{j}")
               for j, (k_in, _) in enumerate(keys)]
        sub = inner.select(*sel)
        cond = None
        for j, (_, k_out) in enumerate(keys):
            eq = E.col(k_out) == E.col(f"__sq{i}_k{j}")
            cond = eq if cond is None else (cond & eq)
        return df.join(sub, on=cond, how="anti" if negated else "semi")

    def _lower_scalar(self, df, comparison: E._Binary, scope: _Scope):
        """``expr <op> (SELECT agg FROM t WHERE corr)`` — the TPC-H Q17
        shape. Decorrelated exactly as the reference's users hand-write it
        in DataFrames: group the inner table by its correlation keys,
        compute the aggregate per group, join back on the keys, compare.
        Rows with no group fall out of the inner join — the same result
        as comparing against a NULL scalar (comparison yields unknown)."""
        flipped = isinstance(comparison.left, _ScalarSubquery)
        marker = comparison.left if flipped else comparison.right
        outer_expr = comparison.right if flipped else comparison.left
        subq = marker.subq
        if subq.star or len(subq.items) != 1:
            raise HyperspaceException(
                "SQL: scalar subqueries must select exactly one expression")
        inner, corr, child = self._analyze_subquery(subq, scope, df)
        if not corr:
            raise HyperspaceException(
                "SQL: uncorrelated scalar subqueries are not supported")
        # The select item may be alias-qualified (``AVG(l2.qty)``) — the
        # same resolution the WHERE conjuncts already got.
        item = self._resolve_quals(subq.items[0][0], child)
        aggs_found: List[E.AggExpr] = []

        def collect(node):
            if isinstance(node, E.AggExpr):
                aggs_found.append(node)
            for ch in node.children:
                collect(ch)

        collect(item)
        if len(aggs_found) != 1:
            raise HyperspaceException(
                "SQL: scalar subqueries must contain exactly one aggregate")
        i = self._sq_counter
        self._sq_counter += 1
        agg_name = f"__sq{i}_agg"
        val_name = f"__sq{i}_val"

        def replace_agg(node):
            if isinstance(node, E.AggExpr):
                return E.col(agg_name)
            return E.map_children(node, replace_agg)

        keys_in = [k for k, _ in corr]
        sub = inner.group_by(*keys_in).agg(aggs_found[0].alias(agg_name))
        sel = [E.col(k).alias(f"__sq{i}_k{j}")
               for j, k in enumerate(keys_in)]
        sel.append(replace_agg(item).alias(val_name))
        sub = sub.select(*sel)
        cond = None
        for j, (_, k_out) in enumerate(corr):
            eq = E.col(k_out) == E.col(f"__sq{i}_k{j}")
            cond = eq if cond is None else (cond & eq)
        joined = df.join(sub, on=cond, how="inner")
        val = E.col(val_name)
        pred = type(comparison)(val, outer_expr) if flipped \
            else type(comparison)(outer_expr, val)
        return joined.filter(pred)


_conjoin = E.conjoin


def _collect_cols(e: E.Expr) -> List[E.Col]:
    out: List[E.Col] = []
    if isinstance(e, E.Col):
        out.append(e)
    for c in e.children:
        out.extend(_collect_cols(c))
    return out


def _split_disjuncts(e: E.Expr) -> List[E.Expr]:
    if isinstance(e, E.Or):
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def _factor_common_or(c: E.Expr) -> List[E.Expr]:
    """For an OR conjunct, hoist predicates that appear in EVERY branch:
    ``(j AND a1) OR (j AND a2)`` → ``j`` + ``(a1 OR a2)``. Purely a
    parse-time normalization (sound by distributivity); it is what lets
    the Q19 text's repeated ``p_partkey = l_partkey`` become a join edge."""
    if not isinstance(c, E.Or):
        return [c]
    branches = [E.split_conjunctive_predicates(b)
                for b in _split_disjuncts(c)]
    if any(any(_contains_subquery(p) for p in br) for br in branches):
        return [c]
    rep_sets = [{repr(p) for p in br} for br in branches]
    common = set.intersection(*rep_sets)
    if not common:
        return [c]
    out: List[E.Expr] = [p for p in branches[0] if repr(p) in common]
    residuals = [[p for p in br if repr(p) not in common]
                 for br in branches]
    if all(residuals):
        ors = [_conjoin(r) for r in residuals]
        rest = ors[0]
        for o in ors[1:]:
            rest = rest | o
        out.append(rest)
    # else: some branch is exactly the common set → the OR is implied by
    # the common predicates alone.
    return out


def _fold(a: E.Expr, b: E.Expr, expr_op, py_op) -> E.Expr:
    """Constant-fold literal-literal arithmetic at parse time (e.g. the
    ``1 + 0.1`` inside ``price * (1 + 0.1)``) — the engine's evaluator
    deliberately rejects all-literal subtrees.

    Folding with floats involved goes through Decimal: Spark parses
    ``.06 - 0.01`` as DECIMAL arithmetic yielding exactly 0.05, while
    float64 yields 0.04999999999999999 — a bound that silently excludes
    the 0.05 data values TPC-H Q6 selects."""
    if isinstance(a, E.Lit) and isinstance(b, E.Lit) and \
            isinstance(a.value, (int, float)) and \
            isinstance(b.value, (int, float)):
        if isinstance(a.value, float) or isinstance(b.value, float):
            from decimal import Decimal, InvalidOperation
            try:
                return E.lit(float(py_op(Decimal(str(a.value)),
                                         Decimal(str(b.value)))))
            except (InvalidOperation, ZeroDivisionError):
                pass
        return E.lit(py_op(a.value, b.value))
    return expr_op(a, b)


def _contains_agg(e: Optional[E.Expr]) -> bool:
    if e is None:
        return False
    if isinstance(e, E.AggExpr):
        return True
    return any(_contains_agg(c) for c in e.children)


def _is_single_row(plan) -> bool:
    """True when the plan provably yields at most one row: a global
    aggregate (no group columns), possibly under projections, or LIMIT 1."""
    from .plan.nodes import Aggregate, Limit, Project
    if isinstance(plan, Aggregate):
        return not plan.group_cols
    if isinstance(plan, Limit):
        return plan.n == 1 or _is_single_row(plan.child)
    if isinstance(plan, Project):
        return _is_single_row(plan.child)
    return False


def _contains_window(e: Optional[E.Expr]) -> bool:
    if e is None:
        return False
    if isinstance(e, E.WindowExpr):
        return True
    return any(_contains_window(c) for c in e.children)


def _lift_aggs(e: E.Expr, prefix: str):
    """Replace every aggregate inside ``e`` with a reference to a hidden
    output column, returning (rewritten expression, the hidden aliased
    aggregates to append to the agg list). Serves both HAVING predicates
    and compound select items like ``100 * sum(a) / sum(b)``. Repeated
    aggregates dedupe by structure (the STDDEV rewrite repeats sum/count
    several times; each distinct aggregate is computed once)."""
    hidden: List[E.Expr] = []
    by_repr: Dict[str, str] = {}

    def rec(node: E.Expr) -> E.Expr:
        if isinstance(node, E.AggExpr):
            key = repr(node)
            name = by_repr.get(key)
            if name is None:
                name = f"{prefix}_{len(hidden)}"
                by_repr[key] = name
                hidden.append(node.alias(name))
            return E.col(name)
        return E.map_children(node, rec)

    return rec(e), hidden


def _lit_value(e: E.Expr):
    if not isinstance(e, E.Lit):
        raise HyperspaceException(
            f"SQL: expected a literal, found {e!r}")
    return e.value


def sql(session, text: str):
    """Parse and lower one SELECT statement to a DataFrame."""
    return _Parser(session, text).query()
