"""Vectorized expression evaluation over device tables (counterpart of
``hyperspace_tpu/execution/evaluator.py``: literals as constant columns,
comparisons, BETWEEN, IN lists, Kleene boolean algebra, arithmetic,
aliases, LIKE, IS NULL, CASE, EXTRACT, SUBSTRING, UPPER/LOWER/TRIM,
concat, the typed NULL and sqrt).

String functions work on the dictionary: each distinct string is matched
or transformed once on the host, and one device gather maps the codes.

Null semantics follow SQL for filters: a comparison touching a null is
null, and Filter keeps only rows whose predicate is true-and-valid.

There is one counted-mask path. Comparisons of a 32-bit column with a
literal run the compare kernel, and ``col >(=) lo AND col <(=) hi`` runs the
range kernel (ops/cuda_kernels.py); an IN list is an OR of such
equalities. Every other shape is plain torch.
"""

from __future__ import annotations

import datetime
import re
from typing import List, Optional

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..ops import cuda_kernels, kernels
from ..plan import expr as E
from ..schema import BOOL, DATE, FLOAT64, INT64, STRING
from ..shapes import padded_length
from .columnar import (DEVICE_DTYPE, Column, Table, dictionaries_equal, literal_to_device,
                       translate_codes)

_COMPARISONS = (E.EqualTo, E.LessThan, E.LessThanOrEqual, E.GreaterThan,
                E.GreaterThanOrEqual)

_KERNEL_DTYPES = (torch.int32, torch.float32, torch.uint32)

_SYMBOL = {"EqualTo": "==", "LessThan": "<", "LessThanOrEqual": "<=",
           "GreaterThan": ">", "GreaterThanOrEqual": ">="}

_ARITH = {"Add": torch.add, "Subtract": torch.sub, "Multiply": torch.mul}

_TORCH_OP = {"EqualTo": torch.eq, "LessThan": torch.lt, "LessThanOrEqual": torch.le,
             "GreaterThan": torch.gt, "GreaterThanOrEqual": torch.ge}


def eval_predicate_mask(table: Table, condition: E.Expr) -> torch.Tensor:
    """Boolean keep-mask for a filter condition."""
    col = eval_expr(table, condition)
    if col.dtype != BOOL:
        raise HyperspaceException(f"Filter condition is not boolean: {condition!r}")
    return col.data if col.validity is None else col.data & col.validity


def eval_expr(table: Table, e: E.Expr) -> Column:
    if isinstance(e, E.Col):
        return table.column(e.column)
    if isinstance(e, E.Alias):
        return eval_expr(table, e.child)
    if isinstance(e, (E.Add, E.Subtract, E.Multiply, E.Divide)):
        return _eval_arith(table, e)
    if isinstance(e, _COMPARISONS):
        return _eval_comparison(table, e)
    if isinstance(e, (E.And, E.Or)):
        if isinstance(e, E.And):
            fused = _try_fused_range(table, e)
            if fused is not None:
                return fused
        left = eval_expr(table, e.left)
        right = eval_expr(table, e.right)
        true, known = kernels.kleene_and_or(
            left.data, left.validity, right.data, right.validity,
            is_and=isinstance(e, E.And))
        validity = None if (left.validity is None and right.validity is None) \
            else known
        return Column(BOOL, true, validity)
    if isinstance(e, E.Not):
        c = eval_expr(table, e.child)
        return Column(BOOL, ~c.data, c.validity)
    if isinstance(e, E.In):
        return _eval_in(table, e)
    if isinstance(e, E.Lit):
        # A constant projection (SELECT 's' AS kind ...); a bare NULL has
        # no type and is refused.
        return _literal_column(e.value, table.num_rows, table.device, "project")
    if isinstance(e, E.Concat):
        return _eval_concat(table, e)
    if isinstance(e, E.NullLit):
        n = table.num_rows
        dev = table.device
        return Column(e.dtype, torch.zeros(n, dtype=DEVICE_DTYPE[e.dtype], device=dev),
                      torch.zeros(n, dtype=torch.bool, device=dev),
                      np.array([""], dtype=object) if e.dtype == STRING else None)
    if isinstance(e, E.Sqrt):
        c = eval_expr(table, e.child)
        x = c.data.to(torch.float64)
        # The root of a negative is NULL in SQL, not NaN.
        nonneg = x >= 0
        return Column(FLOAT64, _sqrt64(torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))),
                      nonneg if c.validity is None else c.validity & nonneg)
    if isinstance(e, E.Like):
        return _eval_like(table, e)
    if isinstance(e, E.IsNull):
        return _eval_is_null(table, e)
    if isinstance(e, E.CaseWhen):
        return _eval_case_when(table, e)
    if isinstance(e, E.DatePart):
        return _eval_date_part(table, e)
    if isinstance(e, (E.Substring, E.StringTransform)):
        return _eval_string_transform(table, e)
    raise HyperspaceException(f"Cannot evaluate expression: {e!r}")


def _sqrt64(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root. CUDA's is; torch's CPU
    kernel is not on every build (it gives sqrt(2.0) one ulp low), so a CPU
    tensor takes numpy's, which is."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _literal_column(v, n: int, device, what: str) -> Column:
    """``v`` repeated ``n`` times, as a column of its logical type; a
    string gets a one-entry dictionary."""
    if isinstance(v, bool):
        return Column(BOOL, torch.full((n,), v, dtype=torch.bool, device=device))
    if isinstance(v, int):
        return Column(INT64, torch.full((n,), v, dtype=torch.int64, device=device))
    if isinstance(v, float):
        return Column(FLOAT64, torch.full((n,), v, dtype=torch.float64, device=device))
    if isinstance(v, str):
        return Column(STRING, torch.zeros(n, dtype=torch.int32, device=device), None,
                      np.array([v], dtype=object))
    if isinstance(v, datetime.date):
        days = (v - datetime.date(1970, 1, 1)).days
        return Column(DATE, torch.full((n,), days, dtype=torch.int32, device=device))
    raise HyperspaceException(f"Cannot {what} literal {v!r} as a column")


def _gather_host(values: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """``values[code]`` for every dictionary code, on the codes' device
    (a null's code, -1, reads entry 0; its validity hides it)."""
    table = torch.from_numpy(np.ascontiguousarray(values)).to(codes.device)
    return table[codes.clamp(min=0).to(torch.int64)]


def _eval_concat(table: Table, e: "E.Concat") -> Column:
    """At most one column operand: the literal affixes rewrite the
    dictionary, and the codes change only where a suffix reorders it."""
    lits = [p.value for p in e.parts if isinstance(p, E.Lit)]
    cols = [p for p in e.parts if not isinstance(p, E.Lit)]
    if not cols:
        return Column(STRING, torch.zeros(table.num_rows, dtype=torch.int32,
                                          device=table.device),
                      None, np.array(["".join(map(str, lits))], dtype=object))
    c = eval_expr(table, cols[0])
    if c.dtype != STRING:
        raise HyperspaceException("concat() over non-string column")
    pre: List[str] = []
    post: List[str] = []
    seen = False
    for p in e.parts:
        if isinstance(p, E.Lit):
            (post if seen else pre).append(str(p.value))
        else:
            seen = True
    prefix, suffix = "".join(pre), "".join(post)
    dic = np.array([f"{prefix}{s}{suffix}" for s in c.dictionary], dtype=object)
    # A dictionary stays sorted (codes compare like the strings). A prefix
    # keeps the order; a suffix can break it (['a', 'ab'] + 'z').
    if dic.size > 1 and any(dic[i] > dic[i + 1] for i in range(dic.size - 1)):
        order = np.argsort(dic)
        remap = np.empty(dic.size, np.int32)
        remap[order] = np.arange(dic.size, dtype=np.int32)
        data = torch.where(c.data >= 0, _gather_host(remap, c.data), c.data)
        return Column(STRING, data, c.validity, dic[order])
    return Column(STRING, c.data, c.validity, dic)


def like_pattern_to_regex(pattern: str) -> str:
    """SQL LIKE as an anchored regex: % is any run, _ any one character,
    the rest literal."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def _eval_like(table: Table, e: "E.Like") -> Column:
    """One host regex match per dictionary entry, then one device gather
    of codes to bool."""
    col = eval_expr(table, e.child)
    if col.dtype != STRING:
        raise HyperspaceException(f"LIKE requires a string operand: {e!r}")
    # DOTALL: SQL's % and _ match newlines too.
    rx = re.compile(like_pattern_to_regex(e.pattern), re.DOTALL)
    dict_mask = np.fromiter((rx.fullmatch(s) is not None for s in col.dictionary),
                            dtype=np.bool_, count=len(col.dictionary))
    if e.negated:
        dict_mask = ~dict_mask
    if dict_mask.all() or not dict_mask.any():
        # Constant over the dictionary: no gather.
        value = bool(dict_mask.all()) if len(dict_mask) else e.negated
        return Column(BOOL, torch.full((len(col),), value, dtype=torch.bool,
                                       device=col.data.device), col.validity)
    return Column(BOOL, _gather_host(dict_mask, col.data), col.validity)


def _eval_is_null(table: Table, e: "E.IsNull") -> Column:
    col = eval_expr(table, e.child)
    if col.validity is None:
        data = torch.full((len(col),), e.negated, dtype=torch.bool, device=col.data.device)
    else:
        data = col.validity if e.negated else ~col.validity
    return Column(BOOL, data, None)  # IS NULL itself is never null.


def _eval_case_when(table: Table, e: "E.CaseWhen") -> Column:
    """The first true condition wins; a null condition falls through; the
    chosen branch's validity carries; no match and no ELSE is null."""
    n = table.num_rows
    dev = table.device
    conds = []
    for c, _ in e.branches:
        cc = eval_expr(table, c)
        if cc.dtype != BOOL:
            raise HyperspaceException(f"CASE condition is not boolean: {c!r}")
        conds.append(cc.data if cc.validity is None else cc.data & cc.validity)

    def value_col(v) -> Optional[Column]:
        if isinstance(v, E.Lit):
            if v.value is None:
                return None  # typed after unification (an all-null column)
            return _literal_column(v.value, n, dev, "use")
        return eval_expr(table, v)

    vals = [value_col(v) for _, v in e.branches]
    if e.else_value is not None:
        vals.append(value_col(e.else_value))
    vals = _unify_branch_columns(vals, n, dev)
    if e.else_value is not None:
        acc, branch_vals = vals[-1], vals[:-1]
    else:
        proto = vals[0]
        acc = Column(proto.dtype, torch.zeros(n, dtype=proto.data.dtype, device=dev),
                     torch.zeros(n, dtype=torch.bool, device=dev), proto.dictionary)
        branch_vals = vals
    data, validity = acc.data, acc.validity
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    # Right to left, so the first true condition wins.
    for cond, v in zip(reversed(conds), reversed(branch_vals)):
        data = torch.where(cond, v.data, data)
        new_valid = torch.where(cond, v.validity if v.validity is not None else ones,
                                validity if validity is not None else ones)
        validity = None if (v.validity is None and validity is None) else new_valid
    return Column(vals[0].dtype, data, validity, vals[0].dictionary)


def _unify_branch_columns(vals, n: int, dev):
    """CASE branch values in one dtype (strings over one dictionary, ints
    widened to float64 beside a float); a None entry (an explicit NULL
    branch) becomes an all-null column of that type."""
    typed = [v for v in vals if v is not None]
    if not typed:
        raise HyperspaceException("CASE with only NULL branches has no type")
    if len(typed) < len(vals):
        typed = _unify_branch_columns(typed, n, dev)
        proto = typed[0]
        null_col = Column(proto.dtype, torch.zeros(n, dtype=proto.data.dtype, device=dev),
                          torch.zeros(n, dtype=torch.bool, device=dev), proto.dictionary)
        it = iter(typed)
        return [null_col if v is None else next(it) for v in vals]
    kinds = {v.dtype for v in vals}
    if kinds == {STRING}:
        dicts = [v.dictionary for v in vals]
        if all(dictionaries_equal(dicts[0], d) for d in dicts[1:]):
            return vals
        union = np.unique(np.concatenate(dicts))
        return [Column(STRING, translate_codes(union, v), v.validity, union) for v in vals]
    if len(kinds) == 1:
        return vals
    if STRING in kinds:
        raise HyperspaceException(
            f"CASE branches mix string and non-string types: {sorted(kinds)}")
    if any(v.data.is_floating_point() for v in vals):
        return [Column(FLOAT64, v.data.to(torch.float64), v.validity) for v in vals]
    return [Column(INT64, v.data.to(torch.int64), v.validity) for v in vals]


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _eval_date_part(table: Table, e: "E.DatePart") -> Column:
    """EXTRACT over int32 days since 1970: the integer civil-from-days
    algorithm, with floor division (days before 1970 are negative)."""
    col = eval_expr(table, e.child)
    if col.dtype != DATE:
        raise HyperspaceException(f"EXTRACT requires a date operand: {e!r}")
    z = col.data.to(torch.int64) + 719468
    era = _floor_div(z, 146097)
    doe = z - era * 146097
    yoe = _floor_div(doe - _floor_div(doe, 1460) + _floor_div(doe, 36524)
                     - _floor_div(doe, 146096), 365)
    doy = doe - (365 * yoe + _floor_div(yoe, 4) - _floor_div(yoe, 100))
    mp = _floor_div(5 * doy + 2, 153)
    if e.part == "day":
        out = doy - _floor_div(153 * mp + 2, 5) + 1
    else:
        m = mp + torch.where(mp < 10, 3, -9)
        if e.part == "year":
            out = yoe + era * 400 + (m <= 2).to(torch.int64)
        elif e.part == "month":
            out = m
        else:
            out = _floor_div(m - 1, 3) + 1
    return Column(INT64, out.to(torch.int64), col.validity)


def _substring_fn(start: int, length: Optional[int]):
    """Spark's SUBSTRING: 1-based start, a negative start counts from the
    end, 0 acts as 1; a start before the beginning still uses up length."""
    def fn(s: str) -> str:
        n = len(s)
        first = start - 1 if start > 0 else (n + start if start < 0 else 0)
        end = n if length is None else first + max(length, 0)
        lo = min(max(first, 0), n)
        return s[lo:max(end, lo)]
    return fn


def _eval_string_transform(table: Table, e) -> Column:
    """SUBSTRING, UPPER, LOWER and TRIM: each dictionary entry transformed
    once on the host and re-encoded (a transform can merge or reorder
    entries), then one gather maps the codes."""
    col = eval_expr(table, e.child)
    if col.dtype != STRING:
        raise HyperspaceException(f"{e.op_name} requires a string operand")
    if isinstance(e, E.Substring):
        fn = _substring_fn(e.start, e.length)
    else:
        fn = {"upper": str.upper, "lower": str.lower, "trim": str.strip}[e.fn]
    transformed = np.asarray([fn(s) for s in col.dictionary])
    if len(transformed) == 0:
        return Column(STRING, col.data, col.validity, transformed)
    union, inverse = np.unique(transformed, return_inverse=True)
    return Column(STRING, _gather_host(inverse.astype(np.int32), col.data), col.validity,
                  union)


_RANGE_LO = (E.GreaterThan, E.GreaterThanOrEqual)
_RANGE_HI = (E.LessThan, E.LessThanOrEqual)


def _kernel_takes(data: torch.Tensor, *lits) -> bool:
    """A mask kernel handles this column and these literals: a non-empty
    32-bit column, and literals that convert to its dtype exactly (a
    fractional or out-of-range literal against an int column takes the
    promoting plain path instead)."""
    return (data.shape[0] > 0 and data.dtype in _KERNEL_DTYPES
            and all(cuda_kernels.literal_fits(v, data.dtype) for v in lits))


def _try_fused_range(table: Table, e: "E.And") -> Optional[Column]:
    """BETWEEN: And(col >(=) lo, col <(=) hi) over one 32-bit column is one
    range-kernel pass instead of two compare passes and an AND."""
    lo_cmp, hi_cmp = e.left, e.right
    if isinstance(lo_cmp, _RANGE_HI) and isinstance(hi_cmp, _RANGE_LO):
        lo_cmp, hi_cmp = hi_cmp, lo_cmp
    if not (isinstance(lo_cmp, _RANGE_LO) and isinstance(hi_cmp, _RANGE_HI)):
        return None
    if not (isinstance(lo_cmp.left, E.Col) and isinstance(hi_cmp.left, E.Col)
            and isinstance(lo_cmp.right, E.Lit)
            and isinstance(hi_cmp.right, E.Lit)
            and lo_cmp.left.column == hi_cmp.left.column):
        return None
    col = table.column(lo_cmp.left.column)
    if col.dtype == STRING:
        return None
    lo = literal_to_device(lo_cmp.right.value, col.dtype, None)
    hi = literal_to_device(hi_cmp.right.value, col.dtype, None)
    if not _kernel_takes(col.data, lo, hi):
        return None
    mask = cuda_kernels.range_mask(
        col.data, lo, hi,
        lo_incl=isinstance(lo_cmp, E.GreaterThanOrEqual),
        hi_incl=isinstance(hi_cmp, E.LessThanOrEqual))
    return Column(BOOL, mask, col.validity)


def _merge_validity(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _eval_comparison(table: Table, e) -> Column:
    left, right = e.left, e.right
    flipped = False
    if isinstance(left, E.Lit) and not isinstance(right, E.Lit):
        left, right = right, left
        flipped = True
    if isinstance(right, E.Lit):
        col = eval_expr(table, left)
        data = compare_literal(col, _op_name(e, flipped), right.value)
        return Column(BOOL, data, col.validity)
    # column vs column.
    lc = eval_expr(table, left)
    rc = eval_expr(table, right)
    ld, rd = _align_for_compare(lc, rc, type(e).__name__)
    data = _TORCH_OP[_op_name(e, False)](ld, rd)
    return Column(BOOL, data, _merge_validity(lc.validity, rc.validity))


def _op_name(e, flipped: bool) -> str:
    name = type(e).__name__
    if not flipped:
        return name
    return {
        "EqualTo": "EqualTo",
        "LessThan": "GreaterThan",
        "LessThanOrEqual": "GreaterThanOrEqual",
        "GreaterThan": "LessThan",
        "GreaterThanOrEqual": "LessThanOrEqual",
    }[name]


def compare_literal(col: Column, op: str, value) -> torch.Tensor:
    """Compare a device column against a host literal.

    Strings compare dictionary codes against searchsorted (lo, hi) bounds,
    so every op is an integer comparison on codes.
    """
    if col.dtype == STRING:
        lo, hi = literal_to_device(value, STRING, col.dictionary)
        codes = col.data
        if op == "EqualTo":
            if lo == hi:  # literal not present.
                return torch.zeros(codes.shape[0], dtype=torch.bool, device=codes.device)
            return codes == lo
        if op == "LessThan":
            return codes < lo
        if op == "LessThanOrEqual":
            return codes < hi
        if op == "GreaterThan":
            return codes >= hi
        if op == "GreaterThanOrEqual":
            return codes >= lo
        raise HyperspaceException(f"Unknown op {op}")
    lit = literal_to_device(value, col.dtype, None)
    data = col.data
    if _kernel_takes(data, lit):
        return cuda_kernels.compare_mask(data, _SYMBOL[op], lit)
    if isinstance(lit, float) and not data.dtype.is_floating_point:
        # An int column against a fractional literal compares in float64,
        # as the JAX package's x64 promotion does (torch alone would pick
        # float32 and lose integer precision).
        data = data.to(torch.float64)
    elif isinstance(lit, int) and data.dtype in (torch.int32, torch.uint32) \
            and not cuda_kernels.literal_fits(lit, data.dtype):
        # An int literal past a 32-bit column's range compares in int64:
        # torch would wrap it to the column's width (2**40 to 0), and the
        # answer would then depend on whether a pushed read pruned first.
        data = data.to(torch.int64)
    return _TORCH_OP[op](data, lit)


def _eval_in(table: Table, e: E.In) -> Column:
    col = eval_expr(table, e.value)
    values = [opt.value for opt in e.options]
    if not values:
        return Column(BOOL, torch.zeros(len(col), dtype=torch.bool, device=col.data.device),
                      col.validity)
    mask = compare_literal(col, "EqualTo", values[0])
    for v in values[1:]:
        mask = mask | compare_literal(col, "EqualTo", v)
    return Column(BOOL, mask, col.validity)


def _eval_arith(table: Table, e) -> Column:
    def operand(x):
        if isinstance(x, E.Lit):
            return None, x.value
        c = eval_expr(table, x)
        if c.dtype == STRING:
            raise HyperspaceException("Arithmetic on string column")
        return c, c.data

    lcol, ld = operand(e.left)
    rcol, rd = operand(e.right)
    if lcol is None and rcol is None:
        raise HyperspaceException("Arithmetic between two literals")
    if isinstance(e, E.Divide):
        dev = (ld if lcol is not None else rd).device
        data = torch.div(_as_float64(ld, dev), _as_float64(rd, dev))
    else:
        data = _ARITH[type(e).__name__](_promote(ld, rd), _promote(rd, ld))
    validity = _merge_validity(None if lcol is None else lcol.validity,
                               None if rcol is None else rcol.validity)
    if data.is_floating_point():
        return Column(FLOAT64, data.to(torch.float64), validity)
    return Column(INT64, data.to(torch.int64), validity)


def _as_float64(x, device) -> torch.Tensor:
    """A literal becomes a 0-d tensor on the device: divided by a Python
    float, torch multiplies by its reciprocal on the card (and for
    ``3 / x`` on the CPU too), one bit off the JAX package's quotient."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.full((), float(x), dtype=torch.float64, device=device)


def _promote(x, other):
    """An integer column meeting a float literal computes in float64."""
    if isinstance(x, torch.Tensor) and not x.is_floating_point() \
            and isinstance(other, float):
        return x.to(torch.float64)
    return x


def _align_for_compare(lc: Column, rc: Column, op_name: str):
    if lc.dtype == STRING or rc.dtype == STRING:
        if lc.dtype != STRING or rc.dtype != STRING:
            raise HyperspaceException("Cannot compare string with non-string")
        if dictionaries_equal(lc.dictionary, rc.dictionary):
            return lc.data, rc.data
        if op_name != "EqualTo":
            raise HyperspaceException(
                "Ordering comparison across different string dictionaries "
                "is not supported yet")
        return lc.data, translate_codes(lc.dictionary, rc)
    return lc.data, rc.data


# ---------------------------------------------------------------------------
# Program-bank stage keys (the JAX package's fused predicate and arithmetic
# programs: one compiled program per STRUCTURE, literal values as runtime
# arguments). The port evaluates eagerly; these keys give its bank lookups
# the stages the reference registers, so the bank counts alike.
# ---------------------------------------------------------------------------

class _NotFusable(Exception):
    pass


def _pred_structure(table: Table, e: E.Expr, col_ix: dict, lits: list):
    """The hashable structure of a predicate the JAX package fuses:
    Col/Lit comparisons (STRING-vs-literal via dictionary bounds), numeric
    col-vs-col comparisons, And/Or/Not, In over literals, IsNull. Raises
    _NotFusable for anything else (LIKE, CASE, arithmetic, string col-col)."""
    if isinstance(e, (E.And, E.Or)):
        return (("and" if isinstance(e, E.And) else "or"),
                _pred_structure(table, e.left, col_ix, lits),
                _pred_structure(table, e.right, col_ix, lits))
    if isinstance(e, E.Not):
        return ("not", _pred_structure(table, e.child, col_ix, lits))
    if isinstance(e, E.IsNull):
        if not isinstance(e.child, E.Col):
            raise _NotFusable()
        return ("isnull", col_ix[e.child.column], bool(e.negated))
    if isinstance(e, E.In):
        if not isinstance(e.value, E.Col) or not all(isinstance(o, E.Lit) for o in e.options):
            raise _NotFusable()
        return ("in", col_ix[e.value.column],
                tuple(_lit_slot(table, e.value.column, o.value, lits) for o in e.options))
    if isinstance(e, _COMPARISONS):
        left, right = e.left, e.right
        flipped = False
        if isinstance(left, E.Lit) and not isinstance(right, E.Lit):
            left, right = right, left
            flipped = True
        if not isinstance(left, E.Col):
            raise _NotFusable()
        if isinstance(right, E.Lit):
            return ("cmp", _op_name(e, flipped), col_ix[left.column],
                    _lit_slot(table, left.column, right.value, lits))
        if not isinstance(right, E.Col):
            raise _NotFusable()
        if STRING in (table.column(left.column).dtype, table.column(right.column).dtype):
            raise _NotFusable()  # dictionary translation is host work
        return ("colcmp", _op_name(e, False), col_ix[left.column], col_ix[right.column])
    raise _NotFusable()


def _lit_slot(table: Table, column: str, value, lits: list):
    """A literal's slot descriptor: its slot number and the Python type of
    its encoded value (the traced scalar's dtype in the reference)."""
    c = table.column(column)
    j = len(lits)
    if c.dtype == STRING:
        lits.extend(literal_to_device(value, STRING, c.dictionary))
        return ("slit", j)
    lit = literal_to_device(value, c.dtype, None)
    lits.append(lit)
    return ("lit", j, type(lit).__name__)


def _arith_structure(table: Table, e: E.Expr, col_ix: dict, lits: list):
    """Structure of an arithmetic tree over Col/Lit (the Project and
    aggregate-child shape, e.g. price * (1 - discount))."""
    if isinstance(e, E.Alias):
        return _arith_structure(table, e.child, col_ix, lits)
    if isinstance(e, E.Col):
        if table.column(e.column).dtype == STRING:
            raise _NotFusable()
        return ("col", col_ix[e.column])
    if isinstance(e, E.Lit):
        v = e.value
        if not isinstance(v, (int, float, bool)) or isinstance(v, bool):
            raise _NotFusable()
        lits.append(v)
        return ("alit", len(lits) - 1, type(v).__name__)
    if isinstance(e, (E.Add, E.Subtract, E.Multiply, E.Divide)):
        return ("arith", type(e).__name__, _arith_structure(table, e.left, col_ix, lits),
                _arith_structure(table, e.right, col_ix, lits))
    raise _NotFusable()


def _bank_key(table: Table, e: E.Expr, walk, tag):
    names = sorted(set(e.references))
    if not names or table.num_rows == 0:
        return None
    col_ix = {nm: i for i, nm in enumerate(names)}
    try:
        spec = walk(table, e, col_ix, [])
    except _NotFusable:
        return None
    cols = [table.column(nm) for nm in names]
    sig = tuple((c.dtype, c.validity is not None) for c in cols)
    # Each input's length class: the length the reference's program is
    # compiled for (its tables ride padded to the class).
    n = padded_length(int(table.num_rows))
    return ("fused-predicate", tag + (spec, sig)), tuple(n for _ in cols)


def predicate_bank_key(table: Table, condition: E.Expr):
    """(stage key, shape-class vector) of the JAX package's fused predicate
    program for a staged Filter, or None where it evaluates eagerly."""
    try:
        return _bank_key(table, condition, _pred_structure, ())
    except KeyError:
        return None


def arith_bank_key(table: Table, e: E.Expr):
    """(stage key, shape-class vector) of the JAX package's fused
    arithmetic program for a projected or aggregated expression, or None."""
    inner = e.child if isinstance(e, E.Alias) else e
    if not isinstance(inner, (E.Add, E.Subtract, E.Multiply, E.Divide)):
        return None
    return _bank_key(table, e, _arith_structure, ("arith",))
