"""Vectorized expression evaluation over device tables (counterpart of
``hyperspace_tpu/execution/evaluator.py``, trimmed to comparisons, BETWEEN,
IN lists, Kleene boolean algebra, arithmetic and aliases).

Null semantics follow SQL for filters: a comparison touching a null is
null, and Filter keeps only rows whose predicate is true-and-valid.

There is one counted-mask path. Comparisons of a 32-bit column with a
literal run the compare kernel, and ``col >(=) lo AND col <(=) hi`` runs the
range kernel (ops/cuda_kernels.py); an IN list is an OR of such
equalities. Every other shape is plain torch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..exceptions import HyperspaceException
from ..ops import cuda_kernels, kernels
from ..plan import expr as E
from ..schema import BOOL, FLOAT64, INT64, STRING
from .columnar import Column, Table, dictionaries_equal, literal_to_device, translate_codes

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
    raise HyperspaceException(f"Cannot evaluate expression: {e!r}")


_RANGE_LO = (E.GreaterThan, E.GreaterThanOrEqual)
_RANGE_HI = (E.LessThan, E.LessThanOrEqual)


def _kernel_takes(data: torch.Tensor, *lits) -> bool:
    """A mask kernel handles this column and these literals: a non-empty
    32-bit column, and literals that convert to its dtype exactly (a
    fractional or out-of-range literal against an int column takes the
    promoting plain path instead, as in the JAX package)."""
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
