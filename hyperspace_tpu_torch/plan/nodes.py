"""Logical plan IR (counterpart of ``hyperspace_tpu/plan/nodes.py``:
Scan, IndexScan, Filter, Project, Join of every type, Aggregate, Window,
Sort, Limit, Union and BucketUnion).

Nodes carry resolved schemas (analysis happens at construction). The
rewrite rules (rules/) pattern-match these nodes the way the reference
matches Scan→Filter(→Project) subtrees.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..exceptions import HyperspaceException
from ..schema import BOOL, DATE, FLOAT32, FLOAT64, INT32, INT64, STRING, Field, Schema
from . import expr as E


def infer_dtype(e: E.Expr, schema: Schema) -> str:
    """Output type of ``e`` under the JAX package's x64 promotion."""
    if isinstance(e, E.Col):
        return schema.field(e.column).dtype
    if isinstance(e, E.Alias):
        return infer_dtype(e.child, schema)
    if isinstance(e, E.Lit):
        v = e.value
        if isinstance(v, bool):
            return BOOL
        if isinstance(v, int):
            return INT64
        if isinstance(v, float):
            return FLOAT64
        if isinstance(v, datetime.date):
            return DATE
        if isinstance(v, str):
            return STRING
        raise HyperspaceException(f"Cannot infer type of literal {v!r}")
    if isinstance(e, (E.EqualTo, E.LessThan, E.LessThanOrEqual, E.GreaterThan,
                      E.GreaterThanOrEqual, E.And, E.Or, E.Not, E.In,
                      E.Like, E.IsNull)):
        return BOOL
    if isinstance(e, E.DatePart):
        return INT64
    if isinstance(e, (E.Substring, E.StringTransform)):
        if infer_dtype(e.child, schema) != STRING:
            raise HyperspaceException(f"{e.op_name} requires a string operand: {e!r}")
        return STRING
    if isinstance(e, E.CaseWhen):
        values = [v for _, v in e.branches]
        if e.else_value is not None:
            values.append(e.else_value)
        # Explicit NULL branches give nullability, not a type.
        kinds = [infer_dtype(v, schema) for v in values
                 if not (isinstance(v, E.Lit) and v.value is None)]
        if not kinds:
            raise HyperspaceException(f"CASE with only NULL branches has no type: {e!r}")
        uniq = set(kinds)
        if len(uniq) == 1:
            return kinds[0]
        if uniq <= {INT64, INT32, FLOAT64, FLOAT32}:
            return FLOAT64 if uniq & {FLOAT64, FLOAT32} else INT64
        raise HyperspaceException(
            f"CASE branches have incompatible types {sorted(uniq)}: {e!r}")
    if isinstance(e, (E.Add, E.Subtract, E.Multiply)):
        kinds = {infer_dtype(c, schema) for c in e.children}
        return FLOAT64 if kinds & {FLOAT64, FLOAT32} else INT64
    if isinstance(e, (E.Divide, E.Sqrt, E.Avg)):
        return FLOAT64
    if isinstance(e, E.NullLit):
        return e.dtype
    if isinstance(e, E.Concat):
        for p in e.parts:
            pt = infer_dtype(p, schema)
            if pt != STRING:
                raise HyperspaceException(f"concat() operands must be strings; got {pt}")
        return STRING
    if isinstance(e, (E.Count, E.CountDistinct)):
        return INT64
    if isinstance(e, E.Sum):
        return FLOAT64 if infer_dtype(e.child, schema) in (FLOAT64, FLOAT32) else INT64
    if isinstance(e, (E.Min, E.Max)):
        return infer_dtype(e.child, schema)
    if isinstance(e, E.WindowExpr):
        if e.fn in E.WindowExpr.RANK_FNS or e.fn == "count":
            return INT64
        if e.fn == "avg":
            return FLOAT64
        child = infer_dtype(e.arg, schema)
        if e.fn == "sum":
            return FLOAT64 if child in (FLOAT64, FLOAT32) else INT64
        return child  # min / max
    raise HyperspaceException(f"Cannot infer type of {e!r}")


class LogicalPlan:
    """Base node. ``schema`` is the resolved output schema."""

    @property
    def children(self) -> List["LogicalPlan"]:
        return []

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def node_name(self) -> str:
        return type(self).__name__

    def collect_leaves(self) -> List["LogicalPlan"]:
        if not self.children:
            return [self]
        out = []
        for c in self.children:
            out.extend(c.collect_leaves())
        return out

    def transform_up(self, fn) -> "LogicalPlan":
        new_children = [c.transform_up(fn) for c in self.children]
        node = self.with_children(new_children) if new_children != self.children else self
        return fn(node)

    def with_children(self, children: List["LogicalPlan"]) -> "LogicalPlan":
        if children:
            raise HyperspaceException(f"{self.node_name} has no children to replace")
        return self

    def simple_string(self) -> str:
        return self.node_name

    def tree_string(self, depth: int = 0) -> str:
        lines = ["  " * depth + ("+- " if depth else "") + self.simple_string()]
        for c in self.children:
            lines.append(c.tree_string(depth + 1))
        return "\n".join(lines)

    # Plan-node names feed the PlanSignatureProvider fingerprint.
    def node_names_preorder(self) -> List[str]:
        out = [self.node_name]
        for c in self.children:
            out.extend(c.node_names_preorder())
        return out


class Scan(LogicalPlan):
    """Leaf: scan a file-based relation.

    ``skipping_note``: set by DataSkippingIndexRule when it narrows the
    relation's file list, so explain renders the pruning (e.g. "[1/4 files
    after skipping]")."""

    def __init__(self, relation, skipping_note: Optional[str] = None):
        self.relation = relation  # sources.FileBasedRelation
        self.skipping_note = skipping_note

    @property
    def schema(self) -> Schema:
        return self.relation.schema

    def simple_string(self) -> str:
        return f"Scan {self.relation.describe()}" + \
            (f" [{self.skipping_note}]" if self.skipping_note else "")


class IndexScan(LogicalPlan):
    """Leaf: scan the bucketed files of a covering index version, optionally
    exposing the bucket spec so equality filters can prune buckets. Under
    Hybrid Scan it also reads ``appended_files`` (source files the index
    lacks) through ``source_relation``, the replaced Scan's relation (so a
    partitioned source's appended rows get their partition columns), and
    drops the rows whose lineage id is in ``deleted_file_ids``."""

    def __init__(self, index_entry, schema: Schema, use_bucket_spec: bool = False,
                 deleted_file_ids: Optional[Sequence[int]] = None,
                 appended_files: Optional[Sequence[str]] = None,
                 source_relation=None):
        self.index_entry = index_entry
        self._schema = schema
        self.use_bucket_spec = use_bucket_spec
        self.deleted_file_ids = list(deleted_file_ids or [])
        self.appended_files = list(appended_files or [])
        self.source_relation = source_relation

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        e = self.index_entry
        extra = ""
        if self.deleted_file_ids or self.appended_files:
            extra = (f", hybrid(+{len(self.appended_files)} appended,"
                     f" -{len(self.deleted_file_ids)} deleted files)")
        return (f"IndexScan Hyperspace(Type: {e.derivedDataset.kind_abbr}, "
                f"Name: {e.name}, LogVersion: {e.log_version}{extra})")


class Filter(LogicalPlan):
    def __init__(self, condition: E.Expr, child: LogicalPlan):
        for ref in condition.references:
            if ref not in child.schema:
                raise HyperspaceException(
                    f"Filter references unknown column '{ref}'; "
                    f"available: {child.schema.names}")
        self.condition = condition
        self.child = child

    @property
    def children(self) -> List[LogicalPlan]:
        return [self.child]

    def with_children(self, children):
        return Filter(self.condition, children[0])

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def simple_string(self) -> str:
        return f"Filter ({self.condition!r})"


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[E.Expr], child: LogicalPlan):
        self.exprs = [E.Col(e) if isinstance(e, str) else e for e in exprs]
        for e in self.exprs:
            for ref in e.references:
                if ref not in child.schema:
                    raise HyperspaceException(
                        f"Project references unknown column '{ref}'; "
                        f"available: {child.schema.names}")
        self.child = child
        names = [e.name for e in self.exprs]
        if len(set(names)) != len(names):
            raise HyperspaceException(f"Duplicate output columns in project: {names}")
        self._schema = Schema(
            [Field(e.name, infer_dtype(e, child.schema)) for e in self.exprs])

    @property
    def children(self) -> List[LogicalPlan]:
        return [self.child]

    def with_children(self, children):
        return Project(self.exprs, children[0])

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return f"Project [{', '.join(e.name for e in self.exprs)}]"


class Join(LogicalPlan):
    """An equi-join of type inner, left, right, full, semi or anti, or a
    cross join (no condition). Semi and anti joins emit the left side's
    rows only; the outer types make the null-producing side nullable."""

    TYPES = ("inner", "left", "right", "full", "semi", "anti", "cross")

    def __init__(self, left: LogicalPlan, right: LogicalPlan, condition: Optional[E.Expr],
                 join_type: str = "inner", reorder_note: Optional[str] = None):
        if join_type not in self.TYPES:
            raise HyperspaceException(f"Unsupported join type: {join_type}")
        if join_type == "cross":
            if condition is not None:
                raise HyperspaceException("Cross join takes no condition")
        elif condition is None:
            raise HyperspaceException(f"{join_type} join requires a condition")
        overlap = set(left.schema.names) & set(right.schema.names)
        if overlap:
            raise HyperspaceException(
                f"Ambiguous join output columns {sorted(overlap)}; rename before joining")
        combined = list(left.schema.fields) + list(right.schema.fields)
        names = {f.name for f in combined}
        for ref in (condition.references if condition is not None else ()):
            if ref not in names:
                raise HyperspaceException(f"Join condition references unknown '{ref}'")
        self.left = left
        self.right = right
        self.condition = condition
        self.join_type = join_type
        # Set by the join reorderer (optimizer/join_order.py) on the joins
        # it re-linearized; the tree string shows it.
        self.reorder_note = reorder_note
        if join_type in ("semi", "anti"):
            self._schema = left.schema
            return
        if join_type in ("left", "right", "full"):
            left_nullable = join_type in ("right", "full")
            right_nullable = join_type in ("left", "full")
            combined = [Field(f.name, f.dtype,
                              f.nullable or (left_nullable if f.name in left.schema
                                             else right_nullable))
                        for f in combined]
        self._schema = Schema(combined)

    @property
    def children(self) -> List[LogicalPlan]:
        return [self.left, self.right]

    def with_children(self, children):
        return Join(children[0], children[1], self.condition, self.join_type,
                    self.reorder_note)

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        note = f" [{self.reorder_note}]" if self.reorder_note else ""
        if self.join_type == "cross":
            return "Join cross" + note
        return f"Join {self.join_type} ({self.condition!r})" + note


class Aggregate(LogicalPlan):
    def __init__(self, group_cols: Sequence[str], aggs: Sequence[E.Expr],
                 child: LogicalPlan):
        self.group_cols = list(group_cols)
        self.aggs = list(aggs)
        for g in self.group_cols:
            if g not in child.schema:
                raise HyperspaceException(f"Group column '{g}' not in {child.schema.names}")
        self.child = child
        fields = [child.schema.field(g) for g in self.group_cols]
        for a in self.aggs:
            fields.append(Field(a.name, infer_dtype(a, child.schema)))
        self._schema = Schema(fields)

    @property
    def children(self) -> List[LogicalPlan]:
        return [self.child]

    def with_children(self, children):
        return Aggregate(self.group_cols, self.aggs, children[0])

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return (f"Aggregate [{', '.join(self.group_cols)}] "
                f"[{', '.join(a.name for a in self.aggs)}]")


class Window(LogicalPlan):
    """Analytic functions over partitions: one output column per
    WindowExpr appended to the child's schema, in the child's row order
    (computed in partition-sorted order and scattered back). Arguments,
    partition and order keys are plain columns; the SQL front end
    materializes anything else first."""

    def __init__(self, wexprs: Sequence[Tuple[str, E.WindowExpr]], child: LogicalPlan):
        if not wexprs:
            raise HyperspaceException("Window requires at least one expr")
        self.wexprs = [(name, w) for name, w in wexprs]
        for name, w in self.wexprs:
            for ref in w.references:
                if ref not in child.schema:
                    raise HyperspaceException(
                        f"Window expr references unknown column '{ref}'; "
                        f"available: {child.schema.names}")
            for p in w.partition:
                if not isinstance(p, E.Col):
                    raise HyperspaceException(
                        f"Window PARTITION BY must be plain columns; got {p!r}")
            for o, _ in w.orders:
                if not isinstance(o, E.Col):
                    raise HyperspaceException(
                        f"Window ORDER BY must be plain columns; got {o!r}")
            if w.arg is not None and not isinstance(w.arg, E.Col):
                raise HyperspaceException(
                    f"Window argument must be a plain column; got {w.arg!r}")
            if name in child.schema:
                raise HyperspaceException(
                    f"Window output '{name}' collides with input column")
        self.child = child
        fields = list(child.schema.fields)
        for name, w in self.wexprs:
            fields.append(Field(name, infer_dtype(w, child.schema)))
        self._schema = Schema(fields)

    @property
    def children(self) -> List[LogicalPlan]:
        return [self.child]

    def with_children(self, children):
        return Window(self.wexprs, children[0])

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return "Window [" + ", ".join(f"{name}={w!r}" for name, w in self.wexprs) + "]"


class Sort(LogicalPlan):
    def __init__(self, orders: Sequence[Tuple[str, bool]], child: LogicalPlan):
        # orders: (column, ascending)
        self.orders = [(c, asc) for c, asc in orders]
        for c, _ in self.orders:
            if c not in child.schema:
                raise HyperspaceException(f"Sort column '{c}' not in {child.schema.names}")
        self.child = child

    @property
    def children(self) -> List[LogicalPlan]:
        return [self.child]

    def with_children(self, children):
        return Sort(self.orders, children[0])

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def simple_string(self) -> str:
        parts = [f"{c} {'ASC' if a else 'DESC'}" for c, a in self.orders]
        return f"Sort [{', '.join(parts)}]"


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.child = child

    @property
    def children(self) -> List[LogicalPlan]:
        return [self.child]

    def with_children(self, children):
        return Limit(self.n, children[0])

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def simple_string(self) -> str:
        return f"Limit {self.n}"


class Union(LogicalPlan):
    """UNION ALL of children with the same column names, in order."""

    def __init__(self, children: List[LogicalPlan]):
        if not children:
            raise HyperspaceException("Union requires children")
        first = children[0].schema.names
        for c in children[1:]:
            if c.schema.names != first:
                raise HyperspaceException("Union children must share schema")
        self._children = list(children)

    @property
    def children(self) -> List[LogicalPlan]:
        return list(self._children)

    def with_children(self, children):
        return Union(children)

    @property
    def schema(self) -> Schema:
        return self._children[0].schema


class BucketUnion(LogicalPlan):
    """A union of bucketed outputs that share one bucket layout: the
    children's rows concatenated, in order."""

    def __init__(self, children: List[LogicalPlan], bucket_spec: "BucketSpec"):
        if not children:
            raise HyperspaceException("BucketUnion requires children")
        first = children[0].schema.names
        for c in children[1:]:
            if c.schema.names != first:
                raise HyperspaceException("BucketUnion children must share schema")
        self._children = list(children)
        self.bucket_spec = bucket_spec

    @property
    def children(self) -> List[LogicalPlan]:
        return list(self._children)

    def with_children(self, children):
        return BucketUnion(children, self.bucket_spec)

    @property
    def schema(self) -> Schema:
        return self._children[0].schema


@dataclass(frozen=True)
class BucketSpec:
    """A bucket layout: the bucket count, the bucketing columns and the
    columns rows are sorted by within a bucket."""

    num_buckets: int
    bucket_column_names: Tuple[str, ...]
    sort_column_names: Tuple[str, ...]
