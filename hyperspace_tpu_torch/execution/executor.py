"""Eager columnar plan executor (counterpart of
``hyperspace_tpu/execution/executor.py``: Scan, IndexScan, Filter and
Project).

Executes a logical plan bottom-up over device-resident tables. A Filter
directly over a scan pushes its prunable conjuncts into the parquet read;
over an IndexScan with the bucket spec exposed, equality predicates on the
indexed columns also prune whole bucket files before any IO.
"""

from __future__ import annotations

from typing import List, Optional, Set

from ..exceptions import HyperspaceException
from ..ops import kernels
from ..ops.index_build import bucket_id_from_file
from ..plan import expr as E
from ..plan.nodes import Filter, IndexScan, LogicalPlan, Project, Scan
from ..schema import STRING
from .columnar import Table, empty_table, literal_to_device, read_parquet
from .evaluator import eval_expr, eval_predicate_mask
from .pushdown import pushable_filter


def execute(plan: LogicalPlan, session) -> Table:
    return _execute(plan, None, session.device)


def _execute(plan: LogicalPlan, needed: Optional[Set[str]], device) -> Table:
    if isinstance(plan, Scan):
        return _execute_scan(plan, needed, device)
    if isinstance(plan, IndexScan):
        return _execute_index_scan(plan, needed, device)
    if isinstance(plan, Filter):
        child_needed = None if needed is None else \
            needed | set(plan.condition.references)
        child = plan.child
        if isinstance(child, (Scan, IndexScan)):
            # Push row-group-prunable conjuncts into the parquet read.
            pa_filter = pushable_filter(plan.condition, child.schema)
            if isinstance(child, Scan):
                table = _execute_scan(child, child_needed, device, pa_filter)
            else:
                table = _execute_index_scan(
                    child, child_needed, device, pa_filter,
                    bucket_subset=_equality_bucket_subset(child, plan.condition))
        else:
            table = _execute(child, child_needed, device)
        return _filter_table(table, plan.condition)
    if isinstance(plan, Project):
        child_needed = set()
        for e in plan.exprs:
            child_needed.update(e.references)
        table = _execute(plan.child, child_needed, device)
        return Table({e.name: eval_expr(table, e) for e in plan.exprs})
    raise HyperspaceException(f"Cannot execute plan node {plan.node_name}")


def _filter_table(table: Table, condition) -> Table:
    return table.filter(eval_predicate_mask(table, condition))


def _read_columns(schema_names: List[str], needed: Optional[Set[str]]) -> List[str]:
    """Columns to read, always explicit: index files live under "v__=<n>"
    directories, and pyarrow's reader would infer a phantom "v__" column
    from the path if asked for all columns."""
    if needed is None:
        return list(schema_names)
    return [n for n in schema_names if n in needed] or [schema_names[0]]


def _execute_scan(plan: Scan, needed: Optional[Set[str]], device,
                  pa_filter=None) -> Table:
    relation = plan.relation
    cols = _read_columns(relation.schema.names, needed)
    files = relation.all_files()
    if not files:
        return empty_table(relation.schema.select(cols), device)
    return read_parquet(files, cols, device, filters=pa_filter)


def _equality_bucket_subset(plan: IndexScan, condition) -> Optional[Set[int]]:
    """Bucket pruning: equality predicates on every indexed column pin the
    buckets a matching row can live in (the reference's useBucketSpec
    behavior), through the host mirror of the device hash."""
    if not plan.use_bucket_spec:
        return None
    entry = plan.index_entry
    # The bucket id combines the hashes of ALL indexed columns, so pruning
    # needs an equality constraint on every one.
    per_column_hashes = []
    for name in entry.indexed_columns:
        if name not in entry.schema:
            return None
        dtype = entry.schema.field(name).dtype
        values = None
        for conjunct in E.split_conjunctive_predicates(condition):
            vals = _equality_values(conjunct, name)
            if vals is not None:
                values = vals if values is None else (values & vals)
        if values is None or len(values) > 16:
            return None
        hashes = []
        for v in values:
            if dtype == STRING:
                hashes.append(kernels.hash32_value_host(str(v), dtype))
            else:
                hashes.append(kernels.hash32_value_host(
                    literal_to_device(v, dtype, None), dtype))
        per_column_hashes.append(hashes)

    combos = [None]
    for hashes in per_column_hashes:
        combos = [kernels.hash_combine_host(c, h) if c is not None else h
                  for c in combos for h in hashes]
        if len(combos) > 256:
            return None
    return {c % entry.num_buckets for c in combos}


def _equality_values(conjunct, column: str):
    if isinstance(conjunct, E.EqualTo):
        left, right = conjunct.left, conjunct.right
        if isinstance(left, E.Lit) and isinstance(right, E.Col):
            left, right = right, left
        if isinstance(left, E.Col) and left.column == column \
                and isinstance(right, E.Lit):
            return {right.value}
    if isinstance(conjunct, E.In) and isinstance(conjunct.value, E.Col) \
            and conjunct.value.column == column:
        if all(isinstance(o, E.Lit) for o in conjunct.options):
            return {o.value for o in conjunct.options}
    return None


def _execute_index_scan(plan: IndexScan, needed: Optional[Set[str]], device,
                        pa_filter=None,
                        bucket_subset: Optional[Set[int]] = None) -> Table:
    entry = plan.index_entry
    # Files in bucket order.
    keyed = sorted(((bucket_id_from_file(f), f) for f in entry.content.files),
                   key=lambda t: (t[0] is None, t[0] or 0, t[1]))
    if bucket_subset is not None:
        keyed = [(b, f) for b, f in keyed if b in bucket_subset]
    cols = _read_columns(plan.schema.names if needed is None else entry.schema.names,
                         needed)
    if not keyed:
        return empty_table(entry.schema.select(cols), device)
    return read_parquet([f for _, f in keyed], cols, device, filters=pa_filter)
