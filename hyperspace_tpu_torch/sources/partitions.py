"""Hive-style partitioned directories, ``root/key=value/.../file``
(counterpart of ``hyperspace_tpu/sources/partitions.py``).

Three host-side concerns:

- discovery: ``key=value`` path segments under the relation's base path
  become typed partition fields (int64 when every value parses as an
  integer, date for ISO dates, string otherwise);
- materialization: partition columns are not in the data files; they are
  attached per file as constant device columns when a scan or a build
  reads the files;
- pruning: partition-column conjuncts are evaluated per file at planning
  time, always (not only with hyperspace enabled), after the index rules.
"""

from __future__ import annotations

import datetime
import os
from itertools import groupby
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..plan import expr as E
from ..schema import DATE, INT64, STRING, Field

HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def partition_segments(base: str, path: str) -> List[Tuple[str, str]]:
    """(key, raw value) pairs from the path's directory levels under base."""
    rel = os.path.relpath(os.path.dirname(os.path.abspath(path)),
                          os.path.abspath(base))
    if rel in (".", ""):
        return []
    out: List[Tuple[str, str]] = []
    for seg in rel.split(os.sep):
        if "=" in seg:
            k, _, v = seg.partition("=")
            out.append((k, v))
    return out


def infer_partition_fields(base: str, files: Sequence[str]) -> List[Field]:
    """The partition schema the file paths agree on, or [] when the layout
    is not hive-partitioned (no key=value levels, or keys that differ
    between files)."""
    keys: Optional[List[str]] = None
    values_by_key: Dict[str, List[str]] = {}
    for f in files:
        segs = partition_segments(base, f)
        ks = [k for k, _ in segs]
        if keys is None:
            keys = ks
        elif ks != keys:
            return []
        for k, v in segs:
            values_by_key.setdefault(k, []).append(v)
    if not keys:
        return []
    return [Field(k, _infer_dtype(values_by_key[k]), False) for k in keys]


def _infer_dtype(raw_values: Sequence[str]) -> str:
    def parses(fn, v) -> bool:
        try:
            fn(v)
            return True
        except ValueError:
            return False

    vals = [v for v in raw_values if v != HIVE_DEFAULT_PARTITION]
    if vals and all(parses(int, v) for v in vals):
        return INT64
    if vals and all(parses(datetime.date.fromisoformat, v) for v in vals):
        return DATE
    return STRING


def partition_value(raw: str, dtype: str):
    if raw == HIVE_DEFAULT_PARTITION:
        return None
    if dtype == INT64:
        return int(raw)
    if dtype == DATE:
        return datetime.date.fromisoformat(raw)
    return raw


def file_partition_values(base: str, path: str, fields: Sequence[Field]):
    by_key = dict(partition_segments(base, path))
    return tuple(partition_value(by_key[f.name], f.dtype) for f in fields)


def attach_partition_columns(table, relation, files: Sequence[str],
                             wanted: Sequence[Field], row_counts: Sequence[int]):
    """``table`` (the rows of ``files``, ``row_counts`` each, in order) with
    a constant-per-file column appended for each partition field in
    ``wanted``: dictionary-coded STRING, or int64 / date values, on the
    table's device."""
    from ..execution.columnar import Column

    device = _table_device(table)
    base = relation.partition_base_path
    counts = np.asarray(row_counts, dtype=np.int64)
    for f in wanted:
        per_file = [file_partition_values(base, p, [f])[0] for p in files]
        validity = None
        if any(v is None for v in per_file):
            validity = torch.from_numpy(np.repeat(
                np.array([v is not None for v in per_file]), counts)).to(device)
        if f.dtype == STRING:
            uniq = sorted({v for v in per_file if v is not None})
            dictionary = np.array(uniq, dtype=str) if uniq else np.array([], dtype=str)
            codes = np.array([np.searchsorted(dictionary, v) if v is not None else -1
                              for v in per_file], np.int32)
            col = Column(STRING, torch.from_numpy(np.repeat(codes, counts)).to(device),
                         validity, dictionary)
        else:
            if f.dtype == DATE:
                epoch = datetime.date(1970, 1, 1)
                nums = np.asarray([(v - epoch).days if v is not None else 0
                                   for v in per_file], np.int32)
            else:
                nums = np.asarray([v if v is not None else 0 for v in per_file], np.int64)
            col = Column(f.dtype, torch.from_numpy(np.repeat(nums, counts)).to(device),
                         validity)
        table = table.with_column(f.name, col)
    return table


def _table_device(table):
    for c in table.columns.values():
        return c.data.device
    return torch.device("cpu")


def read_relation_files(relation, files: Sequence[str], cols: Optional[Sequence[str]],
                        device, filters=None, pool: bool = False):
    """Read ``files`` of ``relation`` onto ``device`` with its partition
    columns attached: the one reader the scans and the builds share. A
    relation without partitions, or a read of none of its partition
    columns, goes straight to the columnar reader (with ``filters``, and
    through the buffer pool when ``pool``, as the executor's parquet scans
    ask); otherwise the files are read without the row-level filter (it
    would skew the per-file row counts; partition pruning has already
    narrowed the files), and the rows keep the files' order.

    Parquet files are read in one pass and counted by their footers. The
    other formats have no footers: each run of consecutive files that
    share partition values is read as one and takes its values (a listing
    walks directory by directory, so runs are partitions)."""
    from ..execution.columnar import Table, parquet_row_counts, read_parquet

    fmt = relation.data_file_format
    fields = relation.partition_fields()
    part_names = {f.name for f in fields}
    if not fields or (cols is not None and not any(c in part_names for c in cols)):
        return read_parquet(files, cols, device, filters=filters, pool=pool, fmt=fmt)
    wanted = fields if cols is None else [f for f in fields if f.name in cols]
    phys_cols = None if cols is None else [c for c in cols if c not in part_names]
    if phys_cols is not None and not phys_cols:
        # Only partition columns are wanted: read one physical column for
        # the row counts and drop it below.
        phys = [n for n in relation.schema.names if n not in part_names]
        phys_cols = [phys[0]] if phys else None
    if fmt == "parquet":
        table = read_parquet(files, phys_cols, device)
        out = attach_partition_columns(table, relation, files, wanted,
                                       parquet_row_counts(files))
    else:
        base = relation.partition_base_path
        parts = []
        for _, run in groupby(files, key=lambda f: file_partition_values(base, f, wanted)):
            run = list(run)
            table = read_parquet(run, phys_cols, device, fmt=fmt)
            parts.append(attach_partition_columns(table, relation, [run[0]], wanted,
                                                  [table.num_rows]))
        out = Table.concat(parts)
    if cols is not None:
        out = out.select([c for c in cols if c in out.names])
    return out


# ---------------------------------------------------------------------------
# Planning-time pruning.
# ---------------------------------------------------------------------------

def prune_partitions(plan):
    """Narrow every Filter-over-Scan of a partitioned relation to the files
    whose partition values can satisfy the filter."""
    from ..plan.nodes import Filter, Scan

    def rewrite(node):
        if isinstance(node, Filter) and isinstance(node.child, Scan):
            kept = _pruned_files(node.child.relation, node.condition)
            if kept is not None:
                return Filter(node.condition, Scan(node.child.relation.with_files(kept)))
        return node

    return plan.transform_up(rewrite)


def _pruned_files(relation, condition) -> Optional[List[str]]:
    fields = relation.partition_fields()
    if not fields:
        return None
    by_name = {f.name: f for f in fields}
    files = relation.all_files()
    base = relation.partition_base_path
    keep = np.ones(len(files), dtype=bool)
    pruned_any = False
    for conjunct in E.split_conjunctive_predicates(condition):
        verdict = _eval_partition_predicate(conjunct, by_name, base, files)
        if verdict is not None:
            keep &= verdict
            pruned_any = True
    if not pruned_any or keep.all():
        return None
    return [f for f, k in zip(files, keep) if k]


_FLIP = {"EqualTo": "EqualTo", "LessThan": "GreaterThan",
         "LessThanOrEqual": "GreaterThanOrEqual", "GreaterThan": "LessThan",
         "GreaterThanOrEqual": "LessThanOrEqual"}

_COMPARE = {
    "EqualTo": lambda v, lit: v == lit,
    "LessThan": lambda v, lit: v < lit,
    "LessThanOrEqual": lambda v, lit: v <= lit,
    "GreaterThan": lambda v, lit: v > lit,
    "GreaterThanOrEqual": lambda v, lit: v >= lit,
}


def _eval_partition_predicate(e, by_name, base, files) -> Optional[np.ndarray]:
    """Per-file keep mask for one conjunct over partition columns only;
    None when it is not a partition predicate (it prunes nothing)."""
    if isinstance(e, E.Or):
        left = _eval_partition_predicate(e.left, by_name, base, files)
        right = _eval_partition_predicate(e.right, by_name, base, files)
        if left is None or right is None:
            return None
        return left | right
    if isinstance(e, E.In) and isinstance(e.value, E.Col) \
            and e.value.column in by_name \
            and all(isinstance(o, E.Lit) for o in e.options):
        field = by_name[e.value.column]
        wanted = {_norm(o.value, field.dtype) for o in e.options}
        return np.array([v in wanted for v in _column_values(field, base, files)])
    if isinstance(e, (E.EqualTo, E.LessThan, E.LessThanOrEqual, E.GreaterThan,
                      E.GreaterThanOrEqual)):
        left, right = e.left, e.right
        op = type(e).__name__
        if isinstance(left, E.Lit) and isinstance(right, E.Col):
            left, right = right, left
            op = _FLIP[op]
        if not (isinstance(left, E.Col) and isinstance(right, E.Lit)
                and left.column in by_name):
            return None
        field = by_name[left.column]
        lit = _norm(right.value, field.dtype)
        # A null partition value never satisfies a comparison.
        return np.array([v is not None and bool(_COMPARE[op](v, lit))
                         for v in _column_values(field, base, files)], dtype=bool)
    return None


def _norm(value, dtype: str):
    if dtype == DATE and isinstance(value, str):
        return datetime.date.fromisoformat(value)
    if dtype == INT64 and not isinstance(value, bool):
        # A fractional literal is not truncated: int(5.5) would prune
        # year=5 from `year < 5.5`.
        if isinstance(value, float):
            return int(value) if value.is_integer() else value
        try:
            return int(value)
        except (TypeError, ValueError):
            return value
    return value


def _column_values(field: Field, base: str, files: Sequence[str]):
    return [file_partition_values(base, f, [field])[0] for f in files]
