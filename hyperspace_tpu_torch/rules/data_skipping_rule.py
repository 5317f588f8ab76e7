"""DataSkippingIndexRule: prune a scan's file list using per-file sketches
(counterpart of ``hyperspace_tpu/rules/data_skipping_rule.py``). The
source relation is kept, but its file listing is narrowed to the files
whose sketches cannot refute the filter predicate. The covering-index
rule runs first; this rule only touches the Scan leaves it left in place.

Sketch probing is host-side, over the (one row per file) sketch table:
numpy, or the native library's C++ loops under ``HST_NATIVE_PROBE``
(native/); unknown predicate shapes keep all files.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import pyarrow.parquet as pq

from .. import native
from ..execution.pushdown import _FLIP
from ..index.constants import States
from ..index.log_entry import IndexLogEntry, Sketch
from ..plan import expr as E
from ..plan.nodes import Filter, LogicalPlan, Scan
from .rule_utils import _plan_signature, get_relation, log_index_usage


class DataSkippingIndexRule:
    def apply(self, session, plan: LogicalPlan, ctx) -> LogicalPlan:
        """Narrow every Filter-over-Scan; ``ctx`` (a ReasonCollector)
        records why an index did not prune and gets the applied names."""
        candidates = [e for e in session.index_collection_manager.get_indexes([States.ACTIVE])
                      if e.derivedDataset.kind == "DataSkippingIndex"]
        if not candidates:
            return plan
        applied: List[str] = []

        def rewrite(node: LogicalPlan) -> LogicalPlan:
            if isinstance(node, Filter) and isinstance(node.child, Scan):
                pruned = self._try_prune(session, node.child, node.condition, candidates,
                                         applied, ctx)
                if pruned is not None:
                    return Filter(node.condition, pruned)
            return node

        new_plan = plan.transform_up(rewrite)
        if applied:
            log_index_usage(session, ctx, sorted(set(applied)), new_plan.tree_string(),
                            "Data skipping index applied.")
            ctx.applied.extend(sorted(set(applied)))
        return new_plan

    def _try_prune(self, session, scan: Scan, condition: E.Expr,
                   candidates: List[IndexLogEntry], applied: List[str],
                   ctx) -> Optional[Scan]:
        relation = get_relation(session, scan)
        if relation is None:
            return None
        all_files = relation.all_files()
        keep = np.ones(len(all_files), dtype=bool)
        hit_names: List[str] = []
        for entry in candidates:
            sig = _plan_signature(entry, scan)
            if sig is None or sig != entry.signature.signatures[0].value:
                ctx.add("SOURCE_DATA_CHANGED", entry,
                        "Source fingerprint mismatch; refresh the data-skipping index.")
                continue
            verdict = evaluate_sketch_predicate(entry, condition, all_files,
                                                relation.schema)
            if verdict is None:
                sketched = sorted({s.column for s in entry.derivedDataset.sketches})
                ctx.add("NO_APPLICABLE_SKETCH", entry,
                        f"No filter conjunct is refutable by the index's sketches "
                        f"(sketched columns: {sketched}); only literal comparisons "
                        f"and IN lists on a sketched column can prune.")
                continue
            keep &= verdict
            hit_names.append(entry.name)
        if not hit_names or keep.all():
            return None  # nothing pruned: no rewrite, no usage.
        applied.extend(hit_names)
        kept_files = [f for f, k in zip(all_files, keep) if k]
        # The note makes the pruning visible in explain: without it a
        # skipped scan prints identically to the full scan.
        return Scan(relation.with_files(kept_files),
                    skipping_note=f"{len(kept_files)}/{len(all_files)} files after skipping")


def evaluate_sketch_predicate(entry: IndexLogEntry, condition: E.Expr,
                              all_files: Sequence[str],
                              relation_schema) -> Optional[np.ndarray]:
    """Per-file keep mask from the entry's sketch table, or None when the
    predicate has no evaluable conjunct."""
    table = _load_sketch_table(entry)
    by_file = {name: i for i, name in enumerate(table["_file"])}
    n_sketch = len(table["_file"])

    sketch_by_col = {}
    for s in entry.derivedDataset.sketches:
        sketch_by_col.setdefault(s.column, []).append(s)

    mask_rows: Optional[np.ndarray] = None
    for conjunct in E.split_conjunctive_predicates(condition):
        verdict = _eval_node(conjunct, table, sketch_by_col, relation_schema, n_sketch)
        if verdict is not None:
            mask_rows = verdict if mask_rows is None else (mask_rows & verdict)
    if mask_rows is None:
        return None

    # Map sketch-row verdicts onto the scan's file list; files without a
    # sketch row (none on a signature match) are kept.
    out = np.ones(len(all_files), dtype=bool)
    for i, f in enumerate(all_files):
        j = by_file.get(f)
        if j is not None:
            out[i] = bool(mask_rows[j])
    return out


def _eval_node(e: E.Expr, table, sketch_by_col, relation_schema,
               n: int) -> Optional[np.ndarray]:
    """Keep mask over sketch rows for one predicate node; None = unknown."""
    if isinstance(e, (E.And, E.Or)):
        left = _eval_node(e.left, table, sketch_by_col, relation_schema, n)
        right = _eval_node(e.right, table, sketch_by_col, relation_schema, n)
        if isinstance(e, E.And):
            if left is None:
                return right
            if right is None:
                return left
            return left & right
        if left is None or right is None:
            return None  # one side unprunable: the OR can't prune.
        return left | right
    if isinstance(e, E.In) and isinstance(e.value, E.Col) \
            and all(isinstance(o, E.Lit) for o in e.options):
        verdicts = [_eval_compare(e.value.column, "EqualTo", o.value, table,
                                  sketch_by_col, relation_schema, n)
                    for o in e.options]
        if not verdicts or any(v is None for v in verdicts):
            return None
        out = verdicts[0]
        for v in verdicts[1:]:
            out = out | v
        return out
    if isinstance(e, (E.EqualTo, E.LessThan, E.LessThanOrEqual,
                      E.GreaterThan, E.GreaterThanOrEqual)):
        left, right, op = e.left, e.right, type(e).__name__
        if isinstance(left, E.Lit) and isinstance(right, E.Col):
            left, right, op = right, left, _FLIP[op]
        if not (isinstance(left, E.Col) and isinstance(right, E.Lit)):
            return None
        return _eval_compare(left.column, op, right.value, table,
                             sketch_by_col, relation_schema, n)
    return None


def _eval_compare(column: str, op: str, value, table, sketch_by_col,
                  relation_schema, n: int) -> Optional[np.ndarray]:
    from ..actions.create_skipping import bloom_col, minmax_cols, valuelist_col

    sketches: List[Sketch] = sketch_by_col.get(column, [])
    if not sketches:
        return None
    out: Optional[np.ndarray] = None

    def apply_mask(m: np.ndarray):
        nonlocal out
        out = m if out is None else (out & m)

    # Probe-ready arrays (bitset matrices, converted min/max columns) are
    # assembled once per sketch table and cached inside it.
    prep_cache = table.setdefault("__prepared__", {})

    for s in sketches:
        if s.kind == "MinMax":
            lo_name, hi_name = minmax_cols(column)
            lo, hi = table[lo_name], table[hi_name]
            dtype = relation_schema.field(column).dtype
            pr = prep_cache.get((column, "MinMax"))
            if pr is None:
                pr = native.prepare_minmax(lo, hi, dtype)
                prep_cache[(column, "MinMax")] = pr if pr is not None else "unsupported"
            if pr not in (None, "unsupported"):
                m = native.minmax_prune_prepared(pr, op, value, dtype)
            else:
                # Strings: the generic per-file comparison.
                m = np.ones(n, dtype=bool)
                for i in range(n):
                    if lo[i] is None or hi[i] is None:
                        continue  # all-null file: only IS NULL matches; keep.
                    if op == "EqualTo":
                        m[i] = lo[i] <= value <= hi[i]
                    elif op == "LessThan":
                        m[i] = lo[i] < value
                    elif op == "LessThanOrEqual":
                        m[i] = lo[i] <= value
                    elif op == "GreaterThan":
                        m[i] = hi[i] > value
                    elif op == "GreaterThanOrEqual":
                        m[i] = hi[i] >= value
            apply_mask(m)
        elif s.kind == "ValueList" and op == "EqualTo":
            m = np.ones(n, dtype=bool)
            for i, vals in enumerate(table[valuelist_col(column)]):
                if vals is not None:  # None: over-cardinality file, keep.
                    m[i] = value in vals  # exact membership.
            apply_mask(m)
        elif s.kind == "BloomFilter" and op == "EqualTo":
            dtype = relation_schema.field(column).dtype
            num_bits = int(s.properties["numBits"])
            num_hashes = int(s.properties["numHashes"])
            pr = prep_cache.get((column, "BloomFilter"))
            if pr is None:
                pr = native.prepare_bloom(table[bloom_col(column)], num_bits)
                prep_cache[(column, "BloomFilter")] = pr
                # The raw bitsets are never read again: drop them so the
                # cached table does not hold the bloom bytes twice.
                table[bloom_col(column)] = None
            apply_mask(native.bloom_probe_prepared(
                pr[0], pr[1], value, dtype, num_bits, num_hashes))
    return out


# Small cache of sketch tables, keyed by the sketch file of an entry
# version: tables are small and would be reread per query otherwise.
_SKETCH_CACHE: dict = {}


def _load_sketch_table(entry: IndexLogEntry) -> dict:
    from ..actions.create_skipping import SKETCH_FILE_NAME

    path = [f for f in entry.content.files if os.path.basename(f) == SKETCH_FILE_NAME][0]
    key = (entry.name, entry.id, path)
    cached = _SKETCH_CACHE.get(key)
    if cached is not None:
        return cached
    # partitioning=None: the file lives under a "v__=<n>" directory, from
    # which pyarrow would otherwise infer a "v__" column.
    from ..index import data_store
    fs, norm = data_store.fs_and_path(path)
    t = pq.read_table(norm, filesystem=fs, partitioning=None)
    table = {name: t.column(name).to_pylist() for name in t.column_names}
    if len(_SKETCH_CACHE) >= 8:  # keep at most a handful of tables alive.
        _SKETCH_CACHE.pop(next(iter(_SKETCH_CACHE)))
    _SKETCH_CACHE[key] = table
    return table
