"""The stream leaf of a one-pass chain body, shared by the mesh tier's
program (execution/spmd.py) and the fused region (execution/fusion.py).

Both bodies stream one Scan or IndexScan leaf through a chain of filters,
projects and join probes over a keep mask. They read the leaf the same
way (whole, within ``maxChunkRows``, with the filters right above it
pushed into the read) and learn their output metadata the same way (by
evaluating the chain over zero-length columns).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..plan import expr as E
from ..plan.nodes import IndexScan, Scan
from .columnar import DEVICE_DTYPE, Column, Table


def meta_column(dt: str, dic, nullable: bool) -> Column:
    """A zero-length column carrying a column's metadata (the prep walk
    evaluates expressions over these to learn output dtypes)."""
    return Column(dt, torch.zeros(0, dtype=DEVICE_DTYPE[dt]),
                  torch.zeros(0, dtype=torch.bool) if nullable else None, dic)


def leaf_rows(leaf) -> Optional[int]:
    """The leaf's rows from parquet metadata only, or None when
    unknowable."""
    from .columnar import parquet_row_counts

    if isinstance(leaf, IndexScan):
        try:
            return sum(parquet_row_counts(list(leaf.index_entry.content.files)
                                          + list(leaf.appended_files)))
        except Exception:
            return None
    if not isinstance(leaf, Scan):
        return None
    relation = leaf.relation
    if relation.data_file_format != "parquet":
        return None
    try:
        return sum(parquet_row_counts(relation.all_files()))
    except Exception:
        return None


def within_budget(leaf, session) -> bool:
    """False when the leaf exceeds ``maxChunkRows``: a body materializes
    its leaf, so a bigger one takes the staged chunked path."""
    total = leaf_rows(leaf)
    return total is None or total <= session.hs_conf.max_chunk_rows()


def load_leaf(leaf, stages, needed, session) -> Table:
    """The stream leaf, its read narrowed by the filters directly above it
    (necessary conditions on the raw rows), as the single-device
    Filter-over-leaf does. A narrowed read that keeps nothing falls
    through to the full read, so the stream still runs (an all-false
    mask)."""
    from . import executor as ex
    from .pushdown import pruned_index_read_filter, pushable_filter

    conds = []
    for kind, node in stages:
        if kind != "filter":
            break
        conds.append(node.condition)
    if conds:
        combined = conds[0]
        for c in conds[1:]:
            combined = E.And(combined, c)
        if isinstance(leaf, IndexScan):
            pa_filter = pruned_index_read_filter(leaf.index_entry, combined, leaf.schema)
            if pa_filter is not None:
                table = ex._execute_index_scan(leaf, needed, session.device, pa_filter,
                                               prefer_pruned_read=True)
                if table.num_rows > 0:
                    return table
        else:  # a source's struct leaves are no physical columns.
            pa_filter = pushable_filter(combined, leaf.schema, allow_nested=False)
            if pa_filter is not None:
                table = ex._execute_scan(leaf, needed, session.device, pa_filter)
                if table.num_rows > 0:
                    return table
    return ex._execute(leaf, needed, session)
