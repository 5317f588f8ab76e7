"""Frozen registry of fusion-region boundary kinds (counterpart of
``hyperspace_tpu/execution/fusion_boundaries.py``; the same 22 strings).

Every place the fusion planner or runner (execution/fusion.py) draws a
region boundary or abandons a fused execution names why with one of
these constants, and ``tests/test_torch_fusion.py`` holds the vocabulary.

Two families share the registry:

- *Barriers*: plan shapes the region does not absorb; the region stops
  there and the barrier subtree executes staged (its own subchains may
  fuse on their own).
- *Fallbacks*: runtime discoveries (duplicate probe keys, bucket-ordered
  streams, chunked sources, a failed region body) that abandon an
  otherwise fusible region; the staged executor runs it instead, with the
  same answer.

The kinds key ``fusion.stats()["fallbacks"]``.
"""

from __future__ import annotations

# ---- barriers: plan shapes that end a region ------------------------------

# The region bottomed out at a source leaf (Scan/IndexScan): the normal,
# successful boundary, counted so stats tell it from bailouts.
LEAF = "leaf"

SORT = "sort"
WINDOW = "window"
LIMIT = "limit"
UNION = "union"
AGGREGATE = "aggregate"          # a nested (non-root) Aggregate subtree
OUTER_JOIN = "outer-join"
CROSS_JOIN = "cross-join"
NON_EQUI_JOIN = "non-equi-join"
MULTI_KEY_JOIN = "multi-key-join"
COUNT_DISTINCT = "count-distinct"
UNSUPPORTED_AGG = "unsupported-agg"
UNSUPPORTED_EXPR = "unsupported-expr"

# ---- fallbacks: runtime bailouts on an otherwise fusible region -----------

DISABLED = "disabled"            # hyperspace.tpu.execution.fusion.enabled=false
SWEEP = "sweep"                  # literal-sweep batches own the staged path
REGION_TOO_SMALL = "region-too-small"
CHUNKED_SOURCE = "chunked-source"
BUCKET_ORDER = "bucket-order"    # stream carries covering-index layout
DUPLICATE_PROBE_KEYS = "duplicate-probe-keys"
KEY_DTYPE = "key-dtype"
EMPTY_INPUT = "empty-input"
FUSED_PROGRAM_ERROR = "fused-program-error"

BOUNDARY_KINDS = frozenset({
    LEAF, SORT, WINDOW, LIMIT, UNION, AGGREGATE, OUTER_JOIN, CROSS_JOIN,
    NON_EQUI_JOIN, MULTI_KEY_JOIN, COUNT_DISTINCT, UNSUPPORTED_AGG,
    UNSUPPORTED_EXPR, DISABLED, SWEEP, REGION_TOO_SMALL, CHUNKED_SOURCE,
    BUCKET_ORDER, DUPLICATE_PROBE_KEYS, KEY_DTYPE, EMPTY_INPUT,
    FUSED_PROGRAM_ERROR,
})
