"""The cost-based optimizer's conf key and sizes (counterpart of
``hyperspace_tpu/optimizer/constants.py``): the statistics provider and
the join-reorder pass."""

from __future__ import annotations


class OptimizerConstants:
    # Reorder chains of inner equi-joins to the cheapest estimated linear
    # order before the index rules run (a trailing Project restores the
    # output column order).
    JOIN_REORDER_ENABLED = "hyperspace.tpu.optimizer.joinReorder.enabled"
    JOIN_REORDER_ENABLED_DEFAULT = "false"


# Rows of the first file sampled for the NDV of a column whose min/max
# span bounds nothing (strings, floats).
STATS_SAMPLE_ROWS = 65536

# Relations whose statistics stay cached (LRU).
STATS_CACHE_ENTRIES = 64

# Chains of at most this many tables are searched exhaustively (left-deep
# dynamic programming over connected subsets); longer ones greedily.
JOIN_REORDER_DP_THRESHOLD = 8
