"""The hyperspace rewrite batch (counterpart of
``hyperspace_tpu/rules/apply_hyperspace.py``). The JAX package's legacy
ordered batch reduced to the filter rule, then the data-skipping rule on
the Scan leaves the filter rule left in place; the join, group-by and
score-based rules are not ported yet.
"""

from __future__ import annotations

from ..plan.nodes import LogicalPlan
from .data_skipping_rule import DataSkippingIndexRule
from .filter_rule import FilterIndexRule


def apply_hyperspace(session, plan: LogicalPlan) -> LogicalPlan:
    plan = FilterIndexRule().apply(session, plan)
    # Data skipping last: the covering rewrite is the better win when it
    # applies, and skipping only narrows the Scan leaves left in place.
    return DataSkippingIndexRule().apply(session, plan)
