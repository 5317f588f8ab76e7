"""The hyperspace rewrite batch (counterpart of
``hyperspace_tpu/rules/apply_hyperspace.py``). The JAX package's legacy
ordered batch (join rule, then filter rule) reduced to the filter rule;
the join, group-by, data-skipping and score-based rules are not ported
yet.
"""

from __future__ import annotations

from ..plan.nodes import LogicalPlan
from .filter_rule import FilterIndexRule


def apply_hyperspace(session, plan: LogicalPlan) -> LogicalPlan:
    return FilterIndexRule().apply(session, plan)
