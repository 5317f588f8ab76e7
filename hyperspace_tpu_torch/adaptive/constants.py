"""The adaptive control plane's conf keys (counterpart of
``hyperspace_tpu/adaptive/constants.py``, the same keys and defaults, for
the knobs an operator sets). The keys live under
``hyperspace.tpu.adaptive.*`` and are read through config.py. The
feedback store's bounds, the re-plan threshold, the builder's poll
interval and the sample fraction below are fixed module constants:
nothing sets them per session. Feedback and admission have no switches
of their own: the master switch turns them on."""

from __future__ import annotations


class AdaptiveConstants:
    # The master switch. Off (the default), feedback, re-planning, the
    # builder and SLO admission are all inert. On, the join reorderer
    # learns per-join corrections from observed actual rows and applies
    # them to its estimates, and SLO breaches drive serving admission.
    ENABLED = "hyperspace.tpu.adaptive.enabled"
    ENABLED_DEFAULT = "false"

    # Re-plan a query at a join boundary.
    REPLAN_ENABLED = "hyperspace.tpu.adaptive.replan.enabled"
    REPLAN_ENABLED_DEFAULT = "true"

    # The builder: the advisor's top recommendation and streaming
    # maintenance in the serving tier's idle windows.
    BUILDER_ENABLED = "hyperspace.tpu.adaptive.builder.enabled"
    BUILDER_ENABLED_DEFAULT = "true"

    # Index bytes the builder may build over its lifetime.
    BUILDER_MAX_BYTES = "hyperspace.tpu.adaptive.builder.maxBytes"
    BUILDER_MAX_BYTES_DEFAULT = "1073741824"

    # Every live frontend idle (nothing queued, no worker busy) this long
    # before a pass spends its budget.
    BUILDER_IDLE_MS = "hyperspace.tpu.adaptive.builder.idleMs"
    BUILDER_IDLE_MS_DEFAULT = "200"

    # An ACTIVE index retires once this many queries completed since the
    # builder first saw it and its usage count is still zero.
    BUILDER_RETIRE_MIN_QUERIES = "hyperspace.tpu.adaptive.builder.retireMinQueries"
    BUILDER_RETIRE_MIN_QUERIES_DEFAULT = "32"

    # What a breach does to a new submission: "shed" raises
    # ServingRejectedError at submit; "degrade" runs an eligible aggregate
    # over a sampled file subset and states its error bound.
    ADMISSION_MODE = "hyperspace.tpu.adaptive.admission.mode"
    ADMISSION_MODE_DEFAULT = "degrade"


# Bound on each tier of the process-wide correction store (exact join
# keys, table-pair ratios); the oldest entries drop first.
FEEDBACK_MAX_ENTRIES = 4096

# EMA weight of the newest observation once a correction entry exists.
FEEDBACK_ALPHA = 0.5

# A join whose actual rows differ from the estimate by more than this
# factor (either way) stops the query, which re-plans with the fresh
# correction and runs again.
REPLAN_ERROR_THRESHOLD = 8.0

# The poll interval (ms) of the builder's optional daemon loop.
BUILDER_INTERVAL_MS = 1000.0

# The share of each source's files the approximate tier reads (a prefix
# of the sorted listing; at least one file).
ADMISSION_SAMPLE_FRACTION = 0.25
