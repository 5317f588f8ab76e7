"""The advisor's conf keys and metadata property names (counterpart of
``hyperspace_tpu/advisor/constants.py``). The keys live under
``hyperspace.tpu.advisor.*`` and are read through config.py; the bound on
the candidates evaluated is a fixed module constant."""

from __future__ import annotations


class AdvisorConstants:
    # Workload capture: every Session.execute records a WorkloadRecord
    # (fingerprint, shapes, latency, applied indexes) in the session's log.
    CAPTURE_ENABLED = "hyperspace.tpu.advisor.capture.enabled"
    CAPTURE_ENABLED_DEFAULT = "false"

    # Bound on the session's workload log; the oldest records drop first.
    CAPTURE_MAX_ENTRIES = "hyperspace.tpu.advisor.capture.maxEntries"
    CAPTURE_MAX_ENTRIES_DEFAULT = "10000"

    # Captured queries that must show a shape before a candidate derived
    # from it is considered.
    MIN_SUPPORT = "hyperspace.tpu.advisor.minSupport"
    MIN_SUPPORT_DEFAULT = "1"

    # derivedDataset property marking a metadata-only what-if entry.
    HYPOTHETICAL_PROPERTY = "advisor.hypothetical"

    # The synthetic content file carrying a hypothetical entry's predicted
    # size, so the rankers' index-size comparisons see the prediction.
    HYPOTHETICAL_FILE_NAME = "__advisor_hypothetical__"

    # Candidate names start with this.
    CANDIDATE_NAME_PREFIX = "adv"


# Bound on the candidate groups the recommender evaluates with the what-if
# planner (highest support first).
MAX_CANDIDATES = 32
