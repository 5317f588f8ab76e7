"""The fault-point names (counterpart of
``hyperspace_tpu/robustness/fault_names.py``, the points this package
places). Every ``faults.fault_point(...)`` site names one of these; a
conf key naming any other point is refused.
"""

from __future__ import annotations

# Op-log writes (index/log_manager.py): the conditional entry put and the
# latestStable overwrite.
LOG_WRITE = "log.write"
LOG_STABLE = "log.stable"

# The start of an action's op() body (actions/action.py): a crash here
# leaves the transient log state with partial (or no) index data.
ACTION_OP = "action.op"

# Streaming ingestion (streaming/ingest.py). INGEST_STAGE fires inside
# append() before the staged batch's parquet is written; INGEST_PUBLISH
# inside the commit action's op(), after the transient table-log entry
# landed and before any batch file moves.
INGEST_STAGE = "ingest.stage"
INGEST_PUBLISH = "ingest.publish"

# A continuous source's poll body (streaming/sources.py): an injected
# error costs only that poll.
STREAMING_SOURCE = "streaming.source"

FAULT_NAMES = frozenset({
    LOG_WRITE, LOG_STABLE, ACTION_OP,
    INGEST_STAGE, INGEST_PUBLISH, STREAMING_SOURCE,
})
