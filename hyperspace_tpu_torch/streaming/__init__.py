"""The streaming ingestion tier (counterpart of ``hyperspace_tpu/streaming/``).

- append/commit (ingest.py): ``Hyperspace.append(table, batch)`` stages a
  record batch out of every scan's sight and prebuilds its index deltas on
  the device; ``commit()`` publishes the batch files and the deltas
  atomically through the op-log protocol, so covering indexes and sketches
  are fresh at commit with no refresh pass.
- compaction (compaction.py): ``compact()`` folds superseded op-log
  entries into one checkpoint entry and vacuums unreferenced data versions.
- standing queries (subscriptions.py): ``ServingFrontend.subscribe`` keeps
  a plan that fires again through the serving workers on every commit.
- continuous sources (sources.py): daemons tailing a drop directory or a
  JSONL log into append/commit.
"""

from .constants import StreamingConstants  # noqa: F401
