"""Streaming-ingestion tier constants: conf keys and on-disk layout
(a copy of ``hyperspace_tpu/streaming/constants.py``: the same keys and
defaults, so one conf dict drives both packages).

The ``hyperspace.tpu.streaming.*`` family configures the append/commit
path (streaming/ingest.py), op-log compaction (streaming/compaction.py)
and standing queries (streaming/subscriptions.py).
"""

from __future__ import annotations


class StreamingConstants:
    # Master switch for the append/commit API. Off, ``Hyperspace.append``
    # raises — the lake stays read-mostly exactly as before this tier.
    ENABLED = "hyperspace.tpu.streaming.enabled"
    ENABLED_DEFAULT = "true"

    # Backpressure: the most batches one table may stage before a
    # commit() must land them (append raises past it).
    MAX_STAGED_BATCHES = "hyperspace.tpu.streaming.maxStagedBatches"
    MAX_STAGED_BATCHES_DEFAULT = "64"

    # Load-time indexing: sketch + bucket-route every staged batch
    # on-device at append() time so covering indexes and skipping
    # sketches are fresh at commit with no separate refresh pass. Off,
    # commit() lands only the source files (hybrid scan still merges
    # them at query time; a later refresh_index catches the indexes up).
    LOAD_TIME_INDEXING = "hyperspace.tpu.streaming.loadTimeIndexing.enabled"
    LOAD_TIME_INDEXING_DEFAULT = "true"

    # compact() folds a log only when it holds at least this many
    # superseded (non-tip) entries — folding a near-empty log buys
    # nothing and costs a checkpoint write.
    COMPACTION_MIN_ENTRIES = "hyperspace.tpu.streaming.compaction.minEntries"
    COMPACTION_MIN_ENTRIES_DEFAULT = "2"

    # Group commit (streaming/ingest.CommitCoordinator): concurrent
    # commit() callers coalesce into one publication wave — one op-log
    # entry per table and one delta build per index per wave. Off,
    # every commit() publishes its own staged batches exactly as before
    # this tier (byte-identical results, just more op-log entries).
    GROUP_COMMIT_ENABLED = "hyperspace.tpu.streaming.groupCommit.enabled"
    GROUP_COMMIT_ENABLED_DEFAULT = "true"
    # Linger before the wave leader pops the queue, letting more appends
    # and committers pile into the same wave. 0 = publish immediately.
    GROUP_COMMIT_WINDOW_MS = "hyperspace.tpu.streaming.groupCommit.windowMs"
    GROUP_COMMIT_WINDOW_MS_DEFAULT = "0"
    # Most staged batches one publication wave may carry; a deeper queue
    # is drained as consecutive sub-waves so undo/redo stays bounded.
    GROUP_COMMIT_MAX_WAVE = "hyperspace.tpu.streaming.groupCommit.maxWave"
    GROUP_COMMIT_MAX_WAVE_DEFAULT = "256"

    # Continuous sources (streaming/sources.py): poll cadence for the
    # directory/log tailers and how many appends they buffer before
    # driving a commit themselves.
    SOURCE_POLL_MS = "hyperspace.tpu.streaming.source.pollMs"
    SOURCE_POLL_MS_DEFAULT = "50"
    SOURCE_COMMIT_BATCHES = "hyperspace.tpu.streaming.source.commitBatches"
    SOURCE_COMMIT_BATCHES_DEFAULT = "8"

    # Blocking backpressure: how long a blocking append (continuous
    # sources; CommitQueue.push(block=True)) waits for staged-batch
    # budget before giving up. The plain append() API keeps its
    # raise-on-full default and never waits.
    BACKPRESSURE_TIMEOUT_MS = \
        "hyperspace.tpu.streaming.backpressure.timeoutMs"
    BACKPRESSURE_TIMEOUT_MS_DEFAULT = "30000"

    # Standing-query subscriptions (serving/frontend.subscribe).
    SUBSCRIPTIONS_MAX = "hyperspace.tpu.streaming.subscriptions.max"
    SUBSCRIPTIONS_MAX_DEFAULT = "64"
    SUBSCRIPTION_HISTORY = \
        "hyperspace.tpu.streaming.subscriptions.historyDepth"
    SUBSCRIPTION_HISTORY_DEFAULT = "16"

    # On-disk layout. Staging dirs start with '_' so the data-path filter
    # (util/file_utils._is_hidden) keeps staged batches invisible to
    # every scan until commit() publishes them.
    STAGING_DIR = "_hst_staging"
    # Published batch files: part-ingest-<batch id>.parquet in the table
    # dir (recovery matches the prefix when rolling a torn commit back).
    INGEST_FILE_PREFIX = "part-ingest-"
    # Per-table streaming op-logs live under
    # <systemPath>/_streaming/<table key>/_hyperspace_log — the leading
    # '_' keeps recover_indexes' index sweep from treating the parent as
    # an index; streaming recovery sweeps it explicitly.
    STREAMING_DIR = "_streaming"

    # Checkpoint-entry properties written by compact().
    COMPACTION_GENERATION_PROPERTY = "compactionGeneration"
    COMPACTED_THROUGH_PROPERTY = "compactedThrough"
