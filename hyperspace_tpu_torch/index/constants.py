"""Action states, config keys and on-disk layout names (counterpart of
``hyperspace_tpu/index/constants.py``, trimmed to what this package reads).

The key strings are the JAX package's, so one conf dict drives both.
"""

from __future__ import annotations


class States:
    """Index lifecycle states."""

    ACTIVE = "ACTIVE"
    CREATING = "CREATING"
    DELETING = "DELETING"
    DELETED = "DELETED"
    REFRESHING = "REFRESHING"
    VACUUMING = "VACUUMING"
    RESTORING = "RESTORING"
    OPTIMIZING = "OPTIMIZING"
    DOESNOTEXIST = "DOESNOTEXIST"
    CANCELLING = "CANCELLING"


STABLE_STATES = frozenset({States.ACTIVE, States.DELETED, States.DOESNOTEXIST})


class IndexConstants:
    """Config keys + defaults."""

    # Root ("system") path under which all indexes live.
    INDEX_SYSTEM_PATH = "hyperspace.system.path"

    INDEX_NUM_BUCKETS = "hyperspace.index.numBuckets"
    INDEX_NUM_BUCKETS_DEFAULT = 200

    INDEX_HYBRID_SCAN_ENABLED = "hyperspace.index.hybridscan.enabled"
    INDEX_HYBRID_SCAN_ENABLED_DEFAULT = "false"

    INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD = "hyperspace.index.hybridscan.maxDeletedRatio"
    INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD_DEFAULT = "0.2"

    INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD = "hyperspace.index.hybridscan.maxAppendedRatio"
    INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD_DEFAULT = "0.3"

    INDEX_FILTER_RULE_USE_BUCKET_SPEC = "hyperspace.index.filterRule.useBucketSpec"
    INDEX_FILTER_RULE_USE_BUCKET_SPEC_DEFAULT = "false"

    # Seconds the session's index list stays cached (index/cache.py); any
    # index mutation through the session clears it at once.
    INDEX_CACHE_EXPIRY_DURATION_SECONDS = "hyperspace.index.cache.expiryDurationInSeconds"
    INDEX_CACHE_EXPIRY_DURATION_SECONDS_DEFAULT = "300"

    # Operation log layout.
    HYPERSPACE_LOG = "_hyperspace_log"
    LATEST_STABLE_LOG_NAME = "latestStable"
    INDEX_VERSION_DIRECTORY_PREFIX = "v__"

    # Lineage: a column of source-file ids in every index row, which lets
    # a refresh or Hybrid Scan drop the rows of deleted source files.
    DATA_FILE_NAME_ID = "_data_file_id"
    INDEX_LINEAGE_ENABLED = "hyperspace.index.lineage.enabled"
    INDEX_LINEAGE_ENABLED_DEFAULT = "false"

    REFRESH_MODE_INCREMENTAL = "incremental"
    REFRESH_MODE_FULL = "full"
    REFRESH_MODE_QUICK = "quick"
    REFRESH_MODES = (REFRESH_MODE_INCREMENTAL, REFRESH_MODE_FULL, REFRESH_MODE_QUICK)

    OPTIMIZE_FILE_SIZE_THRESHOLD = "hyperspace.index.optimize.fileSizeThreshold"
    OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT = 256 * 1024 * 1024
    OPTIMIZE_MODE_QUICK = "quick"
    OPTIMIZE_MODE_FULL = "full"
    OPTIMIZE_MODES = (OPTIMIZE_MODE_QUICK, OPTIMIZE_MODE_FULL)

    UNKNOWN_FILE_ID = -1

    # JSON property names used in index metadata.
    LINEAGE_PROPERTY = "lineage"
    HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY = "hasParquetAsSourceFormat"
    HYPERSPACE_VERSION_PROPERTY = "hyperspaceVersion"
    INDEX_LOG_VERSION = "indexLogVersion"

    CASE_SENSITIVE = "hyperspace.caseSensitive"
    CASE_SENSITIVE_DEFAULT = "false"

    # The event sink's class name (telemetry/logging.py); unset is a no-op.
    EVENT_LOGGER_CLASS = "hyperspace.eventLoggerClass"

    # Parquet row-group size for index files: smaller groups give finer
    # row-group pruning on the sorted indexed columns.
    INDEX_ROW_GROUP_SIZE = "hyperspace.index.rowGroupSize"
    INDEX_ROW_GROUP_SIZE_DEFAULT = 65536

    # Device-footprint budget in rows: a build, a filtered scan or a
    # filtered index scan over more rows streams its input in chunks of at
    # most this many (ops/index_build.py, execution/executor.py).
    TPU_MAX_CHUNK_ROWS = "hyperspace.tpu.maxChunkRows"
    TPU_MAX_CHUNK_ROWS_DEFAULT = str(8 * 1024 * 1024)
    # The mesh tier (execution/spmd.py, parallel/): with more than one
    # device in the mesh, eligible queries run as one per-device program
    # over it and index builds exchange buckets over it. singleDevice
    # "auto" takes the one-device dispatch on a CUDA session and skips it on
    # the CPU; "on"/"off" force. maxDevices caps the mesh (0 = every visible
    # device); minStreamRows keeps smaller leaves single-device (0 disables
    # the gate). A multi-file parquet leaf always shards on file
    # boundaries (the reference's fileAlignedScan default).
    TPU_DISTRIBUTED_ENABLED = "hyperspace.tpu.distributed.enabled"
    TPU_DISTRIBUTED_ENABLED_DEFAULT = "true"
    TPU_DISTRIBUTED_SINGLE_DEVICE = "hyperspace.tpu.distributed.singleDevice"
    TPU_DISTRIBUTED_SINGLE_DEVICE_DEFAULT = "auto"
    TPU_DISTRIBUTED_MESH_MAX_DEVICES = "hyperspace.tpu.distributed.mesh.maxDevices"
    TPU_DISTRIBUTED_MESH_MAX_DEVICES_DEFAULT = "0"
    TPU_DISTRIBUTED_MIN_STREAM_ROWS = "hyperspace.tpu.distributed.minStreamRows"
    TPU_DISTRIBUTED_MIN_STREAM_ROWS_DEFAULT = "4096"
    # Length classes (shapes.py): a length pads to the first
    # rung at or above it of the geometric ladder from minPadElements by
    # growthFactor, unless bucketing is off, or the array holds at least
    # exactFallbackRows rows and the rung would pad it by more than
    # maxWasteRatio of its size. Eager torch compiles nothing per length;
    # the classes are where answers depend on them: the mesh's shard
    # boundaries and the sentinels a MinMax sketch of a short column sees.
    TPU_SHAPE_BUCKETING_ENABLED = "hyperspace.tpu.execution.shapeBucketing.enabled"
    TPU_SHAPE_BUCKETING_ENABLED_DEFAULT = "true"
    TPU_SHAPE_BUCKETING_GROWTH_FACTOR = "hyperspace.tpu.execution.shapeBucketing.growthFactor"
    TPU_SHAPE_BUCKETING_GROWTH_FACTOR_DEFAULT = "2.0"
    TPU_SHAPE_BUCKETING_MIN_PAD = "hyperspace.tpu.execution.shapeBucketing.minPadElements"
    TPU_SHAPE_BUCKETING_MIN_PAD_DEFAULT = "1024"
    TPU_SHAPE_BUCKETING_MAX_WASTE_RATIO = "hyperspace.tpu.execution.shapeBucketing.maxWasteRatio"
    TPU_SHAPE_BUCKETING_MAX_WASTE_RATIO_DEFAULT = "0.25"
    TPU_SHAPE_BUCKETING_EXACT_FALLBACK_ROWS = \
        "hyperspace.tpu.execution.shapeBucketing.exactFallbackRows"
    TPU_SHAPE_BUCKETING_EXACT_FALLBACK_ROWS_DEFAULT = str(4 * 1024 * 1024)

    # Whole-plan fusion (execution/fusion.py): a maximal {Filter, Project,
    # inner/semi/anti Join}* chain of at least two nodes, under an optional
    # Aggregate, runs as one region over a keep mask instead of stage by
    # stage. Off gives the staged executor, with the same answers but for
    # a global aggregate over no kept rows (NULL fused, as in the JAX
    # package's default).
    TPU_FUSION_ENABLED = "hyperspace.tpu.execution.fusion.enabled"
    TPU_FUSION_ENABLED_DEFAULT = "true"

    # When set, every plan execution runs under torch.profiler and writes
    # its chrome trace (CPU and CUDA timeline) into this directory, one
    # file per execution (telemetry/trace.profile_into).
    TPU_TRACE_DIR = "hyperspace.tpu.trace.dir"

    # Parallel I/O (parallel/io.py): the process-wide bounded reader pool
    # and the producer/consumer prefetch pipelines behind multi-file reads,
    # chunk streams, sketch builds and the spill merge. Results keep the
    # sequential order at any thread count. threads=0 means auto
    # (min(16, cpu count)); threads=1 reads sequentially.
    TPU_IO_ENABLED = "hyperspace.tpu.io.enabled"
    TPU_IO_ENABLED_DEFAULT = "true"
    TPU_IO_THREADS = "hyperspace.tpu.io.threads"
    TPU_IO_THREADS_DEFAULT = "0"
    TPU_IO_PREFETCH_DEPTH = "hyperspace.tpu.io.prefetchDepth"
    TPU_IO_PREFETCH_DEPTH_DEFAULT = "2"
    TPU_IO_MAX_INFLIGHT_BYTES = "hyperspace.tpu.io.maxInflightBytes"
    TPU_IO_MAX_INFLIGHT_BYTES_DEFAULT = str(256 * 1024 * 1024)

    # Tiered buffer pool (execution/buffer_pool.py): the process-wide
    # device -> host cache of decoded scans and index tables, shared across
    # queries and sessions. streamAdmitBytes caps the chunk streams the
    # pool keeps for replay.
    TPU_BUFFER_POOL_ENABLED = "hyperspace.tpu.execution.bufferPool.enabled"
    TPU_BUFFER_POOL_ENABLED_DEFAULT = "true"
    TPU_BUFFER_POOL_DEVICE_BYTES = "hyperspace.tpu.execution.bufferPool.deviceBytes"
    TPU_BUFFER_POOL_DEVICE_BYTES_DEFAULT = str(4 * 1024 * 1024 * 1024)
    TPU_BUFFER_POOL_HOST_BYTES = "hyperspace.tpu.execution.bufferPool.hostBytes"
    TPU_BUFFER_POOL_HOST_BYTES_DEFAULT = str(4 * 1024 * 1024 * 1024)
    TPU_BUFFER_POOL_STREAM_ADMIT_BYTES = "hyperspace.tpu.execution.bufferPool.streamAdmitBytes"
    TPU_BUFFER_POOL_STREAM_ADMIT_BYTES_DEFAULT = str(256 * 1024 * 1024)
