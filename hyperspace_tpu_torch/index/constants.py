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
    VACUUMING = "VACUUMING"
    DOESNOTEXIST = "DOESNOTEXIST"


STABLE_STATES = frozenset({States.ACTIVE, States.DELETED, States.DOESNOTEXIST})


class IndexConstants:
    """Config keys + defaults."""

    # Root ("system") path under which all indexes live.
    INDEX_SYSTEM_PATH = "hyperspace.system.path"

    INDEX_NUM_BUCKETS = "hyperspace.index.numBuckets"
    INDEX_NUM_BUCKETS_DEFAULT = 200

    INDEX_FILTER_RULE_USE_BUCKET_SPEC = "hyperspace.index.filterRule.useBucketSpec"
    INDEX_FILTER_RULE_USE_BUCKET_SPEC_DEFAULT = "false"

    # Operation log layout.
    HYPERSPACE_LOG = "_hyperspace_log"
    LATEST_STABLE_LOG_NAME = "latestStable"
    INDEX_VERSION_DIRECTORY_PREFIX = "v__"

    UNKNOWN_FILE_ID = -1

    # JSON property names used in index metadata.
    HAS_PARQUET_AS_SOURCE_FORMAT_PROPERTY = "hasParquetAsSourceFormat"
    HYPERSPACE_VERSION_PROPERTY = "hyperspaceVersion"
    INDEX_LOG_VERSION = "indexLogVersion"

    CASE_SENSITIVE = "hyperspace.caseSensitive"
    CASE_SENSITIVE_DEFAULT = "false"

    # Parquet row-group size for index files: smaller groups give finer
    # row-group pruning on the sorted indexed columns.
    INDEX_ROW_GROUP_SIZE = "hyperspace.index.rowGroupSize"
    INDEX_ROW_GROUP_SIZE_DEFAULT = 65536

    # Device-footprint budget. The JAX package streams a build above it
    # (its chunked build); this package has no chunked build yet and
    # refuses such a source instead (actions/create.py).
    TPU_MAX_CHUNK_ROWS = "hyperspace.tpu.maxChunkRows"
    TPU_MAX_CHUNK_ROWS_DEFAULT = str(8 * 1024 * 1024)
