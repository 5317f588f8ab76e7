"""Config keys of the artifact store (counterpart of
``hyperspace_tpu/artifacts/constants.py``: the same keys, defaults and
clamps).
"""

from __future__ import annotations

# Directory name under the index system path holding the store (it holds
# no _hyperspace_log subdirectory, so the op-log sweeps skip it).
ARTIFACT_DIR_NAME = "_hst_artifacts"

# Blob format version: part of every artifact key and of the version
# directory's name, so a layout change misses every existing blob instead
# of misparsing it.
ARTIFACT_FORMAT_VERSION = 1

# The port's blobs live in a directory of their own kind under the version
# directory (``v1/kernel/``): the JAX package's vacuum removes every
# ``v1/*.hsa`` whose header lacks its runtime fields, so the two packages
# keep their blobs apart while sharing one store root.
KERNEL_KIND = "kernel"


class ArtifactConstants:
    # Master switch. Default OFF: nothing is published or read when false.
    ENABLED = "hyperspace.tpu.artifacts.enabled"
    ENABLED_DEFAULT = "false"

    # Store directory override; empty means
    # ``<index system path>/_hst_artifacts`` (beside the indexes).
    DIR = "hyperspace.tpu.artifacts.dir"
    DIR_DEFAULT = ""

    # Byte budget for resident blobs; publication past the budget evicts
    # least-used blobs first (usage sidecar order).
    MAX_BYTES = "hyperspace.tpu.artifacts.maxBytes"
    MAX_BYTES_DEFAULT = str(1 << 30)

    # Opt-in preload at Session creation (warmup() is always available).
    PRELOAD_ENABLED = "hyperspace.tpu.artifacts.preload.enabled"
    PRELOAD_ENABLED_DEFAULT = "false"

    # Preload budgets: stop loading once either is spent, hottest first.
    PRELOAD_MAX_MS = "hyperspace.tpu.artifacts.preload.maxMs"
    PRELOAD_MAX_MS_DEFAULT = "5000"
    PRELOAD_MAX_BYTES = "hyperspace.tpu.artifacts.preload.maxBytes"
    PRELOAD_MAX_BYTES_DEFAULT = str(256 << 20)

    # Min milliseconds between usage-sidecar flushes.
    USAGE_FLUSH_MS = "hyperspace.tpu.artifacts.usage.flushMs"
    USAGE_FLUSH_MS_DEFAULT = "500"
