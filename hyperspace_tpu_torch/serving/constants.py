"""Serving-tier conf keys and their defaults (counterpart of
``hyperspace_tpu/serving/constants.py``).

The key strings are the JAX package's, so one conf dict drives both. They
are read through ``config.HyperspaceConf`` only. The JAX package also falls
back to ``HST_RESULT_CACHE*`` environment variables when a key is unset;
this package reads the conf alone.
"""

from __future__ import annotations


class ServingConstants:
    # The result cache is off by default: it changes no answer, but trades
    # memory for latency.
    RESULT_CACHE_ENABLED = "serving.result_cache.enabled"
    RESULT_CACHE_ENABLED_DEFAULT = "false"

    # Byte budget of the device tier (results kept on the session's device).
    RESULT_CACHE_DEVICE_BYTES = "serving.result_cache.deviceBytes"
    RESULT_CACHE_DEVICE_BYTES_DEFAULT = str(256 * 1024 * 1024)

    # Byte budget of the host tier, which device-tier victims demote to.
    RESULT_CACHE_HOST_BYTES = "serving.result_cache.hostBytes"
    RESULT_CACHE_HOST_BYTES_DEFAULT = str(1024 * 1024 * 1024)

    # Admission: a result is kept only if its execution took at least
    # minComputeSeconds and its inputs hold at least minInputBytes.
    RESULT_CACHE_MIN_COMPUTE_SECONDS = "serving.result_cache.minComputeSeconds"
    RESULT_CACHE_MIN_COMPUTE_SECONDS_DEFAULT = "0.005"
    RESULT_CACHE_MIN_INPUT_BYTES = "serving.result_cache.minInputBytes"
    RESULT_CACHE_MIN_INPUT_BYTES_DEFAULT = "0"

    # Optional spill tier: host-tier victims are written under spillDir
    # (empty = no spill tier) up to spillBytes. A truncated or corrupt
    # spill file reads back as a miss.
    RESULT_CACHE_SPILL_DIR = "serving.result_cache.spillDir"
    RESULT_CACHE_SPILL_DIR_DEFAULT = ""
    RESULT_CACHE_SPILL_BYTES = "serving.result_cache.spillBytes"
    RESULT_CACHE_SPILL_BYTES_DEFAULT = str(4 * 1024 * 1024 * 1024)

    # SQL text -> plan memo, active while the result cache is; 0 disables.
    RESULT_CACHE_PLAN_CACHE_SIZE = "serving.result_cache.planCacheSize"
    RESULT_CACHE_PLAN_CACHE_SIZE_DEFAULT = "64"

    # The concurrent frontend (serving/frontend.py). ``enabled`` gates only
    # the process-default accessor (Hyperspace.serving_frontend); building
    # a ServingFrontend directly is the opt-in.
    SERVING_ENABLED = "hyperspace.tpu.serving.enabled"
    SERVING_ENABLED_DEFAULT = "false"

    # Queries executing at once (worker threads).
    SERVING_MAX_CONCURRENCY = "hyperspace.tpu.serving.maxConcurrency"
    SERVING_MAX_CONCURRENCY_DEFAULT = "4"

    # Waiting queries beyond this many are rejected.
    SERVING_QUEUE_DEPTH = "hyperspace.tpu.serving.queueDepth"
    SERVING_QUEUE_DEPTH_DEFAULT = "64"

    # Summed input-byte estimates of queued and running queries; a
    # submission past it is rejected unless nothing is in flight.
    SERVING_ADMISSION_MAX_BYTES = "hyperspace.tpu.serving.admission.maxBytes"
    SERVING_ADMISSION_MAX_BYTES_DEFAULT = str(4 * 1024 * 1024 * 1024)

    # Literal sweeps (serving/batcher.py): queries whose plans differ only
    # in Filter literals run as one batch. ``window`` is how long (seconds)
    # a worker holding a batchable query waits for more; ``maxBatch`` caps
    # the members of one batch.
    SERVING_BATCHING_ENABLED = "hyperspace.tpu.serving.batching.enabled"
    SERVING_BATCHING_ENABLED_DEFAULT = "true"
    SERVING_BATCHING_WINDOW = "hyperspace.tpu.serving.batching.window"
    SERVING_BATCHING_WINDOW_DEFAULT = "0.01"
    SERVING_BATCHING_MAX_BATCH = "hyperspace.tpu.serving.batching.maxBatch"
    SERVING_BATCHING_MAX_BATCH_DEFAULT = "8"
