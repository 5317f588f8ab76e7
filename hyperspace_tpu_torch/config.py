"""Runtime configuration (counterpart of ``hyperspace_tpu/config.py``).

Every knob is a string conf read per call, so values can change at run
time. Only the accessors this package reads are here.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

from .adaptive.constants import AdaptiveConstants
from .artifacts.constants import ArtifactConstants
from .advisor.constants import AdvisorConstants
from .cluster.constants import ClusterConstants
from .index.constants import IndexConstants
from .optimizer.constants import OptimizerConstants
from .robustness.constants import RobustnessConstants
from .serving.constants import ServingConstants
from .streaming.constants import StreamingConstants
from .telemetry.constants import TelemetryConstants

T = TypeVar("T")


class Conf:
    """A mutable string-keyed configuration map (the SparkConf analogue)."""

    def __init__(self, initial: Optional[Dict[str, str]] = None):
        self._conf: Dict[str, str] = {k: str(v) for k, v in (initial or {}).items()}

    def set(self, key: str, value: Any) -> "Conf":
        self._conf[key] = str(value)
        return self

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._conf.get(key, default)

    def unset(self, key: str) -> "Conf":
        self._conf.pop(key, None)
        return self

    def as_dict(self) -> Dict[str, str]:
        return dict(self._conf)


class CacheWithTransform(Generic[T]):
    """Caches ``transform(raw)`` and derives it anew whenever the raw conf
    string ``load_func()`` changes. Locked: the serving frontend's workers
    probe holders concurrently."""

    def __init__(self, load_func: Callable[[], str], transform: Callable[[str], T]):
        self._load_func = load_func
        self._transform = transform
        self._cached_raw: Optional[str] = None
        self._cached_value: Optional[T] = None
        self._lock = threading.Lock()

    def load(self) -> T:
        raw = self._load_func()
        with self._lock:
            if self._cached_raw is None or raw != self._cached_raw:
                self._cached_value = self._transform(raw)
                self._cached_raw = raw
            return self._cached_value  # type: ignore[return-value]


class HyperspaceConf:
    """Typed accessors over a :class:`Conf`."""

    def __init__(self, conf: Conf):
        self._conf = conf

    def system_path(self) -> str:
        path = self._conf.get(IndexConstants.INDEX_SYSTEM_PATH)
        if not path:
            raise ValueError(
                f"Config '{IndexConstants.INDEX_SYSTEM_PATH}' is not set; it must point at "
                "the root directory under which indexes are stored.")
        return path

    def num_bucket_count(self) -> int:
        return int(self._conf.get(IndexConstants.INDEX_NUM_BUCKETS,
                                  str(IndexConstants.INDEX_NUM_BUCKETS_DEFAULT)))

    def index_row_group_size(self) -> int:
        return int(self._conf.get(IndexConstants.INDEX_ROW_GROUP_SIZE,
                                  str(IndexConstants.INDEX_ROW_GROUP_SIZE_DEFAULT)))

    # The mesh tier (execution/spmd.py, parallel/).

    def distributed_enabled(self) -> bool:
        return self._get_bool(IndexConstants.TPU_DISTRIBUTED_ENABLED,
                              IndexConstants.TPU_DISTRIBUTED_ENABLED_DEFAULT)

    def distributed_single_device(self) -> str:
        v = str(self._conf.get(IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE,
                               IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE_DEFAULT)).lower()
        # The sibling boolean flags' spellings are accepted; anything else
        # is refused rather than read as "auto".
        v = {"true": "on", "false": "off"}.get(v, v)
        if v not in ("auto", "on", "off"):
            from .exceptions import HyperspaceException
            raise HyperspaceException(
                f"{IndexConstants.TPU_DISTRIBUTED_SINGLE_DEVICE} must be "
                f"auto/on/off (or true/false), got {v!r}")
        return v

    def distributed_mesh_max_devices(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_DISTRIBUTED_MESH_MAX_DEVICES,
                                  IndexConstants.TPU_DISTRIBUTED_MESH_MAX_DEVICES_DEFAULT))

    def distributed_min_stream_rows(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_DISTRIBUTED_MIN_STREAM_ROWS,
                                  IndexConstants.TPU_DISTRIBUTED_MIN_STREAM_ROWS_DEFAULT))

    def max_chunk_rows(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_MAX_CHUNK_ROWS,
                                  IndexConstants.TPU_MAX_CHUNK_ROWS_DEFAULT))

    # Length classes (shapes.py) and whole-plan fusion
    # (execution/fusion.py).

    def shape_bucketing_enabled(self) -> bool:
        return self._get_bool(IndexConstants.TPU_SHAPE_BUCKETING_ENABLED,
                              IndexConstants.TPU_SHAPE_BUCKETING_ENABLED_DEFAULT)

    def shape_bucketing_growth_factor(self) -> float:
        return float(self._conf.get(IndexConstants.TPU_SHAPE_BUCKETING_GROWTH_FACTOR,
                                    IndexConstants.TPU_SHAPE_BUCKETING_GROWTH_FACTOR_DEFAULT))

    def shape_bucketing_min_pad(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_SHAPE_BUCKETING_MIN_PAD,
                                  IndexConstants.TPU_SHAPE_BUCKETING_MIN_PAD_DEFAULT))

    def shape_bucketing_max_waste_ratio(self) -> float:
        return float(self._conf.get(IndexConstants.TPU_SHAPE_BUCKETING_MAX_WASTE_RATIO,
                                    IndexConstants.TPU_SHAPE_BUCKETING_MAX_WASTE_RATIO_DEFAULT))

    def shape_bucketing_exact_fallback_rows(self) -> int:
        return int(self._conf.get(
            IndexConstants.TPU_SHAPE_BUCKETING_EXACT_FALLBACK_ROWS,
            IndexConstants.TPU_SHAPE_BUCKETING_EXACT_FALLBACK_ROWS_DEFAULT))

    def fusion_enabled(self) -> bool:
        return self._get_bool(IndexConstants.TPU_FUSION_ENABLED,
                              IndexConstants.TPU_FUSION_ENABLED_DEFAULT)

    def io_enabled(self) -> bool:
        return self._get_bool(IndexConstants.TPU_IO_ENABLED,
                              IndexConstants.TPU_IO_ENABLED_DEFAULT)

    def io_threads(self) -> int:
        """Reader-pool width; 0 = auto (min(16, cpu count)), 1 = sequential."""
        return int(self._conf.get(IndexConstants.TPU_IO_THREADS,
                                  IndexConstants.TPU_IO_THREADS_DEFAULT))

    def io_prefetch_depth(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_IO_PREFETCH_DEPTH,
                                  IndexConstants.TPU_IO_PREFETCH_DEPTH_DEFAULT))

    def io_max_inflight_bytes(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES,
                                  IndexConstants.TPU_IO_MAX_INFLIGHT_BYTES_DEFAULT))

    def buffer_pool_enabled(self) -> bool:
        return self._get_bool(IndexConstants.TPU_BUFFER_POOL_ENABLED,
                              IndexConstants.TPU_BUFFER_POOL_ENABLED_DEFAULT)

    def buffer_pool_device_bytes(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_BUFFER_POOL_DEVICE_BYTES,
                                  IndexConstants.TPU_BUFFER_POOL_DEVICE_BYTES_DEFAULT))

    def buffer_pool_host_bytes(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_BUFFER_POOL_HOST_BYTES,
                                  IndexConstants.TPU_BUFFER_POOL_HOST_BYTES_DEFAULT))

    def buffer_pool_stream_admit_bytes(self) -> int:
        return int(self._conf.get(IndexConstants.TPU_BUFFER_POOL_STREAM_ADMIT_BYTES,
                                  IndexConstants.TPU_BUFFER_POOL_STREAM_ADMIT_BYTES_DEFAULT))

    def hybrid_scan_enabled(self) -> bool:
        return self._get_bool(IndexConstants.INDEX_HYBRID_SCAN_ENABLED,
                              IndexConstants.INDEX_HYBRID_SCAN_ENABLED_DEFAULT)

    def hybrid_scan_deleted_ratio_threshold(self) -> float:
        return float(self._conf.get(
            IndexConstants.INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD,
            IndexConstants.INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD_DEFAULT))

    def hybrid_scan_appended_ratio_threshold(self) -> float:
        return float(self._conf.get(
            IndexConstants.INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD,
            IndexConstants.INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD_DEFAULT))

    def index_lineage_enabled(self) -> bool:
        return self._get_bool(IndexConstants.INDEX_LINEAGE_ENABLED,
                              IndexConstants.INDEX_LINEAGE_ENABLED_DEFAULT)

    def optimize_file_size_threshold(self) -> int:
        return int(self._conf.get(IndexConstants.OPTIMIZE_FILE_SIZE_THRESHOLD,
                                  str(IndexConstants.OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT)))

    def use_bucket_spec_for_filter_rule(self) -> bool:
        return self._get_bool(IndexConstants.INDEX_FILTER_RULE_USE_BUCKET_SPEC,
                              IndexConstants.INDEX_FILTER_RULE_USE_BUCKET_SPEC_DEFAULT)

    def index_cache_expiry_seconds(self) -> int:
        return int(self._conf.get(IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS,
                                  IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS_DEFAULT))

    def case_sensitive(self) -> bool:
        return self._get_bool(IndexConstants.CASE_SENSITIVE,
                              IndexConstants.CASE_SENSITIVE_DEFAULT)

    def event_logger_class(self) -> Optional[str]:
        return self._conf.get(IndexConstants.EVENT_LOGGER_CLASS)

    def trace_dir(self) -> Optional[str]:
        return self._conf.get(IndexConstants.TPU_TRACE_DIR)

    # The result cache and the SQL plan memo (serving/result_cache.py).

    def result_cache_enabled(self) -> bool:
        return self._get_bool(ServingConstants.RESULT_CACHE_ENABLED,
                              ServingConstants.RESULT_CACHE_ENABLED_DEFAULT)

    def result_cache_device_bytes(self) -> int:
        return int(self._conf.get(ServingConstants.RESULT_CACHE_DEVICE_BYTES,
                                  ServingConstants.RESULT_CACHE_DEVICE_BYTES_DEFAULT))

    def result_cache_host_bytes(self) -> int:
        return int(self._conf.get(ServingConstants.RESULT_CACHE_HOST_BYTES,
                                  ServingConstants.RESULT_CACHE_HOST_BYTES_DEFAULT))

    def result_cache_min_compute_seconds(self) -> float:
        return float(self._conf.get(ServingConstants.RESULT_CACHE_MIN_COMPUTE_SECONDS,
                                    ServingConstants.RESULT_CACHE_MIN_COMPUTE_SECONDS_DEFAULT))

    def result_cache_min_input_bytes(self) -> int:
        return int(self._conf.get(ServingConstants.RESULT_CACHE_MIN_INPUT_BYTES,
                                  ServingConstants.RESULT_CACHE_MIN_INPUT_BYTES_DEFAULT))

    def result_cache_plan_cache_size(self) -> int:
        return int(self._conf.get(ServingConstants.RESULT_CACHE_PLAN_CACHE_SIZE,
                                  ServingConstants.RESULT_CACHE_PLAN_CACHE_SIZE_DEFAULT))

    def result_cache_spill_dir(self) -> str:
        """Directory of the spill tier; empty = no spill tier."""
        return (self._conf.get(ServingConstants.RESULT_CACHE_SPILL_DIR,
                               ServingConstants.RESULT_CACHE_SPILL_DIR_DEFAULT) or "").strip()

    def result_cache_spill_bytes(self) -> int:
        return int(self._conf.get(ServingConstants.RESULT_CACHE_SPILL_BYTES,
                                  ServingConstants.RESULT_CACHE_SPILL_BYTES_DEFAULT))

    def result_cache_conf_string(self) -> str:
        """The identity of the cache instance: the switch and the tier
        budgets. The admission floors are read per query, so tuning them
        keeps a warm cache."""
        return "|".join([str(self.result_cache_enabled()),
                         str(self.result_cache_device_bytes()),
                         str(self.result_cache_host_bytes()),
                         self.result_cache_spill_dir(),
                         str(self.result_cache_spill_bytes())])

    # The concurrent frontend (serving/frontend.py).

    def serving_enabled(self) -> bool:
        return self._get_bool(ServingConstants.SERVING_ENABLED,
                              ServingConstants.SERVING_ENABLED_DEFAULT)

    def serving_max_concurrency(self) -> int:
        return max(int(self._conf.get(ServingConstants.SERVING_MAX_CONCURRENCY,
                                      ServingConstants.SERVING_MAX_CONCURRENCY_DEFAULT)), 1)

    def serving_queue_depth(self) -> int:
        return max(int(self._conf.get(ServingConstants.SERVING_QUEUE_DEPTH,
                                      ServingConstants.SERVING_QUEUE_DEPTH_DEFAULT)), 1)

    def serving_admission_max_bytes(self) -> int:
        return max(int(self._conf.get(ServingConstants.SERVING_ADMISSION_MAX_BYTES,
                                      ServingConstants.SERVING_ADMISSION_MAX_BYTES_DEFAULT)), 1)

    def serving_batching_enabled(self) -> bool:
        return self._get_bool(ServingConstants.SERVING_BATCHING_ENABLED,
                              ServingConstants.SERVING_BATCHING_ENABLED_DEFAULT)

    def serving_batching_window(self) -> float:
        return max(float(self._conf.get(ServingConstants.SERVING_BATCHING_WINDOW,
                                        ServingConstants.SERVING_BATCHING_WINDOW_DEFAULT)), 0.0)

    def serving_batching_max_batch(self) -> int:
        return max(int(self._conf.get(ServingConstants.SERVING_BATCHING_MAX_BATCH,
                                      ServingConstants.SERVING_BATCHING_MAX_BATCH_DEFAULT)), 1)

    # The streaming tier (streaming/constants.py).

    def streaming_enabled(self) -> bool:
        return self._get_bool(StreamingConstants.ENABLED, StreamingConstants.ENABLED_DEFAULT)

    def streaming_max_staged_batches(self) -> int:
        return max(int(self._conf.get(StreamingConstants.MAX_STAGED_BATCHES,
                                      StreamingConstants.MAX_STAGED_BATCHES_DEFAULT)), 1)

    def streaming_load_time_indexing(self) -> bool:
        return self._get_bool(StreamingConstants.LOAD_TIME_INDEXING,
                              StreamingConstants.LOAD_TIME_INDEXING_DEFAULT)

    def streaming_compaction_min_entries(self) -> int:
        return max(int(self._conf.get(StreamingConstants.COMPACTION_MIN_ENTRIES,
                                      StreamingConstants.COMPACTION_MIN_ENTRIES_DEFAULT)), 1)

    def streaming_group_commit_enabled(self) -> bool:
        return self._get_bool(StreamingConstants.GROUP_COMMIT_ENABLED,
                              StreamingConstants.GROUP_COMMIT_ENABLED_DEFAULT)

    def streaming_group_commit_window_ms(self) -> float:
        return max(float(self._conf.get(StreamingConstants.GROUP_COMMIT_WINDOW_MS,
                                        StreamingConstants.GROUP_COMMIT_WINDOW_MS_DEFAULT)), 0.0)

    def streaming_group_commit_max_wave(self) -> int:
        return max(int(self._conf.get(StreamingConstants.GROUP_COMMIT_MAX_WAVE,
                                      StreamingConstants.GROUP_COMMIT_MAX_WAVE_DEFAULT)), 1)

    def streaming_source_poll_ms(self) -> float:
        return max(float(self._conf.get(StreamingConstants.SOURCE_POLL_MS,
                                        StreamingConstants.SOURCE_POLL_MS_DEFAULT)), 1.0)

    def streaming_source_commit_batches(self) -> int:
        return max(int(self._conf.get(StreamingConstants.SOURCE_COMMIT_BATCHES,
                                      StreamingConstants.SOURCE_COMMIT_BATCHES_DEFAULT)), 1)

    def streaming_backpressure_timeout_ms(self) -> float:
        return max(float(self._conf.get(StreamingConstants.BACKPRESSURE_TIMEOUT_MS,
                                        StreamingConstants.BACKPRESSURE_TIMEOUT_MS_DEFAULT)), 0.0)

    def streaming_subscriptions_max(self) -> int:
        return max(int(self._conf.get(StreamingConstants.SUBSCRIPTIONS_MAX,
                                      StreamingConstants.SUBSCRIPTIONS_MAX_DEFAULT)), 1)

    def streaming_subscription_history(self) -> int:
        return max(int(self._conf.get(StreamingConstants.SUBSCRIPTION_HISTORY,
                                      StreamingConstants.SUBSCRIPTION_HISTORY_DEFAULT)), 1)

    # Robustness (robustness/constants.py): fault injection, deadlines,
    # retry, the degradation ladders.

    def robustness_fault_specs(self) -> Dict[str, str]:
        """``{point name: spec string}`` from every
        ``hyperspace.tpu.robustness.faults.<point>`` key; empty means
        disarmed."""
        prefix = RobustnessConstants.FAULTS_PREFIX + "."
        return {k[len(prefix):]: v for k, v in self._conf.as_dict().items()
                if k.startswith(prefix)}

    def robustness_deadline_ms(self) -> float:
        return max(float(self._conf.get(RobustnessConstants.DEADLINE_MS,
                                        RobustnessConstants.DEADLINE_MS_DEFAULT)), 0.0)

    def robustness_retry_max_attempts(self) -> int:
        return max(int(self._conf.get(RobustnessConstants.RETRY_MAX_ATTEMPTS,
                                      RobustnessConstants.RETRY_MAX_ATTEMPTS_DEFAULT)), 1)

    def robustness_retry_base_ms(self) -> float:
        return max(float(self._conf.get(RobustnessConstants.RETRY_BASE_MS,
                                        RobustnessConstants.RETRY_BASE_MS_DEFAULT)), 0.0)

    def robustness_degrade_enabled(self) -> bool:
        return self._get_bool(RobustnessConstants.DEGRADE_ENABLED,
                              RobustnessConstants.DEGRADE_ENABLED_DEFAULT)

    # The artifact store (artifacts/constants.py); the JAX package's
    # defaults and clamps.

    def artifacts_enabled(self) -> bool:
        return self._get_bool(ArtifactConstants.ENABLED, ArtifactConstants.ENABLED_DEFAULT)

    def artifacts_dir(self) -> str:
        return (self._conf.get(ArtifactConstants.DIR, ArtifactConstants.DIR_DEFAULT)
                or "").strip()

    def artifacts_max_bytes(self) -> int:
        return max(int(self._conf.get(ArtifactConstants.MAX_BYTES,
                                      ArtifactConstants.MAX_BYTES_DEFAULT)), 0)

    def artifacts_preload_enabled(self) -> bool:
        return self.artifacts_enabled() and self._get_bool(
            ArtifactConstants.PRELOAD_ENABLED, ArtifactConstants.PRELOAD_ENABLED_DEFAULT)

    def artifacts_preload_max_ms(self) -> float:
        return max(float(self._conf.get(ArtifactConstants.PRELOAD_MAX_MS,
                                        ArtifactConstants.PRELOAD_MAX_MS_DEFAULT)), 0.0)

    def artifacts_preload_max_bytes(self) -> int:
        return max(int(self._conf.get(ArtifactConstants.PRELOAD_MAX_BYTES,
                                      ArtifactConstants.PRELOAD_MAX_BYTES_DEFAULT)), 0)

    def artifacts_usage_flush_ms(self) -> float:
        return max(float(self._conf.get(ArtifactConstants.USAGE_FLUSH_MS,
                                        ArtifactConstants.USAGE_FLUSH_MS_DEFAULT)), 0.0)

    # The serving cluster (cluster/constants.py).

    def cluster_enabled(self) -> bool:
        return self._get_bool(ClusterConstants.ENABLED, ClusterConstants.ENABLED_DEFAULT)

    def cluster_worker_id(self) -> str:
        return (self._conf.get(ClusterConstants.WORKER_ID,
                               ClusterConstants.WORKER_ID_DEFAULT) or "").strip()

    def cluster_bind(self) -> str:
        return (self._conf.get(ClusterConstants.BIND, ClusterConstants.BIND_DEFAULT)
                or "127.0.0.1").strip()

    def cluster_port(self) -> int:
        return max(int(self._conf.get(ClusterConstants.PORT, ClusterConstants.PORT_DEFAULT)), 0)

    def cluster_dir(self) -> str:
        return (self._conf.get(ClusterConstants.DIR, ClusterConstants.DIR_DEFAULT) or "").strip()

    def cluster_heartbeat_ms(self) -> float:
        return max(float(self._conf.get(ClusterConstants.HEARTBEAT_MS,
                                        ClusterConstants.HEARTBEAT_MS_DEFAULT)), 50.0)

    def cluster_staleness_ms(self) -> float:
        return max(float(self._conf.get(ClusterConstants.STALENESS_MS,
                                        ClusterConstants.STALENESS_MS_DEFAULT)), 100.0)

    def cluster_routing_enabled(self) -> bool:
        return self.cluster_enabled() and self._get_bool(
            ClusterConstants.ROUTING_ENABLED, ClusterConstants.ROUTING_ENABLED_DEFAULT)

    def cluster_forward_timeout_ms(self) -> float:
        return max(float(self._conf.get(ClusterConstants.FORWARD_TIMEOUT_MS,
                                        ClusterConstants.FORWARD_TIMEOUT_MS_DEFAULT)), 10.0)

    def cluster_gather_mode(self) -> str:
        mode = (self._conf.get(ClusterConstants.GATHER, ClusterConstants.GATHER_DEFAULT)
                or "").strip().lower()
        return mode if mode in ("auto", "native", "host") else "auto"

    # Cost-based optimizer (optimizer/constants.py).

    def join_reorder_enabled(self) -> bool:
        return self._get_bool(OptimizerConstants.JOIN_REORDER_ENABLED,
                              OptimizerConstants.JOIN_REORDER_ENABLED_DEFAULT)

    # Telemetry (telemetry/constants.py): tracing, SLOs, export, profiler.

    def telemetry_trace_enabled(self) -> bool:
        return self._get_bool(TelemetryConstants.TRACE_ENABLED,
                              TelemetryConstants.TRACE_ENABLED_DEFAULT)

    def telemetry_trace_sample_rate(self) -> float:
        """Head-sampled trace retention probability, clamped to [0, 1]."""
        return min(max(float(self._conf.get(
            TelemetryConstants.TRACE_SAMPLE_RATE,
            TelemetryConstants.TRACE_SAMPLE_RATE_DEFAULT)), 0.0), 1.0)

    def telemetry_slo_p99_ms(self) -> float:
        return max(float(self._conf.get(TelemetryConstants.SLO_P99_MS,
                                        TelemetryConstants.SLO_P99_MS_DEFAULT)), 0.0)

    def telemetry_slo_error_rate(self) -> float:
        return max(float(self._conf.get(TelemetryConstants.SLO_ERROR_RATE,
                                        TelemetryConstants.SLO_ERROR_RATE_DEFAULT)), 0.0)

    def telemetry_slo_min_count(self) -> int:
        return max(int(self._conf.get(TelemetryConstants.SLO_MIN_COUNT,
                                      TelemetryConstants.SLO_MIN_COUNT_DEFAULT)), 1)

    def telemetry_export_http_port(self) -> int:
        return max(int(self._conf.get(TelemetryConstants.EXPORT_HTTP_PORT,
                                      TelemetryConstants.EXPORT_HTTP_PORT_DEFAULT)), 0)

    def telemetry_profiler_enabled(self) -> bool:
        return self._get_bool(TelemetryConstants.PROFILER_ENABLED,
                              TelemetryConstants.PROFILER_ENABLED_DEFAULT)

    def telemetry_profiler_dir(self) -> str:
        return self._conf.get(TelemetryConstants.PROFILER_DIR,
                              TelemetryConstants.PROFILER_DIR_DEFAULT) or ""

    # The advisor (advisor/constants.py): workload capture, recommendation.

    def advisor_capture_enabled(self) -> bool:
        return self._get_bool(AdvisorConstants.CAPTURE_ENABLED,
                              AdvisorConstants.CAPTURE_ENABLED_DEFAULT)

    def advisor_capture_max_entries(self) -> int:
        return int(self._conf.get(AdvisorConstants.CAPTURE_MAX_ENTRIES,
                                  AdvisorConstants.CAPTURE_MAX_ENTRIES_DEFAULT))

    def advisor_min_support(self) -> int:
        return int(self._conf.get(AdvisorConstants.MIN_SUPPORT,
                                  AdvisorConstants.MIN_SUPPORT_DEFAULT))

    # The adaptive control plane (adaptive/constants.py): every feature is
    # off while the master switch is; feedback and admission follow it.

    def adaptive_enabled(self) -> bool:
        return self._get_bool(AdaptiveConstants.ENABLED, AdaptiveConstants.ENABLED_DEFAULT)

    def adaptive_replan_enabled(self) -> bool:
        return self.adaptive_enabled() and self._get_bool(
            AdaptiveConstants.REPLAN_ENABLED, AdaptiveConstants.REPLAN_ENABLED_DEFAULT)

    def adaptive_builder_enabled(self) -> bool:
        return self.adaptive_enabled() and self._get_bool(
            AdaptiveConstants.BUILDER_ENABLED, AdaptiveConstants.BUILDER_ENABLED_DEFAULT)

    def adaptive_builder_max_bytes(self) -> int:
        return max(int(self._conf.get(AdaptiveConstants.BUILDER_MAX_BYTES,
                                      AdaptiveConstants.BUILDER_MAX_BYTES_DEFAULT)), 0)

    def adaptive_builder_idle_ms(self) -> float:
        return max(float(self._conf.get(AdaptiveConstants.BUILDER_IDLE_MS,
                                        AdaptiveConstants.BUILDER_IDLE_MS_DEFAULT)), 0.0)

    def adaptive_builder_retire_min_queries(self) -> int:
        return max(int(self._conf.get(AdaptiveConstants.BUILDER_RETIRE_MIN_QUERIES,
                                      AdaptiveConstants.BUILDER_RETIRE_MIN_QUERIES_DEFAULT)),
                   1)

    def adaptive_admission_mode(self) -> str:
        mode = (self._conf.get(AdaptiveConstants.ADMISSION_MODE,
                               AdaptiveConstants.ADMISSION_MODE_DEFAULT) or "").strip().lower()
        return mode if mode in ("shed", "degrade") else "degrade"

    def _get_bool(self, key: str, default: str) -> bool:
        return (self._conf.get(key, default) or "").strip().lower() == "true"
