"""Telemetry tier (counterpart of ``hyperspace_tpu/telemetry/``): typed
events, per-query span traces, the process metrics registry and its
OpenMetrics exposition, the flight recorder and the SLO monitors. Conf is
``hyperspace.tpu.telemetry.*`` (constants.py), read through config.py."""

from .constants import TelemetryConstants  # noqa: F401
from .events import (  # noqa: F401
    CancelActionEvent, CreateActionEvent, DeleteActionEvent, HyperspaceEvent,
    HyperspaceIndexUsageEvent, IndexCacheHitEvent, IndexCacheMissEvent,
    OptimizeActionEvent, RefreshActionEvent, RefreshIncrementalActionEvent,
    RefreshQuickActionEvent, RestoreActionEvent, ResultCacheAdmitEvent,
    ResultCacheEvictionEvent, ResultCacheHitEvent, ResultCacheMissEvent,
    VacuumActionEvent)
from .logging import EventLogger, NoOpEventLogger, get_logger  # noqa: F401
