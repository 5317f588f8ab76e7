"""Pluggable event logger (counterpart of
``hyperspace_tpu/telemetry/logging.py``).

The sink class is named by conf (``hyperspace.eventLoggerClass``) and
defaults to a no-op; instances are cached per class name.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

from ..exceptions import HyperspaceException
from .events import HyperspaceEvent


class EventLogger:
    def log_event(self, event: HyperspaceEvent) -> None:
        raise NotImplementedError


class NoOpEventLogger(EventLogger):
    def log_event(self, event: HyperspaceEvent) -> None:
        pass


_logger_cache: Dict[str, EventLogger] = {}


def get_logger(class_name: Optional[str]) -> EventLogger:
    if not class_name:
        return NoOpEventLogger()
    if class_name not in _logger_cache:
        module_name, _, cls_name = class_name.rpartition(".")
        try:
            cls = getattr(importlib.import_module(module_name), cls_name)
        except (ImportError, AttributeError) as e:
            raise HyperspaceException(
                f"Cannot load event logger class {class_name}") from e
        _logger_cache[class_name] = cls()
    return _logger_cache[class_name]


def log_event(session, event: HyperspaceEvent) -> None:
    """Emit ``event`` through ``session``'s conf-selected logger."""
    get_logger(session.hs_conf.event_logger_class()).log_event(event)


def emit_distributed_fallback(session, where: str, reason: str) -> None:
    """Record that a distributed path ran single-device instead: the one
    emission point of every fallback site."""
    from .events import DistributedFallbackEvent
    get_logger(session.hs_conf.event_logger_class()).log_event(
        DistributedFallbackEvent(
            message=f"{where} fell back to single-device execution",
            where=where, reason=reason))
