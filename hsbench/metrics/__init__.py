"""Per-layer metric readers, one module a metric, named as the metric.

Each module has ``read(readings) -> float | None``: the metric from a
traced run's :class:`hsbench.instruments.Readings`, or None where the run
holds nothing for it to read (the line then leaves the metric out).
"""

from __future__ import annotations

import os
import pkgutil


def names() -> list:
    return sorted(m.name for m in pkgutil.iter_modules([os.path.dirname(__file__)])
                  if not m.name.startswith("_"))
