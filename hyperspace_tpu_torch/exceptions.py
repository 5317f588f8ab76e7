"""Framework exceptions (counterpart of ``hyperspace_tpu/exceptions.py``)."""

from __future__ import annotations


class HyperspaceException(Exception):
    """Base exception for all framework errors."""
