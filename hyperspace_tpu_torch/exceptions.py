"""Framework exceptions (counterpart of ``hyperspace_tpu/exceptions.py``)."""

from __future__ import annotations


class HyperspaceException(Exception):
    """Base exception for all framework errors."""


class NoChangesException(HyperspaceException):
    """An action found nothing to do (a refresh without source changes, an
    optimize without files to merge); the action records a no-op."""
