"""Framework exceptions (counterpart of ``hyperspace_tpu/exceptions.py``)."""

from __future__ import annotations


class HyperspaceException(Exception):
    """Base exception for all framework errors."""


class NoChangesException(HyperspaceException):
    """An action found nothing to do (a refresh without source changes, an
    optimize without files to merge); the action records a no-op."""


class ServingRejectedError(HyperspaceException):
    """The serving frontend's admission control refused a query: the
    queue is at ``queueDepth``, or the in-flight input bytes would pass
    ``admission.maxBytes``. The query itself did not fail; resubmit later."""


class QueryDeadlineError(HyperspaceException):
    """A query's deadline (``ServingFrontend.submit(deadline_ms=...)``)
    expired before it finished; it was cancelled at a stage boundary and
    computed no answer."""
