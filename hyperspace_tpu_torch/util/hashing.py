"""Hashing helpers (counterpart of ``hyperspace_tpu/util/hashing.py``)."""

from __future__ import annotations

import hashlib
from typing import Any


def md5_hex(value: Any) -> str:
    """md5 hex digest of ``str(value)``."""
    return hashlib.md5(str(value).encode("utf-8")).hexdigest()
