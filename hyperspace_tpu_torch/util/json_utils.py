"""JSON (de)serialization for the metadata model (counterpart of
``hyperspace_tpu/util/json_utils.py``)."""

from __future__ import annotations

import json
from typing import Any


def to_json(obj: Any, indent: int = 2) -> str:
    if hasattr(obj, "to_json_dict"):
        obj = obj.to_json_dict()
    return json.dumps(obj, indent=indent, sort_keys=False)


def from_json(text: str) -> Any:
    return json.loads(text)
