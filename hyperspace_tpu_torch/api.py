"""User API facade (counterpart of ``hyperspace_tpu/api.py``: covering
indexes; create, delete and vacuum)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .exceptions import HyperspaceException


@dataclass(frozen=True)
class IndexConfig:
    """Covering-index specification."""

    index_name: str
    indexed_columns: List[str]
    included_columns: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.index_name:
            raise HyperspaceException("Index name cannot be empty")
        if not self.indexed_columns:
            raise HyperspaceException("Indexed columns cannot be empty")
        lowered = [c.lower() for c in
                   list(self.indexed_columns) + list(self.included_columns)]
        if len(set(lowered)) != len(lowered):
            raise HyperspaceException(
                "Duplicate columns across indexed/included lists")


class Hyperspace:
    def __init__(self, session):
        self.session = session
        self.index_manager = session.index_collection_manager

    def create_index(self, df, index_config: IndexConfig) -> None:
        self.index_manager.create(df, index_config)

    def delete_index(self, index_name: str) -> None:
        self.index_manager.delete(index_name)

    def vacuum_index(self, index_name: str) -> None:
        self.index_manager.vacuum(index_name)
