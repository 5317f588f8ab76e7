"""Source provider of commit-log versioned tables (counterpart of
``hyperspace_tpu/sources/delta.py``).

- The signature is the table version plus the path: the commit log's
  version already fingerprints the file set.
- The ``versionAsOf`` option reads an older version (time travel).
- Index creation and refresh record ``deltaVersionHistory``
  ("indexLogVersion:deltaVersion,...") through ``enrich_index_properties``.
- ``closest_index_log_version`` picks the index log version built nearest
  the scanned table version (rules/rule_utils.resolve_time_travel_entry).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..exceptions import HyperspaceException
from ..lake.delta import DeltaTable, Snapshot
from ..schema import Schema
from ..util import hashing
from .interfaces import FileBasedRelation, FileBasedSourceProvider

DELTA_VERSION_HISTORY_PROPERTY = "deltaVersionHistory"
VERSION_AS_OF_OPTION = "versionAsOf"


def lake_schema(relation, arrow) -> Schema:
    """The relation's schema: the table's recorded one, else the first
    file's footer."""
    if arrow is None:
        import pyarrow.parquet as pq
        files = relation.all_files()
        if not files:
            raise HyperspaceException(
                f"Empty {relation.file_format} table without schema: {relation.root_paths[0]}")
        arrow = pq.read_schema(files[0])
    return Schema.from_arrow(arrow)


class DeltaLakeRelation(FileBasedRelation):
    def __init__(self, path: str, options: Optional[Dict[str, str]] = None,
                 snapshot: Optional[Snapshot] = None):
        self._path = os.path.abspath(path)
        self._options = dict(options or {})
        if snapshot is None:
            version = self._options.get(VERSION_AS_OF_OPTION)
            snapshot = DeltaTable(self._path).snapshot(
                int(version) if version is not None else None)
        self._snapshot = snapshot
        self._schema: Optional[Schema] = None

    @property
    def root_paths(self) -> List[str]:
        return [self._path]

    @property
    def file_format(self) -> str:
        return "delta"

    @property
    def data_file_format(self) -> str:
        return "parquet"

    @property
    def options(self) -> Dict[str, str]:
        return dict(self._options)

    @property
    def delta_version(self) -> int:
        return self._snapshot.version

    def describe(self) -> str:
        return f"delta {self._path}@v{self._snapshot.version}"

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = lake_schema(self, self._snapshot.arrow_schema())
        return self._schema

    def all_files(self) -> List[str]:
        return self._snapshot.file_paths

    def all_file_infos(self) -> List[Tuple[str, int, int]]:
        # Sizes and mtimes come from the commit log, not a listing.
        return self._snapshot.file_infos

    def signature(self) -> str:
        return hashing.md5_hex(f"{self._snapshot.version}{self._path}")

    def refresh(self) -> "DeltaLakeRelation":
        """The latest version: a refresh of an index built over a
        time-traveled read follows the live table."""
        return DeltaLakeRelation(self._path, {k: v for k, v in self._options.items()
                                              if k != VERSION_AS_OF_OPTION})

    def with_files(self, files: Sequence[str]) -> "DeltaLakeRelation":
        keep = {os.path.abspath(f) for f in files}
        snap = self._snapshot
        kept = {rel: a for rel, a in snap._files.items()
                if os.path.join(self._path, rel) in keep}
        pruned = DeltaLakeRelation(self._path, self._options,
                                   snapshot=Snapshot(self._path, snap.version, kept,
                                                     snap.schema_string))
        pruned._schema = self._schema
        return pruned

    def enrich_index_properties(self, props: Dict[str, str],
                                index_log_version: int) -> Dict[str, str]:
        """Append (index log version: delta version) to the history."""
        out = dict(props)
        history = out.get(DELTA_VERSION_HISTORY_PROPERTY, "")
        pair = f"{index_log_version}:{self._snapshot.version}"
        out[DELTA_VERSION_HISTORY_PROPERTY] = f"{history},{pair}" if history else pair
        return out

    @staticmethod
    def parse_version_history(props: Dict[str, str]) -> List[Tuple[int, int]]:
        """[(index log version, delta version), ...] from the property."""
        out = []
        for pair in props.get(DELTA_VERSION_HISTORY_PROPERTY, "").split(","):
            if ":" in pair:
                a, b = pair.split(":", 1)
                out.append((int(a), int(b)))
        return out

    def closest_index_log_version(self, props: Dict[str, str]) -> Optional[int]:
        """The index log version recorded nearest this snapshot's version,
        or None when the latest recorded pair covers it. The latest pair at
        or before the scanned version wins (an index of a later version
        holds rows the snapshot must not see); without one, the nearest
        overall.

        None rather than the latest pair's log id: optimize and quick
        refresh commit newer ACTIVE ids without a pair, and going back to
        the recorded id would drop their work."""
        history = self.parse_version_history(props)
        if not history:
            return None
        version = self._snapshot.version
        at_or_before = [(lv, dv) for lv, dv in history if dv <= version]
        if at_or_before:
            chosen = max(at_or_before, key=lambda p: (p[1], p[0]))
        else:
            chosen = min(history, key=lambda p: (abs(p[1] - version), -p[0]))
        if chosen[1] == max(dv for _, dv in history):
            return None
        return chosen[0]


class DeltaLakeSourceBuilder(FileBasedSourceProvider):
    """Answers ``format("delta")`` loads and delta Scan leaves."""

    def get_relation(self, plan_leaf) -> Optional[FileBasedRelation]:
        relation = getattr(plan_leaf, "relation", None)
        return relation if isinstance(relation, DeltaLakeRelation) else None

    def build_relation(self, paths: Sequence[str], fmt: str,
                       options: Dict[str, str]) -> Optional[FileBasedRelation]:
        if fmt != "delta":
            return None
        if len(paths) != 1:
            raise HyperspaceException(f"Delta tables are single-rooted; got {len(paths)} paths")
        return DeltaLakeRelation(paths[0], options)
