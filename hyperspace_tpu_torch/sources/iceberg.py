"""Source provider of snapshot/manifest versioned tables (counterpart of
``hyperspace_tpu/sources/iceberg.py``): the signature is the snapshot id
plus the table's location, the ``snapshotId`` option reads an older
snapshot, and the files are listed from the manifest.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..exceptions import HyperspaceException
from ..lake.iceberg import IcebergSnapshot, IcebergTable
from ..schema import Schema
from ..util import hashing
from .delta import lake_schema
from .interfaces import FileBasedRelation, FileBasedSourceProvider

SNAPSHOT_ID_OPTION = "snapshotId"


class IcebergRelation(FileBasedRelation):
    def __init__(self, path: str, options: Optional[Dict[str, str]] = None,
                 snapshot: Optional[IcebergSnapshot] = None):
        self._path = os.path.abspath(path)
        self._options = dict(options or {})
        if snapshot is None:
            snap_id = self._options.get(SNAPSHOT_ID_OPTION)
            snapshot = IcebergTable(self._path).snapshot(
                int(snap_id) if snap_id is not None else None)
        self._snapshot = snapshot
        self._schema: Optional[Schema] = None

    @property
    def root_paths(self) -> List[str]:
        return [self._path]

    @property
    def file_format(self) -> str:
        return "iceberg"

    @property
    def data_file_format(self) -> str:
        return "parquet"

    @property
    def options(self) -> Dict[str, str]:
        return dict(self._options)

    @property
    def snapshot_id(self) -> int:
        return self._snapshot.snapshot_id

    def describe(self) -> str:
        return f"iceberg {self._path}@snap{self._snapshot.snapshot_id}"

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = lake_schema(self, self._snapshot.arrow_schema())
        return self._schema

    def all_files(self) -> List[str]:
        return self._snapshot.file_paths

    def all_file_infos(self) -> List[Tuple[str, int, int]]:
        return self._snapshot.file_infos

    def signature(self) -> str:
        return hashing.md5_hex(f"{self._snapshot.snapshot_id}{self._path}")

    def refresh(self) -> "IcebergRelation":
        return IcebergRelation(self._path, {k: v for k, v in self._options.items()
                                            if k != SNAPSHOT_ID_OPTION})

    def with_files(self, files: Sequence[str]) -> "IcebergRelation":
        keep = {os.path.abspath(f) for f in files}
        manifest = dict(self._snapshot._manifest)
        manifest["files"] = [f for f in manifest["files"]
                             if os.path.join(self._path, f["path"]) in keep]
        pruned = IcebergRelation(self._path, self._options,
                                 snapshot=IcebergSnapshot(self._path,
                                                          self._snapshot.snapshot_id, manifest))
        pruned._schema = self._schema
        return pruned


class IcebergSourceBuilder(FileBasedSourceProvider):
    """Answers ``format("iceberg")`` loads and iceberg Scan leaves."""

    def get_relation(self, plan_leaf) -> Optional[FileBasedRelation]:
        relation = getattr(plan_leaf, "relation", None)
        return relation if isinstance(relation, IcebergRelation) else None

    def build_relation(self, paths: Sequence[str], fmt: str,
                       options: Dict[str, str]) -> Optional[FileBasedRelation]:
        if fmt != "iceberg":
            return None
        if len(paths) != 1:
            raise HyperspaceException(
                f"Iceberg tables are single-rooted; got {len(paths)} paths")
        return IcebergRelation(paths[0], options)
