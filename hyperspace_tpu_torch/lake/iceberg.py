"""Snapshot/manifest versioned parquet tables, the Iceberg analogue
(counterpart of ``hyperspace_tpu/lake/iceberg.py``; the same layout)::

    <table>/data/part-<uuid>.parquet
    <table>/metadata/v1.metadata.json        (table metadata, one per commit)
    <table>/metadata/snap-<id>.manifest.json (immutable file manifest)
    <table>/metadata/version-hint.text       (the latest metadata version)

Every snapshot's manifest lists the table's complete file set; metadata
versions chain the table's states, and a snapshot is addressed by its id
for time travel. Metadata is committed create-exclusive (O_EXCL).
"""

from __future__ import annotations

import json
import os
import random
import time
import uuid
from typing import List, Optional, Tuple

import pyarrow as pa

from ..exceptions import HyperspaceException
from .delta import schema_from_string, schema_string, write_parts

METADATA_DIR = "metadata"
DATA_DIR = "data"


class IcebergConcurrentModificationException(HyperspaceException):
    pass


class IcebergSnapshot:
    def __init__(self, table_path: str, snapshot_id: int, manifest: dict):
        self.table_path = table_path
        self.snapshot_id = snapshot_id
        self._manifest = manifest

    @property
    def file_infos(self) -> List[Tuple[str, int, int]]:
        return [(os.path.join(self.table_path, f["path"]), int(f["size"]),
                 int(f["modificationTime"]))
                for f in sorted(self._manifest["files"], key=lambda x: x["path"])]

    @property
    def file_paths(self) -> List[str]:
        return [p for p, _, _ in self.file_infos]

    def arrow_schema(self) -> Optional[pa.Schema]:
        return schema_from_string(self._manifest.get("schemaString"))


class IcebergTable:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def _meta_dir(self) -> str:
        return os.path.join(self.path, METADATA_DIR)

    def _hint_path(self) -> str:
        return os.path.join(self._meta_dir(), "version-hint.text")

    def _metadata_path(self, v: int) -> str:
        return os.path.join(self._meta_dir(), f"v{v}.metadata.json")

    def exists(self) -> bool:
        return os.path.isfile(self._hint_path())

    def _latest_metadata_version(self) -> int:
        if not self.exists():
            raise HyperspaceException(f"Not an iceberg table: {self.path}")
        with open(self._hint_path()) as f:
            return int(f.read().strip())

    def _read_metadata(self, v: Optional[int] = None) -> dict:
        if v is None:
            v = self._latest_metadata_version()
        with open(self._metadata_path(v)) as f:
            return json.load(f)

    def _commit_metadata(self, meta: dict) -> int:
        os.makedirs(self._meta_dir(), exist_ok=True)
        v = meta["metadataVersion"]
        try:
            fd = os.open(self._metadata_path(v), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raise IcebergConcurrentModificationException(
                f"Metadata v{v} of {self.path} was committed concurrently")
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f, indent=1)
        # The exclusive metadata write decides a race; the hint is a pointer
        # update, last writer wins.
        tmp = self._hint_path() + f".tmp{uuid.uuid4().hex}"
        with open(tmp, "w") as f:
            f.write(str(v))
        os.replace(tmp, self._hint_path())
        return v

    def current_snapshot_id(self) -> int:
        return int(self._read_metadata()["currentSnapshotId"])

    def snapshot_ids(self) -> List[int]:
        return [int(s["snapshotId"]) for s in self._read_metadata()["snapshots"]]

    def snapshot(self, snapshot_id: Optional[int] = None) -> IcebergSnapshot:
        meta = self._read_metadata()
        if snapshot_id is None:
            snapshot_id = int(meta["currentSnapshotId"])
        for s in meta["snapshots"]:
            if int(s["snapshotId"]) == snapshot_id:
                with open(os.path.join(self.path, s["manifest"])) as f:
                    return IcebergSnapshot(self.path, snapshot_id, json.load(f))
        raise HyperspaceException(f"Snapshot {snapshot_id} not found in {self.path}")

    def _write_parts(self, table: pa.Table, max_rows_per_file: Optional[int]) -> List[dict]:
        return [{"path": rel, "size": st.st_size, "modificationTime": int(st.st_mtime * 1000),
                 "recordCount": part.num_rows}
                for rel, part, st in write_parts(table, self.path, DATA_DIR, max_rows_per_file)]

    def _new_snapshot(self, files: List[dict], schema: pa.Schema, operation: str,
                      parent: Optional[int]) -> Tuple[int, dict]:
        snap_id = random.getrandbits(62)
        rel = os.path.join(METADATA_DIR, f"snap-{snap_id}.manifest.json")
        with open(os.path.join(self.path, rel), "w") as f:
            json.dump({"schemaString": schema_string(schema), "files": files}, f, indent=1)
        return snap_id, {"snapshotId": snap_id, "manifest": rel,
                         "timestampMs": int(time.time() * 1000), "operation": operation,
                         "parentSnapshotId": parent}

    def create(self, table: pa.Table, max_rows_per_file: Optional[int] = None) -> int:
        if self.exists():
            raise HyperspaceException(f"Iceberg table already exists: {self.path}")
        os.makedirs(self._meta_dir(), exist_ok=True)
        files = self._write_parts(table, max_rows_per_file)
        snap_id, snap_entry = self._new_snapshot(files, table.schema, "append", None)
        self._commit_metadata({"metadataVersion": 1, "location": self.path,
                               "currentSnapshotId": snap_id, "snapshots": [snap_entry]})
        return snap_id

    def _commit_new_state(self, files: List[dict], schema: pa.Schema, operation: str) -> int:
        meta = self._read_metadata()
        snap_id, snap_entry = self._new_snapshot(files, schema, operation,
                                                 int(meta["currentSnapshotId"]))
        self._commit_metadata({"metadataVersion": meta["metadataVersion"] + 1,
                               "location": self.path, "currentSnapshotId": snap_id,
                               "snapshots": meta["snapshots"] + [snap_entry]})
        return snap_id

    def append(self, table: pa.Table, max_rows_per_file: Optional[int] = None) -> int:
        snap = self.snapshot()
        new_files = self._write_parts(table, max_rows_per_file)
        return self._commit_new_state(snap._manifest["files"] + new_files, table.schema,
                                      "append")

    def remove_files(self, abs_paths: List[str]) -> int:
        snap = self.snapshot()
        drop = {os.path.relpath(os.path.abspath(p), self.path) for p in abs_paths}
        missing = drop - {f["path"] for f in snap._manifest["files"]}
        if missing:
            raise HyperspaceException(f"Not part of {self.path}: {sorted(missing)}")
        kept = [f for f in snap._manifest["files"] if f["path"] not in drop]
        return self._commit_new_state(kept, snap.arrow_schema(), "delete")
