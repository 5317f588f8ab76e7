"""Commit-log versioned parquet tables, the Delta Lake analogue
(counterpart of ``hyperspace_tpu/lake/delta.py``; the layout is the same,
so either package reads the other's tables)::

    <table>/part-<uuid>.parquet
    <table>/_delta_log/00000000000000000000.json   (version 0)
    <table>/_delta_log/00000000000000000001.json   (version 1)

A commit file is newline-delimited JSON actions: ``metaData`` (the schema),
``add`` (a file enters the table), ``remove`` (a file leaves) and
``commitInfo`` (operation and timestamp). The snapshot at version v folds
the actions of commits 0..v. Commits are created exclusively (O_EXCL), so
two writers of one version conflict instead of overwriting each other.
"""

from __future__ import annotations

import base64
import json
import os
import time
import uuid
from typing import Dict, List, Optional, Tuple

import pyarrow as pa
import pyarrow.ipc as ipc
import pyarrow.parquet as pq

from ..exceptions import HyperspaceException

LOG_DIR = "_delta_log"


class DeltaConcurrentModificationException(HyperspaceException):
    pass


def _commit_path(table_path: str, version: int) -> str:
    return os.path.join(table_path, LOG_DIR, f"{version:020d}.json")


def schema_string(schema: pa.Schema) -> str:
    """The arrow schema as base64 IPC bytes (the tables' ``schemaString``)."""
    return base64.b64encode(schema.serialize().to_pybytes()).decode()


def schema_from_string(text: Optional[str]) -> Optional[pa.Schema]:
    if text is None:
        return None
    return ipc.read_schema(pa.BufferReader(base64.b64decode(text)))


def write_parts(table: pa.Table, table_path: str, rel_dir: str,
                max_rows_per_file: Optional[int]) -> List[Tuple[str, pa.Table, os.stat_result]]:
    """``table`` as parquet parts of at most ``max_rows_per_file`` rows (one
    part, possibly empty, by default) under ``table_path/rel_dir``:
    (path relative to the table, the part, its stat) each."""
    os.makedirs(os.path.join(table_path, rel_dir), exist_ok=True)
    out = []
    n = table.num_rows
    chunk = max_rows_per_file or max(n, 1)
    for offset in range(0, max(n, 1), chunk):
        part = table.slice(offset, chunk)
        rel = os.path.join(rel_dir, f"part-{uuid.uuid4().hex}.parquet")
        abs_path = os.path.join(table_path, rel)
        pq.write_table(part, abs_path)
        out.append((rel, part, os.stat(abs_path)))
    return out


def _now_ms() -> int:
    return int(time.time() * 1000)


class Snapshot:
    """A table's state at one version."""

    def __init__(self, table_path: str, version: int, files: Dict[str, dict],
                 schema_str: Optional[str]):
        self.table_path = table_path
        self.version = version
        self._files = files  # relative path -> its add action
        self.schema_string = schema_str

    @property
    def file_paths(self) -> List[str]:
        return sorted(os.path.join(self.table_path, p) for p in self._files)

    @property
    def file_infos(self) -> List[Tuple[str, int, int]]:
        """(absolute path, size, modificationTime ms) from the log: the
        lake's metadata is authoritative, no file is stat'ed."""
        return [(os.path.join(self.table_path, rel), int(self._files[rel].get("size", 0)),
                 int(self._files[rel].get("modificationTime", 0)))
                for rel in sorted(self._files)]

    def arrow_schema(self) -> Optional[pa.Schema]:
        return schema_from_string(self.schema_string)


class DeltaTable:
    """Reader and writer of commit-log tables."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def _log_versions(self) -> List[int]:
        log_dir = os.path.join(self.path, LOG_DIR)
        if not os.path.isdir(log_dir):
            return []
        out = []
        for name in os.listdir(log_dir):
            if name.endswith(".json") and name[:-5].isdigit():
                out.append(int(name[:-5]))
        return sorted(out)

    def exists(self) -> bool:
        return bool(self._log_versions())

    def latest_version(self) -> int:
        versions = self._log_versions()
        if not versions:
            raise HyperspaceException(f"Not a delta table: {self.path}")
        return versions[-1]

    def _read_commit(self, version: int) -> List[dict]:
        with open(_commit_path(self.path, version)) as f:
            return [json.loads(line) for line in f if line.strip()]

    def _write_commit(self, version: int, actions: List[dict]) -> None:
        os.makedirs(os.path.join(self.path, LOG_DIR), exist_ok=True)
        try:
            fd = os.open(_commit_path(self.path, version), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raise DeltaConcurrentModificationException(
                f"Version {version} of {self.path} was committed concurrently")
        with os.fdopen(fd, "w") as f:
            for a in actions:
                f.write(json.dumps(a) + "\n")

    def snapshot(self, version: Optional[int] = None) -> Snapshot:
        versions = self._log_versions()
        if not versions:
            raise HyperspaceException(f"Not a delta table: {self.path}")
        if version is None:
            version = versions[-1]
        if version not in versions:
            raise HyperspaceException(
                f"Version {version} does not exist for {self.path} "
                f"(available: {versions[0]}..{versions[-1]})")
        files: Dict[str, dict] = {}
        schema_str = None
        for v in versions:
            if v > version:
                break
            for action in self._read_commit(v):
                if "add" in action:
                    files[action["add"]["path"]] = action["add"]
                elif "remove" in action:
                    files.pop(action["remove"]["path"], None)
                elif "metaData" in action:
                    schema_str = action["metaData"].get("schemaString", schema_str)
        return Snapshot(self.path, version, files, schema_str)

    def history(self) -> List[dict]:
        out = []
        for v in self._log_versions():
            for action in self._read_commit(v):
                if "commitInfo" in action:
                    out.append(dict(action["commitInfo"], version=v))
        return out

    def _add_actions(self, table: pa.Table, max_rows_per_file: Optional[int]) -> List[dict]:
        return [{"add": {"path": rel, "size": st.st_size,
                         "modificationTime": int(st.st_mtime * 1000), "dataChange": True}}
                for rel, _, st in write_parts(table, self.path, "", max_rows_per_file)]

    @staticmethod
    def _metadata(schema: pa.Schema) -> dict:
        return {"metaData": {"id": uuid.uuid4().hex, "schemaString": schema_string(schema),
                             "partitionColumns": []}}

    @staticmethod
    def _commit_info(operation: str) -> dict:
        return {"commitInfo": {"operation": operation, "timestamp": _now_ms()}}

    @staticmethod
    def _remove(rel: str) -> dict:
        return {"remove": {"path": rel, "deletionTimestamp": _now_ms(), "dataChange": True}}

    def create(self, table: pa.Table, max_rows_per_file: Optional[int] = None) -> int:
        """Write version 0; the table must not exist yet."""
        if self.exists():
            raise HyperspaceException(f"Delta table already exists: {self.path}")
        self._write_commit(0, [self._metadata(table.schema)]
                           + self._add_actions(table, max_rows_per_file)
                           + [self._commit_info("WRITE")])
        return 0

    def append(self, table: pa.Table, max_rows_per_file: Optional[int] = None) -> int:
        version = self.latest_version() + 1
        self._write_commit(version, self._add_actions(table, max_rows_per_file)
                           + [self._commit_info("APPEND")])
        return version

    def remove_files(self, abs_paths: List[str]) -> int:
        """Take data files out of the table (a file-granularity delete)."""
        snap = self.snapshot()
        actions = []
        for p in abs_paths:
            rel = os.path.relpath(os.path.abspath(p), self.path)
            if rel not in snap._files:
                raise HyperspaceException(f"{p} is not part of {self.path}")
            actions.append(self._remove(rel))
        self._write_commit(snap.version + 1, actions + [self._commit_info("DELETE")])
        return snap.version + 1

    def overwrite(self, table: pa.Table, max_rows_per_file: Optional[int] = None) -> int:
        snap = self.snapshot()
        self._write_commit(snap.version + 1,
                           [self._remove(rel) for rel in sorted(snap._files)]
                           + [self._metadata(table.schema)]
                           + self._add_actions(table, max_rows_per_file)
                           + [self._commit_info("OVERWRITE")])
        return snap.version + 1
