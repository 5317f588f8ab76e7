"""Index metadata model: the versioned, JSON-serialized operation-log entry
(counterpart of ``hyperspace_tpu/index/log_entry.py``: covering and
data-skipping indexes, and the streaming tier's table entries).

The JSON layout is the JAX package's, field for field, so either package
reads an index the other wrote.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from ..exceptions import HyperspaceException
from ..schema import Schema
from ..util import file_utils, json_utils
from .constants import IndexConstants

HYPERSPACE_VERSION = "0.1.0-tpu"
LOG_ENTRY_VERSION = "0.1"


@dataclass(frozen=True)
class FileInfo:
    """A leaf file: name (or full path), size, mtime (ms), tracker id.
    Equality and hash ignore ``id``, so files diff by (name, size, mtime)."""

    name: str
    size: int
    modifiedTime: int
    id: int = IndexConstants.UNKNOWN_FILE_ID

    def __eq__(self, other):
        return (isinstance(other, FileInfo)
                and self.name == other.name
                and self.size == other.size
                and self.modifiedTime == other.modifiedTime)

    def __hash__(self):
        return hash((self.name, self.size, self.modifiedTime))

    def to_json_dict(self) -> Dict:
        return {"name": self.name, "size": self.size,
                "modifiedTime": self.modifiedTime, "id": self.id}

    @staticmethod
    def from_json_dict(d: Dict) -> "FileInfo":
        return FileInfo(d["name"], d["size"], d["modifiedTime"],
                        d.get("id", IndexConstants.UNKNOWN_FILE_ID))


@dataclass
class Directory:
    """Tree node: directory name, leaf files, subdirectories."""

    name: str
    files: List[FileInfo] = dc_field(default_factory=list)
    subDirs: List["Directory"] = dc_field(default_factory=list)

    def merge(self, other: "Directory") -> "Directory":
        """This tree and ``other``'s: files of both, subdirectories of the
        same name merged, the rest side by side in name order."""
        if self.name != other.name:
            raise HyperspaceException(
                f"Merging directories with names {self.name} and {other.name} failed.")
        mine = {d.name: d for d in self.subDirs}
        theirs = {d.name: d for d in other.subDirs}
        merged_subdirs = []
        for dir_name in sorted(set(mine) | set(theirs)):
            if dir_name in mine and dir_name in theirs:
                merged_subdirs.append(mine[dir_name].merge(theirs[dir_name]))
            else:
                merged_subdirs.append(mine.get(dir_name) or theirs[dir_name])
        return Directory(self.name, list(self.files) + list(other.files), merged_subdirs)

    def to_json_dict(self) -> Dict:
        return {"name": self.name,
                "files": [f.to_json_dict() for f in self.files],
                "subDirs": [d.to_json_dict() for d in self.subDirs]}

    @staticmethod
    def from_json_dict(d: Dict) -> "Directory":
        return Directory(
            d["name"],
            [FileInfo.from_json_dict(f) for f in d.get("files", [])],
            [Directory.from_json_dict(s) for s in d.get("subDirs", [])])

    @staticmethod
    def from_leaf_files(paths: Sequence[str],
                        file_id_tracker: "FileIdTracker") -> "Directory":
        """Build a rooted tree from a list of leaf-file paths."""
        root = Directory(name="/")
        dir_nodes: Dict[str, Directory] = {"/": root}

        def node_for(dir_path: str) -> Directory:
            dir_path = dir_path.rstrip("/") or "/"
            if dir_path in dir_nodes:
                return dir_nodes[dir_path]
            if "://" in dir_path and "/" not in dir_path.split("://", 1)[1]:
                # An object store's root ("hsmem://bucket") is one opaque
                # child of "/": os.path.dirname would collapse its "//".
                node = Directory(name=dir_path)
                root.subDirs.append(node)
                dir_nodes[dir_path] = node
                return node
            parent = node_for(os.path.dirname(dir_path))
            node = Directory(name=os.path.basename(dir_path))
            parent.subDirs.append(node)
            dir_nodes[dir_path] = node
            return node

        # A store's paths are already rooted.
        for p in sorted(p if "://" in p else os.path.abspath(p) for p in paths):
            # Stat exactly once so the tracker key and the recorded FileInfo
            # can never disagree if the file changes mid-listing.
            full, size, mtime = file_utils.file_info_triple(p)
            fid = file_id_tracker.add_file(full, size, mtime)
            node_for(os.path.dirname(p)).files.append(
                FileInfo(os.path.basename(full), size, mtime, fid))
        return root


@dataclass
class NoOpFingerprint:
    kind: str = "NoOp"
    properties: Dict[str, str] = dc_field(default_factory=dict)

    def to_json_dict(self) -> Dict:
        return {"kind": self.kind, "properties": dict(self.properties)}

    @staticmethod
    def from_json_dict(d: Dict) -> "NoOpFingerprint":
        return NoOpFingerprint(d.get("kind", "NoOp"), d.get("properties", {}))


@dataclass
class Content:
    """Directory tree + fingerprint; enumerates its leaf files with full
    paths."""

    root: Directory
    fingerprint: NoOpFingerprint = dc_field(default_factory=NoOpFingerprint)

    def _walk(self):
        """Yield (full_path, FileInfo) for every leaf file in the tree."""

        def rec(node: Directory, prefix: str):
            if "://" in node.name:
                base = node.name  # an object store's root is absolute
            else:
                base = os.path.join(prefix, node.name) if node.name != "/" else "/"
            for f in node.files:
                full = f.name if os.path.isabs(f.name) else os.path.join(base, f.name)
                yield full, f
            for sub in node.subDirs:
                yield from rec(sub, base)

        yield from rec(self.root, "")

    @property
    def files(self) -> List[str]:
        return [full for full, _ in self._walk()]

    @property
    def file_infos(self) -> Set[FileInfo]:
        return {FileInfo(full, f.size, f.modifiedTime, f.id) for full, f in self._walk()}

    def merge(self, other: "Content") -> "Content":
        return Content(self.root.merge(other.root), self.fingerprint)

    def to_json_dict(self) -> Dict:
        return {"root": self.root.to_json_dict(),
                "fingerprint": self.fingerprint.to_json_dict()}

    @staticmethod
    def from_json_dict(d: Dict) -> "Content":
        return Content(Directory.from_json_dict(d["root"]),
                       NoOpFingerprint.from_json_dict(d.get("fingerprint", {})))

    @staticmethod
    def from_directory(path: str, file_id_tracker: "FileIdTracker") -> "Content":
        return Content(Directory.from_leaf_files(
            file_utils.list_leaf_files(path), file_id_tracker))

    @staticmethod
    def from_leaf_files(paths: Sequence[str],
                        file_id_tracker: "FileIdTracker") -> Optional["Content"]:
        if not paths:
            return None
        return Content(Directory.from_leaf_files(paths, file_id_tracker))


@dataclass
class CoveringIndex:
    """Bucketed+sorted columnar copy descriptor."""

    indexed_columns: List[str]
    included_columns: List[str]
    schema: Schema
    num_buckets: int
    properties: Dict[str, str] = dc_field(default_factory=dict)

    kind = "CoveringIndex"
    kind_abbr = "CI"

    def to_json_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "properties": {
                "columns": {"indexed": list(self.indexed_columns),
                            "included": list(self.included_columns)},
                "schema": self.schema.to_json_dict(),
                "numBuckets": self.num_buckets,
                "properties": dict(self.properties),
            },
        }

    @staticmethod
    def from_json_dict(d: Dict) -> "CoveringIndex":
        p = d["properties"]
        return CoveringIndex(
            list(p["columns"]["indexed"]), list(p["columns"]["included"]),
            Schema.from_json_dict(p["schema"]), p["numBuckets"],
            dict(p.get("properties", {})))


@dataclass
class Sketch:
    """A single data-skipping sketch over one column."""

    kind: str  # "MinMax" | "BloomFilter" | "ValueList"
    column: str
    properties: Dict[str, str] = dc_field(default_factory=dict)

    def to_json_dict(self) -> Dict:
        return {"kind": self.kind, "column": self.column,
                "properties": dict(self.properties)}

    @staticmethod
    def from_json_dict(d: Dict) -> "Sketch":
        return Sketch(d["kind"], d["column"], dict(d.get("properties", {})))


@dataclass
class DataSkippingIndex:
    """Per-source-file sketches for scan pruning."""

    sketches: List[Sketch]
    schema: Schema  # schema of the sketch table.
    properties: Dict[str, str] = dc_field(default_factory=dict)

    kind = "DataSkippingIndex"
    kind_abbr = "DS"

    # A data-skipping index has no bucketing.
    num_buckets = 1

    @property
    def indexed_columns(self) -> List[str]:
        return [s.column for s in self.sketches]

    @property
    def included_columns(self) -> List[str]:
        return []

    def to_json_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "properties": {
                "sketches": [s.to_json_dict() for s in self.sketches],
                "schema": self.schema.to_json_dict(),
                "properties": dict(self.properties),
            },
        }

    @staticmethod
    def from_json_dict(d: Dict) -> "DataSkippingIndex":
        p = d["properties"]
        return DataSkippingIndex(
            [Sketch.from_json_dict(s) for s in p["sketches"]],
            Schema.from_json_dict(p["schema"]),
            dict(p.get("properties", {})))


@dataclass
class IngestedTable:
    """The derived dataset of a streaming table's op-log entry
    (streaming/ingest.py). It has no derived data: the table's own files
    are the payload, and the entry's content records which ingested batch
    files each commit published, so recovery tells a committed batch from a
    torn one."""

    schema: Schema
    properties: Dict[str, str] = dc_field(default_factory=dict)

    kind = "IngestedTable"
    kind_abbr = "IT"

    # What the lifecycle actions read of any derived dataset.
    num_buckets = 1
    indexed_columns: List[str] = dc_field(default_factory=list)
    included_columns: List[str] = dc_field(default_factory=list)

    def to_json_dict(self) -> Dict:
        return {
            "kind": self.kind,
            "properties": {
                "schema": self.schema.to_json_dict(),
                "properties": dict(self.properties),
            },
        }

    @staticmethod
    def from_json_dict(d: Dict) -> "IngestedTable":
        p = d["properties"]
        return IngestedTable(Schema.from_json_dict(p["schema"]), dict(p.get("properties", {})))


def derived_dataset_from_json(d: Dict) -> Union[CoveringIndex, DataSkippingIndex, IngestedTable]:
    kind = d.get("kind")
    if kind == CoveringIndex.kind:
        return CoveringIndex.from_json_dict(d)
    if kind == DataSkippingIndex.kind:
        return DataSkippingIndex.from_json_dict(d)
    if kind == IngestedTable.kind:
        return IngestedTable.from_json_dict(d)
    raise HyperspaceException(f"Unknown derived dataset kind: {kind}")


@dataclass(frozen=True)
class Signature:
    provider: str
    value: str

    def to_json_dict(self) -> Dict:
        return {"provider": self.provider, "value": self.value}

    @staticmethod
    def from_json_dict(d: Dict) -> "Signature":
        return Signature(d["provider"], d["value"])


@dataclass
class LogicalPlanFingerprint:
    signatures: List[Signature]
    kind: str = "LogicalPlan"

    def to_json_dict(self) -> Dict:
        return {"kind": self.kind,
                "properties": {"signatures": [s.to_json_dict() for s in self.signatures]}}

    @staticmethod
    def from_json_dict(d: Dict) -> "LogicalPlanFingerprint":
        return LogicalPlanFingerprint(
            [Signature.from_json_dict(s) for s in d["properties"]["signatures"]],
            d.get("kind", "LogicalPlan"))


@dataclass
class Update:
    """Appended/deleted source files since content capture."""

    appendedFiles: Optional[Content] = None
    deletedFiles: Optional[Content] = None

    def to_json_dict(self) -> Dict:
        return {
            "appendedFiles": self.appendedFiles.to_json_dict() if self.appendedFiles else None,
            "deletedFiles": self.deletedFiles.to_json_dict() if self.deletedFiles else None,
        }

    @staticmethod
    def from_json_dict(d: Optional[Dict]) -> Optional["Update"]:
        if not d:
            return None
        return Update(
            Content.from_json_dict(d["appendedFiles"]) if d.get("appendedFiles") else None,
            Content.from_json_dict(d["deletedFiles"]) if d.get("deletedFiles") else None)


@dataclass
class Hdfs:
    content: Content
    update: Optional[Update] = None
    kind: str = "HDFS"

    def to_json_dict(self) -> Dict:
        return {"kind": self.kind,
                "properties": {"content": self.content.to_json_dict(),
                               "update": self.update.to_json_dict() if self.update else None}}

    @staticmethod
    def from_json_dict(d: Dict) -> "Hdfs":
        p = d["properties"]
        return Hdfs(Content.from_json_dict(p["content"]),
                    Update.from_json_dict(p.get("update")), d.get("kind", "HDFS"))


@dataclass
class Relation:
    """Source relation descriptor."""

    rootPaths: List[str]
    data: Hdfs
    dataSchema: Schema
    fileFormat: str
    options: Dict[str, str] = dc_field(default_factory=dict)

    def to_json_dict(self) -> Dict:
        return {"rootPaths": list(self.rootPaths), "data": self.data.to_json_dict(),
                "dataSchema": self.dataSchema.to_json_dict(),
                "fileFormat": self.fileFormat, "options": dict(self.options)}

    @staticmethod
    def from_json_dict(d: Dict) -> "Relation":
        return Relation(list(d["rootPaths"]), Hdfs.from_json_dict(d["data"]),
                        Schema.from_json_dict(d["dataSchema"]), d["fileFormat"],
                        dict(d.get("options", {})))


@dataclass
class SourcePlan:
    """Source plan: relations + fingerprint."""

    relations: List[Relation]
    fingerprint: LogicalPlanFingerprint
    rawPlan: Optional[str] = None
    sql: Optional[str] = None
    kind: str = "Plan"

    def to_json_dict(self) -> Dict:
        return {"kind": self.kind,
                "properties": {"relations": [r.to_json_dict() for r in self.relations],
                               "rawPlan": self.rawPlan, "sql": self.sql,
                               "fingerprint": self.fingerprint.to_json_dict()}}

    @staticmethod
    def from_json_dict(d: Dict) -> "SourcePlan":
        p = d["properties"]
        return SourcePlan(
            [Relation.from_json_dict(r) for r in p["relations"]],
            LogicalPlanFingerprint.from_json_dict(p["fingerprint"]),
            p.get("rawPlan"), p.get("sql"), d.get("kind", "Plan"))


@dataclass
class Source:
    plan: SourcePlan

    def to_json_dict(self) -> Dict:
        return {"plan": self.plan.to_json_dict()}

    @staticmethod
    def from_json_dict(d: Dict) -> "Source":
        return Source(SourcePlan.from_json_dict(d["plan"]))


@dataclass
class IndexLogEntry:
    """One committed version of an index's metadata."""

    state: str = ""
    id: int = 0
    timestamp: int = 0
    version: str = LOG_ENTRY_VERSION
    name: str = ""
    derivedDataset: Union[CoveringIndex, DataSkippingIndex] = None
    content: Content = None
    source: Source = None
    properties: Dict[str, str] = dc_field(default_factory=dict)

    @property
    def relation(self) -> Relation:
        if len(self.source.plan.relations) != 1:
            raise HyperspaceException("An index entry must have exactly one relation")
        return self.source.plan.relations[0]

    @property
    def source_file_info_set(self) -> Set[FileInfo]:
        return self.relation.data.content.file_infos

    @property
    def source_files_size_in_bytes(self) -> int:
        return sum(f.size for f in self.source_file_info_set)

    @property
    def index_files_size_in_bytes(self) -> int:
        return sum(f.size for f in self.content.file_infos)

    @property
    def source_update(self) -> Optional[Update]:
        return self.relation.data.update

    @property
    def appended_files(self) -> Set[FileInfo]:
        """Source files a quick refresh recorded as appended."""
        u = self.source_update
        return u.appendedFiles.file_infos if u and u.appendedFiles else set()

    @property
    def deleted_files(self) -> Set[FileInfo]:
        """Source files a quick refresh recorded as deleted."""
        u = self.source_update
        return u.deletedFiles.file_infos if u and u.deletedFiles else set()

    def has_lineage_column(self) -> bool:
        return self.derivedDataset.properties.get(
            IndexConstants.LINEAGE_PROPERTY, "false").lower() == "true"

    @property
    def signature(self) -> LogicalPlanFingerprint:
        return self.source.plan.fingerprint

    @property
    def num_buckets(self) -> int:
        return self.derivedDataset.num_buckets

    @property
    def indexed_columns(self) -> List[str]:
        return self.derivedDataset.indexed_columns

    @property
    def included_columns(self) -> List[str]:
        return self.derivedDataset.included_columns

    @property
    def schema(self) -> Schema:
        return self.derivedDataset.schema

    @property
    def log_version(self) -> int:
        return int(self.properties.get(IndexConstants.INDEX_LOG_VERSION, self.id))

    def with_log_version(self, version: int) -> "IndexLogEntry":
        props = dict(self.properties)
        props[IndexConstants.INDEX_LOG_VERSION] = str(version)
        return IndexLogEntry(
            state=self.state, id=self.id, timestamp=self.timestamp, version=self.version,
            name=self.name, derivedDataset=self.derivedDataset, content=self.content,
            source=self.source, properties=props)

    def to_json_dict(self) -> Dict:
        return {
            "name": self.name,
            "derivedDataset": self.derivedDataset.to_json_dict(),
            "content": self.content.to_json_dict(),
            "source": self.source.to_json_dict(),
            "properties": dict(self.properties),
            "state": self.state,
            "id": self.id,
            "timestamp": self.timestamp,
            "version": self.version,
        }

    def to_json(self) -> str:
        return json_utils.to_json(self.to_json_dict())

    @staticmethod
    def from_json_dict(d: Dict) -> "IndexLogEntry":
        return IndexLogEntry(
            state=d["state"], id=d["id"], timestamp=d.get("timestamp", 0),
            version=d.get("version", LOG_ENTRY_VERSION), name=d["name"],
            derivedDataset=derived_dataset_from_json(d["derivedDataset"]),
            content=Content.from_json_dict(d["content"]),
            source=Source.from_json_dict(d["source"]),
            properties=dict(d.get("properties", {})))

    @staticmethod
    def from_json(text: str) -> "IndexLogEntry":
        return IndexLogEntry.from_json_dict(json_utils.from_json(text))

    @staticmethod
    def create(name: str, derived_dataset, content: Content, source: Source,
               properties: Dict[str, str]) -> "IndexLogEntry":
        props = dict(properties)
        props[IndexConstants.HYPERSPACE_VERSION_PROPERTY] = HYPERSPACE_VERSION
        return IndexLogEntry(name=name, derivedDataset=derived_dataset, content=content,
                             source=source, properties=props)


class FileIdTracker:
    """Generates unique ids per (path, size, mtime) triple."""

    def __init__(self):
        self._max_id = -1
        self._file_to_id: Dict[Tuple[str, int, int], int] = {}

    def add_file_info(self, files: Set[FileInfo]) -> None:
        """Seed the tracker with already-numbered files (a refresh keeps
        the previous entry's source ids); new files then number past them."""
        for f in files:
            if f.id == IndexConstants.UNKNOWN_FILE_ID:
                raise HyperspaceException(
                    f"Cannot add file info with unknown id. (file: {f.name}).")
            key = (f.name, f.size, f.modifiedTime)
            existing = self._file_to_id.get(key)
            if existing is not None:
                if existing != f.id:
                    raise HyperspaceException(
                        "Adding file info with a conflicting id. "
                        f"(existing id: {existing}, new id: {f.id}, file: {f.name}).")
            else:
                self._file_to_id[key] = f.id
                self._max_id = max(self._max_id, f.id)

    def add_file(self, path: str, size: int, mtime: int) -> int:
        key = (path, size, mtime)
        if key not in self._file_to_id:
            self._max_id += 1
            self._file_to_id[key] = self._max_id
        return self._file_to_id[key]
