"""Default file-based source provider: parquet, csv, json, orc, text and
avro directories on the local filesystem (counterpart of
``hyperspace_tpu/sources/default.py``). A relation lists the files whose
suffix names its format. Hive ``key=value`` directories under the first
root path become partition columns, after the files' own columns
(sources/partitions.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import pyarrow.dataset as pa_ds
import pyarrow.parquet as pq

from ..exceptions import HyperspaceException
from ..schema import STRING, Field, Schema
from ..util import file_utils
from .interfaces import FileBasedRelation, FileBasedSourceProvider

SUPPORTED_FORMATS = ("parquet", "csv", "json", "orc", "text", "avro")

# File suffixes per format ("text" also matches ".txt").
_FORMAT_SUFFIXES = {fmt: ("." + fmt,) for fmt in SUPPORTED_FORMATS}
_FORMAT_SUFFIXES["text"] = (".text", ".txt")


class DefaultFileBasedRelation(FileBasedRelation):
    def __init__(self, paths: Sequence[str], fmt: str = "parquet",
                 options: Optional[Dict[str, str]] = None):
        if fmt not in SUPPORTED_FORMATS:
            raise HyperspaceException(f"Unsupported format: {fmt}")
        self._root_paths = [os.path.abspath(p) for p in paths]
        self._format = fmt
        self._options = dict(options or {})
        self._schema: Optional[Schema] = None
        self._files: Optional[List[str]] = None
        # with_files() keeps the original base, so a pruned relation still
        # sees its partitions.
        self._partition_base = self._root_paths[0] if self._root_paths else ""
        self._partition_fields: Optional[List[Field]] = None

    @property
    def root_paths(self) -> List[str]:
        return list(self._root_paths)

    @property
    def file_format(self) -> str:
        return self._format

    @property
    def options(self) -> Dict[str, str]:
        return dict(self._options)

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            schema = self._physical_schema()
            for f in self.partition_fields():
                if f.name not in schema:
                    schema = schema.append(f)
            self._schema = schema
        return self._schema

    def _physical_schema(self) -> Schema:
        """The first file's schema: its footer (parquet), its header
        (avro), pyarrow's inference (csv, json, orc), or one non-null
        string column "value" (text)."""
        files = self.all_files()
        if not files:
            raise HyperspaceException(f"No data files under {self._root_paths}")
        if self._format == "parquet":
            return Schema.from_arrow(pq.read_schema(files[0]))
        if self._format == "text":
            return Schema([Field("value", STRING, False)])
        if self._format == "avro":
            from ..util.avro import read_avro_schema
            return Schema.from_arrow(read_avro_schema(files[0]))
        return Schema.from_arrow(pa_ds.dataset(files[0], format=self._format).schema)

    @property
    def partition_base_path(self) -> str:
        return self._partition_base

    def partition_fields(self) -> List[Field]:
        if self._partition_fields is None:
            from .partitions import infer_partition_fields
            self._partition_fields = infer_partition_fields(
                self._partition_base, self.all_files())
        return list(self._partition_fields)

    def all_files(self) -> List[str]:
        if self._files is None:
            out: List[str] = []
            suffixes = _FORMAT_SUFFIXES[self._format]
            for root in self._root_paths:
                if os.path.isfile(root):
                    out.append(os.path.abspath(root))
                    continue
                out.extend(f for f in file_utils.list_leaf_files(root)
                           if f.endswith(suffixes))
            self._files = sorted(out)
        return list(self._files)

    @classmethod
    def pinned(cls, root_paths, fmt: str, options, files,
               schema: Schema) -> "DefaultFileBasedRelation":
        """A relation pinned to a given listing and schema: it touches the
        filesystem for neither a footer nor partition inference (the
        streaming commit builds one per index per commit and knows both)."""
        rel = cls(list(root_paths), fmt, dict(options or {}))
        rel._schema = schema
        rel._files = sorted(os.path.abspath(f) for f in files)
        rel._partition_fields = []
        return rel

    def refresh(self) -> "DefaultFileBasedRelation":
        return DefaultFileBasedRelation(self._root_paths, self._format, self._options)

    def with_files(self, files: Sequence[str]) -> "DefaultFileBasedRelation":
        pruned = DefaultFileBasedRelation(list(files), self._format, self._options)
        pruned._schema = self.schema
        pruned._files = sorted(os.path.abspath(f) for f in files)
        pruned._partition_base = self._partition_base
        pruned._partition_fields = self.partition_fields()
        return pruned


class DefaultFileBasedSourceBuilder(FileBasedSourceProvider):
    def get_relation(self, plan_leaf) -> Optional[FileBasedRelation]:
        relation = getattr(plan_leaf, "relation", None)
        if isinstance(relation, DefaultFileBasedRelation):
            return relation
        return None

    def build_relation(self, paths: Sequence[str], fmt: str,
                       options: Dict[str, str]) -> Optional[FileBasedRelation]:
        if fmt in SUPPORTED_FORMATS:
            return DefaultFileBasedRelation(paths, fmt, options)
        return None
