"""User-facing index statistics rows (counterpart of
``hyperspace_tpu/index/statistics.py``): the summary row of
``Hyperspace.indexes()`` and the extended row of ``Hyperspace.index(name)``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

from .log_entry import IndexLogEntry


@dataclass
class IndexStatistics:
    name: str
    indexed_columns: List[str]
    included_columns: List[str]
    num_buckets: int
    schema_json: str
    index_location: str
    state: str
    lineage_enabled: bool
    source_file_count: int
    source_size_bytes: int
    index_file_count: int
    index_size_bytes: int
    appended_file_count: int
    deleted_file_count: int
    index_content_paths: List[str]
    # Times a real rewrite pass of this session applied the index (query
    # executions and optimized_plan() calls); explain and why_not never
    # count (rules/rule_utils.log_index_usage).
    usage_count: int = 0

    SUMMARY_COLUMNS = ["name", "indexedColumns", "includedColumns", "numBuckets",
                       "schema", "indexLocation", "state", "usageCount"]

    @staticmethod
    def from_entry(entry: IndexLogEntry, usage_count: int = 0) -> "IndexStatistics":
        content_files = entry.content.files
        # The directory of the newest index file: its version directory.
        location = os.path.dirname(sorted(content_files)[-1]) if content_files else ""
        return IndexStatistics(
            name=entry.name,
            indexed_columns=list(entry.indexed_columns),
            included_columns=list(entry.included_columns),
            num_buckets=entry.num_buckets,
            schema_json=json.dumps(entry.schema.to_json_dict()),
            index_location=location,
            state=entry.state,
            lineage_enabled=entry.has_lineage_column(),
            source_file_count=len(entry.source_file_info_set),
            source_size_bytes=entry.source_files_size_in_bytes,
            index_file_count=len(entry.content.file_infos),
            index_size_bytes=entry.index_files_size_in_bytes,
            appended_file_count=len(entry.appended_files),
            deleted_file_count=len(entry.deleted_files),
            index_content_paths=sorted({p.rsplit("/", 1)[0] for p in content_files}),
            usage_count=usage_count)

    def to_row(self) -> Dict:
        return {
            "name": self.name,
            "indexedColumns": self.indexed_columns,
            "includedColumns": self.included_columns,
            "numBuckets": self.num_buckets,
            "schema": self.schema_json,
            "indexLocation": self.index_location,
            "state": self.state,
            "usageCount": self.usage_count,
        }

    def to_extended_row(self) -> Dict:
        row = self.to_row()
        row.update({
            "lineageEnabled": self.lineage_enabled,
            "sourceFileCount": self.source_file_count,
            "sourceSizeBytes": self.source_size_bytes,
            "indexFileCount": self.index_file_count,
            "indexSizeBytes": self.index_size_bytes,
            "appendedFileCount": self.appended_file_count,
            "deletedFileCount": self.deleted_file_count,
            "indexContentPaths": self.index_content_paths,
        })
        return row
