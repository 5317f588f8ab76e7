"""Source abstraction (counterpart of ``hyperspace_tpu/sources/interfaces.py``).

A relation describes a file-based dataset (root paths + format + schema) and
exposes what the rules and actions need: file listing, fingerprint input,
and the hook through which a versioned source adds its properties to an
index's log entry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..exceptions import HyperspaceException
from ..schema import Field, Schema
from ..util import file_utils


class FileBasedRelation:
    """Abstract relation over lake files."""

    @property
    def root_paths(self) -> List[str]:
        raise NotImplementedError

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def file_format(self) -> str:
        raise NotImplementedError

    @property
    def data_file_format(self) -> str:
        """The format of the leaf files (a versioned table format is a
        logical wrapper over parquet parts)."""
        return self.file_format

    @property
    def options(self) -> Dict[str, str]:
        return {}

    def all_files(self) -> List[str]:
        """All leaf data files, absolute paths, deterministic order."""
        raise NotImplementedError

    def all_file_infos(self) -> List[Tuple[str, int, int]]:
        """(path, size, mtime_ms) for each file in all_files()."""
        return [file_utils.file_info_triple(p) for p in self.all_files()]

    @property
    def partition_base_path(self) -> str:
        """The directory whose ``key=value`` levels name the partitions."""
        return self.root_paths[0] if self.root_paths else ""

    def partition_fields(self) -> List[Field]:
        """The hive partition columns, which the files do not hold; none by
        default."""
        return []

    def describe(self) -> str:
        return f"{self.file_format} {','.join(self.root_paths)}"

    def enrich_index_properties(self, props: Dict[str, str],
                                index_log_version: int) -> Dict[str, str]:
        """Source-specific properties for an index log entry committed at
        ``index_log_version`` (a delta table records its version history);
        none by default."""
        return props

    def refresh(self) -> "FileBasedRelation":
        """The same relation listed anew (a refresh diffs it against the
        files the index recorded)."""
        raise NotImplementedError

    def with_files(self, files: Sequence[str]) -> "FileBasedRelation":
        """A copy of this relation restricted to ``files`` (data-skipping
        scan pruning). Schema is preserved even when files is empty."""
        raise NotImplementedError


class FileBasedSourceProvider:
    """Builds relations it understands; returns None for ones it doesn't."""

    def name(self) -> str:
        return type(self).__name__

    def get_relation(self, plan_leaf) -> Optional[FileBasedRelation]:
        """If the leaf Scan's relation belongs to this provider, return it."""
        raise NotImplementedError

    def build_relation(self, paths: Sequence[str], fmt: str,
                       options: Dict[str, str]) -> Optional[FileBasedRelation]:
        raise NotImplementedError


class FileBasedSourceProviderManager:
    """Runs each provider in turn; exactly one must answer."""

    def __init__(self, providers: List[FileBasedSourceProvider]):
        if not providers:
            raise HyperspaceException("At least one source provider is required.")
        self._providers = providers

    def _run(self, fn_name: str, *args):
        answers = [r for r in (getattr(p, fn_name)(*args) for p in self._providers)
                   if r is not None]
        if len(answers) != 1:
            names = ", ".join(type(p).__name__ for p in self._providers)
            raise HyperspaceException(
                f"Exactly one provider must respond to {fn_name}{args[1:2]}; "
                f"got {len(answers)} of {len(self._providers)} ({names}).")
        return answers[0]

    def get_relation(self, plan_leaf) -> FileBasedRelation:
        return self._run("get_relation", plan_leaf)

    def build_relation(self, paths: Sequence[str], fmt: str,
                       options: Dict[str, str]) -> FileBasedRelation:
        return self._run("build_relation", paths, fmt, options)

    def is_supported_relation(self, plan_leaf) -> bool:
        answers = [p.get_relation(plan_leaf) for p in self._providers]
        return sum(1 for a in answers if a is not None) == 1
