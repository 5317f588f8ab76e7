"""Logical-plan signature providers: index validity fingerprints
(counterpart of ``hyperspace_tpu/index/signatures.py``).

An index applies to a plan iff the plan's fingerprint, computed by the
provider recorded in the index's metadata, matches the one stored at
creation. Providers are recorded by dotted class path; either package's
path resolves here by its class name, so both packages' logs are read.
"""

from __future__ import annotations

from typing import Optional

from ..exceptions import HyperspaceException
from ..util import hashing


class LogicalPlanSignatureProvider:
    def name(self) -> str:
        return f"{type(self).__module__}.{type(self).__qualname__}"

    def signature(self, plan) -> Optional[str]:
        """Fingerprint of the plan, or None if this provider can't handle it."""
        raise NotImplementedError

    @staticmethod
    def create(name: Optional[str] = None) -> "LogicalPlanSignatureProvider":
        if name is None:
            return IndexSignatureProvider()
        known = {cls.__name__: cls for cls in (
            FileBasedSignatureProvider, PlanSignatureProvider, IndexSignatureProvider)}
        cls = known.get(name.rpartition(".")[2])
        if cls is None:
            raise HyperspaceException(f"Unknown signature provider: {name}")
        return cls()


class FileBasedSignatureProvider(LogicalPlanSignatureProvider):
    """md5 over each source file's (size, mtime, path), combined across all
    file-based relation leaves of the plan."""

    def signature(self, plan) -> Optional[str]:
        parts = []
        for leaf in plan.collect_leaves():
            relation = getattr(leaf, "relation", None)
            if relation is None:
                return None
            for path, size, mtime in relation.all_file_infos():
                parts.append(f"{size}{mtime}{path}")
        if not parts:
            return None
        return hashing.md5_hex("".join(parts))


class PlanSignatureProvider(LogicalPlanSignatureProvider):
    """md5 over the plan's operator node names (structure fingerprint)."""

    def signature(self, plan) -> Optional[str]:
        return hashing.md5_hex("".join(plan.node_names_preorder()))


class IndexSignatureProvider(LogicalPlanSignatureProvider):
    """File-based + plan signatures combined -- the default provider."""

    def signature(self, plan) -> Optional[str]:
        fb = FileBasedSignatureProvider().signature(plan)
        if fb is None:
            return None
        return hashing.md5_hex(fb + PlanSignatureProvider().signature(plan))
