"""Column-name resolution (counterpart of ``hyperspace_tpu/util/resolver.py``).

Resolves user-provided column names against a schema case-insensitively
(or sensitively, per conf).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..exceptions import HyperspaceException


def resolve(available: Sequence[str], requested: str,
            case_sensitive: bool = False) -> Optional[str]:
    """Resolve one name; returns the schema's spelling or None."""
    if case_sensitive:
        return requested if requested in available else None
    matches = [a for a in available if a.lower() == requested.lower()]
    if len(matches) > 1:
        raise HyperspaceException(
            f"Ambiguous column '{requested}' matches {matches}")
    return matches[0] if matches else None


def resolve_all(available: Sequence[str], requested: Sequence[str],
                case_sensitive: bool = False) -> List[str]:
    """Resolve all names or raise naming the first failure."""
    out = []
    for r in requested:
        resolved = resolve(available, r, case_sensitive)
        if resolved is None:
            raise HyperspaceException(
                f"Column '{r}' could not be resolved; available: {list(available)}")
        out.append(resolved)
    return out
