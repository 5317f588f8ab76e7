"""Consistent-hash ring sharding the result cache across the fleet
(counterpart of ``hyperspace_tpu/cluster/hashring.py``, with the same
points, so both packages give every key the same owner).

Each member puts ``vnodes`` points (md5 of ``"<worker_id>#<i>"``) on a
2**128 ring; a key's owner is the first point clockwise from the key's own
md5. A member joining or leaving moves only the keys whose arcs changed,
about 1/N of them. The ring is immutable: the router builds one from the
live roster per decision.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Optional, Sequence


def _point(token: str) -> int:
    return int(hashlib.md5(token.encode("utf-8")).hexdigest(), 16)


class HashRing:
    """An immutable consistent-hash ring over worker ids."""

    __slots__ = ("_points", "_owners", "_members")

    def __init__(self, member_ids: Sequence[str], vnodes: int = 64):
        members = sorted(set(member_ids))
        pairs = sorted((_point(f"{wid}#{i}"), wid) for wid in members
                       for i in range(max(int(vnodes), 1)))
        self._points = [p for p, _ in pairs]
        self._owners = [w for _, w in pairs]
        self._members = tuple(members)

    @property
    def members(self) -> tuple:
        return self._members

    def __len__(self) -> int:
        return len(self._members)

    def owner(self, key: str) -> Optional[str]:
        """The worker id owning ``key`` (a digest string); None on an empty
        ring."""
        if not self._points:
            return None
        idx = bisect.bisect_right(self._points, _point(key))
        return self._owners[idx % len(self._points)]
