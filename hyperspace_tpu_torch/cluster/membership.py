"""Lake-resident cluster membership: register, heartbeat, expire
(counterpart of ``hyperspace_tpu/cluster/membership.py``, with the same
record format, so workers of both packages read one roster).

One JSON record per worker under ``<system path>/_hst_cluster/``:
registration is an O_EXCL create (a second live claimant of an id loses),
the heartbeat an atomic rewrite (tmp + ``os.replace``) with a fresh time,
and expiry is read-side staleness: a record older than
``cluster.staleness.ms`` is a dead worker and is routed around. Readers
skip torn records; the next heartbeat repairs them.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from ..parallel import io as pio
from .constants import CLUSTER_DIR_NAME


@dataclass(frozen=True)
class MemberInfo:
    worker_id: str
    host: str
    port: int
    pid: int
    started_ms: float
    heartbeat_ms: float


def membership_dir(session) -> str:
    """The roster directory of the session's lake (the conf's, else
    ``<system path>/_hst_cluster``)."""
    override = session.hs_conf.cluster_dir()
    if override:
        return override
    return os.path.join(session.hs_conf.system_path(), CLUSTER_DIR_NAME)


def _record_path(root: str, worker_id: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", worker_id)
    return os.path.join(root, f"member-{safe}.json")


def _now_ms() -> float:
    return time.time() * 1000.0


class Membership:
    """One worker's view of the roster: its own record, and reads of
    everyone's, expiring by staleness."""

    def __init__(self, session, worker_id: str, host: str, port: int):
        self._session = session
        self._root = membership_dir(session)
        self.worker_id = worker_id
        self._host = host
        self._port = port
        self._started_ms = _now_ms()
        self._stop = threading.Event()

    def register(self) -> None:
        """Claim this worker's identity put-if-absent. Raises
        FileExistsError while a live record holds the id; a stale one is
        taken over in place."""
        os.makedirs(self._root, exist_ok=True)
        path = _record_path(self._root, self.worker_id)
        record = self._record()
        try:
            with open(path, "x", encoding="utf-8") as f:
                f.write(record)
        except FileExistsError:
            existing = _read_record(path)
            if existing is not None and not self._is_stale(existing):
                raise
            _atomic_write(path, record)

    def start_heartbeat(self) -> None:
        interval_s = max(self._session.hs_conf.cluster_heartbeat_ms() / 1000.0, 0.05)

        def _loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.heartbeat()
                except OSError:
                    pass  # the next beat tries again

        pio.spawn_daemon("hst-cluster-heartbeat", _loop)

    def heartbeat(self) -> None:
        _atomic_write(_record_path(self._root, self.worker_id), self._record())

    def leave(self) -> None:
        self._stop.set()
        try:
            os.remove(_record_path(self._root, self.worker_id))
        except OSError:
            pass  # gone already, or staleness expires it

    def _record(self) -> str:
        return json.dumps({"worker_id": self.worker_id, "host": self._host,
                           "port": self._port, "pid": os.getpid(),
                           "started_ms": self._started_ms, "heartbeat_ms": _now_ms()})

    def _is_stale(self, info: MemberInfo) -> bool:
        return _now_ms() - info.heartbeat_ms > self._session.hs_conf.cluster_staleness_ms()

    def live_members(self) -> List[MemberInfo]:
        """Every record that is not stale, this worker's included, sorted by
        worker id."""
        out: List[MemberInfo] = []
        try:
            names = sorted(os.listdir(self._root))
        except OSError:
            return out
        for name in names:
            if not (name.startswith("member-") and name.endswith(".json")):
                continue
            info = _read_record(os.path.join(self._root, name))
            if info is not None and not self._is_stale(info):
                out.append(info)
        return sorted(out, key=lambda m: m.worker_id)

    def peers(self) -> List[MemberInfo]:
        return [m for m in self.live_members() if m.worker_id != self.worker_id]


def _read_record(path: str) -> Optional[MemberInfo]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.loads(f.read())
        return MemberInfo(worker_id=str(d["worker_id"]), host=str(d["host"]),
                          port=int(d["port"]), pid=int(d["pid"]),
                          started_ms=float(d["started_ms"]),
                          heartbeat_ms=float(d["heartbeat_ms"]))
    except (OSError, ValueError, KeyError, TypeError):
        return None  # a torn write or a foreign file


def _atomic_write(path: str, text: str) -> None:
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)
