"""Lake-resident store of the port's compiled kernel libraries
(counterpart of ``hyperspace_tpu/artifacts/store.py``, the same contract).

Layout (under ``<root>``, by default ``<system path>/_hst_artifacts``):

    v1/kernel/<digest>.hsa    one blob per built library
    v1/kernel/usage.json      persisted per-artifact usage tallies
    v1/kernel/.tmp-*          in-flight publications (vacuumed)

The JAX package's blobs sit in ``v1/`` itself; the port's kind directory
keeps the two packages' blobs, tallies and sweeps apart on one root (the
JAX package's vacuum removes every ``v1/*.hsa`` its runtime cannot load).

A blob is one utf-8 JSON header line carrying the FULL key (format
version, kind, kernel name, a digest of the nvcc flags and the kernel's
sources, the torch and CUDA versions, nvcc's version, the device's
compute capability) plus the payload's length and md5, followed by the
payload: the library's bytes. The filename digest is computed from the
same key fields, so a key mismatch (another card, toolkit or source)
addresses a file that does not exist: a silent MISS, and the kernel is
built with nvcc. A header that disagrees with its key or a checksum that
fails is a miss too: the blob is quarantined (deleted), an
``ArtifactMissEvent(reason="corrupt")`` is emitted and
``artifact_corruptions`` counts it. It is never loaded as a kernel.

Publication is the op-log idiom: fsync'd temp + link-into-place
put-if-absent (losing a cross-process race is success: the winner's bytes
are the same library). The ``artifacts.write`` fault point sits between
the temp write and the link, so a kill there leaves only whole blobs; the
temp is swept by :meth:`ArtifactStore.vacuum` (riding
``Hyperspace.compact()``/``recover()``).

A blob in the kind directory whose header has none of the port's runtime
fields is foreign: never a hit, never quarantined, left alone by vacuum.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..util import hashing
from .constants import ARTIFACT_FORMAT_VERSION, KERNEL_KIND

BLOB_SUFFIX = ".hsa"
TMP_PREFIX = ".tmp-"
USAGE_FILE = "usage.json"

# Key fields serialized into every header, in this order. "sources" is the
# digest of the nvcc flags and the kernel's sources (ops/cuda_kernels.py).
_KEY_FIELDS = ("format", "kind", "kernel", "sources",
               "torch", "cuda", "nvcc", "arch")
_ENV_FIELDS = ("torch", "cuda", "nvcc", "arch")


def runtime_env() -> Dict[str, str]:
    """The environment half of every artifact key: a library loads only
    under the toolkit and card it was built for, so anything else must be
    a silent MISS."""
    from ..ops import cuda_kernels
    return cuda_kernels.runtime_env()


def key_fields(kernel: str, sources: str,
               env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = env or runtime_env()
    out = {"format": str(ARTIFACT_FORMAT_VERSION), "kind": KERNEL_KIND,
           "kernel": kernel, "sources": sources}
    out.update({k: str(env[k]) for k in _ENV_FIELDS})
    return out


def key_digest(fields: Dict[str, str]) -> str:
    return hashing.md5_hex(repr(tuple(fields.get(k, "") for k in _KEY_FIELDS)))[:24]


def _foreign(header: dict) -> bool:
    """A header of another package (or kind): none of the port's runtime
    fields."""
    return not any(k in header for k in _ENV_FIELDS)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       f"{TMP_PREFIX}{os.getpid()}-{threading.get_ident()}-usage")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class ArtifactStore:
    """One process-wide store per root directory (manager.py owns the
    registry). Counters and usage tallies move under ``_lock``; file
    operations are atomic renames and links."""

    def __init__(self, root: str, max_bytes: int, usage_flush_ms: float = 500.0):
        self.root = root
        self.version_dir = os.path.join(root, f"v{ARTIFACT_FORMAT_VERSION}", KERNEL_KIND)
        self.max_bytes = max_bytes
        self.usage_flush_ms = usage_flush_ms
        self._lock = threading.Lock()
        # digest -> [use count, last-use sequence stamp]; merged with the
        # on-disk sidecar at init and on every flush.
        self._usage: Dict[str, List[int]] = {}
        self._usage_seq = 0
        self._dirty = False
        self._last_flush = 0.0
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.persists = 0
        self.persist_bytes = 0
        self.evictions = 0
        self._load_usage_locked()

    # ------------------------------------------------------------------
    # Publication (put-if-absent) + load (miss/corrupt ladder).
    # ------------------------------------------------------------------

    def blob_path(self, digest: str) -> str:
        return os.path.join(self.version_dir, digest + BLOB_SUFFIX)

    def publish(self, fields: Dict[str, str], payload: bytes) -> bool:
        """Publish one library's bytes; True when this call's bytes landed.
        Never raises: a failed publication (injected, out of disk) costs
        only persistence, not the query."""
        from ..robustness import fault_names as _fltn
        from ..robustness import faults as _faults
        from ..telemetry import span_names as SN
        from ..telemetry import trace as _trace
        digest = key_digest(fields)
        path = self.blob_path(digest)
        if os.path.exists(path):
            return False
        tmp = None
        try:
            with _trace.span(SN.ARTIFACT_EXPORT) as sp:
                header = dict(fields)
                header["nbytes"] = len(payload)
                header["md5"] = hashing.md5_hex(payload)
                data = (json.dumps(header, sort_keys=True) + "\n").encode("utf-8") + payload
                os.makedirs(self.version_dir, exist_ok=True)
                # Per thread: two threads publishing one key must not
                # write (and truncate) one temp under each other's link.
                tmp = os.path.join(self.version_dir, f"{TMP_PREFIX}{os.getpid()}-"
                                   f"{threading.get_ident()}-{digest}")
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                # The kill window: the temp is whole, the blob not linked
                # yet; dying here leaves nothing loadable.
                _faults.fault_point(_fltn.ARTIFACTS_WRITE)
                try:
                    os.link(tmp, path)
                    won = True
                except FileExistsError:
                    won = False  # a concurrent publisher won; same bytes
                if sp is not None:
                    sp.attrs["nbytes"] = len(payload)
                    sp.attrs["published"] = won
            if won:
                with self._lock:
                    self.persists += 1
                    self.persist_bytes += len(payload)
                self._emit_event("persist", digest, fields, nbytes=len(payload))
                self._evict_over_budget()
            return won
        except Exception:
            return False
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def load(self, fields: Dict[str, str]) -> Optional[bytes]:
        """The payload for this key, or None (a silent MISS). A corrupt,
        truncated or mismatched blob is quarantined and counted: a miss,
        never a wrong library."""
        from ..robustness import fault_names as _fltn
        from ..robustness import faults as _faults
        from ..telemetry import span_names as SN
        from ..telemetry import trace as _trace
        digest = key_digest(fields)
        path = self.blob_path(digest)
        with _trace.span(SN.ARTIFACT_LOAD) as sp:
            try:
                _faults.fault_point(_fltn.ARTIFACTS_READ)
                with open(path, "rb") as f:
                    data = f.read()
            except Exception:
                # Absent (the common cold miss) or an injected/transient
                # read failure: a plain miss, nothing to quarantine.
                self._miss(sp, digest, fields, reason="absent")
                return None
            try:
                head, sep, payload = data.partition(b"\n")
                if not sep:
                    raise ValueError("truncated header")
                header = json.loads(head.decode("utf-8"))
                for k in _KEY_FIELDS:
                    if str(header.get(k)) != str(fields.get(k, "")):
                        raise ValueError(f"key field {k!r} mismatch")
                if header.get("nbytes") != len(payload) \
                        or header.get("md5") != hashing.md5_hex(payload):
                    raise ValueError("payload checksum mismatch")
            except Exception:
                self.quarantine(digest, sp, fields)
                return None
            with self._lock:
                self.hits += 1
            if sp is not None:
                sp.attrs["hit"] = True
                sp.attrs["nbytes"] = len(payload)
            self._emit_event("hit", digest, fields, nbytes=len(payload))
            return payload

    def load_by_digest(self, digest: str) -> Optional[Tuple[Dict[str, str], bytes]]:
        """Preload-path load: the key comes from the blob's own header
        (checked against the filename digest). Returns (key fields,
        payload) or None: a foreign blob or one of another runtime is
        skipped silently; anything inconsistent is quarantined."""
        path = self.blob_path(digest)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        try:
            head, sep, payload = data.partition(b"\n")
            if not sep:
                raise ValueError("truncated header")
            header = json.loads(head.decode("utf-8"))
            if _foreign(header):
                return None
            fields = {k: str(header.get(k, "")) for k in _KEY_FIELDS}
            if key_digest(fields) != digest:
                raise ValueError("header does not match filename digest")
            env = runtime_env()
            if any(fields[k] != str(env[k]) for k in _ENV_FIELDS):
                return None  # loadable only under the runtime that made it
            if header.get("nbytes") != len(payload) \
                    or header.get("md5") != hashing.md5_hex(payload):
                raise ValueError("payload checksum mismatch")
        except Exception:
            self.quarantine(digest, None, {})
            return None
        with self._lock:
            self.hits += 1
        return fields, payload

    def quarantine(self, digest: str, sp=None, fields: Optional[Dict[str, str]] = None) -> None:
        """The corrupt ladder: delete the blob, count the corruption, and
        report a miss. Also the manager's last rung, for a library that
        fails to load."""
        from ..robustness import faults as _faults
        try:
            os.unlink(self.blob_path(digest))
        except OSError:
            pass  # already removed by a concurrent loader
        _faults.note(artifact_corruptions=1)
        self._miss(sp, digest, fields or {}, reason="corrupt")

    def _miss(self, sp, digest: str, fields: Dict[str, str], reason: str) -> None:
        with self._lock:
            self.misses += 1
            if reason == "corrupt":
                self.corrupt += 1
        if sp is not None:
            sp.attrs["hit"] = False
            sp.attrs["reason"] = reason
        self._emit_event("miss", digest, fields, reason=reason)

    # ------------------------------------------------------------------
    # Usage tallies (the preload order, persisted).
    # ------------------------------------------------------------------

    def record_use(self, digest: str) -> None:
        """Bump one artifact's tally; flushed to the sidecar at most every
        ``usage.flushMs``."""
        with self._lock:
            self._usage_seq += 1
            entry = self._usage.setdefault(digest, [0, 0])
            entry[0] += 1
            entry[1] = self._usage_seq
            self._dirty = True
            due = (time.monotonic() - self._last_flush) * 1000.0 >= self.usage_flush_ms
        if due:
            self.flush_usage()

    def flush_usage(self, force: bool = False) -> None:
        """Merge in-memory tallies with the on-disk sidecar (by max: a
        sibling process's tallies survive ours) and replace it
        atomically."""
        with self._lock:
            if not self._dirty and not force:
                return
            mine = {k: list(v) for k, v in self._usage.items()}
            self._dirty = False
            self._last_flush = time.monotonic()
        disk = self._read_usage_file()
        for k, v in disk.items():
            cur = mine.get(k)
            mine[k] = list(v) if cur is None else [max(cur[0], v[0]), max(cur[1], v[1])]
        try:
            os.makedirs(self.version_dir, exist_ok=True)
            _atomic_write(os.path.join(self.version_dir, USAGE_FILE),
                          json.dumps({"version": 1, "tallies": mine},
                                     sort_keys=True).encode("utf-8"))
        except OSError:
            pass  # tallies are advisory; never fail the serving path

    def _read_usage_file(self) -> Dict[str, List[int]]:
        try:
            with open(os.path.join(self.version_dir, USAGE_FILE), "rb") as f:
                raw = json.loads(f.read().decode("utf-8"))
            return {str(k): [int(v[0]), int(v[1])]
                    for k, v in dict(raw.get("tallies", {})).items()}
        except Exception:
            return {}  # absent or corrupt sidecar: start cold

    def _load_usage_locked(self) -> None:
        self._usage = self._read_usage_file()
        self._usage_seq = max([v[1] for v in self._usage.values()], default=0)

    def usage_order(self) -> List[str]:
        """Resident blob digests, hottest first (count, then recency): the
        preload order."""
        with self._lock:
            tallies = {k: tuple(v) for k, v in self._usage.items()}
        out = [(tallies.get(digest, (0, 0)), digest) for digest, _n in self._list_blobs()]
        out.sort(key=lambda t: (t[0][0], t[0][1]), reverse=True)
        return [d for _t, d in out]

    # ------------------------------------------------------------------
    # Budget eviction + vacuum.
    # ------------------------------------------------------------------

    def _list_blobs(self) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        try:
            names = os.listdir(self.version_dir)
        except OSError:
            return out
        for name in sorted(names):
            if not name.endswith(BLOB_SUFFIX):
                continue
            try:
                nbytes = os.path.getsize(os.path.join(self.version_dir, name))
            except OSError:
                continue  # concurrently evicted
            out.append((name[:-len(BLOB_SUFFIX)], nbytes))
        return out

    def total_bytes(self) -> int:
        return sum(n for _d, n in self._list_blobs())

    def _evict_over_budget(self) -> List[str]:
        """Delete coldest-first until the resident bytes fit the budget. A
        loader that opened the file before the unlink keeps its bytes; one
        that comes after sees a plain miss."""
        blobs = self._list_blobs()
        total = sum(n for _d, n in blobs)
        if total <= self.max_bytes:
            return []
        with self._lock:
            tallies = {k: tuple(v) for k, v in self._usage.items()}
        evicted = []
        for digest, nbytes in sorted(blobs, key=lambda t: tallies.get(t[0], (0, 0))):
            if total <= self.max_bytes:
                break
            try:
                os.unlink(self.blob_path(digest))
            except OSError:
                continue
            total -= nbytes
            evicted.append(digest)
            with self._lock:
                self.evictions += 1
                self._usage.pop(digest, None)
                self._dirty = True
            self._emit_event("evict", digest, None, nbytes=nbytes)
        if evicted:
            self.flush_usage(force=True)
        return evicted

    def vacuum(self) -> Dict:
        """The maintenance sweep riding ``Hyperspace.compact()`` /
        ``recover()``: crashed publication temps, blobs no current runtime
        can load (another format, torch, CUDA, nvcc or card), unparseable
        blobs, sidecar entries with no blob, then the byte budget. Foreign
        blobs are left alone."""
        summary: Dict = {"tmp_removed": 0, "stale_removed": 0,
                         "corrupt_removed": 0, "evicted": 0}
        env = runtime_env()
        try:
            names = os.listdir(self.version_dir)
        except OSError:
            return summary
        for name in sorted(names):
            path = os.path.join(self.version_dir, name)
            if name.startswith(TMP_PREFIX):
                self._unlink(path)
                summary["tmp_removed"] += 1
                continue
            if not name.endswith(BLOB_SUFFIX):
                continue
            header = self._read_header(path)
            if header is None:
                self._unlink(path)
                summary["corrupt_removed"] += 1
            elif _foreign(header):
                continue
            elif str(header.get("format")) != str(ARTIFACT_FORMAT_VERSION) \
                    or any(str(header.get(k)) != str(env[k]) for k in _ENV_FIELDS):
                self._unlink(path)
                summary["stale_removed"] += 1
        live = {d for d, _n in self._list_blobs()}
        with self._lock:
            for digest in list(self._usage):
                if digest not in live:
                    self._usage.pop(digest, None)
                    self._dirty = True
        summary["evicted"] = len(self._evict_over_budget())
        self.flush_usage(force=True)
        return summary

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    @staticmethod
    def _read_header(path: str) -> Optional[dict]:
        try:
            with open(path, "rb") as f:
                head = f.readline(1 << 16)
            return json.loads(head.decode("utf-8"))
        except Exception:
            return None

    # ------------------------------------------------------------------
    # Observability.
    # ------------------------------------------------------------------

    def _emit_event(self, what: str, digest: str, fields: Optional[Dict[str, str]],
                    nbytes: int = 0, reason: str = "") -> None:
        """One typed event per store decision, through the active query's
        logger; store work outside a query (warmup, vacuum) stays silent
        and is summarized by its caller."""
        from ..serving.context import active_context
        ctx = active_context()
        if ctx is None or ctx.session is None:
            return
        try:
            from ..telemetry.events import (ArtifactEvictEvent, ArtifactHitEvent,
                                            ArtifactMissEvent, ArtifactPersistEvent)
            from ..telemetry.logging import get_logger
            cls = {"hit": ArtifactHitEvent, "miss": ArtifactMissEvent,
                   "persist": ArtifactPersistEvent, "evict": ArtifactEvictEvent}[what]
            kw = dict(message=f"artifact {what} {digest}", key_digest=digest,
                      nbytes=nbytes, kind=(fields or {}).get("kind", ""))
            if what == "miss":
                kw["reason"] = reason
            get_logger(ctx.session.hs_conf.event_logger_class()).log_event(cls(**kw))
        except Exception:
            pass  # observability must never fail an execution

    def stats(self) -> dict:
        with self._lock:
            out = {
                "hits": self.hits,
                "misses": self.misses,
                "corrupt": self.corrupt,
                "persists": self.persists,
                "persist_bytes": self.persist_bytes,
                "evictions": self.evictions,
                "tallies": len(self._usage),
            }
        blobs = self._list_blobs()
        out["blobs"] = len(blobs)
        out["resident_bytes"] = sum(n for _d, n in blobs)
        return out
