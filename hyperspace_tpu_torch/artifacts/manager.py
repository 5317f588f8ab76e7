"""Process-wide artifact managers: the seam between the kernel build
(``ops/cuda_kernels.build``) and the lake store (counterpart of
``hyperspace_tpu/artifacts/manager.py``).

- :class:`ArtifactManager`, one per store root: fetches a kernel library
  from the store into the build directory (a hit skips ``nvcc``),
  publishes a library that was built, and preloads the store's libraries
  hottest-first within the preload budgets. A library's usage tally
  counts the processes that loaded it (a fetch or a preload): the port
  keeps the per-launch path free of store work.
- ``cuda_kernels.build`` asks :func:`active_manager` before it runs
  ``nvcc``: with the active session's ``artifacts.enabled`` on, a missing
  library is fetched from the store first, and only a miss builds it
  (then publishes it). Off, nothing is read or written.

The JAX package's ``"bank"``, ``"spmd"`` and ``"util"`` kinds (executables
of banked stages and utility kernels) have no counterpart: the port's
stages are eager closures with nothing to serialize. Its kind is
``"kernel"``, one blob per CUDA kernel library.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Sequence

from .constants import ARTIFACT_DIR_NAME
from .store import ArtifactStore, key_digest


def _write_atomic(path: str, payload: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


class ArtifactManager:
    """Load-through cache of kernel libraries over one :class:`ArtifactStore`.
    ``_loaded`` maps an artifact digest to the library file it was written
    to (by a fetch, a publication or the preload); all access under
    ``_lock``."""

    def __init__(self, store: ArtifactStore):
        self.store = store
        self._lock = threading.Lock()
        self._loaded: Dict[str, str] = {}
        self.warm_hits = 0
        self.preloaded = 0
        self.preload_ms = 0.0
        self.preload_bytes = 0

    def fetch(self, fields: Dict[str, str], dest: str) -> bool:
        """Put the library of this key at ``dest``, from the in-memory
        record (already written there) or the lake. False on a miss (the
        caller builds)."""
        digest = key_digest(fields)
        with self._lock:
            if self._loaded.get(digest) == dest and os.path.exists(dest):
                self.warm_hits += 1
                return True
        payload = self.store.load(fields)
        if payload is None:
            return False
        _write_atomic(dest, payload)
        with self._lock:
            self._loaded[digest] = dest
        self.note_use(digest)
        return True

    def put(self, fields: Dict[str, str], path: str) -> bool:
        """Publish the library at ``path`` (best effort: losing the race or
        failing to write costs persistence only)."""
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except OSError:
            return False
        won = self.store.publish(fields, payload)
        with self._lock:
            self._loaded[key_digest(fields)] = path
        return won

    def note_use(self, digest: str) -> None:
        self.store.record_use(digest)

    def discard(self, fields: Dict[str, str]) -> None:
        """Last rung of the corrupt ladder: a fetched library that did not
        load is dropped from memory and quarantined on the lake, so no
        process loads it again."""
        digest = key_digest(fields)
        with self._lock:
            self._loaded.pop(digest, None)
        self.store.quarantine(digest)

    def publish_kernels(self, names: Optional[Sequence[str]] = None) -> int:
        """Publish every kernel library already built in this process's
        build directory (all kernels by default). Returns the blobs this
        call landed."""
        from ..ops import cuda_kernels
        landed = 0
        for name in (list(cuda_kernels.SOURCES) if names is None else names):
            path = cuda_kernels.library_path(name)
            if os.path.exists(path) and self.put(cuda_kernels.artifact_fields(name), path):
                landed += 1
        return landed

    def preload(self, max_ms: float, max_bytes: int) -> dict:
        """Write the store's libraries into the build directory and load
        them, hottest first (persisted usage order), until either budget is
        spent: a fresh process then reaches its first query with no
        ``nvcc`` run. A blob of another source digest, runtime or package
        is skipped."""
        from ..ops import cuda_kernels
        from ..telemetry import span_names as SN
        from ..telemetry import trace as _trace
        t0 = time.perf_counter()
        loaded = skipped = 0
        nbytes_total = 0
        budget_hit = ""
        with _trace.span(SN.ARTIFACT_WARMUP) as sp:
            for digest in self.store.usage_order():
                if (time.perf_counter() - t0) * 1000.0 >= max_ms:
                    budget_hit = "maxMs"
                    break
                if nbytes_total >= max_bytes:
                    budget_hit = "maxBytes"
                    break
                with self._lock:
                    if digest in self._loaded:
                        continue
                res = self.store.load_by_digest(digest)
                name = res[0]["kernel"] if res is not None else None
                if name not in cuda_kernels.SOURCES \
                        or key_digest(cuda_kernels.artifact_fields(name)) != digest:
                    skipped += 1
                    continue
                fields, payload = res
                dest = cuda_kernels.library_path(name)
                if not os.path.exists(dest):
                    _write_atomic(dest, payload)
                if not cuda_kernels.load_library(name, fields, manager=self):
                    skipped += 1
                    continue
                with self._lock:
                    self._loaded[digest] = dest
                self.note_use(digest)
                loaded += 1
                nbytes_total += len(payload)
            if sp is not None:
                sp.attrs["loaded"] = loaded
                sp.attrs["nbytes"] = nbytes_total
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            self.preloaded += loaded
            self.preload_ms += elapsed_ms
            self.preload_bytes += nbytes_total
        return {"enabled": True, "loaded": loaded, "skipped": skipped,
                "bytes": nbytes_total, "ms": round(elapsed_ms, 3),
                "budget_hit": budget_hit}

    def stats(self) -> dict:
        out = self.store.stats()
        with self._lock:
            out["warm_hits"] = self.warm_hits
            out["loaded_in_memory"] = len(self._loaded)
            out["preloaded"] = self.preloaded
            out["preload_ms"] = round(self.preload_ms, 3)
            out["preload_bytes"] = self.preload_bytes
        return out


# ---------------------------------------------------------------------------
# The per-root manager registry + the conf-driven entry points.
# ---------------------------------------------------------------------------


class _ManagerRegistry:
    """root dir -> manager; process-wide (two sessions over one lake share
    every fetched library)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_root: Dict[str, ArtifactManager] = {}

    def get(self, root: str, max_bytes: int, usage_flush_ms: float) -> ArtifactManager:
        with self._lock:
            mgr = self._by_root.get(root)
            if mgr is None:
                mgr = ArtifactManager(ArtifactStore(root, max_bytes, usage_flush_ms))
                self._by_root[root] = mgr
            else:
                # Budgets follow the most recent conf read.
                mgr.store.max_bytes = max_bytes
                mgr.store.usage_flush_ms = usage_flush_ms
        return mgr

    def all(self) -> list:
        with self._lock:
            return list(self._by_root.values())


_REGISTRY: Optional[_ManagerRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> _ManagerRegistry:
    """The process singleton; first use registers the ``artifacts``
    metrics collector."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = _ManagerRegistry()
            from ..telemetry import metric_names as MN
            from ..telemetry.metrics import get_registry as _metrics
            _metrics().register_collector(MN.COLLECTOR_ARTIFACTS, _collector_stats)
        return _REGISTRY


def reset_for_tests() -> None:
    """Forget every open store (the collector stays registered)."""
    with _REGISTRY_LOCK:
        if _REGISTRY is not None:
            with _REGISTRY._lock:
                _REGISTRY._by_root.clear()


def _collector_stats() -> dict:
    """Store counters summed across every root this process opened."""
    managers = get_registry().all()
    out = {"stores": len(managers)}
    for mgr in managers:
        for k, v in mgr.stats().items():
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
    return out


def manager_for(session) -> Optional[ArtifactManager]:
    """The session's artifact manager, or None when the store is disabled
    or no root can be resolved."""
    hs_conf = session.hs_conf
    if not hs_conf.artifacts_enabled():
        return None
    root = hs_conf.artifacts_dir()
    if not root:
        try:
            root = os.path.join(hs_conf.system_path(), ARTIFACT_DIR_NAME)
        except Exception:
            return None  # no system path configured: nowhere to persist
    return get_registry().get(root, hs_conf.artifacts_max_bytes(),
                              hs_conf.artifacts_usage_flush_ms())


def active_manager() -> Optional[ArtifactManager]:
    """The manager of the active query's (or action's) session: the kernel
    build's entry point."""
    from ..parallel import io as pio
    from ..serving.context import active_context
    ctx = active_context()
    session = ctx.session if ctx is not None else None
    if session is None:
        session = pio.active_session()
    if session is None:
        return None
    return manager_for(session)


def preload(session) -> dict:
    """Preload within the session's budgets; the body of
    ``Hyperspace.warmup()`` and of the opt-in preload at Session
    creation."""
    mgr = manager_for(session)
    if mgr is None:
        return {"enabled": False, "loaded": 0}
    return mgr.preload(session.hs_conf.artifacts_preload_max_ms(),
                       session.hs_conf.artifacts_preload_max_bytes())


def vacuum(session) -> dict:
    """Store maintenance riding ``Hyperspace.compact()``/``recover()``."""
    mgr = manager_for(session)
    if mgr is None:
        return {"enabled": False}
    out = mgr.store.vacuum()
    out["enabled"] = True
    return out


def flush_all() -> None:
    """Force every open store's usage sidecar to disk (tests and orderly
    shutdown; the serving path flushes on its own cadence)."""
    for mgr in get_registry().all():
        mgr.store.flush_usage(force=True)
