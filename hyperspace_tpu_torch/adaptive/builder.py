"""The budgeted background builder (counterpart of
``hyperspace_tpu/adaptive/builder.py``): the advisor's recommendations,
built in the serving tier's idle windows.

- :class:`BuilderLedger`, one per process: what was built, retired and
  maintained, the bytes spent against ``adaptive.builder.maxBytes``, the
  build in flight (``in_progress`` drains to empty), and how long the
  serving tier has been idle.
- :class:`AdaptiveBuilder`: one pass per idle window (``run_once``),
  optionally on a daemon thread (``start``/``stop``, through
  ``parallel/io.spawn_daemon``). A pass acts only after every live
  frontend has been empty for ``adaptive.builder.idleMs``: a build never
  shares the card with a query in flight. Each pass, in order: builds the
  advisor's top recommendation within the budget, through the normal
  create path (so op-log recovery covers it); retires the ACTIVE indexes
  whose usage count is still zero ``retireMinQueries`` completed queries
  after the builder first saw them; compacts the streaming op logs.

Every action emits an AdaptiveActionEvent. A pass drops the errors of its
own steps, as the JAX package's does (nothing to recommend, a create or
delete refused), all but a kernel's: a KernelError
(ops/cuda_kernels.py) goes on to the caller.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..ops.cuda_kernels import KernelError
from .constants import BUILDER_INTERVAL_MS

__all__ = ["BuilderLedger", "AdaptiveBuilder", "get_ledger", "get_builder"]


class BuilderLedger:
    """The process's builder accounting; all state behind ``_lock`` (the
    daemon loop, explicit run_once calls and stats readers race)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._built: List[str] = []
        self._retired: List[str] = []
        self._maintained: List[str] = []
        self._bytes_spent = 0
        self._in_progress: set = set()
        # index name -> the SLO monitor's query total when the builder first
        # saw it ACTIVE and unused (the retirement clock).
        self._first_seen: Dict[str, int] = {}
        self._idle_since: Optional[float] = None

    def note_activity(self) -> None:
        """The serving tier is busy: the idle clock starts again."""
        with self._lock:
            self._idle_since = None

    def idle_for(self, now: Optional[float] = None) -> float:
        """Seconds the serving tier has been idle (the first call starts
        the clock)."""
        t = now if now is not None else time.monotonic()
        with self._lock:
            if self._idle_since is None:
                self._idle_since = t
            return t - self._idle_since

    def begin(self, names) -> None:
        with self._lock:
            self._in_progress.update(names)

    def finish(self, names, ok: bool, bytes_added: int = 0) -> None:
        with self._lock:
            self._in_progress.difference_update(names)
            if ok:
                self._built.extend(names)
                self._bytes_spent += max(int(bytes_added), 0)

    def bytes_spent(self) -> int:
        with self._lock:
            return self._bytes_spent

    def observed_since(self, name: str, total_now: int) -> int:
        """Completed queries since the builder first saw ``name`` unused
        (the first call starts its clock and returns 0)."""
        with self._lock:
            first = self._first_seen.setdefault(name, int(total_now))
            return int(total_now) - first

    def reset_observation(self, name: str) -> None:
        """``name`` was used: its retirement clock stops."""
        with self._lock:
            self._first_seen.pop(name, None)

    def note_retired(self, name: str) -> None:
        with self._lock:
            self._retired.append(name)
            self._first_seen.pop(name, None)

    def note_maintenance(self, action: str) -> None:
        with self._lock:
            self._maintained.append(action)

    def stats(self) -> dict:
        with self._lock:
            return {"built": list(self._built), "retired": list(self._retired),
                    "maintained": list(self._maintained), "bytes_spent": self._bytes_spent,
                    "in_progress": sorted(self._in_progress)}

    def clear(self) -> None:
        with self._lock:
            self._built.clear()
            self._retired.clear()
            self._maintained.clear()
            self._bytes_spent = 0
            self._in_progress.clear()
            self._first_seen.clear()
            self._idle_since = None


_LEDGER: Optional[BuilderLedger] = None
_LEDGER_LOCK = threading.Lock()


def get_ledger() -> BuilderLedger:
    """The process's builder ledger."""
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_LOCK:
            if _LEDGER is None:
                _LEDGER = BuilderLedger()
    return _LEDGER


class AdaptiveBuilder:
    """One background maintenance actor over one Hyperspace handle."""

    def __init__(self, hyperspace, ledger: Optional[BuilderLedger] = None):
        self._hs = hyperspace
        self._ledger = ledger if ledger is not None else get_ledger()
        self._stop_event = threading.Event()
        self._thread = None

    def _serving_busy(self) -> bool:
        """Any live frontend with queued or running work."""
        from ..serving.frontend import all_frontends
        for front in all_frontends():
            try:
                st = front.stats()
            except Exception:
                continue
            if st.get("queued", 0) or st.get("active_workers", 0):
                return True
        return False

    def run_once(self, force: bool = False) -> dict:
        """One maintenance pass. ``force`` skips the idle-window wait (tests
        and operators); the busy check still holds. Returns {ran, built,
        retired, maintained} and a reason when the pass did not run."""
        session = self._hs.session
        conf = session.hs_conf
        out: dict = {"ran": False, "built": [], "retired": [], "maintained": []}
        if not conf.adaptive_builder_enabled():
            out["reason"] = "disabled"
            return out
        now = time.monotonic()
        led = self._ledger
        if self._serving_busy():
            led.note_activity()
            out["reason"] = "serving busy"
            return out
        if not force and led.idle_for(now) * 1000.0 < conf.adaptive_builder_idle_ms():
            out["reason"] = "idle window still warming"
            return out
        out["ran"] = True
        out["built"] = self._build_top_recommendation(session, conf)
        out["retired"] = self._retire_unused(session, conf)
        out["maintained"] = self._streaming_maintenance(session)
        return out

    def _build_top_recommendation(self, session, conf) -> List[str]:
        """Build the advisor's current top recommendation whose indexes do
        not exist yet, within the byte budget."""
        led = self._ledger
        max_bytes = conf.adaptive_builder_max_bytes()
        if max_bytes and led.bytes_spent() >= max_bytes:
            return []
        try:
            recos = list(self._hs.recommend(top_k=1).recommendations)
        except KernelError:
            raise
        except Exception:
            recos = []
        if not recos:
            return []
        rec = recos[0]
        manager = session.index_collection_manager
        missing = [n for n in rec.names if manager.get_index(n) is None]
        if not missing:
            return []
        led.begin(rec.names)
        ok = False
        try:
            self._hs.build_recommendation(rec)
            ok = True
        except KernelError:
            raise
        except Exception:
            pass
        finally:
            built_bytes = 0
            if ok:
                for name in missing:
                    try:
                        entry = manager.get_index(name)
                        if entry is not None:
                            built_bytes += entry.index_files_size_in_bytes
                    except Exception:
                        pass
            led.finish(rec.names, ok, built_bytes)
        if not ok:
            return []
        from . import emit_action
        for name in missing:
            emit_action(session, "builder.build", subject=name,
                        detail=(f"advisor top recommendation; {built_bytes} bytes against "
                                f"budget {max_bytes}"))
        return missing

    def _retire_unused(self, session, conf) -> List[str]:
        """Delete the ACTIVE indexes whose usage count is still zero after
        ``retireMinQueries`` completed queries of observation. A soft
        delete: ``restore_index`` undoes it, and the bytes come back only
        when an operator vacuums."""
        from ..index.constants import States
        from ..telemetry.slo import get_monitor
        from . import emit_action
        led = self._ledger
        min_queries = conf.adaptive_builder_retire_min_queries()
        total = get_monitor().total
        with session._usage_counts_lock:
            usage = dict(session._index_usage_counts)
        retired: List[str] = []
        for entry in session.index_collection_manager.get_indexes([States.ACTIVE]):
            if usage.get(entry.name, 0) > 0:
                led.reset_observation(entry.name)
                continue
            if led.observed_since(entry.name, total) < min_queries:
                continue
            try:
                self._hs.delete_index(entry.name)
            except KernelError:
                raise
            except Exception:
                continue
            led.note_retired(entry.name)
            retired.append(entry.name)
            emit_action(session, "builder.retire", subject=entry.name,
                        detail=f"usageCount 0 after {min_queries}+ completed queries")
        return retired

    def _streaming_maintenance(self, session) -> List[str]:
        """Op-log compaction in the same quiet window; compaction's own
        threshold decides what folds, so a tight lake is a no-op."""
        from . import emit_action
        try:
            summary = self._hs.compact(None)
        except KernelError:
            raise
        except Exception:
            return []
        done = sorted((summary.get("compacted") or {}).keys())
        for name in done:
            self._ledger.note_maintenance(f"compact:{name}")
            emit_action(session, "builder.maintain", subject=name,
                        detail="op-log compaction in idle window")
        return done

    def start(self) -> None:
        """Run ``run_once`` every ``BUILDER_INTERVAL_MS`` on a daemon
        thread (a no-op while it runs)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_event.clear()
        from ..parallel import io as pio
        self._thread = pio.spawn_daemon("hst-adaptive-builder", self._loop)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop_event.is_set():
            if self._stop_event.wait(BUILDER_INTERVAL_MS / 1000.0):
                return
            try:
                self.run_once()
            except KernelError:
                raise
            except Exception:
                pass  # the loop outlives one bad pass


_BUILDER: Optional[AdaptiveBuilder] = None
_BUILDER_LOCK = threading.Lock()


def get_builder(hyperspace) -> AdaptiveBuilder:
    """The process-default builder, made on first use with ``hyperspace``
    governing it (later calls return it whatever the handle)."""
    global _BUILDER
    if _BUILDER is None:
        with _BUILDER_LOCK:
            if _BUILDER is None:
                _BUILDER = AdaptiveBuilder(hyperspace)
    return _BUILDER
