"""Fault-injection registry, degradation switch and counters (counterpart
of ``hyperspace_tpu/robustness/faults.py``).

Named fault points (fault_names.py) sit at every risky boundary of the
ported tiers: pooled reads and prefetch producers, parquet decode, the
buffer pool's probe, the result cache's device copy and spill read-back,
op-log writes, action bodies, serving workers, ingestion, the cluster's
forward and broadcast, the program bank's wrapper construction and the
artifact store's blob write and read. ``hyperspace.tpu.robustness.faults.<point>`` conf
arms them. Disarmed, :func:`fault_point` is one contextvar read.

Arming is scoped: ``Session.execute``, ``Action.run``, ``append`` and a
continuous source's poll loop build one :class:`FaultRegistry` per run from
the governing conf (:func:`scope_for`), so ``nth=`` and ``times=`` count
per run and sessions with different fault confs never see each other's
injections. :func:`scope` activates a registry built by hand, for a whole
wave of submissions (``serving.worker`` fires under the submit-time
context). Reader-pool workers get the registry handed in
(``fault_point(name, reg=...)``) by the consumer that captured it.

Spec grammar (the conf value): ``kind[:opt=val[,opt=val...]]``, see
robustness/constants.py. ``kill`` SIGKILLs the process at the point: a
real kill -9 at an exact protocol position.

:func:`degrade_enabled` is the one switch every degradation ladder asks;
:func:`note` feeds the process-wide counters (explain's "Robustness:"
section, the ``robustness`` collector).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import random
import signal
import threading
import time
from typing import Dict, Optional

from ..exceptions import HyperspaceException
from . import fault_names


class InjectedFaultError(HyperspaceException):
    """The error an armed ``error`` fault point raises."""


class TransientInjectedFaultError(InjectedFaultError):
    """The error an armed ``transient`` fault point raises."""


_KINDS = ("error", "transient", "latency", "kill")

# Builtin exception classes an ``error:exc=<name>`` spec may name.
_EXC_CLASSES = {
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "MemoryError": MemoryError,
}


class FaultSpec:
    """One parsed fault-point arming."""

    __slots__ = ("name", "kind", "p", "nth", "times", "ms", "exc")

    def __init__(self, name: str, kind: str, p: float = 1.0,
                 nth: Optional[int] = None, times: Optional[int] = None,
                 ms: float = 50.0, exc=None):
        self.name = name
        self.kind = kind
        self.p = p
        self.nth = nth
        self.times = times
        self.ms = ms
        self.exc = exc

    @classmethod
    def parse(cls, name: str, raw: str) -> "FaultSpec":
        if name not in fault_names.FAULT_NAMES:
            raise HyperspaceException(
                f"Unknown fault point {name!r}; names come from "
                f"robustness/fault_names.py: {sorted(fault_names.FAULT_NAMES)}")
        raw = (raw or "").strip()
        kind, _, opts_raw = raw.partition(":")
        kind = kind.strip().lower()
        if kind not in _KINDS:
            raise HyperspaceException(
                f"Unknown fault kind {kind!r} for point {name!r}; expected one "
                f"of {_KINDS} (spec: kind[:opt=val[,opt=val...]])")
        spec = cls(name, kind)
        for part in filter(None, (p.strip() for p in opts_raw.split(","))):
            k, eq, v = part.partition("=")
            if not eq:
                raise HyperspaceException(f"Malformed fault option {part!r} for point {name!r}")
            k = k.strip().lower()
            v = v.strip()
            if k == "p":
                spec.p = min(max(float(v), 0.0), 1.0)
            elif k == "nth":
                spec.nth = max(int(v), 1)
            elif k == "times":
                spec.times = max(int(v), 0)
            elif k == "ms":
                spec.ms = max(float(v), 0.0)
            elif k == "exc":
                exc = _EXC_CLASSES.get(v)
                if exc is None:
                    raise HyperspaceException(
                        f"Unknown exception class {v!r} for fault point {name!r}; "
                        f"supported: {sorted(_EXC_CLASSES)}")
                spec.exc = exc
            else:
                raise HyperspaceException(f"Unknown fault option {k!r} for point {name!r}")
        return spec


class FaultRegistry:
    """The armed fault points of one scope. ``trigger`` counts every hit
    per point and fires per the spec."""

    def __init__(self, specs: Dict[str, FaultSpec], seed: int = 0):
        self._specs = dict(specs)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._hits = {n: 0 for n in specs}
        self._fired = {n: 0 for n in specs}

    @classmethod
    def from_conf_specs(cls, raw_specs: Dict[str, str], seed: int = 0) -> "FaultRegistry":
        return cls({n: FaultSpec.parse(n, raw) for n, raw in raw_specs.items()}, seed=seed)

    def hit_count(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    def trigger(self, name: str) -> None:
        spec = self._specs.get(name)
        if spec is None:
            return
        with self._lock:
            self._hits[name] += 1
            if spec.nth is not None and self._hits[name] != spec.nth:
                return
            if spec.times is not None and self._fired[name] >= spec.times:
                return
            if spec.p < 1.0 and self._rng.random() >= spec.p:
                return
            self._fired[name] += 1
        note(injected=1)
        if spec.kind == "latency":
            time.sleep(spec.ms / 1000.0)
            return
        if spec.kind == "kill":
            # Immediate and unhandleable: no atexit, no flush, no CUDA
            # teardown, as in a hard crash.
            os.kill(os.getpid(), signal.SIGKILL)
        if spec.kind == "transient":
            raise TransientInjectedFaultError(f"injected transient fault at {name!r}")
        exc = spec.exc if spec.exc is not None else InjectedFaultError
        raise exc(f"injected fault at {name!r}")


_ARMED: contextvars.ContextVar = contextvars.ContextVar("hst_torch_armed_faults", default=None)


def armed() -> Optional[FaultRegistry]:
    """The active registry, or None while disarmed."""
    return _ARMED.get()


def fault_point(name: str, reg: Optional[FaultRegistry] = None) -> None:
    """Declare one named boundary. Disarmed this is one contextvar read;
    armed, the registry raises, sleeps or kills here per the spec."""
    r = reg if reg is not None else _ARMED.get()
    if r is None:
        return
    r.trigger(name)


@contextlib.contextmanager
def scope(registry: Optional[FaultRegistry]):
    """Activate ``registry`` on this context (None: a no-op)."""
    if registry is None:
        yield None
        return
    token = _ARMED.set(registry)
    try:
        yield registry
    finally:
        _ARMED.reset(token)


# Each conf-armed scope seeds its p= sampler with its ordinal (the JAX
# package's draw under its default seed 0), so a p= spec samples per run
# instead of replaying one draw.
_SCOPE_IDS = itertools.count(1)


@contextlib.contextmanager
def scope_for(hs_conf):
    """Arm from the governing conf for one run. With no
    ``robustness.faults.*`` key set no registry is built."""
    raw_specs = hs_conf.robustness_fault_specs()
    if not raw_specs:
        yield None
        return
    registry = FaultRegistry.from_conf_specs(
        raw_specs, seed=next(_SCOPE_IDS))
    token = _ARMED.set(registry)
    try:
        yield registry
    finally:
        _ARMED.reset(token)


def degrade_enabled() -> bool:
    """The ``robustness.degrade.enabled`` switch of the governing session:
    the active query context's, else the io session scope's (actions),
    else on. Every degradation ladder asks here."""
    from ..serving.context import active_context
    ctx = active_context()
    session = ctx.session if ctx is not None else None
    if session is None:
        from ..parallel import io as pio
        session = pio.active_session()
    if session is None:
        return True
    return session.hs_conf.robustness_degrade_enabled()


# Process-wide robustness counters. ``note`` takes other keys too (the
# buffer pool's ``degraded_buffer_loads``, the cluster's
# ``cluster_forward_fallbacks``), which appear once moved.
_COUNTER_KEYS = (
    "injected",                # fault points that fired
    "retries",                 # retry attempts that ran
    "retry_failures",          # retry sequences that ran out of attempts
    "deadline_cancellations",  # queries cancelled at a deadline check
    "degraded_spmd",           # SPMD faults absorbed by single-device runs
    "degraded_bank_compile",   # bank wrappers built uncached after a fault
    "degraded_device_put",     # result-cache device copies -> host tier
    "spill_corruptions",       # corrupt spill files served as misses
    "artifact_corruptions",    # corrupt artifact blobs served as misses
    "member_fallbacks",        # sweep members run again alone
    "worker_releases",         # entries released from a dying worker
    "recovered_indexes",       # transient op-log states rolled back
    "vacuumed_orphans",        # orphaned index data versions removed
)

# Incidents that make the in-flight query's trace worth keeping under head
# sampling (telemetry/trace.py tail-keep); not the recovery counters: a
# maintenance sweep is not a query anomaly.
_TAIL_KEEP_KEYS = frozenset({
    "injected", "retries", "retry_failures", "deadline_cancellations",
    "degraded_spmd", "degraded_bank_compile", "degraded_device_put",
    "spill_corruptions", "artifact_corruptions", "member_fallbacks",
    "worker_releases",
})
# The subset that flips the active QueryContext's ``degraded`` flag (the
# SLO degrade-rate objective's per-query signal).
_DEGRADE_KEYS = frozenset({
    "degraded_spmd", "degraded_bank_compile", "degraded_device_put",
    "spill_corruptions", "member_fallbacks",
})


class _Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {k: 0 for k in _COUNTER_KEYS}

    def note(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._counts[k] = self._counts.get(k, 0) + v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            for k in self._counts:
                self._counts[k] = 0


_STATS = _Stats()


def note(**deltas) -> None:
    _STATS.note(**deltas)
    fired = {k for k, v in deltas.items() if v}
    if not fired & _TAIL_KEEP_KEYS:
        return
    from ..telemetry import trace as _trace
    _trace.keep_active("robustness")
    if fired & _DEGRADE_KEYS:
        from ..serving.context import active_context
        ctx = active_context()
        if ctx is not None:
            ctx.degraded = True


def stats() -> dict:
    """Process-lifetime robustness counters."""
    return _STATS.snapshot()


def reset_stats() -> None:
    """Zero the counters (between measured phases)."""
    _STATS.reset()


# The robustness counters are a named collector in the process metrics
# registry (telemetry/metrics.py).
from ..telemetry import metric_names as _mn  # noqa: E402
from ..telemetry import metrics as _metrics  # noqa: E402

_metrics.get_registry().register_collector(_mn.COLLECTOR_ROBUSTNESS, stats)
