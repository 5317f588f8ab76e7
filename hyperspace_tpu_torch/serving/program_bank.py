"""Process-wide program bank (counterpart of
``hyperspace_tpu/serving/program_bank.py``).

The JAX package funnels every fused stage (predicate masks, arithmetic
projections, whole-plan regions, mesh programs) through one jit wrapper
per program STRUCTURE, and XLA compiles one executable per (structure,
shape-class vector). This registry holds those wrappers: keyed on the
stage fingerprint, size-bounded (LRU over stages; evicting a stage drops
every program under it) and instrumented.

In the port a stage's wrapper is the eager function its factory returns,
and nothing is compiled: the lookup sites call their stage function as it
stands after the lookup. The accounting is the reference's, so the bank
counts the programs the JAX package would compile for the same queries.
A *stage* is one wrapper (one structure key); a *program* is one (stage,
shape-class vector) pair. ``lookup`` records a **miss** the first time a
(stage, shape vector) pair is seen and a **hit** on every later sighting.
``ProgramBankMissEvent`` is emitted per new program,
``ProgramBankHitEvent`` once per program on its FIRST reuse.

The factory runs behind the ``bank.compile`` fault point: a failure hands
back an unregistered wrapper from one more factory call (the stage runs
uncached, to the same answer) and counts ``degraded_bank_compile``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional, Tuple


class ProgramBank:
    def __init__(self, max_stages: int = 1024):
        self.max_stages = max_stages
        self._lock = threading.Lock()
        # stage key -> (wrapper, {shape vector: reuse count})
        self._stages: "OrderedDict[tuple, Tuple[Callable, dict]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.program_count = 0

    def lookup(self, stage_key: tuple, shape_vec: tuple,
               factory: Callable[[], Callable]) -> Callable:
        """The wrapper for ``stage_key``, made by ``factory`` on first
        sighting. ``shape_vec`` (the shape-class vector of the arguments
        about to be passed) drives the hit/miss accounting only."""
        from ..telemetry import span_names as SN
        from ..telemetry import trace as _trace
        first_reuse = False
        with _trace.span(SN.BANK_LOOKUP) as sp, self._lock:
            entry = self._stages.get(stage_key)
            if entry is None:
                while len(self._stages) >= self.max_stages:
                    _, (_, shapes_seen) = self._stages.popitem(last=False)
                    self.evictions += 1
                    self.program_count -= len(shapes_seen)
                with _trace.span(SN.BANK_COMPILE):
                    fn, degraded = self._build(factory)
                self.misses += 1
                if degraded:
                    # The wrapper that failed once is handed back
                    # unregistered: this execution runs it uncached, and
                    # the next lookup tries the bank again.
                    if sp is not None:
                        sp.attrs["hit"] = False
                        sp.attrs["degraded"] = True
                    return fn
                # shape vector -> times this program was looked up again
                # after registration (0 = registered, never reused yet).
                self._stages[stage_key] = (fn, {shape_vec: 0})
                self.program_count += 1
                hit = False
            else:
                self._stages.move_to_end(stage_key)
                fn, shapes_seen = entry
                if shape_vec in shapes_seen:
                    self.hits += 1
                    shapes_seen[shape_vec] += 1
                    first_reuse = shapes_seen[shape_vec] == 1
                    hit = True
                else:
                    shapes_seen[shape_vec] = 0
                    self.misses += 1
                    self.program_count += 1
                    hit = False
            if sp is not None:
                sp.attrs["hit"] = hit
        self._emit(stage_key, shape_vec, hit=hit, first_reuse=first_reuse)
        return fn

    @staticmethod
    def _build(factory: Callable[[], Callable]):
        """Run the factory behind the ``bank.compile`` fault point. A
        failure (injected or real) degrades to ONE more factory call whose
        wrapper is returned uncached, unless degradation is off (or that
        call fails too, a persistent error that must surface). Returns
        (fn, degraded)."""
        from ..robustness import fault_names as _fltn
        from ..robustness import faults as _faults
        try:
            _faults.fault_point(_fltn.BANK_COMPILE)
            return factory(), False
        except Exception:
            if not _faults.degrade_enabled():
                raise
            fn = factory()  # persistent failures raise here, loudly
            _faults.note(degraded_bank_compile=1)
            return fn, True

    # ------------------------------------------------------------------
    # Observability.
    # ------------------------------------------------------------------

    def _emit(self, stage_key: tuple, shape_vec: tuple, hit: bool,
              first_reuse: bool) -> None:
        """One MissEvent per new program and one HitEvent on a program's
        first reuse, through the active query's logger; lookups outside a
        query stay silent."""
        if hit and not first_reuse:
            return
        from .context import active_context
        ctx = active_context()
        if ctx is None or ctx.session is None:
            return
        try:
            from ..telemetry.events import ProgramBankHitEvent, ProgramBankMissEvent
            from ..telemetry.logging import get_logger
            from ..util import hashing
            digest = hashing.md5_hex(repr(stage_key))[:12]
            cls = ProgramBankHitEvent if hit else ProgramBankMissEvent
            get_logger(ctx.session.hs_conf.event_logger_class()).log_event(
                cls(message=("program bank " + ("reuse" if hit else "new")
                             + f" stage {digest} shapes {shape_vec}"),
                    stage_digest=digest, shape_vec=list(shape_vec),
                    hits=self.hits, misses=self.misses))
        except Exception:
            pass  # observability must never fail an execution

    def stats(self) -> dict:
        """The bank's counters; ``stages_by_kind`` breaks the resident
        stages down by their key's kind tag ("fused-predicate",
        "fused-region", "spmd")."""
        with self._lock:
            kinds: dict = {}
            for k in self._stages:
                tag = k[0] if isinstance(k, tuple) and k and isinstance(k[0], str) \
                    else "other"
                kinds[tag] = kinds.get(tag, 0) + 1
            return {
                "stages": len(self._stages),
                "programs": self.program_count,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "stages_by_kind": kinds,
            }

    def clear(self) -> None:
        """Drop every wrapper (tests)."""
        with self._lock:
            self._stages.clear()
            self.program_count = 0


_BANK: Optional[ProgramBank] = None
_BANK_LOCK = threading.Lock()


def get_bank() -> ProgramBank:
    global _BANK
    if _BANK is None:
        with _BANK_LOCK:
            if _BANK is None:
                _BANK = ProgramBank()
    return _BANK


def reset_for_tests(max_stages: int = 1024) -> ProgramBank:
    """A fresh process bank (counters and stages zeroed)."""
    global _BANK
    with _BANK_LOCK:
        _BANK = ProgramBank(max_stages)
    return _BANK


def _bank_stats() -> dict:
    return get_bank().stats()


# The bank's counters are a named collector in the process metrics
# registry (telemetry/metrics.py): Hyperspace.metrics() and
# serving_stats() read the same dict through it.
from ..telemetry import metric_names as _mn  # noqa: E402
from ..telemetry import metrics as _metrics  # noqa: E402

_metrics.get_registry().register_collector(_mn.COLLECTOR_PROGRAM_BANK, _bank_stats)
