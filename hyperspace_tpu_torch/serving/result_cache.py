"""Three-tier, byte-budgeted query result cache (counterpart of
``hyperspace_tpu/serving/result_cache.py``).

``Session.execute`` consults it when ``serving.result_cache.enabled`` is
set: executed results are kept under :class:`fingerprint.ResultCacheKey`,
so a repeated query is answered without planning or executing, and any
change that could alter the answer changes the key.

Tiers:

  device -- the executed Table on the session's device (CUDA tensors on a
            card); LRU victims demote to the host tier;
  host   -- CPU copies; LRU victims go to the spill tier when one is
            configured, else are evicted;
  spill  -- optional (``serving.result_cache.spillDir``): length-framed
            pickled host tables on disk up to ``spillBytes``. A truncated
            or corrupt file (or a read the ``result_cache.spill_read``
            fault point strikes) reads back as a miss: the entry is
            dropped and ``spill_corruptions`` counted, never an error or a
            wrong answer.

A copy onto the device that fails (the ``result_cache.device_put`` fault
point) puts the entry in the host tier instead (``degraded_device_put``):
residency never fails the query that computed the result.

Admission is decided by :func:`execute_with_cache` from the execution time
and the plan's input bytes: a result cheap to recompute is not worth
memory. One lock guards the tiers; copies between tiers and spill reads and
writes happen outside it.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from collections import OrderedDict
from typing import Optional, Tuple

from ..execution.buffer_pool import _moved, _table_to_host
from ..execution.index_cache import table_nbytes  # noqa: F401 (the shared byte count)
from ..robustness import fault_names as _fltn
from ..robustness import faults as _faults
from .fingerprint import ResultCacheKey, compute_key, estimate_recompute_bytes, normalize

TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_SPILL = "spill"

# A spill file that a concurrent drop or clear unlinked mid-probe: a plain
# miss, not corruption.
_GONE = object()


def _to_device(table, device):
    """The table with every tensor on ``device`` (a no-op for a result that
    is there already): the device tier holds device memory, so its budget
    never charges host memory."""
    _faults.fault_point(_fltn.RESULT_CACHE_DEVICE_PUT)
    if all(c.data.device.type == device.type
           and device.index in (None, c.data.device.index) for c in table.columns.values()):
        return table
    return _moved(table, device, False)


class ResultCache:
    def __init__(self, device_bytes: int, host_bytes: int, on_evict=None,
                 spill_dir: Optional[str] = None, spill_bytes: int = 0, device="cpu",
                 on_spill_corrupt=None):
        import torch
        self.device = torch.device(device)
        self.device_bytes = device_bytes
        self.host_bytes = host_bytes
        self.spill_dir = spill_dir or None
        if self.spill_dir is not None:
            try:
                os.makedirs(self.spill_dir, exist_ok=True)
            except OSError:
                self.spill_dir = None  # an unusable directory: two tiers
        self.spill_bytes = spill_bytes if self.spill_dir else 0
        # on_evict(tier, nbytes, demoted) may run under the lock: it must not
        # call back into the cache.
        self._on_evict = on_evict
        # on_spill_corrupt(nbytes): a corrupt spill file was dropped and
        # served as a miss.
        self._on_spill_corrupt = on_spill_corrupt
        self._lock = threading.Lock()
        self._device: "OrderedDict[ResultCacheKey, Tuple[object, int]]" = OrderedDict()
        self._host: "OrderedDict[ResultCacheKey, Tuple[object, int]]" = OrderedDict()
        # key -> (file path, nbytes); the table lives on disk only.
        self._spill: "OrderedDict[ResultCacheKey, Tuple[str, int]]" = OrderedDict()
        self._device_nbytes = 0
        self._host_nbytes = 0
        self._spill_nbytes = 0
        self._spill_seq = 0
        self.hits = 0
        self.device_hits = 0
        self.host_hits = 0
        self.spill_hits = 0
        self.misses = 0
        self.admissions = 0
        self.rejections = 0
        self.demotions = 0
        self.evictions = 0
        self.spill_corruptions = 0

    # Lookup.

    def get(self, key: ResultCacheKey):
        """(table, tier) on a hit, the device tier first; else None."""
        with self._lock:
            entry = self._device.get(key)
            if entry is not None:
                self._device.move_to_end(key)
                self.hits += 1
                self.device_hits += 1
                return entry[0], TIER_DEVICE
            entry = self._host.get(key)
            if entry is not None:
                self._host.move_to_end(key)
                self.hits += 1
                self.host_hits += 1
                return entry[0], TIER_HOST
            spilled = self._spill.get(key)
            if spilled is None:
                self.misses += 1
                return None
            self._spill.move_to_end(key)
            path = spilled[0]
        table = self._spill_read(path)  # outside the lock
        if table is None or table is _GONE:
            with self._lock:
                old = self._spill.pop(key, None)
                if old is not None:
                    self._spill_nbytes -= old[1]
                self.misses += 1
                # Only the thread that dropped the entry counts the
                # corruption.
                corrupt = table is None and old is not None
                if corrupt:
                    self.spill_corruptions += 1
            if corrupt:
                self._unlink(path)
                _faults.note(spill_corruptions=1)
                if self._on_spill_corrupt is not None:
                    self._on_spill_corrupt(old[1])
            return None
        # A hit comes back to the host tier, so a hot entry stops paying the
        # disk read; host victims it displaces spill as usual.
        host_victims = []
        with self._lock:
            self.hits += 1
            self.spill_hits += 1
            still = self._spill.pop(key, None)
            if still is not None:
                self._spill_nbytes -= still[1]
                if key not in self._device and key not in self._host:
                    self._host[key] = (table, still[1])
                    self._host_nbytes += still[1]
                    host_victims = self._pop_host_victims()
        if still is not None:
            self._unlink(path)
        self._spill_store(host_victims)
        return table, TIER_SPILL

    def peek(self, key: ResultCacheKey) -> Optional[str]:
        """The tier holding ``key``, with no effect on counters or recency
        (explain's probe)."""
        with self._lock:
            if key in self._device:
                return TIER_DEVICE
            if key in self._host:
                return TIER_HOST
            if key in self._spill:
                return TIER_SPILL
            return None

    # Admission and eviction.

    def put(self, key: ResultCacheKey, table) -> Optional[str]:
        """Keep an admitted result; returns its tier, or None when it fits
        no budget."""
        nbytes = table_nbytes(table)
        if nbytes <= self.device_bytes:
            try:
                dev_table = _to_device(table, self.device)  # outside the lock
            except Exception:
                if not _faults.degrade_enabled():
                    raise
                _faults.note(degraded_device_put=1)
                dev_table = None  # the host tier below
            if dev_table is not None:
                with self._lock:
                    self._drop(key)
                    self._device[key] = (dev_table, nbytes)
                    self._device_nbytes += nbytes
                    self.admissions += 1
                    victims = self._pop_device_victims()
                self._demote(victims)
                return TIER_DEVICE
        if nbytes <= self.host_bytes:
            host_copy = _table_to_host(table)  # outside the lock
            with self._lock:
                self._drop(key)
                self._host[key] = (host_copy, nbytes)
                self._host_nbytes += nbytes
                self.admissions += 1
                host_victims = self._pop_host_victims()
            self._spill_store(host_victims)
            return TIER_HOST
        return None

    def note_rejected(self) -> None:
        with self._lock:
            self.rejections += 1

    def _drop(self, key: ResultCacheKey) -> None:
        old = self._device.pop(key, None)
        if old is not None:
            self._device_nbytes -= old[1]
        old = self._host.pop(key, None)
        if old is not None:
            self._host_nbytes -= old[1]
        old = self._spill.pop(key, None)
        if old is not None:
            self._spill_nbytes -= old[1]
            self._unlink(old[0])

    def _pop_device_victims(self) -> list:
        """Under the lock: pop LRU device entries past the budget. Those
        that fit the host budget come back for demotion outside the lock
        (a concurrent get() misses them meanwhile: a recompute, never a
        stale answer); the rest are evicted here."""
        victims = []
        while self._device_nbytes > self.device_bytes and len(self._device) > 1:
            vk, (vt, vn) = self._device.popitem(last=False)
            self._device_nbytes -= vn
            if vn <= self.host_bytes:
                self.demotions += 1
                victims.append((vk, vt, vn))
            else:
                self.evictions += 1
                if self._on_evict is not None:
                    self._on_evict(TIER_DEVICE, vn, False)
        return victims

    def _demote(self, victims: list) -> None:
        spill_victims = []
        for vk, vt, vn in victims:
            host_copy = _table_to_host(vt)  # outside the lock
            with self._lock:
                if vk in self._device or vk in self._host:
                    continue  # admitted again meanwhile; keep that one
                self._host[vk] = (host_copy, vn)
                self._host_nbytes += vn
                spill_victims.extend(self._pop_host_victims())
            if self._on_evict is not None:
                self._on_evict(TIER_DEVICE, vn, True)
        self._spill_store(spill_victims)

    def _pop_host_victims(self) -> list:
        """Under the lock: pop LRU host entries past the budget; with a
        spill tier, those that fit it come back for spilling."""
        victims = []
        while self._host_nbytes > self.host_bytes and len(self._host) > 1:
            vk, (vt, vn) = self._host.popitem(last=False)
            self._host_nbytes -= vn
            if self.spill_dir is not None and vn <= self.spill_bytes:
                # Counted as a demotion once the spill write lands.
                victims.append((vk, vt, vn))
            else:
                self.evictions += 1
                if self._on_evict is not None:
                    self._on_evict(TIER_HOST, vn, False)
        return victims

    # The spill tier.

    def _spill_path(self) -> str:
        with self._lock:
            self._spill_seq += 1
            seq = self._spill_seq
        return os.path.join(self.spill_dir, f"rc-{os.getpid()}-{id(self)}-{seq}.bin")

    def _spill_store(self, victims: list) -> None:
        """Write host-tier victims to disk, outside the lock. A failed write
        evicts the victim: spilling must never fail a query."""
        for vk, vt, vn in victims:
            path = self._spill_path()
            try:
                payload = pickle.dumps(vt, protocol=pickle.HIGHEST_PROTOCOL)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    # The length frame tells a torn tail from a whole payload.
                    f.write(len(payload).to_bytes(8, "big"))
                    f.write(payload)
                os.replace(tmp, path)
            except Exception:  # any failed write evicts: spilling never fails a query
                with self._lock:
                    self.evictions += 1
                if self._on_evict is not None:
                    self._on_evict(TIER_HOST, vn, False)
                continue
            overflow = []
            with self._lock:
                stale = vk in self._device or vk in self._host or vk in self._spill
                if not stale:
                    self._spill[vk] = (path, vn)
                    self._spill_nbytes += vn
                    self.demotions += 1
                    while self._spill_nbytes > self.spill_bytes and len(self._spill) > 1:
                        _, (op, on) = self._spill.popitem(last=False)
                        self._spill_nbytes -= on
                        self.evictions += 1
                        overflow.append((op, on))
            if stale:
                self._unlink(path)
                continue
            for op, on in overflow:
                self._unlink(op)
                if self._on_evict is not None:
                    self._on_evict(TIER_SPILL, on, False)
            if self._on_evict is not None:
                self._on_evict(TIER_HOST, vn, True)

    @staticmethod
    def _spill_read(path: str):
        """One spilled table; None for a torn or corrupt file or a read the
        ``result_cache.spill_read`` fault point strikes, ``_GONE`` for a
        file a concurrent drop or clear removed."""
        try:
            _faults.fault_point(_fltn.RESULT_CACHE_SPILL_READ)
        except Exception:
            return None
        try:
            with open(path, "rb") as f:
                header = f.read(8)
                if len(header) != 8:
                    return None
                expected = int.from_bytes(header, "big")
                payload = f.read()
        except FileNotFoundError:
            return _GONE
        except OSError:
            return None
        if len(payload) != expected:
            return None  # a torn tail
        try:
            return pickle.loads(payload)
        except Exception:  # any undecodable payload is a miss
            return None

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def clear(self) -> None:
        with self._lock:
            self._device.clear()
            self._host.clear()
            spilled = list(self._spill.values())
            self._spill.clear()
            self._device_nbytes = 0
            self._host_nbytes = 0
            self._spill_nbytes = 0
        for path, _ in spilled:
            self._unlink(path)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "device_hits": self.device_hits,
                "host_hits": self.host_hits,
                "spill_hits": self.spill_hits,
                "misses": self.misses,
                "admissions": self.admissions,
                "rejections": self.rejections,
                "demotions": self.demotions,
                "evictions": self.evictions,
                "spill_corruptions": self.spill_corruptions,
                "device_entries": len(self._device),
                "host_entries": len(self._host),
                "spill_entries": len(self._spill),
                "device_nbytes": self._device_nbytes,
                "host_nbytes": self._host_nbytes,
                "spill_nbytes": self._spill_nbytes,
            }


def build_result_cache(session) -> Optional[ResultCache]:
    """The session's cache (rebuilt, and so emptied, whenever
    ``result_cache_conf_string`` changes), or None while it is disabled."""
    conf = session.hs_conf
    if not conf.result_cache_enabled():
        return None

    def on_evict(tier: str, nbytes: int, demoted: bool) -> None:
        from ..telemetry.events import ResultCacheEvictionEvent
        from ..telemetry.logging import get_logger
        get_logger(conf.event_logger_class()).log_event(ResultCacheEvictionEvent(
            message=f"result cache evicted {nbytes} bytes from {tier} tier"
                    + (" (demoted)" if demoted else ""),
            tier=tier, nbytes=nbytes, demoted=demoted))

    def on_spill_corrupt(nbytes: int) -> None:
        from ..telemetry.events import ResultCacheMissEvent
        from ..telemetry.logging import get_logger
        get_logger(conf.event_logger_class()).log_event(ResultCacheMissEvent(
            message="corrupt/truncated spill entry evicted; serving as a miss",
            tier=TIER_SPILL, nbytes=nbytes, reason="spill-corrupt"))

    return ResultCache(conf.result_cache_device_bytes(), conf.result_cache_host_bytes(),
                       on_evict, spill_dir=conf.result_cache_spill_dir() or None,
                       spill_bytes=conf.result_cache_spill_bytes(), device=session.device,
                       on_spill_corrupt=on_spill_corrupt)


def execute_with_cache(session, cache: ResultCache, plan):
    """``Session.execute`` with the cache on: probe, serve a hit (no
    rewrite, no execution), else execute and apply the admission floors.
    The ``serving.cache_lookup`` span covers the key and the probe, not
    the recompute on a miss; each outcome emits its ResultCache event."""
    from ..telemetry import span_names as SN
    from ..telemetry import trace as _trace
    from ..telemetry.events import (ResultCacheAdmitEvent, ResultCacheHitEvent,
                                    ResultCacheMissEvent)
    from ..telemetry.logging import log_event
    with _trace.span(SN.CACHE_LOOKUP) as sp:
        norm = normalize(plan)
        key = compute_key(session, plan, normalized=norm)
        hit = cache.get(key) if key is not None else None
        if sp is not None:
            sp.attrs["cacheable"] = key is not None
            sp.attrs["hit"] = hit is not None
            if hit is not None:
                sp.attrs["tier"] = hit[1]
    if key is None:
        # Not cacheable: execute as if there were no cache.
        return session._run_optimized(session.optimize(norm, _pre_normalized=True))
    if hit is not None:
        table, tier = hit
        log_event(session, ResultCacheHitEvent(
            message=f"result served from cache ({tier} tier)", key_digest=key.digest(),
            tier=tier, nbytes=table_nbytes(table)))
        return table
    log_event(session, ResultCacheMissEvent(message="result cache miss",
                                            key_digest=key.digest()))
    optimized = session.optimize(norm, _pre_normalized=True)
    t0 = time.perf_counter()
    table = session._run_optimized(optimized)
    elapsed = time.perf_counter() - t0
    conf = session.hs_conf
    admit = elapsed >= conf.result_cache_min_compute_seconds() and \
        estimate_recompute_bytes(optimized) >= conf.result_cache_min_input_bytes()
    tier = cache.put(key, table) if admit else None
    if tier is not None:
        log_event(session, ResultCacheAdmitEvent(
            message=f"result admitted to cache ({tier} tier)", key_digest=key.digest(),
            tier=tier, nbytes=table_nbytes(table)))
    else:
        cache.note_rejected()
    return table
