"""Tiered buffer pool: decoded scans shared across queries (counterpart of
``hyperspace_tpu/execution/buffer_pool.py``).

A process-wide, byte-budgeted, two-tier (device, then host) pool of decoded
tables, keyed by the source files' signatures (path, size, mtime), the
column set, the pushed row-group filter and the device, so two queries that
read the same columns of the same files share one decode and one
host->device copy. Three namespaces use it:

- ``"scan"``: the executor's bulk scan (``columnar.read_parquet`` with
  ``pool=True``); the reader pool's tasks are its producers;
- ``"stream"``: a chunked filtered scan's whole chunk sequence
  (``columnar.iter_dataset_chunks``), up to ``streamAdmitBytes``, replayed
  chunk for chunk; these entries are device-only (dropped on eviction);
- ``"index"``: the index-table cache (``execution/index_cache.py``).

A file that changes gets a new signature, so its old entries are never
found again and age out of the LRU. Eviction runs device -> host -> drop;
the copies run outside the lock. Tables that come out of the pool are
shared by every query that hits them, so nothing may write into their
tensors in place.

The degrade contract (robustness/faults.degrade_enabled): a load that
fails at the ``buffer.load`` fault point drops the entry and reports a
miss, so the caller reads the files again; a failed promotion serves the
host copy; a failed demotion drops the victim. With degrade off each of
them raises.

Every probe emits a BufferPoolHitEvent or BufferPoolMissEvent, and every
step down the eviction ladder a BufferPoolEvictEvent, through the
executing session's logger; the counters are the ``buffer_pool``
collector of the metrics registry.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

from ..robustness import fault_names as _fn
from ..robustness import faults as _faults
from ..telemetry import metric_names as _mn
from ..telemetry import metrics as _metrics

# Budgets when no session is in scope (the JAX package's defaults).
_DEVICE_BYTES_DEFAULT = 4 << 30
_HOST_BYTES_DEFAULT = 4 << 30
_STREAM_ADMIT_BYTES_DEFAULT = 256 << 20


class PoolKey(NamedTuple):
    """One entry's identity: namespace, the hashable key, and the source
    bytes its files hold (credited to ``decode_bytes_saved`` on a hit)."""

    ns: str
    key: tuple
    source_bytes: int


class _Entry:
    __slots__ = ("payload", "nbytes", "source_bytes", "device_only", "device")

    def __init__(self, payload, nbytes: int, source_bytes: int, device_only: bool, device):
        self.payload = payload
        self.nbytes = nbytes
        self.source_bytes = source_bytes
        self.device_only = device_only
        self.device = device


def _note_query(**deltas) -> None:
    """Credit the active query context (serving/context.py) with a probe's
    outcome, so pool hits and misses count against the query that made
    them."""
    from ..serving.context import active_context
    ctx = active_context()
    if ctx is not None:
        ctx.note_io(**deltas)


def _hit_event(ns: str, tier: str, nbytes: int):
    from ..telemetry.events import BufferPoolHitEvent
    return BufferPoolHitEvent(message=f"buffer pool hit ({ns}, {tier} tier)",
                              namespace=ns, tier=tier, nbytes=nbytes)


def _miss_event(ns: str, reason: str):
    from ..telemetry.events import BufferPoolMissEvent
    return BufferPoolMissEvent(message=f"buffer pool miss ({ns})", namespace=ns,
                               reason=reason)


def _evict_event(tier: str, nbytes: int, demoted: bool):
    from ..telemetry.events import BufferPoolEvictEvent
    return BufferPoolEvictEvent(
        message=f"buffer pool {'demotion' if demoted else 'eviction'} ({tier} tier)",
        tier=tier, nbytes=nbytes, demoted=demoted)


def _emit_event(make, *args) -> None:
    """Build the event only when a session is in scope to receive it."""
    from ..parallel import io as pio
    session = pio.active_session()
    if session is None:
        return
    from ..telemetry.logging import log_event
    log_event(session, make(*args))


def _tensors(table):
    for c in table.columns.values():
        yield c.data
        if c.validity is not None:
            yield c.validity


def table_nbytes(table) -> int:
    """Bytes a table keeps alive: the storages behind its tensors, each once
    (a sliced view pins its whole base storage), and 8 bytes a dictionary
    slot."""
    seen: Dict[int, int] = {}
    for t in _tensors(table):
        storage = t.untyped_storage()
        seen[storage.data_ptr()] = storage.nbytes()
    total = sum(seen.values())
    for c in table.columns.values():
        if c.dictionary is not None:
            total += c.dictionary.size * 8
    return total


def _payload_device(payload):
    for t in _tensors(payload):
        return t.device
    return None


def _moved(table, device, non_blocking: bool):
    from .columnar import Column, Table
    return Table({n: Column(c.dtype, c.data.to(device, non_blocking=non_blocking),
                            None if c.validity is None
                            else c.validity.to(device, non_blocking=non_blocking),
                            c.dictionary)
                  for n, c in table.columns.items()}, table.bucket_order)


def _table_to_host(table):
    """Demote a table to host memory (pinned when it leaves a card: the
    copies are queued together, then waited on once)."""
    import torch
    device = _payload_device(table)
    if device is None or device.type != "cuda":
        return _moved(table, "cpu", False)
    from .columnar import Column, Table
    cols = {}
    for n, c in table.columns.items():
        def host(t):
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            return out
        cols[n] = Column(c.dtype, host(c.data),
                         None if c.validity is None else host(c.validity), c.dictionary)
    torch.cuda.current_stream(device).synchronize()
    return Table(cols, table.bucket_order)


def _table_to_device(table, device):
    """Promote a host-tier table back to ``device``; the copies are queued
    on the current stream, which orders them before every later use."""
    return _moved(table, device, True)


class BufferPool:
    """Two-tier (device, then host) byte-budgeted LRU of decoded tables.

    Entries are tables (demotable) or device-only payloads (chunk-stream
    lists, dropped on eviction). Counters: ``device_hits``/``host_hits``/
    ``misses`` per probe, ``admissions``/``rejections`` per put, ``loads``
    (admitted decodes), ``promotions`` (host->device copies; with loads, the
    pool's ``transfers``), ``demotions``/``evictions`` down the ladder,
    ``invalidations`` (entries a load fault or a failed promotion dropped)
    and ``degraded_loads``.
    """

    def __init__(self, device_bytes: int, host_bytes: int):
        self.device_bytes = int(device_bytes)
        self.host_bytes = int(host_bytes)
        self._lock = threading.Lock()
        self._device: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._host: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._device_nbytes = 0
        self._host_nbytes = 0
        self._ns: Dict[str, Dict[str, int]] = {}
        self.reset_stats()

    # Under the lock.

    def _bump_ns(self, ns: str, field: str) -> None:
        slot = self._ns.setdefault(ns, {"hits": 0, "misses": 0})
        slot[field] += 1

    def _drop(self, full: tuple) -> int:
        e = self._device.pop(full, None)
        if e is not None:
            self._device_nbytes -= e.nbytes
            return e.nbytes
        e = self._host.pop(full, None)
        if e is not None:
            self._host_nbytes -= e.nbytes
            return e.nbytes
        return 0

    def _pop_victims(self, tier: "OrderedDict", attr: str, budget: int) -> list:
        """LRU entries of ``tier`` until it fits ``budget`` (the newest
        entry stays), for the caller to demote or drop outside the lock."""
        victims = []
        while getattr(self, attr) > budget and len(tier) > 1:
            full, e = tier.popitem(last=False)
            setattr(self, attr, getattr(self, attr) - e.nbytes)
            victims.append((full, e))
        return victims

    # Probe and admit.

    def get(self, pk: PoolKey):
        """The cached payload, or None (a miss: the caller reads). The
        ``buffer.load`` fault point fires here: a load failure, like a
        failed promotion of a host-tier entry, drops the entry and is a
        miss (``degraded_loads``, ``invalidations``)."""
        full = (pk.ns,) + tuple(pk.key)
        try:
            _faults.fault_point(_fn.BUFFER_LOAD)
        except Exception:
            if not _faults.degrade_enabled():
                raise
            _faults.note(degraded_buffer_loads=1)
            with self._lock:
                if self._drop(full):
                    self.invalidations += 1
                self.degraded_loads += 1
                self.misses += 1
                self._bump_ns(pk.ns, "misses")
            _note_query(pool_misses=1)
            _emit_event(_miss_event, pk.ns, "fault")
            return None
        host = None
        with self._lock:
            e = self._device.get(full)
            if e is not None:
                self._device.move_to_end(full)
                self._count_hit(pk.ns, e, "device")
                payload = e.payload
            else:
                e = host = self._host.get(full)
                if e is None:
                    self.misses += 1
                    self._bump_ns(pk.ns, "misses")
        if e is None:
            _note_query(pool_misses=1)
            _emit_event(_miss_event, pk.ns, "")
            return None
        if host is not None:
            payload = self._promote(pk.ns, full, host)
            if payload is None:
                _note_query(pool_misses=1)
                _emit_event(_miss_event, pk.ns, "fault")
                return None
        _note_query(pool_hits=1, pool_bytes_saved=e.source_bytes)
        _emit_event(_hit_event, pk.ns, "device" if host is None else "host", e.nbytes)
        return payload

    def _count_hit(self, ns: str, e: _Entry, tier: str) -> None:
        if tier == "device":
            self.device_hits += 1
        else:
            self.host_hits += 1
        self.decode_bytes_saved += e.source_bytes
        self._bump_ns(ns, "hits")

    def _promote(self, ns: str, full: tuple, e: _Entry):
        """A host-tier hit goes back to the device (copied outside the
        lock) and its entry moves to the device tier. A failed copy, with
        degrade on, drops the entry and turns the hit into a miss (None):
        the caller reads the files again onto its session's device, where
        a device that is truly broken fails loudly. The host copy is never
        served in place of the device's."""
        try:
            dev_payload = _table_to_device(e.payload, e.device)
        except Exception:
            if not _faults.degrade_enabled():
                raise
            _faults.note(degraded_buffer_loads=1)
            with self._lock:
                if self._drop(full):
                    self.invalidations += 1
                self.degraded_loads += 1
                self.misses += 1
                self._bump_ns(ns, "misses")
            return None
        with self._lock:
            self._count_hit(ns, e, "host")
            cur = self._host.pop(full, None)
            if cur is None:  # a concurrent clear or eviction: serve, don't re-admit.
                return dev_payload
            self._host_nbytes -= cur.nbytes
            cur.payload = dev_payload
            self._device[full] = cur
            self._device_nbytes += cur.nbytes
            self.promotions += 1
            victims = self._pop_victims(self._device, "_device_nbytes", self.device_bytes)
        self._settle(victims)
        return dev_payload

    def put(self, pk: PoolKey, payload, nbytes: Optional[int] = None,
            device_only: bool = False) -> None:
        """Admit a freshly decoded payload to the device tier. A payload
        above the device budget is rejected rather than thrashing the LRU."""
        if nbytes is None:
            nbytes = table_nbytes(payload)
        device = None if device_only else _payload_device(payload)
        full = (pk.ns,) + tuple(pk.key)
        with self._lock:
            if nbytes > self.device_bytes:
                self.rejections += 1
                return
            self._drop(full)
            self._device[full] = _Entry(payload, nbytes, pk.source_bytes, device_only, device)
            self._device_nbytes += nbytes
            self.admissions += 1
            self.loads += 1
            victims = self._pop_victims(self._device, "_device_nbytes", self.device_bytes)
        self._settle(victims)

    def _settle(self, victims: list) -> None:
        """Device victims move to the host tier, or drop when device-only or
        when the host tier has no budget; host victims drop."""
        dropped = []  # (tier, nbytes, demoted)
        for full, e in victims:
            if e.device_only or self.host_bytes <= 0:
                dropped.append(("device", e.nbytes, False))
                continue
            try:
                host_payload = _table_to_host(e.payload)
            except Exception:
                if not _faults.degrade_enabled():
                    raise
                dropped.append(("device", e.nbytes, False))
                continue
            e.payload = host_payload
            with self._lock:
                self._host[full] = e
                self._host_nbytes += e.nbytes
                self.demotions += 1
                host_victims = self._pop_victims(self._host, "_host_nbytes", self.host_bytes)
            dropped.append(("device", e.nbytes, True))
            dropped.extend(("host", he.nbytes, False) for _, he in host_victims)
        evicted = sum(1 for _, _, demoted in dropped if not demoted)
        if evicted:
            with self._lock:
                self.evictions += evicted
        for tier, nbytes, demoted in dropped:
            _emit_event(_evict_event, tier, nbytes, demoted)

    # Maintenance and observability.

    def set_budgets(self, device_bytes: int, host_bytes: int) -> None:
        with self._lock:
            self.device_bytes = int(device_bytes)
            self.host_bytes = int(host_bytes)

    def clear(self, ns: Optional[str] = None) -> None:
        """Drop every entry, or one namespace's. Counters stay."""
        with self._lock:
            for tier, attr in ((self._device, "_device_nbytes"), (self._host, "_host_nbytes")):
                for full in [k for k in tier if ns is None or k[0] == ns]:
                    setattr(self, attr, getattr(self, attr) - tier.pop(full).nbytes)

    def ns_counts(self, ns: str) -> Tuple[int, int]:
        """(hits, misses) of one namespace."""
        with self._lock:
            slot = self._ns.get(ns)
            return (0, 0) if slot is None else (slot["hits"], slot["misses"])

    def ns_nbytes(self, ns: str) -> int:
        with self._lock:
            return sum(e.nbytes for tier in (self._device, self._host)
                       for k, e in tier.items() if k[0] == ns)

    def stats(self) -> dict:
        with self._lock:
            return {
                "device_hits": self.device_hits,
                "host_hits": self.host_hits,
                "hits": self.device_hits + self.host_hits,
                "misses": self.misses,
                "admissions": self.admissions,
                "rejections": self.rejections,
                "loads": self.loads,
                "promotions": self.promotions,
                "transfers": self.loads + self.promotions,
                "demotions": self.demotions,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "degraded_loads": self.degraded_loads,
                "decode_bytes_saved": self.decode_bytes_saved,
                "device_entries": len(self._device),
                "host_entries": len(self._host),
                "device_nbytes": self._device_nbytes,
                "host_nbytes": self._host_nbytes,
                "device_bytes": self.device_bytes,
                "host_bytes": self.host_bytes,
                "namespaces": {ns: dict(slot) for ns, slot in self._ns.items()},
            }

    def reset_stats(self) -> None:
        """Zero the counters; the entries stay."""
        with self._lock:
            self.device_hits = self.host_hits = self.misses = 0
            self.admissions = self.rejections = 0
            self.loads = self.promotions = self.demotions = self.evictions = 0
            self.invalidations = self.degraded_loads = self.decode_bytes_saved = 0
            self._ns.clear()


# ---------------------------------------------------------------------------
# The process-wide pool; the conf rides the parallel-io session scope.
# ---------------------------------------------------------------------------

_POOL: Optional[BufferPool] = None
_POOL_LOCK = threading.Lock()


def _conf():
    from ..parallel import io as pio
    session = pio.active_session()
    return session.hs_conf if session is not None else None


def enabled() -> bool:
    c = _conf()
    return True if c is None else c.buffer_pool_enabled()


def stream_admit_bytes() -> int:
    c = _conf()
    return _STREAM_ADMIT_BYTES_DEFAULT if c is None else c.buffer_pool_stream_admit_bytes()


def get_pool() -> BufferPool:
    """The process pool, its budgets refreshed from the session in scope."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = BufferPool(_DEVICE_BYTES_DEFAULT, _HOST_BYTES_DEFAULT)
        pool = _POOL
    c = _conf()
    if c is not None:
        pool.set_budgets(c.buffer_pool_device_bytes(), c.buffer_pool_host_bytes())
    return pool


def pool_stats() -> dict:
    """``Hyperspace.buffer_pool_stats()`` and the ``buffer_pool``
    collector."""
    return get_pool().stats()


_metrics.get_registry().register_collector(_mn.COLLECTOR_BUFFER_POOL, pool_stats)


# ---------------------------------------------------------------------------
# Keys.
# ---------------------------------------------------------------------------

def file_signature(files: Sequence[str]) -> Optional[tuple]:
    """((path, size, mtime), ...): any rewrite, append, refresh or
    optimize changes a size, an mtime or a path, so stale entries are never
    found again. None when a file cannot be stat'ed (the caller reads
    around the pool). A file on a data store is stat'ed through it."""
    from ..index import data_store
    sig = []
    for f in files:
        try:
            size, mtime = data_store.file_stamp(f)
        except OSError:
            return None
        sig.append((str(f), int(size), int(mtime)))
    return tuple(sig)


def _sig_bytes(sig: tuple) -> int:
    return sum(size for _, size, _ in sig)


def scan_key(files: Sequence[str], columns, filters, device) -> Optional[PoolKey]:
    """One bulk scan read: file signature, column set, the pushed filter
    (it is the row-group pruning choice) and the device."""
    sig = file_signature(files)
    if sig is None:
        return None
    cols = tuple(columns) if columns is not None else None
    return PoolKey("scan", (sig, cols, repr(filters), str(device)), _sig_bytes(sig))


def stream_key(files: Sequence[str], columns, filters, chunk_rows: int,
               device) -> Optional[PoolKey]:
    """One chunked filtered scan: the chunk size is part of it, since the
    replay must equal the stream chunk for chunk."""
    sig = file_signature(files)
    if sig is None:
        return None
    cols = tuple(columns) if columns is not None else None
    return PoolKey("stream", (sig, cols, repr(filters), int(chunk_rows), str(device)),
                   _sig_bytes(sig))


def index_key(key: tuple) -> PoolKey:
    """The index-table cache's namespace (its key carries the files'
    signature and the device)."""
    return PoolKey("index", tuple(key), 0)
