"""Parallel I/O: pooled ordered file reads, file writes and prefetch pipelines
(counterpart of ``hyperspace_tpu/parallel/io.py``).

Three primitives, each with the sequential loop's results at any thread
count:

- ``map_ordered`` / ``imap_ordered`` fan ``fn(item)`` out over one
  process-wide bounded reader pool and gather the results in submission
  order: the multi-file parquet read, the sketch build's per-file reads and
  the chunked build's spill read-back.
- ``run_all`` runs ``fn(item)`` over threads of its own and waits for
  every call: the index builds' writes of one file a bucket.
- ``prefetch_iter`` advances a stream on a producer thread up to
  ``prefetchDepth`` items (and ``maxInflightBytes`` estimated bytes) ahead
  of the consumer, so chunk k+1 decodes while chunk k runs on the device.

None reorders anything, so file-to-row provenance (lineage ids, the
``FileIdTracker``'s ids, string dictionaries) does not depend on the thread
count. A pooled read's transient error is retried (robustness/retry.py,
with the ``io.pooled_read`` fault point inside the retried call); any
other failure raises at the consumer, and nothing falls back to another
path. The prefetch producer carries the ``io.prefetch_produce`` point, and
a query with a deadline polls it while it waits on a read or a producer. A pooled task that itself fans out runs that fan-out sequentially
inside the worker, so the pool never waits on itself. The conf is the
``hyperspace.tpu.io.*`` keys of the session that ``use_session`` scopes
(the executor and the action framework set it).

Telemetry rides the consumer side, where the per-query io counters are
credited (pool workers never see the query's context): one ``io.read``
span and one IoReadEvent per pooled fan-out, one ``io.prefetch`` span and
one IoWaitEvent per prefetch stream. The counters are the ``io`` collector
of the metrics registry.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

from ..robustness import fault_names as _fn
from ..robustness import faults as _faults
from ..robustness import retry as _retry
from ..serving.context import active_context, check_deadline, deadline_remaining_s
from ..telemetry import metric_names as _mn
from ..telemetry import metrics as _metrics
from ..telemetry import span_names as _sn
from ..telemetry import trace as _trace


@dataclass(frozen=True)
class IoParams:
    enabled: bool = True
    threads: int = 0  # 0 = auto: min(16, cpu count), at least 2.
    prefetch_depth: int = 2
    max_inflight_bytes: int = 256 * 1024 * 1024

    def resolved_threads(self) -> int:
        if self.threads > 0:
            return self.threads
        return min(16, max(2, os.cpu_count() or 4))


_DEFAULT_PARAMS = IoParams()

# The session whose conf governs the pool; conf values are read per call.
_SESSION: contextvars.ContextVar = contextvars.ContextVar("hst_torch_io_session",
                                                         default=None)


@contextlib.contextmanager
def use_session(session):
    """Scope the session whose ``hyperspace.tpu.io.*`` conf the primitives
    read (None = the defaults)."""
    token = _SESSION.set(session)
    try:
        yield
    finally:
        _SESSION.reset(token)


def params_from_conf(hs_conf) -> IoParams:
    return IoParams(enabled=bool(hs_conf.io_enabled()),
                    threads=max(int(hs_conf.io_threads()), 0),
                    prefetch_depth=max(int(hs_conf.io_prefetch_depth()), 1),
                    max_inflight_bytes=max(int(hs_conf.io_max_inflight_bytes()), 1))


def active_params() -> IoParams:
    session = _SESSION.get()
    return params_from_conf(session.hs_conf) if session is not None else _DEFAULT_PARAMS


def active_session():
    return _SESSION.get()


# ---------------------------------------------------------------------------
# The process-wide pool.
# ---------------------------------------------------------------------------

_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0
_IN_WORKER = threading.local()


def in_worker() -> bool:
    """True on a pool worker thread: nested fan-outs run sequentially, and
    readers stay single-threaded (the pool is the parallelism)."""
    return bool(getattr(_IN_WORKER, "flag", False))


def _executor(n: int) -> ThreadPoolExecutor:
    """The shared reader pool, grown (never shrunk) to ``n`` workers. A
    caller that asked for fewer threads is throttled by its submission
    window, not by the pool's size."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None or _pool_size < n:
            old = _pool
            _pool = ThreadPoolExecutor(max_workers=n, thread_name_prefix="hst-torch-io")
            _pool_size = n
            if old is not None:
                old.shutdown(wait=False)
        return _pool


# The serving frontend's workers run on a pool of their own, not the reader
# pool, so a query can still fan its reads out underneath.
_serving_lock = threading.Lock()
_serving_pool: Optional[ThreadPoolExecutor] = None
_serving_pool_size = 0


def submit_serving(fn: Callable, threads: int = 4):
    """Run ``fn()`` on the serving pool (grown, never shrunk, to
    ``threads``); returns the Future."""
    global _serving_pool, _serving_pool_size
    n = max(int(threads), 1)
    with _serving_lock:
        if _serving_pool is None or _serving_pool_size < n:
            old = _serving_pool
            _serving_pool = ThreadPoolExecutor(max_workers=n, thread_name_prefix="hst-torch-serve")
            _serving_pool_size = n
            if old is not None:
                old.shutdown(wait=False)
        pool = _serving_pool
    while True:
        try:
            return pool.submit(fn)
        except RuntimeError:
            # A concurrent grow replaced the pool: submit to the new one. The
            # same pool refusing was shut down for good (interpreter exit).
            with _serving_lock:
                if _serving_pool is pool:
                    raise
                pool = _serving_pool


def spawn_daemon(name: str, fn: Callable) -> threading.Thread:
    """Start ``fn()`` on a named daemon thread and return it: the
    long-lived service threads (the streaming tier's continuous sources)
    must hold no reader or serving slot. Nothing of the caller's context
    follows ``fn``."""
    t = threading.Thread(target=fn, name=name, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# Process-wide counters (explain's "I/O:" section, Hyperspace.io_stats).
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
_STATS = {
    "pooled_reads": 0,      # completed map_ordered fan-outs (more than one task)
    "read_tasks": 0,        # pooled fn(item) completions
    "read_bytes": 0,        # summed weight estimates of pooled tasks
    "read_seconds": 0.0,    # summed in-worker read+decode time
    "wait_seconds": 0.0,    # consumer time blocked on pool or prefetch results
    "prefetch_streams": 0,  # completed prefetch_iter pipelines
    "prefetch_items": 0,    # items that crossed a prefetch queue
}


def _note(**deltas) -> None:
    with _stats_lock:
        for k, v in deltas.items():
            _STATS[k] += v
    # The active query context (serving/context.py) is credited too, so the
    # reads are charged to the query that caused them.
    ctx = active_context()
    if ctx is not None:
        ctx.note_io(**deltas)


def pool_stats() -> dict:
    with _stats_lock:
        out = dict(_STATS)
    out["pool_threads"] = _pool_size
    return out


_metrics.get_registry().register_collector(_mn.COLLECTOR_IO, pool_stats)


def reset_stats() -> None:
    with _stats_lock:
        for k in _STATS:
            _STATS[k] = 0 if isinstance(_STATS[k], int) else 0.0


def _emit(session, event) -> None:
    target = session if session is not None else _SESSION.get()
    if target is None:
        return
    from ..telemetry.logging import log_event
    log_event(target, event)


def _emit_read(session, label: str, files: int, nbytes: int, seconds: float,
               threads: int) -> None:
    from ..telemetry.events import IoReadEvent
    _emit(session, IoReadEvent(message=f"pooled read '{label}': {files} file task(s)",
                               files=files, nbytes=nbytes, seconds=round(seconds, 4),
                               threads=threads))


def _emit_wait(session, label: str, wait_seconds: float, read_seconds: float,
               items: int) -> None:
    from ..telemetry.events import IoWaitEvent
    _emit(session, IoWaitEvent(message=f"prefetch stream '{label}': {items} item(s)",
                               where=label, wait_seconds=round(wait_seconds, 4),
                               read_seconds=round(read_seconds, 4), items=items))


# ---------------------------------------------------------------------------
# Ordered pooled map.
# ---------------------------------------------------------------------------

def imap_ordered(fn: Callable, items: Iterable, *, weight: Optional[Callable] = None,
                 params: Optional[IoParams] = None, label: str = "read",
                 session=None) -> Iterator:
    """Yield ``fn(item)`` for every item in order, the calls fanned out over
    the shared pool with a bounded window and in-flight byte budget.

    ``weight(item)`` estimates the bytes a result holds; submission pauses
    while the in-flight estimate exceeds ``maxInflightBytes`` (the first
    pending task always goes, so an oversized item still progresses). At
    most ``threads + prefetchDepth`` results are alive at once: the window,
    refilled just before each yield, plus the one the consumer holds.

    Sequential (a plain loop) when the pool is disabled, threads <= 1, for
    one item, or inside a pool worker. ``label`` names the fan-out in its
    span and event; ``session`` receives the event (else the scoped one).

    Each call is retried on a transient error (robustness/retry.py) with
    the ``io.pooled_read`` fault point inside the retried function; a query
    with a deadline polls it while it waits for a read.
    """
    items = list(items)
    p = params if params is not None else active_params()
    n = p.resolved_threads()
    # Taken on the consumer's side (pool workers see no contextvar): the
    # armed fault registry and the governing session's retry policy.
    reg = _faults.armed()
    sess = session if session is not None else _SESSION.get()
    pol = _retry.policy_from_conf(sess.hs_conf) if sess is not None else _retry.DEFAULT_POLICY

    def _read(it):
        def _attempt():
            _faults.fault_point(_fn.IO_POOLED_READ, reg=reg)
            return fn(it)

        return _retry.call(_attempt, where="io.pooled_read", policy=pol, session=sess)

    if not p.enabled or n <= 1 or len(items) <= 1 or in_worker():
        # The process-wide counters count pooled work only; the active
        # query context is charged for these reads all the same.
        ctx = active_context()
        if ctx is not None and items:
            ctx.note_io(read_tasks=len(items),
                        read_bytes=sum(int(weight(it)) for it in items)
                        if weight is not None else 0)
        for it in items:
            yield _read(it)
        return

    def _task(it):
        _IN_WORKER.flag = True
        t0 = time.perf_counter()
        return _read(it), time.perf_counter() - t0

    ex = _executor(n)

    def _submit(it):
        # A concurrent stream may replace the pool (grow-only); the old one
        # finishes what it has but refuses new work.
        nonlocal ex
        while True:
            try:
                return ex.submit(_task, it)
            except RuntimeError:
                ex = _executor(n)

    window = max(n + max(p.prefetch_depth, 0) - 1, 1)
    pending: deque = deque()
    inflight = 0
    i = done = nbytes = 0
    read_s = wait_s = 0.0
    t_start = time.perf_counter()

    def _refill():
        nonlocal i, inflight
        while i < len(items) and len(pending) < window:
            w = int(weight(items[i])) if weight is not None else 0
            if pending and inflight + w > p.max_inflight_bytes:
                break
            pending.append((_submit(items[i]), w))
            inflight += w
            i += 1

    has_deadline = deadline_remaining_s() is not None
    try:
        _refill()
        while pending:
            fut, w = pending.popleft()
            t0 = time.perf_counter()
            if has_deadline:
                # A query with a deadline polls instead of blocking on a
                # wedged read; the finally cancels the window.
                while True:
                    check_deadline("io.read")
                    try:
                        result, task_s = fut.result(timeout=0.05)
                        break
                    except FutureTimeout:
                        if fut.done():
                            # Done in the race after the wait timed out, or
                            # the task itself raised TimeoutError (the same
                            # class from 3.11): its own outcome.
                            result, task_s = fut.result()
                            break
            else:
                result, task_s = fut.result()
            wait_s += time.perf_counter() - t0
            inflight -= w
            done += 1
            read_s += task_s
            nbytes += w
            # Refill before yielding: the next reads run while the consumer
            # works on this result.
            _refill()
            yield result
    finally:
        for fut, _ in pending:
            fut.cancel()
        _note(pooled_reads=1, read_tasks=done, read_bytes=nbytes,
              read_seconds=read_s, wait_seconds=wait_s)
        _trace.add_span(_sn.IO_READ, start_perf=t_start, label=label, files=done,
                        nbytes=nbytes, read_seconds=round(read_s, 4),
                        wait_seconds=round(wait_s, 4), threads=n)
        _emit_read(session, label, done, nbytes, read_s, n)


def map_ordered(fn: Callable, items: Iterable, **kwargs) -> list:
    """``list(imap_ordered(...))``, for callers that need every result."""
    return list(imap_ordered(fn, items, **kwargs))


def run_all(fn: Callable, items: Iterable, *, params: Optional[IoParams] = None) -> None:
    """Call ``fn(item)`` for every item on up to ``threads`` threads of the
    call's own: the writes of separate files, which the reader pool's
    size, counters, spans and events leave out. Sequential when the pool
    is disabled, threads <= 1, for one item, or inside a pool worker,
    where the first error stops the loop. Threaded, every call has ended
    when this returns, and the first error is raised then."""
    items = list(items)
    p = params if params is not None else active_params()
    n = p.resolved_threads()
    if not p.enabled or n <= 1 or len(items) <= 1 or in_worker():
        for it in items:
            fn(it)
        return
    with ThreadPoolExecutor(max_workers=min(n, len(items)),
                            thread_name_prefix="hst-torch-write") as ex:
        futures = [ex.submit(fn, it) for it in items]
    for fut in futures:
        fut.result()


def zip_prefetch(items, fn: Callable, **kwargs) -> Iterator:
    """(item, fn(item)) pairs in order, the reads pooled ahead of the
    consumer (the sketch build's per-file pipeline)."""
    items = list(items)
    return zip(items, imap_ordered(fn, items, **kwargs))


# ---------------------------------------------------------------------------
# Producer/consumer prefetch.
# ---------------------------------------------------------------------------

_DONE = object()


def prefetch_iter(source: Iterable, *, nbytes: Optional[Callable] = None,
                  params: Optional[IoParams] = None,
                  label: str = "prefetch", session=None) -> Iterator:
    """Iterate ``source`` with a producer thread up to ``prefetchDepth``
    items (and ``maxInflightBytes`` estimated bytes) ahead of the consumer.
    Order, values and exceptions are the source's own: an error in the
    producer raises at the consumer. A consumer that stops early stops and
    closes the producer.

    The producer runs under a copy of the caller's context, so
    contextvar-scoped state (the executing session) is as if the source ran
    inline. Pass-through (no thread) when the pool is disabled, threads <=
    1, or inside a pool worker.
    """
    p = params if params is not None else active_params()
    if not p.enabled or p.resolved_threads() <= 1 or in_worker():
        yield from source
        return

    depth = max(p.prefetch_depth, 1)
    cond = threading.Condition()
    buf: deque = deque()
    state = {"bytes": 0, "closed": False, "read_s": 0.0, "error": None}

    def _room() -> bool:
        return len(buf) < depth and (not buf or state["bytes"] < p.max_inflight_bytes)

    def _produce():
        it = iter(source)
        try:
            while True:
                # Wait for room before advancing the source: producing first
                # would hold one more item than the depth allows.
                with cond:
                    while not _room() and not state["closed"]:
                        cond.wait()
                    if state["closed"]:
                        break
                t0 = time.perf_counter()
                try:
                    # The producer runs under a copy of the consumer's
                    # context, so the armed registry reaches it; an error
                    # crosses the queue and raises at the consumer.
                    _faults.fault_point(_fn.IO_PREFETCH_PRODUCE)
                    item = next(it)
                except StopIteration:
                    break
                state["read_s"] += time.perf_counter() - t0
                w = int(nbytes(item)) if nbytes is not None else 0
                with cond:
                    if state["closed"]:
                        break
                    buf.append((item, w))
                    state["bytes"] += w
                    cond.notify_all()
        except BaseException as e:  # raised again at the consumer.
            with cond:
                state["error"] = e
                cond.notify_all()
        finally:
            try:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            except BaseException as e:
                with cond:
                    state["error"] = state["error"] or e
            finally:
                with cond:
                    buf.append((_DONE, 0))
                    cond.notify_all()

    ctx = contextvars.copy_context()
    producer = threading.Thread(target=ctx.run, args=(_produce,),
                                name=f"hst-torch-prefetch-{label}", daemon=True)
    producer.start()
    wait_s = 0.0
    items = 0
    t_start = time.perf_counter()
    has_deadline = deadline_remaining_s() is not None
    try:
        while True:
            t0 = time.perf_counter()
            with cond:
                while not buf and state["error"] is None:
                    # A query with a deadline polls the wait, so a stalled
                    # producer cannot outlive the cancellation.
                    cond.wait(0.05 if has_deadline else None)
                    if has_deadline:
                        check_deadline("io.prefetch")
                if state["error"] is not None and not buf:
                    raise state["error"]
                item, w = buf.popleft()
                state["bytes"] -= w
                cond.notify_all()
            wait_s += time.perf_counter() - t0
            if item is _DONE:
                if state["error"] is not None:
                    raise state["error"]
                break
            items += 1
            yield item
    finally:
        with cond:
            state["closed"] = True
            buf.clear()
            state["bytes"] = 0
            cond.notify_all()
        producer.join()
        _note(prefetch_streams=1, prefetch_items=items, wait_seconds=wait_s,
              read_seconds=state["read_s"])
        _trace.add_span(_sn.IO_PREFETCH, start_perf=t_start, label=label, items=items,
                        read_seconds=round(state["read_s"], 4),
                        wait_seconds=round(wait_s, 4))
        _emit_wait(session, label, wait_s, state["read_s"], items)
