"""The process-wide concurrent serving frontend (counterpart of
``hyperspace_tpu/serving/frontend.py``).

One :class:`ServingFrontend` takes queries from many sessions and runs
them on a bounded pool of worker threads, sharing what is safe to share:

- results: a frontend-owned cross-session result cache. Its keys pin the
  plan, the sources, the index log versions and the session's conf hash,
  so an entry computed for one session is served to another only where
  executing there would give the same bytes;
- literal sweeps: queued queries whose plans differ only in Filter
  literals run as one batch over a shared scan (serving/batcher.py). A
  member that fails inside the batch runs again alone; ``member_fallbacks``
  counts those reruns.

Admission control keeps it honest under load: a bounded queue
(``queueDepth``) and an in-flight input-byte budget
(``admission.maxBytes``; a query alone always runs). A refused submission
raises :class:`~..exceptions.ServingRejectedError` at once.

The workers run on the serving pool of ``parallel/io.py``, not the reader
pool, so a query still fans its reads out. Each submission takes a
``contextvars.copy_context()`` snapshot and executes inside it, so the
io session scope and the query context follow the query onto the worker.
Each worker executes on the device of the member's session.

Standing queries (``subscribe``, ``unsubscribe``, ``notify_commit``;
streaming/subscriptions.py) fire through the same workers on every
streaming commit to a table they read.

The conf is ``hyperspace.tpu.serving.*``, read from the frontend's
governing session at each decision. Telemetry: the ServingAdmit, Reject
and Batch events; a sweep's members nest their ``query`` spans under one
shared ``serving.sweep`` span; every completed query feeds the
``serving.latency_ms`` histogram; the process-default frontend is the
``serving`` collector.

SLO admission (adaptive/admission.py): while an armed objective is
breached and ``adaptive.enabled`` holds, a submission is shed
(ServingRejectedError, as a full queue) or degraded: it runs alone, never
in a sweep, and an eligible aggregate runs over a sampled prefix of its
files and carries ``approx_error_bound``.

Degradation ladders (robustness/, under ``robustness.degrade.enabled``): a
worker that dies between popping an entry and starting it (the
``serving.worker`` fault point) releases the held members to run alone
(``worker_releases``); a sweep member that fails runs again alone
(``member_fallbacks``). With degrade off both failures land as they are.

Cluster routing (cluster/worker.py): with ``cluster.enabled`` and
``cluster.routing.enabled``, a submission whose result-cache shard another
live worker owns is shipped there, and any failure runs it here, to the
same bytes.
"""

from __future__ import annotations

import contextvars
import threading
import time
import weakref
from collections import deque
from typing import List, Optional

from ..exceptions import HyperspaceException, QueryDeadlineError, ServingRejectedError
from ..parallel import io as pio
from ..robustness import fault_names as _fn
from ..robustness import faults as _faults
from . import batcher
from .context import QueryContext, deadline_cancel, next_query_id
from .fingerprint import estimate_recompute_bytes, normalize


class PendingQuery:
    """The handle :meth:`ServingFrontend.submit` returns."""

    def __init__(self, query_id: int, client: str, estimated_bytes: int):
        self.query_id = query_id
        self.client = client
        self.estimated_bytes = estimated_bytes
        self.submitted_s = time.perf_counter()
        self.started_s: Optional[float] = None
        self.completed_s: Optional[float] = None
        self.batched = False
        self.batch_size = 0
        self.context: Optional[QueryContext] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._done_cb = None
        self._cb_lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def on_done(self, cb) -> None:
        """Call ``cb(self)`` once when the query completes: on the worker
        that finishes it, or now if it already did (the standing-query
        delivery hook). ``cb`` must be quick; what it raises is dropped."""
        with self._cb_lock:
            if not self._event.is_set():
                self._done_cb = cb
                return
        try:
            cb(self)
        except Exception:
            pass

    def result(self, timeout: Optional[float] = None):
        """The executed Table, once done. Raises the query's own error if it
        failed, TimeoutError on a timeout."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"query {self.query_id} not done after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_s is None:
            return None
        return self.completed_s - self.submitted_s

    def _finish(self, result=None, error: Optional[BaseException] = None) -> None:
        self.completed_s = time.perf_counter()
        self._result = result
        self._error = error
        with self._cb_lock:
            self._event.set()
            cb = self._done_cb
            self._done_cb = None
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass  # a delivery hook never fails the query


class _Entry:
    __slots__ = ("plan", "norm", "session", "ctx", "pending", "batch_key", "deadline_s",
                 "approx")

    def __init__(self, plan, norm, session, ctx, pending, batch_key, deadline_s=None,
                 approx=False):
        self.plan = plan
        self.norm = norm
        self.session = session
        self.ctx = ctx  # the submitter's contextvars.Context snapshot
        self.pending = pending
        self.batch_key = batch_key  # None: never batched
        self.deadline_s = deadline_s  # absolute perf_counter, or None
        self.approx = approx  # SLO degrade: try the approximate tier


class ServingFrontend:
    """One instance serves the process; sessions are its clients."""

    def __init__(self, session):
        # The governing session: its conf carries the serving family.
        self._session = session
        self._hs_conf = session.hs_conf
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: "deque[_Entry]" = deque()
        self._active_workers = 0
        self._inflight_bytes = 0
        # The cross-session result cache, rebuilt (and so emptied) when the
        # governing conf's serving.result_cache budgets change.
        from ..config import CacheWithTransform
        from .result_cache import build_result_cache
        self._shared_cache_holder = CacheWithTransform(
            self._hs_conf.result_cache_conf_string,
            lambda raw: build_result_cache(self._session))
        self._stats = {
            "submitted": 0, "admitted": 0, "rejected": 0, "completed": 0, "failed": 0,
            "batches": 0, "batched_queries": 0, "shared_scans": 0, "shared_scan_hits": 0,
            "member_fallbacks": 0,
        }
        from ..streaming.subscriptions import SubscriptionRegistry
        self._subscriptions = SubscriptionRegistry()
        # Building one is the opt-in: the first live frontend becomes the
        # process default, which serving_stats() and explain read.
        global _DEFAULT
        with _DEFAULT_LOCK:
            _ALL_FRONTENDS.add(self)
            if _DEFAULT is None:
                _DEFAULT = self
                from ..telemetry import metric_names as MN
                from ..telemetry import metrics as _metrics
                _metrics.get_registry().register_collector(MN.COLLECTOR_SERVING, self.stats)

    def result_cache(self):
        """The cross-session result cache (None while the governing conf
        has it off)."""
        return self._shared_cache_holder.load()

    # Submission and admission control.

    def submit(self, query, session=None, client: str = "",
               deadline_ms: Optional[float] = None) -> PendingQuery:
        """Queue one query (a DataFrame, or a plan with ``session``) and
        return at once. Raises :class:`ServingRejectedError` when admission
        control refuses it. ``deadline_ms`` bounds the query from submit
        time, the queue wait included; past it the query is cancelled and
        ``result()`` raises QueryDeadlineError."""
        plan = getattr(query, "plan", query)
        session = session if session is not None else getattr(query, "session", None)
        if session is None:
            raise HyperspaceException("submit() needs a DataFrame or an explicit session=")
        norm = normalize(plan)
        est = estimate_recompute_bytes(norm)
        # The cluster router: the finished answer of the shard's owner, or
        # None to run here. A disabled cluster costs one conf read.
        if self._hs_conf.cluster_routing_enabled():
            from ..cluster import worker as _cluster
            forwarded = _cluster.try_forward(session, plan, norm, client=client,
                                             deadline_ms=deadline_ms, est=est)
            if forwarded is not None:
                with self._lock:
                    self._stats["submitted"] += 1
                    self._stats["admitted"] += 1
                self._observe_latency(forwarded)
                return forwarded
        batch_key = batcher.template_key(session, norm) \
            if self._hs_conf.serving_batching_enabled() else None
        # A degraded query never joins a sweep, which shares exact scans.
        approx = self._slo_admission(session, client, est)
        if approx:
            batch_key = None
        pending = PendingQuery(next_query_id(), client, est)
        deadline_s = time.perf_counter() + deadline_ms / 1000.0 \
            if deadline_ms is not None and deadline_ms > 0 else None
        depth = self._hs_conf.serving_queue_depth()
        max_bytes = self._hs_conf.serving_admission_max_bytes()
        with self._lock:
            self._stats["submitted"] += 1
            self._admit_or_raise(session, client, est, depth, max_bytes)
            entry = _Entry(plan, norm, session, contextvars.copy_context(), pending,
                           batch_key, deadline_s, approx)
            self._queue.append(entry)
            queued = len(self._queue)
            spawn = self._active_workers < self._hs_conf.serving_max_concurrency()
            if spawn:
                self._active_workers += 1
            # Wake every worker waiting out a batching window: notify()
            # could pick one holding an incompatible batch.
            self._cv.notify_all()
        self._emit_admit(session, client, est, queued)
        if spawn:
            try:
                pio.submit_serving(self._drain, self._hs_conf.serving_max_concurrency())
            except BaseException:
                # Roll the admission back, unless a worker took the entry.
                with self._lock:
                    self._active_workers -= 1
                    try:
                        self._queue.remove(entry)
                    except ValueError:
                        pass
                    else:
                        self._inflight_bytes = max(0, self._inflight_bytes - est)
                        self._stats["admitted"] -= 1
                raise
        return pending

    def _slo_admission(self, session, client: str, est: int) -> bool:
        """The admission controller's verdict for one submission
        (adaptive/admission.py): raises ServingRejectedError when it sheds,
        returns True when it degrades, False when it admits."""
        if not session.hs_conf.adaptive_enabled():
            return False
        from ..adaptive.admission import get_controller
        verdict = get_controller().decide(session)
        if verdict == "shed":
            with self._lock:
                self._stats["submitted"] += 1
                self._stats["rejected"] += 1
            reason = "slo breach: shedding load"
            self._emit_reject(session, client, est, reason)
            raise ServingRejectedError(f"serving admission rejected query: {reason}")
        return verdict == "degrade"

    def _admit_or_raise(self, session, client: str, est: int, depth: int,
                        max_bytes: int) -> None:
        """Under the lock: count the admission and charge its bytes, or
        count the rejection, emit its event and raise."""
        queued = len(self._queue)
        inflight = self._inflight_bytes
        if queued >= depth or (inflight > 0 and inflight + est > max_bytes):
            self._stats["rejected"] += 1
            reason = (f"queue full ({queued}/{depth})" if queued >= depth
                      else f"byte budget ({inflight + est} > {max_bytes})")
            self._emit_reject(session, client, est, reason)
            raise ServingRejectedError(f"serving admission rejected query: {reason}")
        self._stats["admitted"] += 1
        self._inflight_bytes += est

    def batching_enabled(self) -> bool:
        """Whether the governing conf batches literal variants (the
        standing-query fire asks before grouping)."""
        return self._hs_conf.serving_batching_enabled()

    def submit_wave(self, requests: List[tuple]) -> List:
        """Admit a group formed by the caller as one literal-sweep batch,
        past the queue's window and ``maxBatch``. Each request is ``(plan,
        session, client, deadline_ms)``. The returned list is aligned with
        ``requests``: a :class:`PendingQuery` per admitted member, or the
        exception ``submit()`` would have raised (a full queue sheds a
        member, as it does a single query). One member's rejection never
        aborts the wave."""
        out: List = []
        entries: List[_Entry] = []
        depth = self._hs_conf.serving_queue_depth()
        max_bytes = self._hs_conf.serving_admission_max_bytes()
        for plan, session, client, deadline_ms in requests:
            try:
                norm = normalize(plan)
                est = estimate_recompute_bytes(norm)
                approx = self._slo_admission(session, client, est)
                pending = PendingQuery(next_query_id(), client, est)
                deadline_s = time.perf_counter() + deadline_ms / 1000.0 \
                    if deadline_ms is not None and deadline_ms > 0 else None
                with self._lock:
                    self._stats["submitted"] += 1
                    self._admit_or_raise(session, client, est, depth, max_bytes)
                    queued = len(self._queue)
                self._emit_admit(session, client, est, queued)
                entries.append(_Entry(plan, norm, session, contextvars.copy_context(),
                                      pending, None, deadline_s, approx))
                out.append(pending)
            except Exception as e:  # the member's own refusal, returned in place
                out.append(e)
        if entries:
            with self._lock:
                self._active_workers += 1
            try:
                pio.submit_serving(lambda: self._drain_wave(entries),
                                   self._hs_conf.serving_max_concurrency())
            except BaseException as e:
                # No worker will run these members: fail them and release
                # their admission.
                with self._lock:
                    self._active_workers -= 1
                for entry in entries:
                    entry.pending._finish(error=e)
                    self._note(failed=1)
                    self._release(entry)
        return out

    def _drain_wave(self, entries: List[_Entry]) -> None:
        """One caller-formed wave: the degraded members alone, then a single
        other member alone, more as one sweep. Any escape releases the
        unstarted members to run alone, and the worker slot always comes
        back."""
        try:
            sweepers = [e for e in entries if not e.approx]
            for e in entries:
                if e.approx:
                    self._run_single(e)
            if len(sweepers) == 1:
                self._run_single(sweepers[0])
            elif sweepers:
                self._run_batch(sweepers)
        except BaseException as e:
            self._release_batch(entries, e)
        finally:
            with self._lock:
                self._active_workers -= 1

    # Standing queries (the streaming tier).

    def subscribe(self, query, session=None, client: str = "",
                  deadline_ms: Optional[float] = None):
        """Register a standing query: the plan fires again through this
        frontend's workers on every streaming commit to a table it reads.
        Returns a :class:`~..streaming.subscriptions.Subscription`;
        ``deadline_ms`` bounds each fire as a submit() deadline does."""
        session = session if session is not None else getattr(query, "session", None)
        if session is None:
            raise HyperspaceException("subscribe() needs a DataFrame or an explicit session=")
        return self._subscriptions.subscribe(
            self, query, session, client, deadline_ms,
            self._hs_conf.streaming_subscriptions_max(),
            self._hs_conf.streaming_subscription_history())

    def unsubscribe(self, subscription) -> bool:
        return self._subscriptions.unsubscribe(subscription)

    def notify_commit(self, session, table: str = "") -> int:
        """Fire every live standing query over ``table`` (the streaming tier
        calls this after a commit publishes). Returns the fires admitted."""
        return self._subscriptions.fire(self, session, table)

    # The worker loop.

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    self._active_workers -= 1
                    return
                entry = self._queue.popleft()
            batch = [entry]
            # A worker that dies with entries in hand would strand their
            # futures and leak the byte budget: everything past the pop is
            # guarded, and the worker lives on.
            try:
                # Under the head entry's submit-time context: the submitter's
                # armed scope reaches this point, the worker carries none.
                entry.ctx.run(_faults.fault_point, _fn.SERVING_WORKER)
                window = self._hs_conf.serving_batching_window()
                limit = self._hs_conf.serving_batching_max_batch()
                with self._lock:
                    self._collect_batch(entry, batch, limit)
                if entry.batch_key is not None and window > 0 and len(batch) < limit:
                    # Hold the door one window open for batchable arrivals;
                    # submits notify the condition, so the batch is
                    # collected again as they land, and a full batch goes
                    # at once.
                    deadline = time.monotonic() + window
                    with self._lock:
                        while len(batch) < limit:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            self._cv.wait(remaining)
                            self._collect_batch(entry, batch, limit)
                if len(batch) == 1:
                    self._run_single(entry)
                else:
                    self._run_batch(batch)
            except BaseException as e:
                self._release_batch(batch, e)

    def _release_batch(self, batch: List[_Entry], error) -> None:
        """After a worker's failure outside any one query: with degrade on,
        members never started run alone (their own errors land on their own
        futures) and count as degraded; started but unfinished members, and
        every member with degrade off, get the worker's error."""

        for b in batch:
            if b.pending.done():
                continue
            if b.pending.started_s is None and b.session.hs_conf.robustness_degrade_enabled():
                _faults.note(worker_releases=1)
                self._run_single(b, degraded=True)  # it lands its own outcome
                continue
            b.pending._finish(error=error)
            self._note(failed=1)
            self._release(b)

    def _collect_batch(self, head: _Entry, batch: List[_Entry], limit: int) -> None:
        """Under the lock: move queued entries batchable with ``head`` into
        ``batch``, in submission order."""
        if head.batch_key is None or len(batch) >= limit:
            return
        keep = deque()
        while self._queue and len(batch) < limit:
            e = self._queue.popleft()
            if e.batch_key == head.batch_key:
                batch.append(e)
            else:
                keep.append(e)
        keep.extend(self._queue)
        self._queue.clear()
        self._queue.extend(keep)

    def _run_single(self, entry: _Entry, degraded: bool = False) -> None:
        entry.pending.started_s = time.perf_counter()
        try:
            self._check_entry_deadline(entry)
            result = entry.ctx.run(self._execute_entry, entry, None, None, degraded)
            entry.pending._finish(result=result)
            self._note(completed=1)
        except BaseException as e:  # the submitter gets the error
            entry.pending._finish(error=e)
            self._note(failed=1)
        finally:
            self._release(entry)
            self._observe_latency(entry.pending)

    @staticmethod
    def _check_entry_deadline(entry: _Entry) -> None:
        """Fail a query whose deadline passed in the queue before paying for
        any execution. The SLO window records it as a failed query: it never
        reaches Session.execute's own feed."""
        if entry.deadline_s is None or time.perf_counter() < entry.deadline_s:
            return
        from ..telemetry import slo as _slo
        waited_ms = (time.perf_counter() - entry.pending.submitted_s) * 1000.0
        _slo.observe_query(entry.session, waited_ms, error=True)
        deadline_cancel(entry.session, entry.pending.query_id, "serving.queue", waited_ms)

    def _sweep_trace(self, batch: List[_Entry]):
        """The shared sweep trace: one ``serving.sweep`` span whose
        children are the members' ``query`` roots, opened only when the
        governing conf traces, and handed to members through
        ``QueryContext.trace_parent`` (their submit-time context snapshots
        predate the batch). The sweep shares one retention coin."""
        if not self._hs_conf.telemetry_trace_enabled():
            return None
        from ..telemetry import span_names as SN
        from ..telemetry import trace as _trace
        tr = _trace.Trace(label="sweep", sampled=_trace.sample_coin(self._session))
        return tr, tr.new_span(SN.SERVING_SWEEP, None, {"size": len(batch)})

    def _run_batch(self, batch: List[_Entry]) -> None:
        """Literal-variant members under one SweepContext: one shared scan
        per source; each member otherwise runs its own path (its own masks,
        result-cache key and pipeline)."""
        try:
            conditions = [batcher.plan_template(e.norm)[1] for e in batch]
        except batcher.Unbatchable:
            for e in batch:
                self._run_single(e)
            return
        sweep = batcher.SweepContext(len(batch))
        trace_parent = self._sweep_trace(batch)
        for e in batch:
            e.pending.started_s = time.perf_counter()
            e.pending.batched = True
            e.pending.batch_size = len(batch)
            try:
                self._check_entry_deadline(e)
                try:
                    result = e.ctx.run(self._execute_entry, e, sweep, trace_parent)
                except QueryDeadlineError:
                    raise
                except BaseException:
                    # One member's failure inside the sweep must poison
                    # neither its siblings nor itself: it runs again alone,
                    # and a lasting error comes from that run unchanged.
                    # The rerun counts as degraded (the SLO degrade rate).
                    # With degrade off the failure is the member's answer.
                    if not e.session.hs_conf.robustness_degrade_enabled():
                        raise
                    self._note(member_fallbacks=1)
                    _faults.note(member_fallbacks=1)
                    result = e.ctx.run(self._execute_entry, e, None, trace_parent, True)
                e.pending._finish(result=result)
                self._note(completed=1)
            except BaseException as err:
                e.pending._finish(error=err)
                self._note(failed=1)
            finally:
                self._release(e)
                self._observe_latency(e.pending)
        s = sweep.stats()
        if trace_parent is not None:
            sweep_tr, sweep_span = trace_parent
            if sweep_span is not None:
                sweep_span.attrs["positions"] = len(conditions[0])
                sweep_span.attrs["members"] = len(batch)
                sweep_span.finish()
            # The frontend owns the shared trace's retention.
            from ..telemetry import trace as _trace
            _trace.finish_root(self._session, sweep_tr)
        self._note(batches=1, batched_queries=len(batch), shared_scans=s["shared_scans"],
                   shared_scan_hits=s["shared_scan_hits"])
        self._emit_batch(batch, len(conditions[0]), s)

    def _execute_entry(self, entry: _Entry, sweep: Optional[batcher.SweepContext],
                       trace_parent=None, degraded: bool = False):
        qc = QueryContext.for_session(entry.session, shared_cache=self.result_cache(),
                                      client=entry.pending.client,
                                      deadline_s=entry.deadline_s,
                                      query_id=entry.pending.query_id)
        qc.trace_parent = trace_parent
        qc.degraded = degraded
        # A sweep attempt's failure is rescued by a rerun alone (with degrade
        # on), whose outcome is the query's real SLO sample.
        qc.slo_suppress_error = sweep is not None and \
            entry.session.hs_conf.robustness_degrade_enabled()
        entry.pending.context = qc
        if entry.approx and sweep is None:
            # The SLO degrade tier: an eligible plan runs sampled, its result
            # carries its stated error bound and counts as degraded.
            from ..adaptive.admission import approximate_plan
            hit = approximate_plan(entry.session, entry.plan)
            if hit is not None:
                approx_plan, bound = hit
                qc.degraded = True
                result = entry.session.execute(approx_plan, context=qc)
                result.approx_error_bound = dict(bound)
                return result
        with batcher.use_sweep(sweep):
            return entry.session.execute(entry.plan, context=qc)

    def _observe_latency(self, pending: PendingQuery) -> None:
        """Feed the live ``serving.latency_ms`` histogram (the rolling
        p50/p95/p99 and QPS of ``Hyperspace.metrics()``)."""
        if pending.latency_s is None:
            return
        from ..telemetry import metric_names as MN
        from ..telemetry import metrics as _metrics
        _metrics.get_registry().histogram(MN.SERVING_LATENCY_MS).record(
            pending.latency_s * 1000.0)

    def _release(self, entry: _Entry) -> None:
        with self._lock:
            self._inflight_bytes = max(0, self._inflight_bytes - entry.pending.estimated_bytes)

    # Observability.

    def _note(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["queued"] = len(self._queue)
            out["active_workers"] = self._active_workers
            out["inflight_bytes"] = self._inflight_bytes
        cache = self.result_cache()
        out["shared_result_cache"] = cache.stats() if cache is not None else None
        from .program_bank import get_bank
        out["program_bank"] = get_bank().stats()
        out["subscriptions"] = self._subscriptions.stats()
        return out

    def _emit_admit(self, session, client: str, est: int, depth: int) -> None:
        from ..telemetry.events import ServingAdmitEvent
        from ..telemetry.logging import log_event
        log_event(session, ServingAdmitEvent(
            message=f"query admitted (queue depth {depth})", client=client,
            estimated_bytes=est, queue_depth=depth))

    def _emit_reject(self, session, client: str, est: int, reason: str) -> None:
        from ..telemetry.events import ServingRejectEvent
        from ..telemetry.logging import log_event
        log_event(session, ServingRejectEvent(
            message=f"query rejected: {reason}", client=client, estimated_bytes=est,
            reason=reason))

    def _emit_batch(self, batch: List[_Entry], positions: int, s: dict) -> None:
        from ..telemetry.events import ServingBatchEvent
        from ..telemetry.logging import log_event
        log_event(batch[0].session, ServingBatchEvent(
            message=(f"literal sweep: {len(batch)} queries, 0 batched invocation(s), "
                     f"{s['shared_scans']} shared scan(s)"),
            size=len(batch), positions=positions, sweep_invocations=0,
            shared_scans=s["shared_scans"]))

    def drain(self, timeout: float = 60.0) -> None:
        """Block until the queue is empty and the workers idle."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and self._active_workers == 0:
                    return
            time.sleep(0.005)
        raise TimeoutError("serving frontend did not drain")


# The process-default frontend (Hyperspace.serving_frontend).

_DEFAULT: Optional[ServingFrontend] = None
# Reentrant: get_frontend constructs under it, and __init__ takes it again.
_DEFAULT_LOCK = threading.RLock()
# Every live frontend (weakly held).
_ALL_FRONTENDS: "weakref.WeakSet[ServingFrontend]" = weakref.WeakSet()


def all_frontends() -> List[ServingFrontend]:
    """Every live frontend in the process."""
    with _DEFAULT_LOCK:
        return list(_ALL_FRONTENDS)


def get_frontend(session) -> ServingFrontend:
    """The process-default frontend, built on first use with ``session``
    governing it. Requires ``hyperspace.tpu.serving.enabled=true`` on that
    session (a directly built frontend needs no switch)."""
    if not session.hs_conf.serving_enabled():
        raise HyperspaceException(
            "hyperspace.tpu.serving.enabled is false; set it (or construct "
            "ServingFrontend directly) to use the serving tier")
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = ServingFrontend(session)
        return _DEFAULT
