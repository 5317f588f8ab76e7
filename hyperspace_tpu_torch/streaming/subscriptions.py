"""Standing queries: plans fired again on every streaming commit
(counterpart of ``hyperspace_tpu/streaming/subscriptions.py``).

``ServingFrontend.subscribe(df)`` registers the plan; every ``commit()`` to
a table it reads submits it again through the frontend's workers, so
admission control and deadlines apply as to ad-hoc queries. Each fire
re-lists the plan's relations, so a delivery holds the committed rows.
Deliveries land on the subscription's bounded buffer; consumers wait on
``wait_for`` or ``latest``, or read ``deliveries()``.

Subscriptions whose fresh plans share a literal-sweep template fire as one
wave through ``ServingFrontend.submit_wave``: one shared scan, and each
member's own mask (the serving tier's batch design). A fire the frontend
refuses is delivered as that fire's error, never skipped.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..exceptions import HyperspaceException, ServingRejectedError


class Delivery:
    """One fire's outcome: ``result`` (an executed Table) or ``error``."""

    __slots__ = ("seq", "table", "result", "error", "at_s")

    def __init__(self, seq: int, table: str, result=None, error=None):
        self.seq = seq
        self.table = table
        self.result = result
        self.error = error
        self.at_s = time.perf_counter()

    @property
    def ok(self) -> bool:
        return self.error is None


class Subscription:
    """The handle ``ServingFrontend.subscribe`` returns. Deliveries arrive
    from serving workers, so every mutable field is guarded by ``_cv``."""

    def __init__(self, registry: "SubscriptionRegistry", sub_id: int, plan, session,
                 client: str, deadline_ms: Optional[float], history: int):
        self._registry = registry
        self.sub_id = sub_id
        self.plan = plan
        self.session = session
        self.client = client or f"standing:{sub_id}"
        self.deadline_ms = deadline_ms
        # The tables the plan reads (absolute roots): a commit elsewhere
        # does not fire it.
        self.tables = _source_roots(plan)
        self._cv = threading.Condition()
        self._deliveries: "deque[Delivery]" = deque(maxlen=history)
        self._delivered_total = 0
        self._fired_total = 0
        self._active = True

    def fresh_plan(self, relation_memo: Optional[dict] = None):
        """The plan with every file-based relation listed anew now (a
        relation pins its listing; a standing query follows the stream).
        ``relation_memo`` shares one listing per root set across a fire, so
        N subscriptions on one table walk its directory once. A leaf that
        cannot refresh keeps its relation."""
        from ..plan.nodes import Scan

        def refresh(node):
            if isinstance(node, Scan) and getattr(node, "relation", None) is not None:
                try:
                    key = (tuple(node.relation.root_paths), node.relation.file_format)
                    fresh = None if relation_memo is None else relation_memo.get(key)
                    if fresh is None:
                        fresh = node.relation.refresh()
                        # Listed at fire time: the delivery answers the
                        # table as of the commit that fired it.
                        fresh.all_files()
                        if relation_memo is not None:
                            relation_memo[key] = fresh
                    return Scan(fresh, skipping_note=node.skipping_note)
                except Exception:
                    return node
            return node

        try:
            return self.plan.transform_up(refresh)
        except Exception:
            return self.plan

    @property
    def active(self) -> bool:
        with self._cv:
            return self._active

    def _close(self) -> None:
        with self._cv:
            self._active = False
            self._cv.notify_all()

    def _next_seq(self) -> int:
        with self._cv:
            self._fired_total += 1
            return self._fired_total

    def _deliver(self, seq: int, table: str, result=None, error=None) -> None:
        with self._cv:
            self._deliveries.append(Delivery(seq, table, result, error))
            self._delivered_total += 1
            self._cv.notify_all()

    def deliveries(self) -> List[Delivery]:
        with self._cv:
            return list(self._deliveries)

    @property
    def delivered_total(self) -> int:
        with self._cv:
            return self._delivered_total

    def wait_for(self, n: int, timeout: float = 30.0) -> List[Delivery]:
        """Wait until ``n`` deliveries in all have arrived; returns the
        buffered (most recent) ones. TimeoutError past ``timeout``; a
        HyperspaceException once unsubscribed."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._delivered_total < n:
                if not self._active:
                    raise HyperspaceException(
                        f"subscription {self.sub_id} closed after {self._delivered_total}/{n} "
                        "deliveries")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"subscription {self.sub_id}: {self._delivered_total}/"
                                       f"{n} deliveries after {timeout}s")
                self._cv.wait(remaining)
            return list(self._deliveries)

    def latest(self, timeout: float = 30.0) -> Delivery:
        """The delivery of the latest fire (by sequence number, not arrival:
        a slow earlier fire may finish after a later one), waiting for the
        first if none arrived yet."""
        with self._cv:
            have = self._delivered_total
        if have == 0:
            self.wait_for(1, timeout)
        with self._cv:
            return max(self._deliveries, key=lambda d: d.seq)

    def unsubscribe(self) -> bool:
        return self._registry.unsubscribe(self)


class SubscriptionRegistry:
    """A frontend's standing queries, registered from client threads and
    fired from whichever thread commits; the table is lock-guarded."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: Dict[int, Subscription] = {}
        self._next_id = 0
        self._stats = {"subscribed": 0, "unsubscribed": 0, "fires": 0, "fired_queries": 0,
                       "rejected_queries": 0, "wave_groups": 0, "wave_members": 0}

    def subscribe(self, frontend, query, session, client: str, deadline_ms: Optional[float],
                  max_subs: int, history: int) -> Subscription:
        plan = getattr(query, "plan", query)
        with self._lock:
            live = len(self._subs)
            if live >= max_subs:
                raise HyperspaceException(
                    f"{live} standing queries reach hyperspace.tpu.streaming.subscriptions.max")
            self._next_id += 1
            sub = Subscription(self, self._next_id, plan, session, client, deadline_ms, history)
            self._subs[sub.sub_id] = sub
            self._stats["subscribed"] += 1
        return sub

    def unsubscribe(self, sub: Subscription) -> bool:
        with self._lock:
            dropped = self._subs.pop(sub.sub_id, None) is not None
            if dropped:
                self._stats["unsubscribed"] += 1
        if dropped:
            sub._close()
        return dropped

    def fire(self, frontend, session, table: str) -> int:
        """Submit every live subscription that reads ``table`` (re-listed
        fresh) through the frontend. Same-template subscriptions go as one
        ``submit_wave``; the rest one ``submit`` each. Returns the fires
        admitted; refused fires are delivered as errors."""
        with self._lock:
            subs = list(self._subs.values())
        subs = [s for s in subs if s.active and (not table or not s.tables or table in s.tables)]
        fired = rejected = 0
        relation_memo: dict = {}
        batching = frontend.batching_enabled()
        plans: List[tuple] = []  # (sub, seq, plan, template key or None)
        for sub in subs:
            seq = sub._next_seq()
            plan = sub.fresh_plan(relation_memo)
            key = None
            if batching:
                try:
                    from ..serving import batcher
                    from ..serving.fingerprint import normalize
                    key = batcher.template_key(sub.session, normalize(plan))
                except Exception:
                    key = None
            plans.append((sub, seq, plan, key))
        buckets: Dict[object, List[tuple]] = {}
        for item in plans:
            buckets.setdefault(item[3], []).append(item)
        waves = members = 0
        for key, group in buckets.items():
            if key is not None and len(group) >= 2:
                waves += 1
                members += len(group)
                f, r = self._fire_wave(frontend, table, group)
            else:
                f, r = self._fire_singles(frontend, table, group)
            fired += f
            rejected += r
        with self._lock:
            self._stats["fires"] += 1 if subs else 0
            self._stats["fired_queries"] += fired
            self._stats["rejected_queries"] += rejected
            self._stats["wave_groups"] += waves
            self._stats["wave_members"] += members
        if subs:
            self._emit(session, table, fired, rejected, waves)
        return fired

    @staticmethod
    def _emit(session, table: str, fired: int, rejected: int, groups: int) -> None:
        from ..telemetry.events import StandingQueryEvent
        from ..telemetry.logging import log_event
        log_event(session, StandingQueryEvent(
            message=(f"commit re-fired {fired} standing "
                     f"quer{'y' if fired == 1 else 'ies'}"
                     + (f" in {groups} shared-scan group{'s' if groups != 1 else ''}"
                        if groups else "")
                     + (f", shed {rejected}" if rejected else "")),
            table=table, fired=fired, rejected=rejected, groups=groups))

    def _fire_singles(self, frontend, table: str, group: List[tuple]) -> tuple:
        fired = rejected = 0
        for sub, seq, plan, _key in group:
            try:
                pending = frontend.submit(plan, session=sub.session, client=sub.client,
                                          deadline_ms=sub.deadline_ms)
            except Exception as e:
                # Any submit failure is this fire's error: it never reaches
                # the committer, whose commit is durable.
                sub._deliver(seq, table, error=e)
                if isinstance(e, ServingRejectedError):
                    rejected += 1
                continue
            pending.on_done(_delivery_callback(sub, seq, table))
            fired += 1
        return fired, rejected

    def _fire_wave(self, frontend, table: str, group: List[tuple]) -> tuple:
        """One same-template group through submit_wave, whose slots align
        with the group: a PendingQuery per admitted member, else the
        exception a lone submit would have raised."""
        fired = rejected = 0
        try:
            results = frontend.submit_wave([(plan, sub.session, sub.client, sub.deadline_ms)
                                            for sub, _seq, plan, _key in group])
        except Exception as e:
            results = [e] * len(group)
        for (sub, seq, _plan, _key), res in zip(group, results):
            if isinstance(res, Exception):
                sub._deliver(seq, table, error=res)
                if isinstance(res, ServingRejectedError):
                    rejected += 1
                continue
            res.on_done(_delivery_callback(sub, seq, table))
            fired += 1
        return fired, rejected

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["live"] = len(self._subs)
        return out


def _source_roots(plan) -> frozenset:
    """Absolute root paths of every file-based leaf (empty when any leaf is
    opaque: such a plan fires on every commit)."""
    roots = set()
    try:
        for leaf in plan.collect_leaves():
            relation = getattr(leaf, "relation", None)
            if relation is None or not hasattr(relation, "root_paths"):
                return frozenset()
            roots.update(os.path.abspath(p) for p in relation.root_paths)
    except Exception:
        return frozenset()
    return frozenset(roots)


def _delivery_callback(sub: Subscription, seq: int, table: str):
    """The completion hook a serving worker runs at the query's finish."""

    def _on_done(pending) -> None:
        sub._deliver(seq, table, result=pending._result, error=pending._error)

    return _on_done
