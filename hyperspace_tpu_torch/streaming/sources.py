"""Continuous ingestion sources: tailing daemons that drive append/commit
(counterpart of ``hyperspace_tpu/streaming/sources.py``).

A :class:`ContinuousSource` is a daemon (``parallel/io.spawn_daemon``)
that discovers new input, stages it through ``append()`` (load-time
indexing and all) and commits every ``source.commitBatches`` appends, plus
once more when input goes idle. Its appends block on a full staging
budget (up to ``backpressure.timeoutMs``) instead of raising.

Each poll fires the ``streaming.source`` fault point. Any poll failure is
counted, backed off one poll interval and retried; an item is acknowledged
only after its append succeeded, so a failed poll finds the same input
again, and the daemon never dies of a poll error.

- :class:`DirectoryTailSource` watches a drop directory for new
  ``*.parquet`` files (producers land them atomically; ``*.tmp`` names are
  skipped) and appends each as one batch.
- :class:`LogTailSource` tails a JSONL log by byte offset; each poll
  appends the complete new lines as one dict-of-columns batch.

While the SLO admission controller reports overload
(adaptive/admission.should_pause_ingest), a poll pulls no new input and
counts a pause: under load, serving drains first and ingest waits.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

import pyarrow.parquet as pq

from ..exceptions import HyperspaceException
from ..parallel import io as pio
from ..robustness import fault_names as _fn
from ..robustness import faults as _faults
from ..telemetry import span_names as SN
from ..telemetry import trace as _trace
from . import ingest


class ContinuousSource:
    """The tailing daemon. Subclasses implement ``_discover()`` (new work
    items, oldest first), ``_load(item)`` (an item as a batch append()
    takes, or None to skip it) and ``_ack(item)`` (mark it consumed, after
    its append). Mutable state is behind ``_lock``."""

    def __init__(self, session, table_path: str, name: Optional[str] = None):
        self._session = session
        self._table_path = os.path.abspath(table_path)
        self._name = name or type(self).__name__
        self._lock = threading.Lock()
        self._stop_flag = threading.Event()
        self._thread = None
        self._pending = 0  # appends no commit covers yet
        self._stats = {"polls": 0, "batches": 0, "rows": 0, "commits": 0, "errors": 0,
                       "waits": 0, "pauses": 0}

    def _discover(self) -> List:
        raise NotImplementedError

    def _load(self, item):
        raise NotImplementedError

    def _ack(self, item) -> None:
        raise NotImplementedError

    def start(self) -> "ContinuousSource":
        if not self._session.hs_conf.streaming_enabled():
            raise HyperspaceException(
                "hyperspace.tpu.streaming.enabled is false; enable it to run continuous sources")
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_flag.clear()
            self._thread = pio.spawn_daemon(f"hs-source-{self._name}", self._run)
        return self

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def stop(self, drain: bool = True, timeout_s: float = 60.0) -> dict:
        """Stop and join the daemon; with ``drain`` (the default) commit what
        it staged and had not committed. Returns the source's stats."""
        self._stop_flag.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout_s)
        if drain:
            with self._lock:
                pending = self._pending
                self._pending = 0
            if pending:
                try:
                    ingest.commit(self._session, self._table_path)
                except BaseException:
                    with self._lock:
                        self._pending += pending
                    raise
                with self._lock:
                    self._stats["commits"] += 1
        return self.stats()

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["pending"] = self._pending
        out["running"] = self.running()
        out["name"] = self._name
        out["table"] = self._table_path
        return out

    def _run(self) -> None:
        poll_s = self._session.hs_conf.streaming_source_poll_ms() / 1000.0
        # One fault scope for the daemon's life: nth= and times= count
        # across polls.
        with _faults.scope_for(self._session.hs_conf):
            while not self._stop_flag.is_set():
                try:
                    productive = self._poll_once()
                except Exception:
                    with self._lock:
                        self._stats["errors"] += 1
                    self._stop_flag.wait(poll_s)
                    continue
                if not productive:
                    self._idle_commit()
                    self._stop_flag.wait(poll_s)

    def _idle_commit(self) -> None:
        # A trickle must not wait staged until commitBatches fills.
        with self._lock:
            pending = self._pending
            self._pending = 0
        if pending:
            try:
                ingest.commit(self._session, self._table_path)
                with self._lock:
                    self._stats["commits"] += 1
            except Exception:
                with self._lock:
                    self._pending += pending
                    self._stats["errors"] += 1

    def _poll_once(self) -> bool:
        with self._lock:
            self._stats["polls"] += 1
        _faults.fault_point(_fn.STREAMING_SOURCE)
        # The overload pause: staged work still commits, serving drains.
        from ..adaptive.admission import get_controller
        if get_controller().should_pause_ingest(self._session):
            with self._lock:
                self._stats["pauses"] += 1
            return False
        items = self._discover()
        if not items:
            return False
        session = self._session
        commit_every = session.hs_conf.streaming_source_commit_batches()
        max_staged = session.hs_conf.streaming_max_staged_batches()
        queue = ingest.get_queue()
        appended = rows = commits = waits = 0
        with _trace.maintenance_trace(session, "source"), \
                _trace.span(SN.INGEST_SOURCE) as sp:
            for item in items:
                if self._stop_flag.is_set():
                    break
                payload = self._load(item)
                if payload is None:
                    self._ack(item)
                    continue
                if queue.staged_count(self._table_path) >= max_staged:
                    waits += 1  # the blocking append will wait
                res = ingest.append(session, self._table_path, payload, block=True)
                self._ack(item)
                appended += 1
                rows += res["rows"]
                with self._lock:
                    self._pending += 1
                    flushed = self._pending
                    flush = flushed >= commit_every
                    if flush:
                        self._pending = 0
                if flush:
                    try:
                        ingest.commit(session, self._table_path)
                    except BaseException:
                        with self._lock:
                            self._pending += flushed
                        raise
                    commits += 1
            if sp is not None:
                sp.attrs["batches"] = appended
                sp.attrs["rows"] = rows
                sp.attrs["commits"] = commits
        if appended or commits:
            with self._lock:
                self._stats["batches"] += appended
                self._stats["rows"] += rows
                self._stats["commits"] += commits
                self._stats["waits"] += waits
            self._emit(appended, rows, commits, waits)
        return bool(appended)

    def _emit(self, batches: int, rows: int, commits: int, waits: int) -> None:
        from ..telemetry.events import StreamingSourceEvent
        from ..telemetry.logging import log_event
        log_event(self._session, StreamingSourceEvent(
            message=(f"{self._name}: appended {batches} batches ({rows} rows), "
                     f"drove {commits} commits"),
            source=self._name, table=self._table_path, batches=batches, rows=rows,
            commits=commits, waits=waits))


class DirectoryTailSource(ContinuousSource):
    """Tail a drop directory: each new ``*.parquet`` file becomes one
    appended batch, oldest mtime first. Consumed names are remembered for
    the daemon's life, so producers must not reuse a name."""

    def __init__(self, session, watch_dir: str, table_path: str, name: Optional[str] = None):
        super().__init__(session, table_path, name=name or "dir-tail")
        self._watch_dir = os.path.abspath(watch_dir)
        self._seen: Dict[str, bool] = {}

    def _discover(self) -> List[str]:
        try:
            names = os.listdir(self._watch_dir)
        except OSError:
            return []
        with self._lock:
            fresh = [n for n in names if n.endswith(".parquet") and n not in self._seen]
        paths = [os.path.join(self._watch_dir, n) for n in sorted(fresh)]
        paths.sort(key=lambda p: (os.path.getmtime(p) if os.path.isfile(p) else 0.0, p))
        return paths

    def _load(self, item: str):
        try:
            table = pq.read_table(item)
        except OSError:
            return None  # gone between listing and read
        return table if table.num_rows else None

    def _ack(self, item: str) -> None:
        with self._lock:
            self._seen[os.path.basename(item)] = True


class LogTailSource(ContinuousSource):
    """Tail a JSONL log by byte offset: each poll appends the complete new
    lines past the consumed offset as one dict-of-columns batch. The offset
    moves only after the append, so a failed poll replays the same lines."""

    def __init__(self, session, log_path: str, table_path: str, name: Optional[str] = None):
        super().__init__(session, table_path, name=name or "log-tail")
        self._log_path = os.path.abspath(log_path)
        self._offset = 0

    def _discover(self) -> List[tuple]:
        with self._lock:
            offset = self._offset
        try:
            with open(self._log_path, "rb") as f:
                f.seek(offset)
                chunk = f.read()
        except OSError:
            return []
        # Only newline-terminated lines: a partial last line is mid-write.
        end = chunk.rfind(b"\n")
        if end < 0:
            return []
        records = [json.loads(line.decode("utf-8"))
                   for line in (ln.strip() for ln in chunk[:end + 1].splitlines()) if line]
        if not records:
            with self._lock:
                self._offset = offset + end + 1
            return []
        columns = sorted(records[0])
        return [(offset + end + 1, {c: [r.get(c) for r in records] for c in columns})]

    def _load(self, item: tuple):
        return item[1]

    def _ack(self, item: tuple) -> None:
        with self._lock:
            self._offset = max(self._offset, item[0])


def tail_directory(session, watch_dir: str, table_path: str,
                   name: Optional[str] = None) -> DirectoryTailSource:
    """Build and start a directory tailer."""
    return DirectoryTailSource(session, watch_dir, table_path, name=name).start()


def tail_log(session, log_path: str, table_path: str, name: Optional[str] = None) -> LogTailSource:
    """Build and start a JSONL log tailer."""
    return LogTailSource(session, log_path, table_path, name=name).start()
