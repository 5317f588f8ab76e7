"""What a traced run records, and the device facts every run reports.

In a traced run (``--trace 1``) the benchmark wraps, from its own files:

- the port's ``telemetry.trace.finish_root``, to keep every finished span
  tree (the port's own spans: ``plan.normalize``, ``exec.stage``, ...);
- the executor's ``read_parquet``, ``read_relation_files`` and
  ``iter_dataset_chunks`` (a generator: per item), host clock, outermost
  call per thread;
- the kernels' ``cuda_kernels._launch``, to count each launch's bytes
  while the profiler runs;

it reads the frontend's and the buffer pool's counters at the window's
open and close, and profiles a slice of the window (CUDA activity only)
with ``torch.profiler``. The per-layer readers (``metrics/<name>.py``)
take their numbers from the :class:`Readings` this leaves.
"""

from __future__ import annotations

import importlib
import inspect
import subprocess
import threading
import time

from hsbench import reduce as red
from hsbench import roofline

# How much of the window the profiler covers, at most (its middle).
PROFILE_S = 10.0


def device_info(device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Readings:
    """What the per-layer readers read: the queries answered in the window,
    its length, the counters' deltas, the span trees, the scan reads, and
    the profiled slice (device records and kernel launches)."""

    def __init__(self):
        self.queries: list = []
        self.window_s = 0.0
        self.serving: dict = {}
        self.pool: dict = {}
        self.traces: list = []
        self.scan_read_s = 0.0
        self.scan_reads = 0
        self.launches: list = []  # (wrapper name, least bytes)
        self.device_events: list = []  # (name, start, end) on the host's clock
        self.slice = None  # (start, end) on the host's clock
        self.clock = ""


def _counters(cell) -> tuple:
    from hyperspace_tpu_torch.execution import buffer_pool
    fe = cell.frontend.stats()
    pool = buffer_pool.get_pool().stats()
    return ({k: fe[k] for k in ("completed", "batched_queries", "batches", "shared_scans")},
            {k: pool[k] for k in ("hits", "misses")})


class Instruments:
    def __init__(self, cell, trace: bool):
        self.cell, self.trace = cell, trace
        self.r = Readings()
        self._lock = threading.Lock()
        self._saved: list = []
        self._depth = threading.local()
        self._window = (0.0, float("inf"))
        self._profiling = False
        self._before = None
        self._power = ""

    # Wrappers.

    def _patch(self, obj, attr, make) -> None:
        orig = getattr(obj, attr)
        self._saved.append((obj, attr, orig))
        setattr(obj, attr, make(orig))

    def __enter__(self):
        if not self.trace:
            return self
        from hyperspace_tpu_torch.execution import executor
        from hyperspace_tpu_torch.ops import cuda_kernels
        from hyperspace_tpu_torch.telemetry import trace as ttrace

        def keep_trace(orig):
            def finish_root(session, tr):
                with self._lock:
                    self.r.traces.append(tr)
                return orig(session, tr)
            return finish_root

        def count_launch(orig):
            def _launch(name, x, *args, **kw):
                if self._profiling:
                    n = roofline.launch_bytes(name, x, args)
                    with self._lock:
                        self.r.launches.append((name, n))
                return orig(name, x, *args, **kw)
            return _launch

        self._patch(ttrace, "finish_root", keep_trace)
        self._patch(cuda_kernels, "_launch", count_launch)
        for attr in ("read_parquet", "read_relation_files", "iter_dataset_chunks"):
            self._patch(executor, attr, self._timed)
        return self

    def __exit__(self, *exc):
        for obj, attr, orig in reversed(self._saved):
            setattr(obj, attr, orig)
        self._saved.clear()

    def _add_read(self, t0: float) -> None:
        t1 = time.perf_counter()
        lo, hi = self._window
        if lo <= t0 <= hi:
            with self._lock:
                self.r.scan_read_s += t1 - t0
                self.r.scan_reads += 1

    def _timed(self, fn):
        def items(it):
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    self._add_read(t0)
                    return
                self._add_read(t0)
                yield item

        def wrapper(*a, **k):
            depth = getattr(self._depth, "n", 0)
            if depth:
                return fn(*a, **k)
            t0 = time.perf_counter()
            self._depth.n = 1
            try:
                out = fn(*a, **k)
            finally:
                self._depth.n = 0
                self._add_read(t0)
            return items(out) if inspect.isgenerator(out) else out
        return wrapper

    # The window.

    def during(self, t_start: float, t_end: float) -> None:
        """On the main thread while the clients run: the counters at the
        open, and in a traced run the profiled slice."""
        self._window = (t_start, t_end)
        self._before = _counters(self.cell)
        if self.cell.device == "cuda":
            from hyperspace_tpu_torch.ops import cuda_kernels
            self._launches0 = dict(cuda_kernels.LAUNCHES)
        if not self.trace:
            return
        if self.cell.device == "cuda":
            self._power = power_limit()
            length = min(PROFILE_S, t_end - t_start)
            time.sleep(max(0.0, t_start + (t_end - t_start - length) / 2 - time.perf_counter()))
            self._profile(length, t_end)

    @staticmethod
    def prime_profiler() -> None:
        """Start and stop the profiler once in set-up: its first start
        loads and initialises CUPTI, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def _profile(self, length: float, t_end: float) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        e0, p0 = time.time_ns(), time.perf_counter()
        self._profiling = True
        time.sleep(max(0.0, min(p0 + length, t_end) - time.perf_counter()))
        self._profiling = False
        p1 = time.perf_counter()
        torch.cuda.synchronize()
        prof.stop()
        events = []
        for ev in prof.profiler.kineto_results.events():
            if str(ev.device_type()).split(".")[-1] != "CUDA":
                continue
            events.append((ev.name(), ev.start_ns(), ev.end_ns()))
        # The profiler's clock is the wall clock in ns: map it onto the
        # host's perf_counter; where most records fall outside the slice
        # that way, the first record is taken as the slice's start.
        mapped = [(n, p0 + (s - e0) / 1e9, p0 + (e - e0) / 1e9) for n, s, e in events]
        inside = sum(1 for _, s, _ in mapped if p0 - 0.5 <= s <= p1 + 0.5)
        self.r.clock = "wall"
        if events and inside < 0.9 * len(events):
            first = min(s for _, s, _ in events)
            mapped = [(n, p0 + (s - first) / 1e9, p0 + (e - first) / 1e9)
                      for n, s, e in events]
            self.r.clock = "first record"
        self.r.device_events = mapped
        self.r.slice = (p0, p1)
        from hsbench.harness import log
        names: dict = {}
        for n, _, _ in mapped:
            k = red.kernel_name(n)
            names[k] = names.get(k, 0) + 1
        log(f"profiled {p1 - p0:.2f} s: {len(mapped)} device records ({self.r.clock} clock, "
            f"{inside} inside the slice), kernels of the port: "
            f"{ {k: v for k, v in names.items() if 'mask' in k or 'bucket' in k} }, "
            f"launches counted {len(self.r.launches)}")

    def freeze(self, queries: list, in_window: list, t_start: float, t_end: float) -> None:
        """After the window: the counters' deltas and the window's facts."""
        after = _counters(self.cell)
        before = self._before or after
        if self.cell.device == "cuda" and self.trace:
            from hyperspace_tpu_torch.ops import cuda_kernels
            from hsbench.harness import log
            log(f"kernel launches in the window: "
                f"{ {k: v - self._launches0.get(k, 0) for k, v in cuda_kernels.LAUNCHES.items()} }")
        self.r.queries = in_window
        self.r.window_s = t_end - t_start
        self.r.serving = {k: after[0][k] - before[0][k] for k in after[0]}
        self.r.pool = {k: after[1][k] - before[1][k] for k in after[1]}
        # Span trees whose root opened in the window.
        self.r.traces = [tr for tr in self.r.traces
                         if tr.spans and t_start <= tr.spans[0].start_perf <= t_end]

    # What the line reports.

    def readings(self) -> dict:
        from hsbench import metrics
        out = {}
        for name in metrics.names():
            reader = importlib.import_module(f"hsbench.metrics.{name}")
            out[name] = reader.read(self.r)
        return out

    def device_extra(self) -> dict:
        if self.r.slice is None:
            return {}
        lo, hi = self.r.slice
        busy = red.covered([(s, e) for _, s, e in self.r.device_events], lo, hi)
        return {"busy_s": busy, "window_s": hi - lo, "card": self._power,
                "profiler_clock": self.r.clock}

    def breakdown(self) -> dict:
        """The ten device operations that took most time in the slice, and
        the ten longest idle gaps, each named by the innermost port span
        open at its middle on any thread."""
        if self.r.slice is None:
            return {"device_ops": [], "idle_gaps": []}
        lo, hi = self.r.slice
        per_op: dict = {}
        for n, s, e in self.r.device_events:
            key = red.kernel_name(n)
            per_op[key] = per_op.get(key, 0.0) + max(0.0, min(e, hi) - max(s, lo))
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
        spans = [s for tr in self.r.traces for s in tr.spans if s.end_perf is not None]
        gaps = sorted(red.gaps([(s, e) for _, s, e in self.r.device_events], lo, hi),
                      key=lambda g: g[0] - g[1])[:10]
        named = []
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            open_ = [s for s in spans if s.start_perf <= mid <= s.end_perf]
            inner = max(open_, key=lambda s: s.start_perf, default=None)
            label = "no port span open" if inner is None else inner.name + (
                f" {inner.attrs['node']}" if "node" in inner.attrs else "")
            named.append([label, g1 - g0])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
