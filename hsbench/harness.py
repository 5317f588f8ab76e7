"""The benchmark of hyperspace_tpu_torch: one cell, one run.

    python3 hsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its clients and its mix of query templates
(``queries/<template>.py``) with their literal domains (``params.py``).
Nothing here names a cell, a configuration or a template: a new one is a
new file.

A run:

1. set-up: the configuration's tables made from the seed by its generator
   (``data/<generator>.py``), a session with the configuration's conf, the
   covering indexes the cell's templates read, the kernels built or
   loaded, and every template run once alone and then under the cell's
   full load, for ``warmup_s`` seconds; ``setup_s`` ends there;
2. the window: ``clients`` closed-loop clients, each submitting its next
   query through the serving frontend when its last answer is in hand as
   arrow, for ``--seconds``;
3. the check: every answer waited for, a sample of them (drawn from the
   seed) held to the plain reference (``compare.py``, ``refdata.py``);
4. one JSON line: ``correct``, ``attempted``, ``failed``, the metrics,
   the device, and last the compared numbers beside their limits.

With ``--trace 1`` the same run also records the per-layer readings
(``instruments.py``) and profiles a slice of the window; the line then
carries the per-layer metrics that ``BENCHMARK.json`` gives this cell.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import random
import shutil
import statistics
import sys
import tempfile
import threading
import time

from hsbench import compare as cmp
from hsbench import params as prm
from hsbench.refdata import RefData

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that must not be loaded: the JAX package and
# JAX itself. Compared whole: hyperspace_tpu_torch is the system.
FORBIDDEN = ("jax", "jaxlib", "flax", "hyperspace_tpu")
# How long past the window's close an answer is waited for.
LATE_S = 60.0


def log(msg: str) -> None:
    print(f"[hsbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple:
    """(workload, configuration) of a cell, by name."""
    work = load_json(BENCH_DIR, "workloads", f"{name}.json")
    return work, load_json(BENCH_DIR, "configs", f"{work['config']}.json")


def template(name: str):
    return importlib.import_module(f"hsbench.queries.{name}")


def cell_metrics(name: str, trace: bool) -> list:
    """The metrics BENCHMARK.json asks of this cell: its end-to-end ones,
    or with ``trace`` its per-layer ones."""
    spec = load_json(ROOT, "BENCHMARK.json")
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Set-up.
# ---------------------------------------------------------------------------

class Cell:
    """One cell's system under test: the data, the session and its
    indexes, the frontend, the templates and their draws."""

    def __init__(self, work: dict, config: dict, seed: int, root: str, device: str,
                 scale=None):
        self.work, self.config, self.seed, self.root = work, config, seed, root
        self.device = device
        gen = importlib.import_module(f"hsbench.data.{config['generator']}")
        cfg = dict(config, scale=scale) if scale is not None else config
        t0 = time.perf_counter()
        self.data = gen.make(os.path.join(root, "data"), cfg, seed)
        log(f"data {self.data['rows']} in {time.perf_counter() - t0:.1f} s")
        self.dirs = self.data["dirs"]
        self.mix = work["mix"]
        self.templates = {m["template"]: template(m["template"]) for m in self.mix}
        self.sql = {m["template"]: hasattr(self.templates[m["template"]], "text")
                    for m in self.mix}
        self.session = self._session()
        self.frontend = self._frontend()

    def _session(self):
        import hyperspace_tpu_torch as ht

        session = ht.Session(system_path=os.path.join(self.root, "indexes"),
                             device=self.device)
        for k, v in self.config["conf"].items():
            session.conf.set(k, v)
        if self.device == "cuda":
            from hyperspace_tpu_torch.ops import cuda_kernels
            t0 = time.perf_counter()
            cuda_kernels.build()
            log(f"kernels ready in {time.perf_counter() - t0:.1f} s")
        views = self.config.get("views", False)
        if views:
            for table, d in self.dirs.items():
                session.create_temp_view(table, session.read.parquet(d))
        wanted = {i for m in self.mix for i in m["indexes"]}
        hs = ht.Hyperspace(session)
        for spec in self.config["indexes"]:
            if spec["name"] not in wanted:
                continue
            t0 = time.perf_counter()
            source = session.table(spec["table"]) if views else \
                session.read.parquet(self.dirs[spec["table"]])
            hs.create_index(source, ht.IndexConfig(spec["name"], spec["indexed"],
                                                   spec["included"]))
            log(f"built {spec['name']} in {time.perf_counter() - t0:.1f} s")
            wanted.discard(spec["name"])
        if wanted:
            raise ValueError(f"indexes {sorted(wanted)} are not in the configuration")
        session.enable_hyperspace()
        return session

    def _frontend(self):
        from hyperspace_tpu_torch.serving.frontend import get_frontend
        return get_frontend(self.session)

    def plan(self, entry: dict, params: dict):
        """The template's DataFrame for these literals (SQL: lowered from
        its text), and the seconds the lowering took."""
        t = self.templates[entry["template"]]
        if self.sql[entry["template"]]:
            t0 = time.perf_counter()
            df = self.session.sql(t.text(params))
            return df, time.perf_counter() - t0
        return t.build(self.session, self.dirs, params), 0.0


class Query:
    __slots__ = ("client", "entry", "params", "keep", "t0", "t1", "lower_s", "query_id",
                 "table", "error")

    def __init__(self, client: int, entry: dict, params: dict, keep: bool):
        self.client, self.entry, self.params, self.keep = client, entry, params, keep
        self.t0 = self.t1 = None
        self.lower_s = 0.0
        self.query_id = None
        self.table = None
        self.error = None


class Client:
    """One closed-loop client: its literal stream comes from the seed and
    its number alone, so the same seed sends the same queries in the same
    order, however fast they are answered."""

    def __init__(self, cell: Cell, number: int, seed: int):
        self.cell, self.number = cell, number
        self.rng = prm.client_rng(seed, number)
        self.keep_rng = random.Random(f"hsbench-keep:{seed}:{number}")
        self.deck: list = []
        self.done: list = []

    def next_entry(self) -> dict:
        """The next template from this client's deck: each template
        ``weight`` times a deck, in the client's own order, so every seed
        sends the mix in its exact proportions."""
        if not self.deck:
            self.deck = [m for m in self.cell.mix for _ in range(int(m["weight"]))]
            self.rng.shuffle(self.deck)
        return self.deck.pop()

    def next_query(self) -> Query:
        entry = self.next_entry()
        p = prm.draw(entry["params"], self.rng)
        keep = self.keep_rng.random() < entry["sample"]["rate"]
        return Query(self.number, entry, p, keep)

    def run_one(self, q: Query, timeout: float) -> None:
        q.t0 = time.perf_counter()
        try:
            df, q.lower_s = self.cell.plan(q.entry, q.params)
            pending = self.cell.frontend.submit(df, client=f"client{self.number}")
            q.query_id = pending.query_id
            table = pending.result(timeout=timeout).to_arrow()
            q.table = table if q.keep else None
        except Exception as e:  # the query's failure is its outcome
            q.error = f"{type(e).__name__}: {e}"
        q.t1 = time.perf_counter()

    def loop(self, until: float, timeout: float) -> None:
        while time.perf_counter() < until:
            q = self.next_query()
            self.run_one(q, timeout)
            self.done.append(q)


def run_clients(cell: Cell, seed: int, seconds: float, timeout: float, during=None):
    """``clients`` closed-loop clients for ``seconds``; a query sent before
    the close is waited for. ``during(t_start, t_end)`` runs on this thread
    meanwhile. Returns (clients, t_start, t_end)."""
    clients = [Client(cell, i, seed) for i in range(int(cell.work["clients"]))]
    t_start = time.perf_counter()
    t_end = t_start + seconds
    threads = [threading.Thread(target=c.loop, args=(t_end, timeout), daemon=True,
                                name=f"hsbench-client{c.number}") for c in clients]
    for t in threads:
        t.start()
    if during is not None:
        during(t_start, t_end)
    for t in threads:
        t.join(seconds + timeout + LATE_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client did not finish past the window's close")
    return clients, t_start, t_end


class PlanLog:
    """The index names of each executed plan, by query id: a wrapper of the
    session's ``_run_optimized``, which every execution passes with its
    optimized plan under the query's context."""

    def __init__(self, session):
        from hyperspace_tpu_torch.serving.context import active_context

        self.indexes: dict = {}
        self._lock = threading.Lock()
        run = session._run_optimized

        def wrapped(optimized):
            names = {getattr(getattr(leaf, "index_entry", None), "name", None)
                     for leaf in optimized.collect_leaves()} - {None}
            ctx = active_context()
            if ctx is not None:
                with self._lock:
                    self.indexes.setdefault(ctx.query_id, set()).update(names)
            return run(optimized)

        session._run_optimized = wrapped

    def missing(self, q: Query) -> list:
        """The indexes the template's plan must read and this query's did not."""
        return sorted(set(q.entry["indexes"]) - self.indexes.get(q.query_id, set()))


def warm_up(cell: Cell, seed: int, plans: PlanLog, timeout: float) -> None:
    """Each template alone with two literals (its plan must read its
    indexes), then the cell's full load for ``warmup_s``."""
    rng = prm.client_rng(seed, -1)
    for entry in cell.mix:
        for _ in range(2):
            q = Query(-1, entry, prm.draw(entry["params"], rng), False)
            Client(cell, -1, seed).run_one(q, timeout)
            if q.error:
                raise RuntimeError(f"warm-up {entry['template']}: {q.error}")
            if plans.missing(q):
                raise RuntimeError(f"warm-up {entry['template']}: the plan does not read "
                                   f"{plans.missing(q)} (read {plans.indexes.get(q.query_id)})")
    run_clients(cell, seed ^ 0x5A5A5A5A, float(cell.work["warmup_s"]), timeout)
    cell.frontend.drain(timeout)


def settle(root: str) -> None:
    """The end of set-up: every file set-up wrote (tables, indexes) flushed
    to the disk, and the objects set-up made moved out of the collector's
    reach, so that neither the write-back of those files nor a collection
    of set-up's heap falls into the window."""
    for d, _, files in os.walk(root):
        for f in files:
            fd = os.open(os.path.join(d, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    gc.collect()
    gc.freeze()


# ---------------------------------------------------------------------------
# The check.
# ---------------------------------------------------------------------------

def answers_to_check(queries: list, seed: int) -> list:
    """The kept answers, at most ``sample.params`` distinct literal sets a
    template (chosen from the seed), every answer with those literals."""
    rng = random.Random(f"hsbench-sample:{seed}")
    by_template: dict = {}
    for q in queries:
        if q.keep and q.table is not None:
            by_template.setdefault(q.entry["template"], []).append(q)
    out = []
    for name in sorted(by_template):
        qs = by_template[name]
        keys = sorted({json.dumps(q.params, default=str, sort_keys=True) for q in qs})
        rng.shuffle(keys)
        chosen = set(keys[:int(qs[0].entry["sample"]["params"])])
        out += [q for q in qs if json.dumps(q.params, default=str, sort_keys=True) in chosen]
    return out


def check_answers(cell: Cell, checked: list, control: str = "") -> dict:
    """Each checked answer against the reference worked out in float64.
    With ``control="float32"`` the answers are the reference's own, worked
    out in float32, in the program's place."""
    import numpy as np
    import pyarrow as pa

    ref = RefData(cell.dirs)
    reads: dict = {}
    for name in {q.entry["template"] for q in checked}:
        for table, cols in cell.templates[name].READS.items():
            reads.setdefault(table, set()).update(cols)
    for table, cols in reads.items():
        ref.load(table, sorted(cols))
    out = {"mismatched": 0, "rel_err": 0.0, "compared": 0, "first": ""}
    memo: dict = {}
    for q in checked:
        t = cell.templates[q.entry["template"]]
        key = (q.entry["template"], json.dumps(q.params, default=str, sort_keys=True))
        if key not in memo:
            memo[key] = t.reference(ref, q.params, np.float64)
        want = memo[key]
        got = q.table
        if control == "float32":
            low = t.reference(ref, q.params, np.float32)
            k = getattr(t, "TOP_K", 0)
            got = pa.table({c: (v[:k] if k else v) for c, v in low.items()})
            got = _typed_like(got, q.table)
        r = cmp.compare(got, want, floats=t.FLOATS, ordered=t.ORDERED,
                        top_k=getattr(t, "TOP_K", 0), tie=getattr(t, "TIE", ""),
                        tie_rel=float(cell.work["checks"]["max_rel_err"]))
        out["compared"] += 1
        out["rel_err"] = max(out["rel_err"], r.rel_err)
        if r.mismatch:
            out["mismatched"] += 1
            if not out["first"]:
                out["first"] = f"{q.entry['template']} {q.params}: {r.why}"
    return out


def _typed_like(table, like):
    """``table`` cast to ``like``'s schema (dates, widths), column by column."""
    import pyarrow as pa
    cols = []
    for name, field in zip(like.column_names, like.schema):
        arr = table.column(name)
        if pa.types.is_date32(field.type):
            arr = arr.cast(pa.int32()).cast(pa.date32())
        elif pa.types.is_dictionary(field.type):
            arr = arr.cast(field.type.value_type)
        else:
            arr = arr.cast(field.type)
        cols.append(arr)
    return pa.table(cols, names=like.column_names)


# ---------------------------------------------------------------------------
# One run.
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             scale=None, control: str = "", t_process: float = None,
             overrides: dict = None) -> dict:
    """One run of cell ``name``; returns the result object (the last line).
    ``device`` other than "cuda", a ``scale`` other than the
    configuration's and ``overrides`` of the workload's keys are for the
    harness's own tests on the CPU."""
    t_process = time.perf_counter() if t_process is None else t_process
    work, config = load_cell(name)
    work = dict(work, **(overrides or {}))
    timeout = float(work.get("query_timeout_s", 120))
    root = tempfile.mkdtemp(prefix="hsbench_")
    try:
        return _run(name, work, config, seed, seconds, trace, device, scale, control,
                    t_process, timeout, root)
    finally:
        gc.unfreeze()
        shutil.rmtree(root, ignore_errors=True)


def _run(name, work, config, seed, seconds, trace, device, scale, control, t_process,
         timeout, root) -> dict:
    from hsbench import instruments

    cell = Cell(work, config, seed, root, device, scale)
    plans = PlanLog(cell.session)
    warm_up(cell, seed, plans, timeout)
    settle(root)
    if device == "cuda":
        import torch
        if trace:
            instruments.Instruments.prime_profiler()
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    log(f"set-up {setup_s:.1f} s; window {seconds} s with {work['clients']} clients")

    inst = instruments.Instruments(cell, trace)
    with inst:
        clients, t_start, t_end = run_clients(cell, seed, seconds, timeout,
                                              during=inst.during)
    cell.frontend.drain(timeout)
    queries = [q for c in clients for q in c.done]
    in_window = [q for q in queries if q.error is None and q.t1 <= t_end]
    failed = [q for q in queries if q.error is not None]
    unplanned = [q for q in queries if q.error is None and plans.missing(q)]
    for q in failed[:3]:
        log(f"failed: {q.entry['template']} {q.params}: {q.error}")
    for q in unplanned[:3]:
        log(f"planned without {plans.missing(q)}: {q.entry['template']} {q.params}")
    lat_ms = [(q.t1 - q.t0) * 1000.0 for q in in_window]
    if in_window:
        tenths = [0] * 10
        for q in in_window:
            tenths[min(9, int(10 * (q.t1 - t_start) / (t_end - t_start)))] += 1
        log(f"answers by tenth of the window: {tenths}")
    for t in sorted({q.entry["template"] for q in in_window}):
        ms = sorted((q.t1 - q.t0) * 1000.0 for q in in_window if q.entry["template"] == t)
        log(f"{t}: {len(ms)} answers, median {statistics.median(ms):.1f} ms, "
            f"max {ms[-1]:.1f} ms")
    device_info = instruments.device_info(device)
    inst.freeze(queries, in_window, t_start, t_end)

    t0 = time.perf_counter()
    checked = answers_to_check(queries, seed)
    if control:
        # The program's own answers are read as well, so that a control run
        # also gives the sound reading of its seed.
        sound = check_answers(cell, checked)
        log(f"sound answers: {sound['mismatched']} mismatched, max_rel_err "
            f"{sound['rel_err']!r}, {sound['compared']} compared")
    res = check_answers(cell, checked, control)
    limits = work["checks"]
    numbers = {
        "failed_queries": (len(failed) + len(unplanned), 0),
        "mismatched_answers": (res["mismatched"], limits["mismatched_answers"]),
        "max_rel_err": (res["rel_err"], limits["max_rel_err"]),
        "answers_compared": (res["compared"], limits["answers_compared"]),
    }
    correct = not failed and not unplanned \
        and res["mismatched"] <= limits["mismatched_answers"] \
        and res["rel_err"] <= limits["max_rel_err"] \
        and res["compared"] >= limits["answers_compared"]
    log(f"checked {res['compared']} answers in {time.perf_counter() - t0:.1f} s"
        + (f"; first mismatch: {res['first']}" if res["first"] else ""))

    wanted = cell_metrics(name, trace)
    if trace:
        readings = inst.readings()
        metrics = {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]}
                   for m in wanted if readings.get(m["name"]) is not None}
    else:
        window = t_end - t_start
        values = {"setup_s": setup_s, "queries_per_s": len(in_window) / window,
                  "query_p95_ms": percentile(lat_ms, 95) if lat_ms else None,
                  "query_p50_ms": percentile(lat_ms, 50) if lat_ms else None}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in wanted if values.get(m["name"]) is not None}
    result = {"correct": bool(correct), "attempted": len(queries),
              "failed": len(failed) + len(unplanned), "metrics": metrics,
              "device": dict(device_info, **(inst.device_extra() if trace else {}))}
    if trace:
        result["breakdown"] = inst.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    log(f"{len(in_window)} answers in the window; p50 "
        f"{statistics.median(lat_ms) if lat_ms else float('nan'):.1f} ms; "
        f"{len(failed)} failed, {len(unplanned)} planned without their index")
    return result


def main(argv, t_process: float) -> int:
    ap = argparse.ArgumentParser(prog="hsbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("float32",), default="",
                    help="put the reference, worked out in float32, in the program's "
                         "place (the comparison's control; not a benchmark run)")
    args = ap.parse_args(argv)
    work, _ = load_cell(args.workload)
    try:
        importlib.import_module("hyperspace_tpu_torch")
    except ImportError as e:
        print(f"hsbench: the system under test is not here: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(work.get("chips", 1)):
        print(f"hsbench: needs {work.get('chips', 1)} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      control=args.control, t_process=t_process)
    found = forbidden_modules()
    if found:
        print(f"hsbench: the process loaded {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
