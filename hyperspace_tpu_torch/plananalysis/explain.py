"""Explain: the plan with and without the hyperspace rewrite, side by side
(counterpart of ``hyperspace_tpu/plananalysis/explain.py``, its plan-only
sections: ``explain_string(..., diagnostics=False)``).

Both plans are walked in lockstep and every subtree the rewrite changed
is highlighted on each side; then the indexes the rewritten plan uses
and, verbose, the operator counts that changed. The rewrite runs as a
diagnostic pass: it counts no index usage. With ``diagnostics`` follow the
"Result cache:" section while the result cache is enabled, the I/O section
once the reader pool or a prefetch stream has done work, and the
"Serving:" section while the serving tier is enabled or a frontend has
taken queries, the "Robustness:" section while the session sets a
deadline, arms a fault point or turns degrade off, or once a robustness
counter moved, the "SLO:" section once the SLO monitor's window holds
queries (with the admission controller's line while adaptive admission is
on), and the "Trace:" section once a trace was retained. The "Advisor:"
section follows while workload capture is on or has recorded queries.
While ``optimizer.joinReorder.enabled`` is set, the "Join order:" section
shows each join chain's order and its estimates beside the actual rows of
its last run, and the "Distributed:" section once the mesh tier
dispatched or built. The "Compilation:" section follows the result
cache's once a kernel library was built with nvcc or loaded from the
artifact store (where the JAX package counts XLA compiles), and the
"Serving:" section ends with the program bank's line.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..plan.nodes import IndexScan, LogicalPlan
from .display import BufferStream, DisplayMode, get_mode


def _used_indexes(plan: LogicalPlan) -> List[str]:
    out = []
    for leaf in plan.collect_leaves():
        if isinstance(leaf, IndexScan):
            e = leaf.index_entry
            out.append(f"{e.name} (Type: {e.derivedDataset.kind_abbr}, "
                       f"LogVersion: {e.log_version})")
    return out


def _render(plan: LogicalPlan, depth: int = 0) -> List[Tuple[LogicalPlan, int, str]]:
    rows = [(plan, depth, "  " * depth + plan.simple_string())]
    for c in plan.children:
        rows.extend(_render(c, depth + 1))
    return rows


def _mark_all(node: LogicalPlan, marks: Set[int]) -> None:
    marks.add(id(node))
    for c in node.children:
        _mark_all(c, marks)


def _diff_marks(a: LogicalPlan, b: LogicalPlan, marks_a: Set[int], marks_b: Set[int]) -> None:
    """Walk both trees in lockstep; where they diverge, mark the whole
    differing subtree on each side."""
    if a.tree_string() == b.tree_string():
        return
    same_head = (type(a) is type(b) and a.simple_string() == b.simple_string()
                 and len(a.children) == len(b.children))
    if not same_head:
        _mark_all(a, marks_a)
        _mark_all(b, marks_b)
        return
    for ca, cb in zip(a.children, b.children):
        _diff_marks(ca, cb, marks_a, marks_b)


def _write_plan(buf: BufferStream, plan: LogicalPlan, marks: Optional[Set[int]]) -> None:
    for node, _depth, line in _render(plan):
        buf.write_line(line, highlight=marks is not None and id(node) in marks)


def _header(buf: BufferStream, title: str) -> None:
    buf.write_line("=" * 60)
    buf.write_line(title)
    buf.write_line("=" * 60)


def _count_nodes(plan: LogicalPlan) -> Dict[str, int]:
    counts: Dict[str, int] = {}

    def rec(node):
        counts[node.node_name] = counts.get(node.node_name, 0) + 1
        for c in node.children:
            rec(c)

    rec(plan)
    return counts


def explain_string(session, plan: LogicalPlan, verbose: bool = False,
                   mode="plaintext", diagnostics: bool = True) -> str:
    """The rewrite diff of ``plan`` rendered in ``mode`` ("plaintext",
    "console" or "html"), whether or not hyperspace is enabled.
    ``diagnostics=False`` leaves out the runtime sections, which read
    process-wide counters."""
    display: DisplayMode = get_mode(mode)
    was_enabled = session.is_hyperspace_enabled()
    try:
        session.enable_hyperspace()
        with_index = session.optimize(plan, diagnostic=True)
    finally:
        if not was_enabled:
            session.disable_hyperspace()

    marks_with: Set[int] = set()
    marks_without: Set[int] = set()
    _diff_marks(with_index, plan, marks_with, marks_without)

    buf = BufferStream(display)
    _header(buf, "Plan with indexes:")
    _write_plan(buf, with_index, marks_with)
    buf.write_line()
    _header(buf, "Plan without indexes:")
    _write_plan(buf, plan, marks_without)
    buf.write_line()
    _header(buf, "Indexes used:")
    for line in _used_indexes(with_index) or ["<none>"]:
        buf.write_line(line)
    if diagnostics:
        _write_cache_section(buf, session, plan)
        _write_compilation_section(buf, session)
        _write_io_section(buf, session)
        _write_spmd_section(buf, session)
        _write_serving_section(buf, session)
        _write_robustness_section(buf, session)
        _write_slo_section(buf, session)
        _write_trace_section(buf, session)
    _write_advisor_section(buf, session, with_index)
    _write_join_order_section(buf, session)
    if verbose:
        buf.write_line()
        _header(buf, "Physical operator stats:")
        before, after = _count_nodes(plan), _count_nodes(with_index)
        for name in sorted(set(before) | set(after)):
            b, a = before.get(name, 0), after.get(name, 0)
            if b != a:
                buf.write_line(f"{name}: {b} -> {a}")
    return buf.build()


def _write_io_section(buf: BufferStream, session) -> None:
    """The reader pool's process-wide counters, the read/decode against
    consumer-wait split, and the buffer pool's; rendered only once the pool
    or a prefetch stream has done work."""
    from ..execution import buffer_pool
    from ..parallel import io as pio
    s = pio.pool_stats()
    if s["pooled_reads"] == 0 and s["prefetch_streams"] == 0:
        return
    p = pio.params_from_conf(session.hs_conf)
    buf.write_line()
    _header(buf, "I/O:")
    if p.enabled and p.resolved_threads() > 1:
        buf.write_line(f"reader pool: on (threads={p.resolved_threads()} "
                       f"prefetchDepth={p.prefetch_depth} "
                       f"maxInflightBytes={p.max_inflight_bytes})")
    else:
        buf.write_line("reader pool: off (reads run sequentially on the calling thread)")
    buf.write_line(f"pooled reads: {s['pooled_reads']} fan-out(s), "
                   f"{s['read_tasks']} file task(s), {s['read_bytes']} bytes; "
                   f"prefetch: {s['prefetch_streams']} stream(s), "
                   f"{s['prefetch_items']} item(s)")
    overlap = max(s["read_seconds"] - s["wait_seconds"], 0.0)
    buf.write_line(f"time split: read+decode={s['read_seconds']:.2f}s "
                   f"consumer wait={s['wait_seconds']:.2f}s "
                   f"(~{overlap:.2f}s of read hidden behind compute)")
    bp = buffer_pool.pool_stats()
    if bp["hits"] + bp["misses"] > 0:
        buf.write_line(f"buffer pool: hits={bp['hits']} misses={bp['misses']} "
                       f"transfers={bp['transfers']} "
                       f"decode_bytes_saved={bp['decode_bytes_saved']} "
                       f"resident={bp['device_nbytes']}+{bp['host_nbytes']}")


def _write_spmd_section(buf: BufferStream, session) -> None:
    """The mesh tier: the mesh the dispatch would span, the dispatch
    tallies and the last program's collectives. Rendered only once an SPMD
    program dispatched or a mesh build ran, so explain output of sessions
    that never went distributed is unchanged."""
    from ..execution import spmd
    from ..parallel import distributed_build
    if spmd.DISPATCH_COUNT + distributed_build.DISPATCH_COUNT == 0:
        return
    from ..parallel.mesh import mesh_devices
    conf = session.hs_conf
    devices = mesh_devices(session)
    buf.write_line()
    _header(buf, "Distributed:")
    buf.write_line(
        f"distributed: {'on' if conf.distributed_enabled() else 'off'} "
        f"(mesh devices={len(devices)} platform={devices[0].type} "
        f"singleDevice={conf.distributed_single_device()} "
        "fileAlignedScan=on)")
    buf.write_line(
        f"dispatches: queries={spmd.DISPATCH_COUNT} sorts={spmd.SORT_DISPATCH_COUNT} "
        f"builds={distributed_build.DISPATCH_COUNT} "
        "mesh programs compiled=0")
    lc = spmd.last_collectives()
    if lc:
        pairs = " ".join(f"{k}={v}" for k, v in sorted(lc.items()) if v)
        buf.write_line(f"last program collectives: {pairs or 'none'}")


def _write_cache_section(buf: BufferStream, session, plan: LogicalPlan) -> None:
    """Whether this query would be served from the result cache, with the
    cache's counters and the device index-table cache's; rendered only
    while the result cache is enabled."""
    cache = session.result_cache
    if cache is None:
        return
    from ..execution import index_cache
    from ..serving.fingerprint import compute_key
    buf.write_line()
    _header(buf, "Result cache:")
    key = compute_key(session, plan)
    if key is None:
        buf.write_line("plan shape not cacheable")
    else:
        tier = cache.peek(key)
        if tier is not None:
            buf.write_line(f"result served from cache ({tier} tier, key {key.digest()})")
        else:
            buf.write_line(f"miss - result will be computed and considered for "
                           f"admission (key {key.digest()})")
    s = cache.stats()
    buf.write_line(f"result cache: hits={s['hits']} misses={s['misses']} "
                   f"admissions={s['admissions']} evictions={s['evictions']} "
                   f"entries={s['device_entries']}+{s['host_entries']} "
                   f"bytes={s['device_nbytes']}+{s['host_nbytes']}")
    if index_cache.enabled():
        ic = index_cache.get_cache()
        buf.write_line(f"index table cache: hits={ic.hits} misses={ic.misses} "
                       f"resident_bytes={ic.nbytes}")


def _write_serving_section(buf: BufferStream, session) -> None:
    """The frontend's admission and batching counters; rendered only while
    the serving tier is enabled on this session or a frontend has taken
    queries."""
    from ..serving import frontend as fe
    front = fe._DEFAULT
    enabled = session.hs_conf.serving_enabled()
    fstats = front.stats() if front is not None else None
    if not enabled and (fstats is None or fstats["submitted"] == 0):
        return
    conf = session.hs_conf
    buf.write_line()
    _header(buf, "Serving:")
    buf.write_line(f"frontend: {'on' if enabled else 'off'} "
                   f"(maxConcurrency={conf.serving_max_concurrency()} "
                   f"queueDepth={conf.serving_queue_depth()} "
                   f"admission.maxBytes={conf.serving_admission_max_bytes()} "
                   f"batching={'on' if conf.serving_batching_enabled() else 'off'})")
    if fstats is not None:
        s = fstats
        buf.write_line(f"queries: submitted={s['submitted']} admitted={s['admitted']} "
                       f"rejected={s['rejected']} completed={s['completed']} "
                       f"failed={s['failed']}")
        buf.write_line(f"batching: batches={s['batches']} "
                       f"batched_queries={s['batched_queries']} "
                       f"shared_scans={s['shared_scans']} "
                       f"member_fallbacks={s['member_fallbacks']}")
    from ..serving.program_bank import get_bank
    b = get_bank().stats()
    buf.write_line(f"program bank: stages={b['stages']} programs={b['programs']} "
                   f"hits={b['hits']} misses={b['misses']} evictions={b['evictions']}")


def _write_compilation_section(buf: BufferStream, session) -> None:
    """The kernel libraries this process built with nvcc and loaded from
    the artifact store (where the JAX package counts XLA compiles), and the
    session's shape-bucketing conf; rendered only once a library was built
    or loaded, as the reference renders its section only after a compile."""
    from .. import shapes
    from ..ops import cuda_kernels
    st = cuda_kernels.BUILD_STATS
    if st["builds"] == 0 and st["store_loads"] == 0:
        return
    p = shapes.params_from_conf(session.hs_conf)
    buf.write_line()
    _header(buf, "Compilation:")
    buf.write_line(f"kernel builds: total={st['builds']} seconds={st['build_seconds']:.2f} "
                   f"store_loads={st['store_loads']}")
    if p.enabled:
        buf.write_line(f"shape bucketing: on (growth={p.growth_factor:g} "
                       f"minPad={p.min_pad} maxWaste={p.max_waste_ratio:g} "
                       f"exactFallbackRows={p.exact_fallback_rows})")
    else:
        buf.write_line("shape bucketing: off (every data-dependent "
                       "length compiles its own programs)")


def _write_robustness_section(buf: BufferStream, session) -> None:
    """The deadline, retry and degrade knobs, the armed fault points and
    the process's counters of every ladder; rendered only when the session
    configures the layer or something already happened (a retry, an
    injected fault, a degradation, a cancellation)."""
    from ..robustness import faults as _faults
    conf = session.hs_conf
    s = _faults.stats()
    armed = conf.robustness_fault_specs()
    configured = bool(armed) or conf.robustness_deadline_ms() > 0 or \
        not conf.robustness_degrade_enabled()
    if not configured and not any(s.values()):
        return
    buf.write_line()
    _header(buf, "Robustness:")
    buf.write_line(f"deadlineMs={conf.robustness_deadline_ms():g} "
                   f"retry.maxAttempts={conf.robustness_retry_max_attempts()} "
                   f"retry.baseMs={conf.robustness_retry_base_ms():g} "
                   f"degrade={'on' if conf.robustness_degrade_enabled() else 'off'}")
    buf.write_line(f"fault points armed: {len(armed)}"
                   + (f" ({', '.join(sorted(armed))})" if armed else ""))
    buf.write_line(f"retries={s['retries']} retry_failures={s['retry_failures']} "
                   f"injected={s['injected']} cancellations={s['deadline_cancellations']}")
    buf.write_line(f"degradations: spmd={s['degraded_spmd']} "
                   f"bank_compile={s['degraded_bank_compile']} "
                   f"device_put={s['degraded_device_put']} "
                   f"spill_corrupt={s['spill_corruptions']} "
                   f"sweep_member={s['member_fallbacks']} "
                   f"worker_release={s['worker_releases']}")


def _write_slo_section(buf: BufferStream, session) -> None:
    """``Hyperspace.health()``'s verdict per armed objective; rendered only
    once the monitor's window holds completed queries."""
    from ..telemetry.slo import get_monitor
    verdict = get_monitor().evaluate(session, emit=False)
    if not verdict.get("count"):
        return
    buf.write_line()
    _header(buf, "SLO:")
    buf.write_line(f"{'healthy' if verdict['healthy'] else 'BREACHED'} over "
                   f"{verdict['window_s']:g}s window ({verdict['count']} queries, "
                   f"{verdict['errors']} errors, {verdict['degraded']} degraded)")
    for name, obj in verdict["objectives"].items():
        if not obj["armed"]:
            continue
        observed = obj["observed"]
        buf.write_line(f"{name}: observed "
                       f"{'n/a' if observed is None else f'{observed:.4g}'} "
                       f"objective {obj['threshold']:g}"
                       + (" BREACHED" if obj["breached"] else ""))
    if session.hs_conf.adaptive_enabled():
        from ..adaptive.admission import get_controller
        s = get_controller().stats()
        buf.write_line(f"admission ({session.hs_conf.adaptive_admission_mode()}): "
                       f"{'overloaded' if s['overloaded'] else 'admitting'} "
                       f"breaches={s['breaches']} recoveries={s['recoveries']} "
                       f"sheds={s['sheds']} degrades={s['degrades']}")


def _write_trace_section(buf: BufferStream, session) -> None:
    """The span timeline of the session's most recent retained trace, with
    per-span wall and self times (host times); rendered only once a trace
    was retained."""
    trace = session._last_trace
    if trace is None:
        return
    from ..telemetry.trace import render_timeline
    buf.write_line()
    _header(buf, "Trace:")
    buf.write_line(f"trace {trace.trace_id}: {len(trace.spans)} span(s), "
                   f"{trace.duration_s() * 1000:.2f} ms total "
                   f"(hs.last_trace().to_chrome_json() exports it)")
    for line in render_timeline(trace):
        buf.write_line(line)


def _write_advisor_section(buf: BufferStream, session, with_index: LogicalPlan) -> None:
    """The advisor's capture state and the session's applied counts of the
    indexes this plan uses; rendered only while capture is on or the
    workload log holds records."""
    from ..advisor.workload import log_for
    log = log_for(session)
    capture_on = session.hs_conf.advisor_capture_enabled()
    if len(log) == 0 and not capture_on:
        return
    buf.write_line()
    _header(buf, "Advisor:")
    buf.write_line(f"workload capture: {'on' if capture_on else 'off'} "
                   f"({len(log)} record(s); hs.recommend() ranks index candidates from them)")
    counts = session._index_usage_counts
    for leaf in with_index.collect_leaves():
        if isinstance(leaf, IndexScan):
            name = leaf.index_entry.name
            buf.write_line(f"index '{name}' applied {counts.get(name, 0)} time(s) this session")


def _write_join_order_section(buf: BufferStream, session) -> None:
    """The join reorderer's chain records from the pass that just ran: the
    order chosen, and each step's estimated rows beside the actual rows
    the executor last recorded under the step's key ("n/a" before a
    run)."""
    if not session.hs_conf.join_reorder_enabled():
        return
    records = session._last_join_order
    if not records:
        return
    actuals = session._join_actuals
    buf.write_line()
    _header(buf, "Join order:")
    for r in records:
        if r["reordered"]:
            buf.write_line(f"chain [{', '.join(r['labels'])}] reordered -> "
                           f"[{', '.join(r['order'])}]")
        else:
            buf.write_line(f"chain [{', '.join(r['labels'])}] kept ({r.get('note', 'kept')})")
        for b in r["base"]:
            buf.write_line(f"  {b['label']}: est {b['est_rows']:.0f} rows")
        for step in r["steps"]:
            actual = actuals.get(step["key"])
            buf.write_line(f"  join +{step['right']}: est {step['est_rows']:.0f} rows, "
                           f"actual {actual if actual is not None else 'n/a'}")
