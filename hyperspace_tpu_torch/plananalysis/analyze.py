"""explain_analyze: one post-execution report for one query (counterpart of
``hyperspace_tpu/plananalysis/analyze.py``).

``Hyperspace.explain_analyze(df)`` executes the plan under a QueryContext
of its own with its trace forced on (``trace_force`` pins the sample coin:
the caller asked for this query's trace), then renders:

- the span-tree timeline with per-span wall and self times
  (telemetry/trace.render_timeline). They are host times: a span that
  launches a CUDA kernel ends when the launch returns;
- estimated against actual rows for every reordered join step, with the
  per-step q-error;
- the query's tallies: the context's io attribution, the result-cache
  lookup outcome (from the trace), and the process deltas of the program
  bank's and the robustness counters across this execution.

The bank and robustness deltas are process-wide counter diffs, so a
concurrent query's lookups or incidents can leak into them; the io numbers
come from the context and are exact.
"""

from __future__ import annotations

import time

from ..telemetry import span_names as SN
from ..telemetry.trace import render_timeline


def _q_error(est: float, actual: int) -> float:
    est = max(float(est), 1.0)
    actual = max(float(actual), 1.0)
    return max(est / actual, actual / est)


def _join_lines(session) -> list:
    records = session._last_join_order or []
    actuals = session._join_actuals
    lines = []
    for r in records:
        head = "reordered" if r.get("reordered") else "kept"
        lines.append(f"chain [{', '.join(r.get('labels', []))}] {head}"
                     + (f" -> [{', '.join(r['order'])}]" if r.get("reordered") else ""))
        for s in r.get("steps", []):
            actual = actuals.get(s["key"])
            if actual is None:
                lines.append(f"  join +{s['right']}: est {s['est_rows']:.0f} rows, actual n/a")
            else:
                lines.append(f"  join +{s['right']}: est {s['est_rows']:.0f} rows, "
                             f"actual {actual} (q-error {_q_error(s['est_rows'], actual):.2f})")
    return lines


def explain_analyze_string(session, plan) -> str:
    from ..robustness import faults as _faults
    from ..serving.context import QueryContext
    from ..serving.program_bank import get_bank
    from ..telemetry.exposition import delta

    ctx = QueryContext.for_session(session)
    ctx.trace_force = True
    # The "Joins" section must be this execution's: a result-cache hit runs
    # no reorder pass and reports no joins.
    session._last_join_order = None
    bank0 = get_bank().stats()
    rob0 = _faults.stats()
    t0 = time.perf_counter()
    table = session.execute(plan, context=ctx)
    elapsed_ms = (time.perf_counter() - t0) * 1000.0
    bank1 = get_bank().stats()
    rob1 = _faults.stats()
    tr = ctx.trace

    lines = ["== Explain Analyze =="]
    lines.append(f"query {ctx.query_id}: {elapsed_ms:.2f} ms, {table.num_rows} row(s)")

    lines.append("")
    lines.append("Trace:")
    if tr is not None:
        lines.extend(render_timeline(tr))
    else:
        lines.append("(no trace recorded)")

    join_lines = _join_lines(session)
    if join_lines:
        lines.append("")
        lines.append("Joins (estimated vs actual):")
        lines.extend(join_lines)

    lines.append("")
    lines.append("Tallies:")
    io = ctx.io_stats()
    lines.append(f"io: tasks={io['read_tasks']} bytes={io['read_bytes']} "
                 f"read={io['read_seconds']:.3f}s wait={io['wait_seconds']:.3f}s "
                 f"prefetch_items={io['prefetch_items']}")
    cache_line = "cache: no lookup (result cache off)"
    if tr is not None:
        lookups = tr.find(SN.CACHE_LOOKUP)
        if lookups:
            a = lookups[-1].attrs
            cache_line = (f"cache: {'hit' if a.get('hit') else 'miss'}"
                          + (f" tier={a['tier']}" if a.get("tier") else ""))
    lines.append(cache_line)
    bank_d = delta(bank0, bank1)
    lines.append("bank: " + (" ".join(f"{k}={v:+g}" for k, v in sorted(bank_d.items()))
                             if bank_d else "no traffic"))
    rob_d = delta(rob0, rob1)
    lines.append("robustness: " + (" ".join(f"{k}={v:+g}" for k, v in sorted(rob_d.items()))
                                   if rob_d else "clean"))
    if tr is not None and tr.keep_reasons:
        lines.append(f"tail-keep marks: {', '.join(tr.keep_reasons)}")
    return "\n".join(lines)
