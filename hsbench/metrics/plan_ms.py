"""planner: the mean host milliseconds a query spends in the port's
planning spans (``plan.normalize``, ``rewrite.index_rules``,
``optimize.join_reorder``), by their self time, over the span trees whose
root opened in the window."""

from hsbench import reduce as red

PLAN_SPANS = {"plan.normalize", "rewrite.index_rules", "optimize.join_reorder"}


def read(r):
    total, queries = 0.0, 0
    for tr in r.traces:
        kids = red.children_of(tr.spans)
        queries += sum(1 for s in tr.spans if s.name == "query")
        total += sum(red.self_seconds(s, kids.get(s.span_id, []))
                     for s in tr.spans if s.name in PLAN_SPANS and s.end_perf is not None)
    return 1000.0 * total / queries if queries else None
