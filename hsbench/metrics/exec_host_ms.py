"""execution: the mean host milliseconds a query spends in the executor,
the outermost ``exec.stage``, ``exec.fused`` and ``spmd.dispatch`` spans
of each span tree whose root opened in the window. No span waits for the
device, so device time lands in whichever stage first waits for it."""

from hsbench import reduce as red

EXEC_SPANS = {"exec.stage", "exec.fused", "spmd.dispatch"}


def read(r):
    total, queries = 0.0, 0
    for tr in r.traces:
        queries += sum(1 for s in tr.spans if s.name == "query")
        total += sum(s.duration_s for s in red.outermost(tr.spans, EXEC_SPANS))
    return 1000.0 * total / queries if queries else None
