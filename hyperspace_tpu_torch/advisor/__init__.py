"""Workload capture, what-if planning and cost-ranked index recommendation
(counterpart of ``hyperspace_tpu/advisor/``).

  constants   — ``hyperspace.tpu.advisor.*`` keys and the hypothetical markers
  workload    — the session's workload log, written by ``Session.execute``
  candidates  — candidate covering and sketch configs from the log's shapes
  whatif      — hypothetical entries through the rules' ``candidates_for``
                hook (metadata only, nothing built)
  cost        — the input-byte cost model over file and index sizes
  recommend   — cost-ranked recommendations (``Hyperspace.recommend``)

Hypothetical entries are in-memory values only: they never reach a log
store, a data file or the executor.
"""
