"""Running a cell of the benchmark on the CPU at a tiny scale."""

import os

from hsbench import harness

TINY = 0.002
# Short set-up and window: the tests check what a run decides, not its speed.
FAST = {"warmup_s": 0.5}


def run(cell: str, seed: int = 7, seconds: float = 1.5, trace: bool = False,
        control: str = "", **overrides) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", scale=TINY,
                            control=control, overrides=dict(FAST, **overrides))


def workload_names() -> list:
    """The cells that have a workload file, by name."""
    return sorted(f[:-len(".json")] for f in os.listdir(os.path.join(harness.BENCH_DIR,
                                                                     "workloads"))
                  if f.endswith(".json"))
