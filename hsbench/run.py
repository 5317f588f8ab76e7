#!/usr/bin/env python3
"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 hsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; it needs a CUDA device and prints one
JSON line last (see hsbench/harness.py).
"""

import time

_T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this directory, is where modules are found.
sys.path[0] = ROOT

if __name__ == "__main__":
    from hsbench import harness
    sys.exit(harness.main(sys.argv[1:], _T_PROCESS))
