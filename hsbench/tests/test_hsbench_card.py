"""On the card: each cell's run at its own size prints a correct line,
and its float32 control a line that is not correct.

    python -m pytest hsbench/tests/test_hsbench_card.py -q

from the checkout's root on a machine with a CUDA device (minutes a
cell: each run makes its tables and indexes at the configuration's
scale)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The cells of BENCHMARK.json.
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def _run(cell: str, seed: int, control: str = "") -> dict:
    cmd = [sys.executable, "hsbench/run.py", "--workload", cell, "--seed", str(seed),
           "--seconds", "10", "--trace", "0"] + (["--control", control] if control else [])
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_and_its_control_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    assert _run(cell, 2 ** 31 + 101)["correct"] is True
    assert _run(cell, 2 ** 31 + 102, control="float32")["correct"] is False
