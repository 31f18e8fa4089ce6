"""On the card: one short run of each cell, correct, with the contract's
last line.  Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import run

CELLS = [w["name"] for w in run.read_json("BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"),
                        "--workload", cell, "--seed", str(2 ** 31 + 3),
                        "--seconds", "3"], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
