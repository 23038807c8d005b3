"""On a card: each cell's command runs a short window and prints a
correct result line.  Skips without a CUDA card (decided inside the
test)."""

import json
import pathlib
import subprocess
import sys

import pytest

from perfbench.core import cell as cellmod

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in cellmod.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
