"""On a CUDA card: each cell's command runs briefly and its check passes.
Skips without a card (decided in the test, not at import)."""

import json
import subprocess
import sys

import pytest

from benchmark import run
from conftest import ADAPTIVE_CELLS, CELLS, MESH_CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS + ADAPTIVE_CELLS + MESH_CELLS)
def test_cell_runs_on_the_card(name):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           str(2**31 + 5), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    checks = run.check_lines(out["checks"])
    assert proc.stderr.strip().splitlines()[-len(checks):] == checks
