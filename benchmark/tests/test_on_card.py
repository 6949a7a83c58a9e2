"""On a card: each cell runs end to end, briefly, and reads correct.

    python3 -m pytest benchmark/tests/test_on_card.py -m gpu
"""

import json
import subprocess
import sys

import pytest

from benchmark import run

CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", "3000000999", "--seconds", "2", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
