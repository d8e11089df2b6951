"""On the card: one short run of each cell prints a correct result of the
contract's shape. Skips without a CUDA card (decided inside the test)."""

import json
import subprocess
import sys

import h100bench_cases as hc
import pytest

from benchlib import registry

CELLS = [w["name"] for w in registry.benchmark(hc.ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "1"],
                         cwd=str(hc.ROOT), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
