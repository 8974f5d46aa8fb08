"""One short run of the benchmark's command on the card (skips without
one)."""

import json
import subprocess
import sys

import pytest
import torch

from nfbench.tests.conftest import ROOT


@pytest.mark.cuda
def test_transition_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "nfbench.run", "--workload", "transition-train",
         "--seed", "5000000003", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
