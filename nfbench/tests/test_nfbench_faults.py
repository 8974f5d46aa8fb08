"""A run with the timed path broken underneath comes out not correct
(`nfbench/faults.py`): a step that leaves the state unchanged, a loss over
half of the batch, and an answer altered where it is produced. No cell
exchanges data between chips."""

import pytest

from nfbench.faults import planted

CASES = [("transition-train", "unchanged"), ("e2e-train", "unchanged"),
         ("warmup-train", "unchanged"), ("transition-train", "half"),
         ("e2e-train", "half"), ("warmup-train", "half"),
         ("eval-frame", "altered")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_broken_program_is_not_correct(workload, fault, run_tiny):
    with planted(fault):
        result, _ = run_tiny(workload)
    assert not result["correct"]
    if fault == "unchanged":
        assert max(c["value"] for k, c in result["checks"].items()
                   if k.startswith("change_gap")) > 0.5
