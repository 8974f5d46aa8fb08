"""The control, the reference computed one precision below the
configuration's in the program's place, comes out not correct under the
cells' limits: at this test's size on the CPU, as on the chip at the
cells' own size (PERF.md gives those readings)."""

import pytest
import torch

from nfbench import harness
from nfbench.tests.conftest import SEED, tiny_parts


@pytest.mark.parametrize("workload", ["transition-train", "e2e-train",
                                      "warmup-train", "eval-frame"])
def test_control_fails_a_limit(workload):
    parts = tiny_parts(workload)
    dev = torch.device("cpu")
    entry = harness.make_entry(parts, SEED, dev)
    entry.setup()
    harness.window(entry, 0.1, dev)
    entry.release()
    control = entry.control_numbers()
    assert set(parts.limits) <= set(control)
    assert any(value > parts.limits[name] for name, value in control.items()
               if name in parts.limits)
