"""The `e2e-trainer-loop` cell: `E2ETrainer`'s own iteration through the
harness. The readers of the loop's spans on synthetic span lists; on the
CPU at a tiny scene, a run is correct and its traced line carries the
loop's metrics, and the control fails a limit; on the card, the cell's
`sync.*` spans are the syncs that `set_sync_debug_mode('warn')` reports
(the list path's and the loop's copies). The cell's schema and
discovery are the shared tests' (`test_nfbench_schema.py`,
`test_nfbench_discovery.py`)."""

import time
from types import SimpleNamespace

import pytest
import torch

from neurofluid_torch.utils.profiling import Span
from nfbench import harness
from nfbench.tests.conftest import ROOT, SEED
from nfbench.tests.test_nfbench_spans import (
    test_sync_spans_are_the_syncs_the_card_reports as _sync_check,
)
from nfbench.trace import DeviceTrace, Op

CELL = "e2e-trainer-loop"
US = 1000  # ns
# two steps of 1,000 us; the first holds its data [0, 100] and a log
# [800, 1,000] with its Pred2GT [900, 1,000], the second its data [1,000,
# 1,050]; idle gaps of 40 us in data, 100 in the train step, 100 in the
# Pred2GT, 30 in data
SPANS = [Span("loop.data", 0, 100 * US, "step.e2e"),
         Span("particle_net", 100 * US, 500 * US, "step.e2e"),
         Span("loop.pred2gt", 900 * US, 1000 * US, "loop.log"),
         Span("loop.log", 800 * US, 1000 * US, "step.e2e"),
         Span("step.e2e", 0, 1000 * US, None),
         Span("loop.data", 1000 * US, 1050 * US, "step.e2e"),
         Span("step.e2e", 1000 * US, 2000 * US, None)]
DEVICE = DeviceTrace([Op("k", a * US, b * US) for a, b in
                      ((0, 20), (60, 400), (500, 850), (950, 1010),
                       (1040, 2000))], [])
READERS = ("loop_idle_ms", "loop_host_ms")


def test_readers_read_the_loop_spans_or_nothing(monkeypatch):
    from nfbench import spans as sp

    run = SimpleNamespace(unit="step", units=2, trace=DEVICE)
    read = {n: harness.load_reader(ROOT, n) for n in READERS}
    monkeypatch.setattr(sp, "recorded", lambda: SPANS)
    assert read["loop_idle_ms"](run) == pytest.approx(0.085)
    # data 100 + 50 us, the log 200 (its Pred2GT inside it) over 2 steps
    assert read["loop_host_ms"](run) == pytest.approx(0.175)
    # the parent's program: step spans, no loop span
    monkeypatch.setattr(sp, "recorded", lambda: [s for s in SPANS
                                                 if s.name == "step.e2e"])
    assert all(r(run) is None for r in read.values())
    monkeypatch.setattr(sp, "recorded", lambda: [])
    assert all(r(run) is None for r in read.values())
    frame = SimpleNamespace(unit="frame", units=2, trace=DEVICE)
    assert all(r(frame) is None for r in read.values())


def tiny_parts():
    """The cell at a tiny scene: 216 particles in view of a narrow 16 x 16
    camera, 8 + 8 samples, 16 rays a step."""
    parts = harness.load_parts(ROOT, CELL)
    parts.config["scene"].update(fluid_side=6, box_side=12, fluid_floor=-0.3)
    parts.config["camera"].update(image=16, camera_angle_x=0.03)
    parts.config["render_net"].update(n_samples=8, n_importance=8)
    parts.traffic.update(rays_per_view=16)
    return parts


def test_tiny_run_is_correct_and_traced_line_has_the_loop_metrics():
    torch.manual_seed(0)
    result, _ = harness.run(tiny_parts(), SEED, 0.3, True,
                            t_start=time.perf_counter(), device="cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 9
    metrics = result["metrics"]
    assert metrics["loop_host_ms"]["value"] > 0
    assert metrics["loop_idle_ms"]["value"] == 0.0  # no device trace
    # a CPU run: the log's reads and the overflow read, every 10th step
    assert metrics["host_syncs.train"]["value"] > 0


def test_control_fails_a_limit():
    parts = tiny_parts()
    dev = torch.device("cpu")
    entry = harness.make_entry(parts, SEED, dev)
    entry.setup()
    harness.window(entry, 0.1, dev)
    entry.release()
    control = entry.control_numbers()
    assert set(parts.limits) <= set(control)
    assert any(control[name] > limit for name, limit in parts.limits.items())


@pytest.mark.cuda
def test_sync_spans_are_the_syncs_the_card_reports():
    _sync_check(CELL)
