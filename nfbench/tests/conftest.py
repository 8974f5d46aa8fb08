"""Shared fixtures of the harness's CPU tests: a tiny scene at the
configurations' published widths, in view of a narrow camera."""

import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 7  # more than 32 bits, as the benchmark's seeds are

TINY = {
    "scene": {"fluid_side": 5, "box_side": 5, "fluid_floor": -0.3},
    "camera": {"image": 16, "camera_angle_x": 0.03},
    "render_net": {"n_samples": 8, "n_importance": 8},
    "eval_chunk": 64,
    "traffic": {"rays_per_view": 16, "checked_rays_per_frame": 16},
}


def tiny(workload: str) -> dict:
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in TINY.items()}
    if workload in ("transition-train", "dummy-cell"):
        return {"scene": out["scene"]}
    return out


def tiny_parts(workload: str, root: Path = ROOT):
    """The cell's pieces as `harness.load_parts` finds them, with the
    configuration's sections and the traffic cut to the tiny size."""
    from nfbench import harness

    parts = harness.load_parts(root, workload)
    for section, values in tiny(workload).items():
        if section == "traffic":
            parts.traffic.update(values)
        elif isinstance(values, dict):
            parts.config[section].update(values)
        else:
            parts.config[section] = values
    return parts


@pytest.fixture
def run_tiny():
    """run_tiny(workload, trace=False, root=ROOT) -> (result, lines) of a
    0.3 s run on the CPU at the tiny size."""
    from nfbench import harness

    def run(workload, trace=False, root=ROOT, seed=SEED):
        torch.manual_seed(0)
        return harness.run(tiny_parts(workload, root), seed, 0.3, trace,
                           t_start=time.perf_counter(), device="cpu")

    return run
