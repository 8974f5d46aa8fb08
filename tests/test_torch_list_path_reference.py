"""The trainers' own ParticleNet path, the list backends (`search_backend`
'grid' and 'auto': the plain grid or brute-force search, the adjoint
plans, the list geometry and tap matrix, the gathers' products), held
through `make_transition_train_step` against the benchmark's plain
reference (`nfbench/reference/particle_net.py`, brute-force uncapped
pairs) on seeded weights at the published widths; the search route of
the benchmark's `transition-train-auto` cell; the list path's spans.

Imports no JAX: it runs on the CPU, where the port takes its plain
versions (K8's is `segment_sum_plain`).
"""

import json
import statistics
from collections import Counter
from pathlib import Path

import pytest
import torch

from neurofluid_torch.models import particle_net as pn_mod
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.ops.neighbor_search import CellGrid
from neurofluid_torch.train import losses
from neurofluid_torch.train.transition import make_transition_train_step
from neurofluid_torch.utils import profiling
from nfbench import inputs
from nfbench.reference import particle_net as ref_pn

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads(
    (ROOT / "nfbench/configs/dlf-watercube-auto-f32.json").read_text())
PN = CONFIG["particle_net"]
# the cell's scene generator at a tiny size: 216 fluid particles at the
# rest spacing on the container's floor, whose 720 particles lie close
# enough (0.177 apart) for the box conv to see pairs
SCENE = dict(CONFIG["scene"], fluid_side=6, box_side=12)
MODEL = {k: PN[k] for k in ("timestep", "radius_scale", "particle_radius",
                            "gravity", "correction_scale", "layer_channels")}
RADIUS = 3.0 * PN["radius_scale"] * PN["particle_radius"]
SEEDS = [1, 2 ** 33 + 7]

# Gaps against the f32 reference over four seeds: the loss <= 1.6e-7
# relative, each leaf's gradient <= 2.5e-7 of the larger of its norm and
# the median leaf's (the sums' order and the polynomial arctan). The same
# reference with TF32 operands, in the program's place, reads >= 1.5e-5
# and >= 3.5e-4. Each limit lies about 10x above the first and 7-35x
# below the second.
LOSS_GAP = 2e-6
GRAD_GAP = 1e-5


def _norm(t) -> float:
    return float(t.double().norm())


def _gaps(loss, grads, ref_loss, ref_grads) -> tuple:
    """(relative loss gap, the worst leaf's gradient gap)."""
    med = statistics.median(_norm(g) for g in ref_grads.values())
    worst = max(_norm(grads[k] - g) / max(_norm(g), med)
                for k, g in ref_grads.items())
    return abs(loss - ref_loss) / abs(ref_loss), worst


def _scene(seed: int):
    weights = inputs.draw_weights(inputs.particle_net_specs(PN), seed,
                                  "particle_net", "cpu")
    frame = inputs.fluid_frames(SCENE, PN, 1, seed, "cpu")[0]
    box, normals = inputs.container(SCENE, "cpu")
    return weights, frame, box, normals


def _net(backend: str) -> ParticleNet:
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in PN.items()}
    kw["search_backend"] = backend
    return ParticleNet(**kw, device="cpu")


def _reference(weights, frame, box, normals, precision: str) -> tuple:
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    loss = ref_pn.transition_loss(p, frame, box, normals, MODEL,
                                  ref_pn.Precision(precision, precision))
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), dict(zip(p, grads))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", ["grid", "auto"])
def test_train_step_matches_the_plain_reference(backend, seed):
    weights, frame, box, normals = _scene(seed)
    pos1 = frame[0] + frame[1] * PN["timestep"]
    assert ref_pn.radius_pairs(pos1, box, RADIUS, False).qi.numel()
    net = _net(backend)
    net.load_state_dict(weights)
    step = make_transition_train_step(
        net, torch.optim.Adam(net.parameters(), lr=1e-6),
        losses.default_box_bounds(PN["particle_radius"], "cpu"), 0.0)
    loss, aux = step(*frame, box, normals)
    assert not aux["search_overflow"] and not aux["search_cap_exceeded"]
    grads = {k: p.grad for k, p in net.named_parameters()}
    ref = _reference(weights, frame, box, normals, "f32")
    loss_gap, grad_gap = _gaps(float(loss), grads, *ref)
    assert loss_gap < LOSS_GAP and grad_gap < GRAD_GAP, (loss_gap, grad_gap)
    # the limits tell TF32 operands from f32 ones
    control = _reference(weights, frame, box, normals, "tf32")
    c_loss, c_grad = _gaps(*control, *ref)
    assert c_loss > LOSS_GAP or c_grad > GRAD_GAP, (c_loss, c_grad)


def test_the_cell_searches_by_grid():
    """At the cell's size 'auto' searches the 13,824 fluid particles by
    grid, and the box by the grid `make_box_plan` passes, though its 3,920
    particles are under the threshold."""
    net = _net("auto")
    box, _ = inputs.container(CONFIG["scene"], "cpu")
    n_fluid = CONFIG["scene"]["fluid_side"] ** 3
    assert n_fluid == 13_824 and box.shape[0] == 3_920
    assert box.shape[0] < pn_mod.AUTO_GRID_POINTS <= n_fluid
    plan = net.make_box_plan(box)
    assert isinstance(plan, CellGrid)
    assert net.search_route(n_fluid) == "grid"
    assert net.search_route(box.shape[0], plan) == "grid"
    assert net.search_route(box.shape[0]) == "brute"


@pytest.mark.parametrize("backend", ["grid", "auto"])
def test_list_plan_spans_nest_in_the_plan(backend):
    """Each ParticleNet step of the list path records one
    `particle_net.search` and one `particle_net.geometry` inside its
    `particle_net.plan`, and no `sync.*` span on the CPU, where no copy
    waits for a device."""
    weights, frame, box, normals = _scene(SEEDS[0])
    net = _net(backend)
    net.load_state_dict(weights)
    step = make_transition_train_step(
        net, torch.optim.Adam(net.parameters(), lr=1e-6),
        losses.default_box_bounds(PN["particle_radius"], "cpu"), 0.0)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(*frame, box, normals)
    got = profiling.spans()
    pairs = Counter((s.name, s.parent) for s in got)
    assert pairs[("particle_net.plan", "particle_net")] == 2
    assert pairs[("particle_net.search", "particle_net.plan")] == 2
    assert pairs[("particle_net.geometry", "particle_net.plan")] == 2
    assert not [s for s in got if s.name.startswith("sync.")]
    plan = sorted((s for s in got if s.name == "particle_net.plan"),
                  key=lambda s: s.start_ns)
    for child in ("particle_net.search", "particle_net.geometry"):
        inner = sorted((s for s in got if s.name == child),
                       key=lambda s: s.start_ns)
        for outer, s in zip(plan, inner):
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def test_sync_span_records_copies_to_a_card_only():
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.sync_span("sync.cpu", torch.device("cpu")):
            torch.tensor([1.0, 2.0])
        with profiling.sync_span("sync.cuda", torch.device("cuda")):
            pass
    assert [s.name for s in profiling.spans()] == ["sync.cuda"]
