"""The end-to-end trainer's own loop, one `E2ETrainer.train_iteration` at a
time, on the CPU at a tiny version of the benchmark's `e2e-trainer-loop`
cell: its scene (216 particles of the seeded block, a 32 x 32 view of it)
written by `nfbench/entries/e2e_trainer_loop.py` through `data.synthetic.
write_blender_scene`, its trainer (the stage's configuration,
`configs/end2end.yaml` with the watercube block, on `search_backend=
'auto'`, the seeded weights, NeRFs 8 x 32) and its reference:

- `train()` is a loop over `train_iteration`: the same losses, weights,
  optimizer states and host draws, bitwise;
- three carried steps against `nfbench/reference` (the chain carries its
  own state from the sequence's first frame, at the published schedule's
  rates): the losses, the renderer's first gradients, the carried
  positions and the Pred2GT the trainer logs; the rays and targets the
  trainer hands its step against those built from the written scene at
  the published loop's pixel draw;
- the loop's spans: one `step.e2e` an iteration, holding `loop.data`,
  `loop.log`, `loop.pred2gt` and `sync.log`; the train step called alone
  still records one `step.e2e` a step;
- the scene writer: `BlenderDataset` reads back the frames, the box, the
  poses and the images it was given.

Imports no JAX.
"""

import functools
import importlib.util
import json
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from neurofluid_torch.data.blender import BlenderDataset
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train import trainer_base, warmup
from neurofluid_torch.utils import profiling
from neurofluid_torch.utils.logging import MetricsLogger
from nfbench.reference.trainer_loop import pred2gt_mm

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 7
N_FRAMES = 4  # 3 carried steps a sequence
SIZE = 32
NERF_WIDTH = 32


def _entry_module():
    path = ROOT / "nfbench" / "entries" / "e2e_trainer_loop.py"
    spec = importlib.util.spec_from_file_location("e2e_trainer_loop", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LOOP = _entry_module()


def _tiny() -> tuple:
    """The cell's configuration and traffic cut to a tiny scene."""
    config = json.loads((ROOT / "nfbench" / "configs"
                         / "neurofluid-watercube-auto-f32.json").read_text())
    traffic = json.loads((ROOT / "nfbench" / "traffic"
                          / "e2e-trainer-loop.json").read_text())
    config["end_index"] = N_FRAMES
    config["scene"].update(fluid_side=6, box_side=12, fluid_floor=-0.3)
    config["camera"].update(image=SIZE, camera_angle_x=0.03)
    config["render_net"].update(n_samples=8, n_importance=8,
                                nerf_width=NERF_WIDTH)
    traffic.update(rays_per_view=16, log_interval=2, pool=N_FRAMES - 1)
    return config, traffic


CONFIG, TRAFFIC = _tiny()
F32 = CONFIG["precision"]

# Gaps against the f32 reference over four seeds: the losses <= 9.1e-8
# relative, the renderer's first gradients <= 2.2e-6 of the larger of a
# leaf's norm and the median leaf's, the carried positions <= 1.8e-6 of
# the spacing, the rays and targets <= 1.3e-7 from the written scene's
# (float32's rounding), the logged Pred2GT <= 2.0e-16 (a k-d tree and
# every pair, both in float64). The same reference with TF32 operands
# reads >= 6.7e-6, 9.1e-4 and 3.8e-5, rays of a TF32 product >= 2.1e-4,
# the Pred2GT of TF32-rounded positions >= 1.7e-4. Each limit lies 3.9-14x
# above the first and 5.6-210x below the second; the trainer still in its
# centre crop reads a ray gap of 0.96.
LOSS_GAP, GRAD_GAP, STATE_GAP, PRED2GT_GAP = 1e-6, 3e-5, 7e-6, 1e-9
RAY_GAP = 1e-6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    return dict(LOOP.write_scene(root, CONFIG, SEED), root=root)


@pytest.fixture
def tiny_nerf(monkeypatch):
    """NeRFs NERF_WIDTH wide; no TensorBoard."""
    monkeypatch.setattr(warmup, "RenderNet",
                        functools.partial(RenderNet, nerf_width=NERF_WIDTH))
    monkeypatch.setattr(trainer_base, "MetricsLogger",
                        functools.partial(MetricsLogger,
                                          use_tensorboard=False))


@pytest.fixture
def make_trainer(scene, tmp_path, tiny_nerf):
    """make_trainer() -> a fresh trainer of the cell on the scene."""
    made = []

    def make():
        made.append(LOOP.build_trainer(CONFIG, TRAFFIC, SEED, scene["root"],
                                       str(tmp_path / f"e2e{len(made)}"),
                                       "cpu")[0])
        return made[-1]

    return make


def observe(trainer) -> list:
    """The arguments of every train step the trainer takes, and its
    losses, appended to the list returned."""
    step, calls = trainer.train_step, []

    def observed(*args):
        out = step(*args)
        calls.append((args, out[0]))
        return out

    trainer.train_step = observed
    return calls


def test_train_is_a_loop_over_its_iteration(make_trainer):
    a, b = make_trainer(), make_trainer()
    calls_a, calls_b = observe(a), observe(b)
    loss = a.train(n_epochs=1, eval_during_training=False)
    for data_idx in range(N_FRAMES - 1):
        b.train_iteration(data_idx, eval_during_training=False)
    assert [float(c[1]) for c in calls_a] == [float(c[1]) for c in calls_b]
    assert loss == float(calls_b[-1][1])
    assert a.global_step == b.global_step == a.start_step + N_FRAMES - 1
    for (ka, pa), (kb, pb) in zip(
            list(a.transition.named_parameters())
            + list(a.renderer.named_parameters()),
            list(b.transition.named_parameters())
            + list(b.renderer.named_parameters())):
        assert ka == kb and torch.equal(pa, pb), ka
    for oa, ob in ((a.opt_r, b.opt_r), (a.opt_t, b.opt_t)):
        for sa, sb in zip(oa.state.values(), ob.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(a.state_pos, b.state_pos)
    assert a.np_rng.bit_generator.state == b.np_rng.bit_generator.state
    assert a.fluid_errors.errors == b.fluid_errors.errors


def _gap(got, want) -> float:
    return abs(got - want) / abs(want)


def test_three_carried_steps_match_the_reference(tiny_nerf):
    entry = LOOP.Entry(CONFIG, TRAFFIC, SEED, "cpu")
    entry.setup()  # the cell's start: 3 carried steps, their rays observed
    try:
        assert entry.checked == N_FRAMES - 1
        losses, first, _, (pos, _) = entry._chain(F32)
        assert max(_gap(got, want) for got, want
                   in zip(entry.losses, losses)) < LOSS_GAP
        renderer = entry.groups()["renderer"]
        med = statistics.median(float(first[k].norm()) for k in renderer)
        worst = max(float((entry.first_grads[k] - first[k]).norm())
                    / max(float(first[k].norm()), med) for k in renderer)
        assert worst < GRAD_GAP
        assert entry._state_gap(entry.state_after_start, pos) < STATE_GAP
        assert entry._ray_gap() < RAY_GAP
        # the start's first step is logged (step 501, log_interval 2): the
        # Pred2GT of the state it left, which the second step took
        logged = entry.trainer.fluid_errors.errors[1]["gt2pred_mean"]
        assert _gap(logged, pred2gt_mm(entry.inputs[1][0],
                                       entry.positions[1])) < PRED2GT_GAP
    finally:
        entry.release()


def test_rays_paired_with_other_pixels_fail_the_ray_gap(tiny_nerf):
    """The targets of the drawn pixels rolled by one: a pairing of ray
    and pixel that the other gaps, on the trainer's batch, cannot see."""
    entry = LOOP.Entry(CONFIG, TRAFFIC, SEED, "cpu")
    entry.setup()
    try:
        *rest, rgbs_v = entry.inputs[0]
        entry.inputs[0] = (*rest, rgbs_v.roll(1, dims=1))
        assert entry._ray_gap() > 1e3 * RAY_GAP
    finally:
        entry.release()


def test_loop_spans_sit_inside_one_step_span_an_iteration(make_trainer):
    tr = make_trainer()
    tr.train_iteration(0, eval_during_training=False)  # warm (step 501)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.train_iteration(1, eval_during_training=False)
        tr.train_iteration(2, eval_during_training=False)  # step 503: logged
    got = profiling.spans()
    steps = [s for s in got if s.name == "step.e2e"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for s in got:
        if s.name != "step.e2e":
            assert any(u.start_ns <= s.start_ns <= s.end_ns <= u.end_ns
                       for u in steps), s.name
    pairs = [(s.name, s.parent) for s in got]
    assert pairs.count(("loop.data", "step.e2e")) == 2
    assert pairs.count(("loop.log", "step.e2e")) == 1
    assert pairs.count(("loop.pred2gt", "loop.log")) == 1
    assert pairs.count(("sync.overflow", "loop.log")) == 1
    # the loss, 6 scalars, the two per-view losses, the view's two
    # histograms and the positions for Pred2GT
    assert pairs.count(("sync.log", "loop.log")) == 12
    assert ("particle_net", "step.e2e") in pairs
    # on the CPU a copy to the device waits for nothing: no sync.data
    assert not any(name == "sync.data" for name, _ in pairs)


def test_the_train_step_alone_records_one_step_span(make_trainer):
    tr = make_trainer()
    calls = observe(tr)
    tr.train_iteration(0, eval_during_training=False)
    args = calls[0][0]
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.train_step(*args)
        tr.train_step(*args)
    names = [s.name for s in profiling.spans()]
    assert names.count("step.e2e") == 2
    assert not any(n.startswith("loop.") for n in names)


def test_written_scene_reads_back_exactly(scene):
    for view, split in (("view_1", "train"), ("view_5", "test")):
        ds = BlenderDataset(scene["root"], img_wh=(SIZE, SIZE),
                            end_index=N_FRAMES, view_names=(view,),
                            split=split)
        assert len(ds) == N_FRAMES - 1
        np.testing.assert_array_equal(ds.particles_pos, scene["positions"])
        np.testing.assert_array_equal(ds.particles_vel, scene["velocities"])
        np.testing.assert_array_equal(ds.box, scene["box"])
        np.testing.assert_array_equal(ds.box_normals, scene["box_normals"])
        np.testing.assert_array_equal(
            ds.cw[0], np.broadcast_to(scene["cameras"][view],
                                      (N_FRAMES, 3, 4)))
        want = scene["images"][view].reshape(N_FRAMES, -1, 3)
        np.testing.assert_array_equal(
            ds.rgbs[0], want.astype(np.float32) / np.float32(255.0))
