"""Port parity, the evaluators: neurofluid_torch.train.evaluation against
neurofluid_tpu.train.evaluation on the CPU, and the chunked full-image
renderer of neurofluid_torch.train.trainer_base.

- `print_pred2gt_report` prints JAX's text;
- `TransitionEvaluator` on the tiny synthetic scene
  (tests/test_torch_trainer_common.py), the port loading JAX's initial
  weights from a checkpoint: the same per-frame Pred2GT, unclipped and
  clipped to the box, within 1e-3 mm (positions agree to f32 rounding of
  each rollout step, Pred2GT is in mm);
- `make_chunk_renderer` on a ragged ray count equals one unchunked render
  (the port's form of tests/test_train.py's chunk-renderer test);
- `E2EEvaluator` and `RendererEvaluator` run on the tiny scene from
  checkpoints and write their reports, clouds and images.
"""

import os

import jax
import numpy as np
import pytest
import torch

from neurofluid_tpu.train import evaluation as jevaluation
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train import checkpoint as ckpt
from neurofluid_torch.train import evaluation
from neurofluid_torch.train.trainer_base import TrainerBase
from neurofluid_torch.train.warmup import build_renderer
from neurofluid_torch.utils.config import ConfigNode
from neurofluid_torch.utils.params import transition_state_from_flax
from test_torch_trainer_common import (
    configs, renderer_cfg, scene_cfg, write_scene,
)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("scene")))


@pytest.mark.parametrize("n", [1, 5, 12, 49, 60])
def test_pred2gt_report_matches_jax(n, capsys):
    dists = list(np.random.default_rng(n).uniform(1, 30, n))
    dists.insert(n // 2, None)  # a frame with non-finite positions
    jevaluation.print_pred2gt_report(dists)
    want = capsys.readouterr().out
    evaluation.print_pred2gt_report(dists)
    assert capsys.readouterr().out == want


def test_transition_evaluator_matches_jax(scene, tmp_path):
    cfg = dict(expname="trans_eval", resume_from="",
               TEST=dict(seed=10, datapath=scene, datatype="blender_all",
                         start_index=0, end_index=4, save_obj=True,
                         gravity=[0.0, 0.0, -9.81]))
    jcfg, tcfg = configs(cfg, tmp_path)
    jev = jevaluation.TransitionEvaluator(jcfg)
    weights = jax.tree_util.tree_map(np.asarray, jev.params)
    ckpt.save_checkpoint(str(tmp_path / "models"), 0, {
        "step": 0, "transition": transition_state_from_flax(weights)})
    tev = evaluation.TransitionEvaluator(
        tcfg.clone().merge(dict(resume_from=str(tmp_path / "models"))),
        device="cpu")
    assert tev.net.search_backend == "auto"
    want, want_clipped = jev.eval()
    got, got_clipped = tev.eval()
    # every window of the three view directories, as JAX rolls out
    assert len(got) == len(want) == len(tev.dataset) == 9
    assert all(d is not None for d in got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_clipped, want_clipped, rtol=0, atol=1e-3)
    assert os.path.isfile(os.path.join(tev.exppath, "pred2gt_clipped.json"))
    assert os.path.isfile(os.path.join(tev.particlepath, "eval", "pred_9.obj"))


def test_chunk_renderer_ragged_matches_one_render():
    rng = np.random.default_rng(10)
    net = RenderNet(near=1.0, far=3.0, n_samples=8, n_importance=4,
                    nerf_depth=2, nerf_width=32, num_neighbors=6,
                    grid_lower=(-0.5, -0.5, -0.5), grid_upper=(0.5, 0.5, 0.5),
                    device="cpu")
    with torch.no_grad():  # opaque samples
        for nerf in (net.nerf_coarse, net.nerf_fine):
            nerf.sigma.bias.add_(3.0)
    pos = torch.from_numpy(rng.uniform(-0.4, 0.4, (60, 3)).astype(np.float32))
    ro = torch.tensor([0.0, 0.0, 2.0])
    n_rays, chunk = 21, 8  # 2 full chunks + a ragged 5-ray tail
    d = np.tile([0.0, 0.0, -1.0], (n_rays, 1)).astype(np.float32)
    d[:, 0] += np.linspace(-0.15, 0.15, n_rays, dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([np.tile(ro.numpy(), (n_rays, 1)), d], -1)
    # make_chunk_renderer reads nothing from self
    render_full = TrainerBase.make_chunk_renderer(None, net, chunk=chunk)
    out = render_full(pos, ro, rays)
    with torch.no_grad():
        want = net(pos, ro, torch.from_numpy(rays))
    assert set(out) == set(want)
    for k, v in out.items():
        if k == "overflow":  # one flag per chunk
            assert v.shape == (3,) and not bool(v.any())
            continue
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(out["opacity1"].max()) > 0.1


def test_chunk_renderer_builds_the_list_grid_once(monkeypatch):
    """On the list path's grid backend the chunked render builds the
    particles' grid once for all its blocks (as the JAX package's scan
    does) and still equals one unchunked render."""
    rng = np.random.default_rng(11)
    net = RenderNet(near=1.0, far=3.0, n_samples=8, n_importance=4,
                    nerf_depth=2, nerf_width=32, num_neighbors=6,
                    grid_lower=(-0.5, -0.5, -0.5), grid_upper=(0.5, 0.5, 0.5),
                    search_mode="list", search_backend="grid", device="cpu")
    builds = []
    build = net.build_grid
    monkeypatch.setattr(net, "build_grid",
                        lambda p: builds.append(1) or build(p))
    pos = torch.from_numpy(rng.uniform(-0.4, 0.4, (60, 3)).astype(np.float32))
    ro = torch.tensor([0.0, 0.0, 2.0])
    d = np.tile([0.0, 0.0, -1.0], (13, 1)).astype(np.float32)
    d[:, 1] += np.linspace(-0.15, 0.15, 13, dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([np.tile(ro.numpy(), (13, 1)), d], -1)
    out = TrainerBase.make_chunk_renderer(None, net, chunk=4)(pos, ro, rays)
    assert len(builds) == 1
    with torch.no_grad():
        want = net(pos, ro, torch.from_numpy(rays))
    for k in ("rgb0", "rgb1", "num_nn_0", "mask_1"):
        np.testing.assert_allclose(out[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert int(want["mask_0"].sum()) > 0


def test_e2e_and_renderer_evaluators_run(scene, tmp_path, capsys):
    """Both evaluators from checkpoints on the tiny scene (one render chunk
    a frame, two test frames): the report, the clouds and the images."""
    cfg = ConfigNode(dict(
        expdir=str(tmp_path), expname="e2e_eval", resume_from="",
        TRAIN=dict(seed=10),
        TEST=dict(imgW=24, imgH=24, scale=1.0, camera_angle_x=0.32),
        RENDERER=dict(renderer_cfg(), ray=dict(
            ray_chunk=64, N_importance=4, N_samples=8, eval_ray_chunk=576)),
        **scene_cfg(scene)))
    cfg.test.end_index = 3
    renderer = build_renderer(cfg, device="cpu")
    net = ParticleNet(gravity=(0.0, 0.0, -9.81), device="cpu")
    models = str(tmp_path / "models")
    ckpt.save_checkpoint(models, 1, {"step": 1,
                                     "renderer": renderer.state_dict(),
                                     "transition": net.state_dict()})
    cfg.resume_from = models
    ev = evaluation.E2EEvaluator(cfg, device="cpu")
    dists, psnrs = ev.eval()
    assert len(dists) == len(psnrs) == 2
    assert np.isfinite(dists).all() and np.isfinite(psnrs).all()
    assert "Pred2GT-end:" in capsys.readouterr().out
    for path in ("particles/Pred/2.obj", "particles/GT/2.obj",
                 "images/fine/view_5/Pred/00002.png", "pred2gt.json"):
        assert os.path.isfile(os.path.join(ev.exppath, path)), path

    cfg.expname = "render_eval"
    outdir = evaluation.RendererEvaluator(cfg, device="cpu").eval(
        max_frames=2)
    assert sorted(os.listdir(outdir)) == [
        "coarse_pred_0.png", "coarse_pred_1.png", "fine_pred_0.png",
        "fine_pred_1.png"]
