"""Port parity, the end-to-end trainer: neurofluid_torch.train.e2e against
neurofluid_tpu's on the CPU. The JAX trainer is built once for the module
(its 8 x 256 NeRF's flax init is most of its cost) and its jitted step
never runs.

(a) The host loop: both trainers' `train_step`, `eval` and
    `save_checkpoint` replaced by recorders on the tiny synthetic scene
    (tests/test_torch_trainer_common.py), the renderer-protection anchor
    on, for two epochs: the same state reaches the step (reset to the GT
    particles at each sequence start, else the previous step's output),
    with the same sampled rays and pixels (the center crop until
    precrop_iters; the anchor's with precrop 0) and the same anchor
    inputs; the logged tags (scalars and histograms), the checkpoint and
    the eval steps agree.
(b) The anchored step's math: two steps of the port's
    `make_e2e_train_step(..., with_anchor=True)` against JAX's, at the
    widths of tests/test_torch_train.py (NeRF depth 2, search backend
    'brute'), the same weights through
    `*_state_from_flax`: per-step loss within rtol 1e-5 and the weights
    within 2 lr (that file's tolerances).
(c) Resume: model weights only, fresh optimizers and schedules, and the
    start step JAX's gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurofluid_tpu.models.particle_net import ParticleNet as JParticleNet
from neurofluid_tpu.models.render_net import RenderNet as JRenderNet
from neurofluid_tpu.train import e2e as je2e
from neurofluid_tpu.train import losses as jlosses
from neurofluid_tpu.train.e2e import E2ETrainer as JE2ETrainer
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train import losses as tlosses
from neurofluid_torch.train.e2e import E2ETrainer, make_e2e_train_step
from neurofluid_torch.utils.config import ConfigNode
from neurofluid_torch.utils.params import (
    renderer_state_from_flax, transition_state_from_flax,
)
from test_torch_trainer_common import (
    CallRecorder, StepRecorder, assert_calls_equal, configs, metric_events,
    metric_values, renderer_cfg, scene_cfg, write_scene,
)

EPOCHS = 2
AUX_SCALARS = ("rgbloss_0", "rgbloss_1", "boundary_loss",
               "grad_norm_renderer", "grad_norm_transition",
               "search_cap_exceeded")
HISTS = ("grad_hist_renderer_before", "grad_hist_renderer_after",
         "grad_hist_transition_before", "grad_hist_transition_after")


def _cfg(root):
    return dict(
        expname="e2e", resume_from="",
        TRAIN=dict(seed=10, epochs=EPOCHS, precrop_iters=2, save_interval=4,
                   log_interval=2, imgW=24, imgH=24, scale=1.0,
                   grad_clip_value=0.5,
                   LR=dict(trans_lr=1e-5, renderer_lr=3e-4,
                           use_scheduler=True),
                   loss_weight=dict(boundary_loss=1.0),
                   anchor=dict(enabled=True, weight=1.0, rays=16, n_views=2),
                   pretrained_renderer="", pretrained_transition_model="",
                   partial_load=False, search_backend="brute"),
        TEST=dict(imgW=24, imgH=24, scale=1.0, start_index=0, end_index=4),
        RENDERER=renderer_cfg(),
        **scene_cfg(root),
    )


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    root = write_scene(str(tmp_path_factory.mktemp("scene")))
    jcfg, tcfg = configs(_cfg(root), tmp_path_factory.mktemp("exps"))
    return JE2ETrainer(jcfg), E2ETrainer(tcfg, device="cpu"), tcfg


def test_initial_weights_in_jax_key_order(trainers):
    """JAX's e2e trainer draws the transition model under its first key
    and the renderer under its second; the port's trainer starts from the
    same weights, so it splits its key in the same order."""
    jtr, ttr, _ = trainers
    for module, params, convert in (
            (ttr.transition, jtr.params_t, transition_state_from_flax),
            (ttr.renderer, jtr.params_r, renderer_state_from_flax)):
        want = convert(jax.tree_util.tree_map(np.asarray, params))
        got = module.state_dict()
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].numpy(), w.numpy(),
                                          err_msg=name)


def _aux(i, n_views, lib):
    """A step's aux as the trainers log it, from `lib` (numpy or torch)."""
    full = (lambda shape: np.full(shape, 0.1 * (i + 1), np.float32)) \
        if lib is np else (lambda shape: torch.full(shape, 0.1 * (i + 1)))
    aux = {k: full(()) for k in AUX_SCALARS}
    aux.update({k: full((3,)) for k in HISTS})
    aux.update(mse0_views=full((n_views,)), mse1_views=full((n_views,)),
               num_nn_0=full((n_views, 5, 1)), num_nn_1=full((n_views, 7, 1)),
               search_overflow=np.bool_(False) if lib is np
               else torch.tensor(False))
    return aux


def test_host_loop_matches_jax(trainers):
    jtr, ttr, _ = trainers
    assert jtr.anchor_enabled and ttr.anchor_enabled
    n_views = len(ttr.train_views)

    def jax_result(i, pr, pt, sr, st, pos, vel, *_):
        return (pr, pt, sr, st, np.float32(i), np.asarray(pos) + 0.01,
                np.asarray(vel) - 0.01, _aux(i, n_views, np))

    def torch_result(i, pos, vel, *_):
        return (torch.tensor(float(i)), pos + 0.01, vel - 0.01,
                _aux(i, n_views, torch))

    jtr.train_step = StepRecorder(jax_result)
    ttr.train_step = StepRecorder(torch_result)
    for tr in (jtr, ttr):
        tr.eval, tr.save_checkpoint = CallRecorder(), CallRecorder()
        tr.train()
    # JAX's step takes (params_r, params_t, opt_r_state, opt_t_state, pos,
    # vel, box, nrm, ro_v, rays_v, rgbs_v, box_grid, anchor_pos,
    # anchor_ro_v, anchor_rays_v, anchor_rgbs_v); 'brute' has no box grid
    jcalls = [c[4:] for c in jtr.train_step.calls]
    tcalls = ttr.train_step.calls
    assert len(jcalls) == EPOCHS * len(ttr.dataset) == 6
    assert_calls_equal(tcalls, jcalls, "train_step", atol=1e-6)
    # the state: the GT frame at each sequence start, else carried
    gt0 = ttr.dataset[0]["particles_pos"]
    np.testing.assert_array_equal(tcalls[0][0], gt0)
    np.testing.assert_array_equal(tcalls[3][0], gt0)
    np.testing.assert_allclose(tcalls[1][0], gt0 + 0.01, rtol=0, atol=1e-6)
    assert ttr.save_checkpoint.calls == jtr.save_checkpoint.calls == [(4,)]
    assert ttr.eval.calls == jtr.eval.calls == [(4,)]
    events = metric_events(ttr.exppath)
    assert events == metric_events(jtr.exppath)
    assert ("view_1/num_neighbors_1", 5) in events
    assert ("train/grad_hist_transition_after", 5) in events
    for tag in ("train/loss", "train/lr_renderer", "train/lr_transition",
                "train/pred2gt_distance"):
        np.testing.assert_allclose(metric_values(ttr.exppath, tag),
                                   metric_values(jtr.exppath, tag),
                                   rtol=1e-5, err_msg=tag)


# ---- (b) the anchored step at tests/test_torch_train.py's widths

TIGHT = dict(grid_lower=(-0.5, -0.5, -0.65), grid_upper=(0.5, 0.5, 0.55),
             fused_cell_scale=2.0, layer_channels=(8, 24, 3))
# NeRF depth 2 and the transition on 'brute' (no Pallas kernel in JAX's
# conv) keep JAX's compile of the anchored step short
RENDER = dict(near=1.0, far=3.0, n_samples=16, n_importance=16, nerf_depth=2,
              nerf_width=32, grid_lower=(-0.5, -0.5, -0.65),
              grid_upper=(0.5, 0.5, 0.55), grid_max_per_cell=64, xyz_freqs=5)
LR_R, LR_T, STEPS, ANCHOR_WEIGHT = 3e-4, 1e-5, 2, 0.5
LO = np.asarray([-0.2, -0.2, -0.3], np.float32)
HI = np.asarray([0.2, 0.2, 0.2], np.float32)


def _scene():
    rng = np.random.default_rng(4)
    n, m, v, r = 160, 24, 2, 8
    pos = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    box = rng.uniform(-0.45, 0.45, (m, 3)).astype(np.float32)
    box[:, 2] = -0.45
    nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (m, 1))
    o = np.tile(np.asarray([0.0, 0.02, 2.0], np.float32), (r, 1))
    d = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (r, 1))
    d[:, 0] += np.linspace(-0.1, 0.1, r, dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rays_v = np.stack([rays, rays[::-1].copy()])
    rays_v[1, :, 0] += 0.03
    ro_v = rays_v[:, 0, :3].copy()
    rgbs_v = rng.uniform(size=(v, r, 3)).astype(np.float32)
    # the anchor: other particles (the "frame 0"), other pixels
    a_pos = pos[::-1].copy() * 0.9
    a_rays_v = rays_v.copy()
    a_rays_v[:, :, 1] -= 0.04
    a_ro_v = a_rays_v[:, 0, :3].copy()
    a_rgbs_v = rng.uniform(size=(v, r, 3)).astype(np.float32)
    return ((pos, vel, box, nrm, ro_v, rays_v, rgbs_v),
            (a_pos, a_ro_v, a_rays_v, a_rgbs_v))


def test_anchored_steps_match_jax():
    (pos, vel, box, nrm, ro_v, rays_v, rgbs_v), anchor = _scene()
    jnet = JParticleNet(search_backend="brute", gravity=(0, 0, -9.81),
                        **TIGHT)
    pj = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(1), *map(jnp.asarray, (pos, vel, box, nrm))))
    jren = JRenderNet(**RENDER)
    rj = jax.tree_util.tree_map(np.asarray, jren.init(
        jax.random.PRNGKey(2), jnp.asarray(pos), jnp.asarray(ro_v[0]),
        jnp.asarray(rays_v[0])))
    for nerf in ("nerf_coarse", "nerf_fine"):  # opaque samples
        rj["params"][nerf]["sigma"]["bias"] = (
            rj["params"][nerf]["sigma"]["bias"] + 3.0)
    opt_r, opt_t = optax.adam(LR_R), optax.adam(LR_T)
    jstep = jax.jit(je2e.make_e2e_train_step(
        jnet, jren, opt_r, opt_t,
        jlosses.BoxBounds(jnp.asarray(LO), jnp.asarray(HI)), 1.0,
        with_anchor=True, anchor_weight=ANCHOR_WEIGHT))

    tnet = ParticleNet(search_backend="brute", gravity=(0, 0, -9.81),
                       device="cpu", **TIGHT)
    tnet.load_state_dict(transition_state_from_flax(pj))
    tren = RenderNet(device="cpu", **RENDER)
    tren.load_state_dict(renderer_state_from_flax(rj))
    tstep = make_e2e_train_step(
        tnet, tren, torch.optim.Adam(tren.parameters(), lr=LR_R),
        torch.optim.Adam(tnet.parameters(), lr=LR_T),
        tlosses.BoxBounds(torch.from_numpy(LO), torch.from_numpy(HI)), 1.0,
        with_anchor=True, anchor_weight=ANCHOR_WEIGHT)

    pr, pt, sr, st = rj, pj, opt_r.init(rj), opt_t.init(pj)
    jp, jv = jnp.asarray(pos), jnp.asarray(vel)
    tp, tv = torch.from_numpy(pos), torch.from_numpy(vel)
    data = (box, nrm, ro_v, rays_v, rgbs_v)
    for _ in range(STEPS):
        pr, pt, sr, st, loss_j, jp, jv, aux_j = jstep(
            pr, pt, sr, st, jp, jv, *map(jnp.asarray, data), None,
            *map(jnp.asarray, anchor))
        loss, tp, tv, aux = tstep(tp, tv, *map(torch.from_numpy, data), None,
                                  *map(torch.from_numpy, anchor))
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        assert bool(aux["search_overflow"]) == bool(aux_j["search_overflow"])
        for key in ("rgbloss_0", "rgbloss_1", "grad_norm_renderer"):
            np.testing.assert_allclose(aux[key].numpy(), aux_j[key],
                                       rtol=2e-4, err_msg=key)
        # the anchor term is in the loss: it is more than the joint terms
        joint = float(aux["rgbloss_0"] + aux["rgbloss_1"]
                      + aux["boundary_loss"])
        assert float(loss) > joint + 1e-3
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=2e-6)
    # Adam moves each entry by ~lr per step whatever its gradient's size,
    # so the weights agree within 2 lr
    for model, want, lr in (
            (tren, renderer_state_from_flax(jax.tree_util.tree_map(
                np.asarray, pr)), LR_R),
            (tnet, transition_state_from_flax(jax.tree_util.tree_map(
                np.asarray, pt)), LR_T)):
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr, err_msg=name)


# ---- (c) resume


def test_resume_resets_optimizers(trainers, tmp_path):
    """One real step of the port (a one-step epoch), a checkpoint, and a
    resumed trainer: the weights come back, the optimizers and their
    schedules start afresh, and the start step is JAX's."""
    jtr, _, tcfg = trainers
    cfg = ConfigNode(tcfg.to_dict()).merge(dict(
        expdir=str(tmp_path), train=dict(end_index=2),
        TRAIN=dict(anchor=dict(enabled=False), log_interval=100)))
    tr = E2ETrainer(cfg, device="cpu")
    tr.train(n_epochs=1, eval_during_training=False)
    tr.save_checkpoint(3)
    assert tr.opt_r.state_dict()["state"]
    resumed = E2ETrainer(cfg.clone().merge(dict(resume_from=tr.modelpath)),
                         device="cpu")
    JE2ETrainer.save_checkpoint(jtr, 3)
    JE2ETrainer.resume(jtr, jtr.modelpath)
    assert resumed.start_step == jtr.start_step == 4
    for opt in (resumed.opt_r, resumed.opt_t):
        assert not opt.state_dict()["state"]
    assert [s.last_epoch for s in resumed.lr_scheds] == [0, 0]
    for model, trained in ((resumed.renderer, tr.renderer),
                           (resumed.transition, tr.transition)):
        for name, p in model.state_dict().items():
            np.testing.assert_array_equal(p.numpy(),
                                          trained.state_dict()[name].numpy())
