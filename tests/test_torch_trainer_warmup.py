"""Port parity, the warm-up trainer: neurofluid_torch.train.warmup against
neurofluid_tpu's on the CPU. The JAX trainer is built once for the module
(its 8 x 256 NeRF's flax init is most of its cost) and its jitted step
never runs.

(a) The host loop: both trainers' `train_step`, `eval` and
    `save_checkpoint` replaced by recorders on the tiny synthetic scene
    (tests/test_torch_trainer_common.py): the same frame-0 particles, camera
    origins, sampled rays and pixels (the center crop until precrop_iters,
    then the whole image) reach the step, and the logged tags and values,
    the checkpoint and the eval steps agree.
(b) The step's math: three steps of the port's `make_warmup_train_step`
    against the same objective written here over JAX's RenderNet (the form
    of neurofluid_tpu/train/warmup.py's step: the sum over views of
    MSE(rgb0) + MSE(rgb1)) with `optax.adam` on JAX's exponential decay, at
    nerf_depth 2, nerf_width 32, the same weights through
    `renderer_state_from_flax`: per-step loss within rtol 1e-5, the
    learning rate the schedule's at each update count, and the weights
    within 2 lr (tests/test_torch_train.py's tolerances).
(c) Resume: the port restores the optimizer and its schedule, so that the
    learning rate continues mid-decay (the port's form of
    tests/test_train.py's schedule-offset test), and starts at the step
    JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurofluid_tpu.models.render_net import RenderNet as JRenderNet
from neurofluid_tpu.train import schedules as jsched
from neurofluid_tpu.train.warmup import WarmupTrainer as JWarmupTrainer
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train import schedules
from neurofluid_torch.train.warmup import (
    WarmupTrainer, build_renderer, make_warmup_train_step,
)
from neurofluid_torch.utils.config import ConfigNode
from neurofluid_torch.utils.params import renderer_state_from_flax
from test_torch_trainer_common import (
    CallRecorder, StepRecorder, assert_calls_equal, configs, metric_events,
    metric_values, renderer_cfg, scene_cfg, write_scene,
)

N_ITERS, DECAY = 6, 10


def _cfg(root):
    return dict(
        expname="warmup", resume_from="",
        TRAIN=dict(seed=10, N_iters=N_ITERS, precrop_iters=2,
                   save_interval=3, log_interval=2, imgW=24, imgH=24,
                   scale=1.0, LR=dict(lr=5e-3, use_scheduler=True,
                                      decay_epochs=DECAY),
                   pretrained_renderer="", partial_load=False),
        TEST=dict(imgW=24, imgH=24, scale=1.0, start_index=0, end_index=4),
        RENDERER=renderer_cfg(),
        **scene_cfg(root),
    )


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    root = write_scene(str(tmp_path_factory.mktemp("scene")))
    jcfg, tcfg = configs(_cfg(root), tmp_path_factory.mktemp("exps"))
    return JWarmupTrainer(jcfg), WarmupTrainer(tcfg, device="cpu"), tcfg


def test_initial_weights_are_jax_draw(trainers):
    """From one config (TRAIN.seed 10) the port's trainer starts from the
    JAX trainer's initial weights: flax's init of the 8 x 256 RenderNet
    under the first key of PRNGKey(10), drawn by the port on the host."""
    jtr, ttr, _ = trainers
    want = renderer_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params))
    got = ttr.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w.numpy(),
                                      err_msg=name)


def test_host_loop_matches_jax(trainers):
    jtr, ttr, _ = trainers
    n_views = len(ttr.train_views)
    assert n_views == 2

    def jax_result(i, params, opt_state, *_):
        mse = np.full(n_views, 0.1 * i, np.float32)
        return params, opt_state, np.float32(i), (mse, mse, np.bool_(False))

    def torch_result(i, *_):
        mse = torch.full((n_views,), 0.1 * i)
        return torch.tensor(float(i)), (mse, mse, torch.tensor(False))

    jtr.train_step = StepRecorder(jax_result)
    ttr.train_step = StepRecorder(torch_result)
    for tr in (jtr, ttr):
        tr.eval, tr.save_checkpoint = CallRecorder(), CallRecorder()
        tr.train()
    # JAX's step takes (params, opt_state, particles, ro_v, rays_v, rgbs_v)
    jcalls = [c[2:] for c in jtr.train_step.calls]
    assert len(jcalls) == N_ITERS
    assert_calls_equal(ttr.train_step.calls, jcalls, "train_step", atol=1e-6)
    assert ttr.save_checkpoint.calls == jtr.save_checkpoint.calls == [(2,),
                                                                      (5,)]
    assert ttr.eval.calls == jtr.eval.calls == [(2,), (5,)]
    assert metric_events(ttr.exppath) == metric_events(jtr.exppath)
    for tag in ("train/loss", "train/lr", "view_2/rgbloss"):
        np.testing.assert_allclose(metric_values(ttr.exppath, tag),
                                   metric_values(jtr.exppath, tag),
                                   rtol=1e-6, err_msg=tag)


def test_pixel_sampling_matches_jax(trainers):
    """`sample_pixel_indices` draws the same indices as JAX's from the same
    seed and call order, inside the crop and after it."""
    jtr, ttr, _ = trainers
    jtr.np_rng = np.random.default_rng(3)
    ttr.np_rng = np.random.default_rng(3)
    for step in (0, 1, 2, 3):
        want = jtr.sample_pixel_indices(24, 24, step, 50, 1)
        got = ttr.sample_pixel_indices(24, 24, step, 50, 1)
        np.testing.assert_array_equal(got, want)
        rows, cols = got // 24, got % 24
        inside = ((rows >= 6) & (rows < 18) & (cols >= 6) & (cols < 18)).all()
        assert inside == (step <= 1)


# ---- (b) the step's math at nerf_depth 2, nerf_width 32

SMALL = dict(near=1.0, far=3.0, n_samples=16, n_importance=16, nerf_depth=2,
             nerf_width=32, grid_lower=(-0.5, -0.5, -0.65),
             grid_upper=(0.5, 0.5, 0.55), grid_max_per_cell=64)
LR, STEP_DECAY, STEPS = 5e-3, 2, 3


def _views():
    rng = np.random.default_rng(4)
    particles = rng.uniform(-0.25, 0.25, (160, 3)).astype(np.float32)
    o = np.tile(np.asarray([0.0, 0.02, 2.0], np.float32), (8, 1))
    d = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (8, 1))
    d[:, 0] += np.linspace(-0.1, 0.1, 8, dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rays_v = np.stack([rays, rays[::-1].copy()])
    rays_v[1, :, 0] += 0.03
    ro_v = rays_v[:, 0, :3].copy()
    rgbs_v = rng.uniform(size=(2, 8, 3)).astype(np.float32)
    return particles, ro_v, rays_v, rgbs_v


def test_warmup_steps_match_jax():
    particles, ro_v, rays_v, rgbs_v = _views()
    jren = JRenderNet(**SMALL)
    params = jax.tree_util.tree_map(np.asarray, jren.init(
        jax.random.PRNGKey(2), jnp.asarray(particles), jnp.asarray(ro_v[0]),
        jnp.asarray(rays_v[0])))
    for nerf in ("nerf_coarse", "nerf_fine"):  # opaque samples
        params["params"][nerf]["sigma"]["bias"] = (
            params["params"][nerf]["sigma"]["bias"] + 3.0)
    schedule_j = jsched.exponential_decay(LR, STEP_DECAY, gamma=0.1)
    opt = optax.adam(schedule_j)

    @jax.jit
    def jstep(p, s):
        def loss_fn(p):
            outs = jax.vmap(lambda ro, rays: jren.apply(
                p, jnp.asarray(particles), ro, rays))(ro_v, rays_v)
            mse0 = jnp.mean((outs["rgb0"] - rgbs_v) ** 2, axis=(1, 2))
            mse1 = jnp.mean((outs["rgb1"] - rgbs_v) ** 2, axis=(1, 2))
            return jnp.sum(mse0 + mse1), (mse0, mse1,
                                          jnp.any(outs["overflow"]))

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, aux

    tren = RenderNet(device="cpu", **SMALL)
    tren.load_state_dict(renderer_state_from_flax(params))
    topt = torch.optim.Adam(tren.parameters(), lr=LR)
    schedule = schedules.exponential_decay(LR, STEP_DECAY, gamma=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        topt, schedules.lr_lambda(schedule, LR))
    step = make_warmup_train_step(tren, topt)
    inputs = [torch.from_numpy(x) for x in (particles, ro_v, rays_v, rgbs_v)]

    p, s = params, opt.init(params)
    losses = []
    for i in range(STEPS):
        np.testing.assert_allclose(topt.param_groups[0]["lr"],
                                   float(schedule_j(i)), rtol=1e-6)
        p, s, loss_j, (mse0_j, mse1_j, ov_j) = jstep(p, s)
        loss, (mse0, mse1, ov) = step(*inputs)
        sched.step()
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        losses.append(float(loss))
        np.testing.assert_allclose(mse0.numpy(), np.asarray(mse0_j),
                                   rtol=1e-5)
        np.testing.assert_allclose(mse1.numpy(), np.asarray(mse1_j),
                                   rtol=1e-5)
        assert bool(ov) == bool(ov_j) is False
    assert losses[-1] < losses[0]
    want = renderer_state_from_flax(jax.tree_util.tree_map(np.asarray, p))
    for name, w in tren.state_dict().items():
        np.testing.assert_allclose(w.numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * LR, err_msg=name)


# ---- (c) resume


def test_resume_continues_the_schedule(trainers, tmp_path):
    """Two real steps of the port on one view (the plain ball-feature sums
    dominate a CPU step), a checkpoint, and a resumed trainer."""
    jtr, _, tcfg = trainers
    cfg = ConfigNode(tcfg.to_dict()).merge(dict(
        expdir=str(tmp_path), train=dict(views=dict(warmup=["view_1"])),
        TRAIN=dict(save_interval=100)))
    tr = WarmupTrainer(cfg, device="cpu")
    tr.train(n_iters=2)
    tr.save_checkpoint(1)
    resumed = WarmupTrainer(cfg.clone().merge(dict(resume_from=tr.modelpath)),
                            device="cpu")
    JWarmupTrainer.save_checkpoint(jtr, 1)
    JWarmupTrainer.resume(jtr, jtr.modelpath)
    assert resumed.start_step == jtr.start_step == 2
    # two updates done: the next one runs at schedule(2), mid-decay
    counts = {int(s["step"]) for s in resumed.optimizer.state_dict()[
        "state"].values()}
    assert counts == {2}
    lr = resumed.optimizer.param_groups[0]["lr"]
    np.testing.assert_allclose(lr, resumed.schedule(2), rtol=1e-6)
    assert lr < 5e-3
    for name, p in resumed.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(),
                                      tr.model.state_dict()[name].numpy())


def test_build_renderer_refuses_what_is_not_ported(tmp_path):
    """Every RENDERER key reaches the RenderNet as the JAX package's
    `build_renderer` sets it (the list mode, each encoding switch, bf16,
    the backend and the selection, and their defaults when a key is
    absent), so nothing JAX accepts is refused any more; a value that
    names nothing is."""
    from neurofluid_tpu.train.warmup import build_renderer as jbuild

    fields = ("near", "far", "n_samples", "n_importance", "search_radius",
              "num_neighbors", "use_mask", "encode_density", "encode_var",
              "encode_smoothed_pos", "encode_smoothed_dir", "exclude_ray",
              "same_smooth_factor", "search_mode", "search_backend",
              "search_selection", "in_channels_xyz", "in_channels_dir")
    base = dict(_cfg(str(tmp_path)), expdir=str(tmp_path))
    for path, value in ((("NN_search", "mode"), "list"),
                        (("NN_search", "backend"), "grid"),
                        (("NN_search", "selection"), "sort"),
                        (("encoding", "density"), False),
                        (("encoding", "var"), False),
                        (("encoding", "smoothed_pos"), False),
                        (("encoding", "smoothed_dir"), False),
                        (("encoding", "exclude_ray"), False),
                        (("encoding", "same_smooth_factor"), True),
                        (("bf16",), True), (None, None)):
        cfg = ConfigNode(base)
        if path is not None:
            node = cfg.RENDERER
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = value
        else:  # the optional keys absent: JAX's defaults
            del cfg.RENDERER.NN_search["backend"]
            del cfg.RENDERER.NN_search["mode"]
            del cfg.RENDERER.encoding["same_smooth_factor"]
        tnet = build_renderer(cfg, device="cpu")
        jnet = jbuild(cfg)
        for name in fields:
            assert getattr(tnet, name) == getattr(jnet, name), (path, name)
        assert (tnet.compute_dtype == torch.bfloat16) == (
            jnet.compute_dtype == jnp.bfloat16), path
        assert tnet.nerf_coarse.xyz_encoding_1[0].in_features == \
            jnet.in_channels_xyz
        if path is not None and path[-1] == "bf16":
            assert tnet.nerf_fine.compute_dtype == torch.bfloat16
            assert tnet.nerf_fine.sigma.weight.dtype == torch.float32
    for key, value in (("mode", "sparse"), ("backend", "fused")):
        cfg = ConfigNode(base)
        cfg.RENDERER.NN_search[key] = value
        with pytest.raises(ValueError, match=f"unknown search_{key}"):
            build_renderer(cfg, device="cpu")