"""Port parity, the training slice: three steps of the port's
`make_e2e_train_step` against neurofluid_tpu.train.e2e.make_e2e_train_step
(optax Adam, the same weights through `*_state_from_flax`, the fused-CConv
backend at 'highest' precision), a step with gradient clipping against
optax's `clip_by_global_norm`, and the losses and schedules.

The renderer's encodings of the sample, smoothed position and variance stop
at 2^4 here (`xyz_freqs=5`): at the default 2^9 the f32 gradient through
the variance feature is so ill-conditioned that JAX's own jitted and eager
steps disagree by ~2% on the transition gradient (see
tests/test_torch_render_grad.py)."""

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
from neurofluid_tpu.train import schedules as jsched
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train import e2e as te2e
from neurofluid_torch.train import losses as tlosses
from neurofluid_torch.train import schedules as tsched
from neurofluid_torch.utils.params import (
    renderer_state_from_flax, transition_state_from_flax,
)

TIGHT = dict(grid_lower=(-0.5, -0.5, -0.65), grid_upper=(0.5, 0.5, 0.55),
             fused_cell_scale=2.0, layer_channels=(8, 24, 3))
RENDER = dict(near=1.0, far=3.0, n_samples=16, n_importance=16, nerf_depth=6,
              nerf_width=32, grid_lower=(-0.5, -0.5, -0.65),
              grid_upper=(0.5, 0.5, 0.55), grid_max_per_cell=64, xyz_freqs=5)
LR_R, LR_T = 3e-4, 1e-5
# tight box bounds, so that some predicted particles lie outside and the
# boundary loss has a gradient
LO = np.asarray([-0.2, -0.2, -0.3], np.float32)
HI = np.asarray([0.2, 0.2, 0.2], np.float32)
STEPS = 3
CLIP = 0.1  # above the transition's gradient norm, below the renderer's


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _keep_grads():
    """An identity optax transform whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


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
    return pos, vel, box, nrm, ro_v, rays_v, rgbs_v


@pytest.fixture(scope="module")
def jax_run():
    """The JAX models' own initial weights, and three jitted JAX steps:
    (weights, per step (loss, next_pos, next_vel, aux, g_r, g_t), final
    weights)."""
    pos, vel, box, nrm, ro_v, rays_v, rgbs_v = _scene()
    jnet = JParticleNet(search_backend="fused_cconv", conv_precision="highest",
                        gravity=(0, 0, -9.81), **TIGHT)
    pj = jnet.init(jax.random.PRNGKey(1), *map(jnp.asarray,
                                                (pos, vel, box, nrm)))
    jren = JRenderNet(**RENDER)
    rj = _np(jren.init(jax.random.PRNGKey(2), jnp.asarray(pos),
                       jnp.asarray(ro_v[0]), jnp.asarray(rays_v[0])))
    for nerf in ("nerf_coarse", "nerf_fine"):  # opaque samples
        rj["params"][nerf]["sigma"]["bias"] = (
            rj["params"][nerf]["sigma"]["bias"] + 3.0)
    opt_r = optax.chain(_keep_grads(), optax.adam(LR_R))
    opt_t = optax.chain(_keep_grads(), optax.adam(LR_T))
    bounds = jlosses.BoxBounds(jnp.asarray(LO), jnp.asarray(HI))
    step = jax.jit(je2e.make_e2e_train_step(jnet, jren, opt_r, opt_t, bounds,
                                            1.0))
    weights = (_np(rj), _np(pj))
    pr, pt = rj, pj
    sr, st = opt_r.init(pr), opt_t.init(pt)
    p, v = jnp.asarray(pos), jnp.asarray(vel)
    data = [jnp.asarray(x) for x in (box, nrm, ro_v, rays_v, rgbs_v)]
    steps = []
    for _ in range(STEPS):
        pr, pt, sr, st, loss, p, v, aux = step(pr, pt, sr, st, p, v, *data)
        steps.append((float(loss), np.asarray(p), np.asarray(v), _np(aux),
                      _np(sr[0]), _np(st[0])))
    return weights, steps, (_np(pr), _np(pt))


def _port(weights, clip=0.0):
    rj, pj = weights
    tnet = ParticleNet(gravity=(0, 0, -9.81), device="cpu", **TIGHT)
    tnet.load_state_dict(transition_state_from_flax(pj))
    tren = RenderNet(device="cpu", **RENDER)
    tren.load_state_dict(renderer_state_from_flax(rj))
    opt_r = torch.optim.Adam(tren.parameters(), lr=LR_R)
    opt_t = torch.optim.Adam(tnet.parameters(), lr=LR_T)
    bounds = tlosses.BoxBounds(torch.from_numpy(LO), torch.from_numpy(HI))
    step = te2e.make_e2e_train_step(tnet, tren, opt_r, opt_t, bounds, 1.0,
                                    grad_clip_value=clip)
    return tnet, tren, step


def _assert_grads(model, want_state, what):
    for name, p in model.named_parameters():
        want = want_state[name].numpy()
        # relative to the leaf's largest entry: f32 sums in another order
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=f"{what} {name}")


def test_e2e_steps_match_jax(jax_run):
    weights, steps, (pr, pt) = jax_run
    tnet, tren, step = _port(weights)
    pos, vel, box, nrm, ro_v, rays_v, rgbs_v = map(torch.from_numpy, _scene())
    for i, (loss_j, pos_j, vel_j, aux_j, gr_j, gt_j) in enumerate(steps):
        loss, pos, vel, aux = step(pos, vel, box, nrm, ro_v, rays_v, rgbs_v)
        assert not pos.requires_grad and not vel.requires_grad
        np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
        assert set(aux) == set(aux_j)
        for key in ("search_overflow", "search_cap_exceeded", "num_nn_0",
                    "num_nn_1"):
            np.testing.assert_array_equal(aux[key].numpy(), aux_j[key],
                                          err_msg=key)
        for key in ("rgbloss_0", "rgbloss_1", "mse0_views", "mse1_views",
                    "boundary_loss", "grad_norm_renderer",
                    "grad_norm_transition"):
            np.testing.assert_allclose(aux[key].numpy(), aux_j[key],
                                       rtol=2e-4, atol=1e-9, err_msg=key)
        assert float(aux["boundary_loss"]) > 0
        assert float(aux["grad_norm_transition"]) > 0
        # the state: positions to f32 rounding of one step; velocity is
        # (pos - pos0) / dt, 50x wider
        np.testing.assert_allclose(pos.numpy(), pos_j, rtol=0, atol=2e-6)
        np.testing.assert_allclose(vel.numpy(), vel_j, rtol=0, atol=1e-4)
        if i == 0:
            _assert_grads(tren, renderer_state_from_flax(gr_j), "renderer")
            _assert_grads(tnet, transition_state_from_flax(gt_j),
                          "transition")
    # Adam moves each entry by ~lr per step whatever its gradient's size,
    # so after three steps the weights agree within 2 lr
    for model, want, lr in ((tren, renderer_state_from_flax(pr), LR_R),
                            (tnet, transition_state_from_flax(pt), LR_T)):
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr, err_msg=name)


def test_e2e_step_with_grad_clip_matches_optax(jax_run):
    """One clipped step from the same weights: the renderer's gradient is
    clipped and the transition's is not; the clipped gradients, the
    before/after histograms and the updated weights follow optax's
    chain(clip_by_global_norm, adam) on JAX's gradients."""
    weights, steps, _ = jax_run
    gr_j, gt_j = steps[0][4], steps[0][5]
    tnet, tren, step = _port(weights, clip=CLIP)
    pos, vel, box, nrm, ro_v, rays_v, rgbs_v = map(torch.from_numpy, _scene())
    _, _, _, aux = step(pos, vel, box, nrm, ro_v, rays_v, rgbs_v)
    assert float(aux["grad_norm_renderer"]) > CLIP
    assert float(aux["grad_norm_transition"]) < CLIP
    rj, pj = weights
    for name, model, g_j, params, lr, to_state in (
            ("renderer", tren, gr_j, rj, LR_R, renderer_state_from_flax),
            ("transition", tnet, gt_j, pj, LR_T, transition_state_from_flax)):
        tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(lr))
        clipped, _ = optax.clip_by_global_norm(CLIP).update(g_j, None)
        updates, _ = tx.update(g_j, tx.init(params), params)
        new = to_state(_np(optax.apply_updates(params, updates)))
        _assert_grads(model, to_state(_np(clipped)), name)
        for key in (f"grad_hist_{name}_before", f"grad_hist_{name}_after"):
            gn = float(aux[f"grad_norm_{name}"])
            before = np.sort(np.asarray(je2e._leaf_norms(g_j)))
            want = before if key.endswith("before") else (
                before * min(1.0, CLIP / (gn + 1e-16)))
            # the same leaves in another order (flax sorts by name)
            np.testing.assert_allclose(np.sort(aux[key].numpy()), want,
                                       rtol=2e-4, atol=1e-9, err_msg=key)
        for pname, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), new[pname].numpy(), rtol=0,
                                       atol=2 * lr, err_msg=pname)


def test_losses_match_jax(rng):
    pos = rng.uniform(-1.2, 2.7, (500, 3)).astype(np.float32)
    pos[:3] = [[0.975, 0.0, 0.0], [-0.975, 0.0, 2.4302], [0, 0, 0]]  # on it
    gt = pos + rng.normal(size=pos.shape).astype(np.float32) * 0.01
    nn = rng.integers(0, 60, 500).astype(np.float32)
    bt, bj = tlosses.default_box_bounds(), jlosses.default_box_bounds()
    np.testing.assert_array_equal(bt.lower.numpy(), np.asarray(bj.lower))
    np.testing.assert_array_equal(bt.upper.numpy(), np.asarray(bj.upper))
    np.testing.assert_array_equal(
        tlosses.clip_to_box(torch.from_numpy(pos), bt).numpy(),
        np.asarray(jlosses.clip_to_box(jnp.asarray(pos), bj)))
    p = torch.from_numpy(pos).requires_grad_(True)
    bd = tlosses.boundary_loss(p, bt)
    g, = torch.autograd.grad(bd, p)
    bdj, gj = jax.value_and_grad(jlosses.boundary_loss)(jnp.asarray(pos), bj)
    np.testing.assert_allclose(bd.item(), float(bdj), rtol=1e-6)
    # abs'(0) = 0: particles inside the box get no gradient. A coordinate
    # exactly on a bound gets none either; JAX gives it +1/(3N) there
    # (lax.abs' is +1 at 0 and its clamp passes nothing at a bound)
    g, gj = g.numpy(), np.asarray(gj)
    np.testing.assert_array_equal(g[3:], gj[3:])
    np.testing.assert_array_equal(g[:3], 0.0)
    assert (g == 0).all(axis=1).sum() > 100
    np.testing.assert_allclose(
        float(tlosses.weighted_mse_loss(torch.from_numpy(pos),
                                        torch.from_numpy(gt),
                                        torch.from_numpy(nn))),
        float(jlosses.weighted_mse_loss(jnp.asarray(pos), jnp.asarray(gt),
                                        jnp.asarray(nn))), rtol=1e-6)
    mse_t = tlosses.img_mse(torch.from_numpy(pos), torch.from_numpy(gt))
    mse_j = jlosses.img_mse(jnp.asarray(pos), jnp.asarray(gt))
    np.testing.assert_allclose(float(mse_t), float(mse_j), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.mse_to_psnr(mse_t)),
                               float(jlosses.mse_to_psnr(mse_j)), rtol=1e-6)


def test_schedules_match_jax():
    steps = [0, 1, 9_999, 10_000, 10_001, 30_001, 75_001, 150_001, 300_001,
             400_000]
    pairs = [
        (tsched.e2e_renderer_schedule(3e-4), jsched.e2e_renderer_schedule(3e-4)),
        (tsched.e2e_transition_schedule(1e-5),
         jsched.e2e_transition_schedule(1e-5)),
    ]
    for ts, js in pairs:
        for s in steps:
            np.testing.assert_allclose(ts(s), float(js(s)), rtol=1e-6)
    # as LambdaLR factors of an optimizer whose lr is the initial value
    w = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([w], lr=3e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, tsched.lr_lambda(tsched.e2e_renderer_schedule(3e-4), 3e-4))
    js = jsched.e2e_renderer_schedule(3e-4)
    for s in range(3):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(js(s)),
                                   rtol=1e-6)
        opt.step()
        sched.step()
    sched.last_epoch = 10_000
    sched.step()
    np.testing.assert_allclose(opt.param_groups[0]["lr"], float(js(10_001)),
                               rtol=1e-6)
