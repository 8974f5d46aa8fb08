"""Port parity, backward of the renderer: the plain K4
(`ball_sums_bwd_plain`, through `ball_feature_sums`) against JAX's
`_ball_bwd` on the Pallas backward kernel in interpret mode and on the XLA
backend; the plain K6 (`composite_weights_bwd_plain`) against the custom
VJP of the Pallas compositing kernel in interpret mode; and the particle
gradient of the whole RenderNet against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.models.render_net import RenderNet as JRenderNet
from neurofluid_tpu.ops import ball_features as jbf
from neurofluid_tpu.ops import pallas_kernels
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.ops import ball_features as tbf
from neurofluid_torch.ops import composite as tcomp
from neurofluid_torch.utils.params import renderer_state_from_flax

LOWER = (-0.7, -0.7, -0.7)
UPPER = (0.7, 0.7, 0.7)
R = 0.225


@pytest.fixture(scope="module")
def ball_case():
    """Dense particles (count > K for most queries), queries on particles
    (d == 0 pairs), a cull capacity below the in-AABB query count, one
    cell over max_per_cell (its tail particles are in no table), and a
    cotangent on all 13 sums."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.35, 0.35, (500, 3)).astype(np.float32)
    pts[:40] = rng.uniform(0.30, 0.34, (40, 3))  # one crowded cell
    qs = rng.uniform(-0.65, 0.65, (400, 3)).astype(np.float32)
    qs[:5] = pts[100:105]
    cot = rng.normal(size=(400, tbf.N_SUMS)).astype(np.float32)
    p = torch.from_numpy(pts).requires_grad_(True)
    sums, over = tbf.ball_feature_sums(torch.from_numpy(qs), p, R, 20, LOWER,
                                       UPPER, max_per_cell=32,
                                       capacity_frac=0.6)
    got, = torch.autograd.grad((sums * torch.from_numpy(cot)).sum(), p)
    return pts, qs, cot, got.numpy(), sums.detach().numpy(), bool(over)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_ball_sums_bwd_matches_jax(ball_case, backend):
    pts, qs, cot, got, sums, over = ball_case

    def f(p):
        s, _ = jbf.ball_feature_sums(jnp.asarray(qs), p, R, 20, LOWER, UPPER,
                                     max_per_cell=32, capacity_frac=0.6,
                                     backend=backend)
        return jnp.sum(s * cot)

    # on the CPU the Pallas backend runs pallas_features.backward in
    # interpret mode (its default off the TPU)
    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(pts)))
    assert over  # the crowded cell overflowed and the cull capped queries
    assert (sums[:, 0] > 20).sum() > 50 and (sums[:, 0] == 0).sum() > 0
    # f32 sums of <= 20 selected terms per query in another order,
    # relative to the largest entry
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    assert np.abs(got).max() > 1.0
    # a particle in no table slot gets exactly zero
    grid = tbf.build_tables(torch.from_numpy(pts), LOWER, UPPER, R, 32)[0]
    in_table = np.zeros(len(pts), bool)
    idx = grid.table_idx.numpy()
    in_table[idx[idx >= 0]] = True
    assert (~in_table).sum() > 0
    assert np.abs(got[~in_table]).max() == 0.0


@pytest.mark.parametrize("s", [64, 192])
def test_composite_weights_bwd_matches_pallas_vjp(rng, s):
    """Sigmas with negatives and zeros (relu), huge values (alpha == 1) and
    a repeated sample (delta == 0); ||d|| != 1."""
    n = 40
    sig = rng.normal(size=(n, s)).astype(np.float32) * 5.0
    sig[:, s // 3] = 1e6
    sig[0, :] = 0.0
    z = np.sort(rng.uniform(9.0, 13.0, size=(n, s)).astype(np.float32), -1)
    z[1, 4] = z[1, 3]
    dn = rng.uniform(0.5, 1.5, n).astype(np.float32)
    g = rng.normal(size=(n, s)).astype(np.float32)

    def f(a):
        return pallas_kernels.composite_weights(
            a, jnp.asarray(z), jnp.asarray(dn[:, None]), 16, True)

    want = np.asarray(jax.vjp(f, jnp.asarray(sig))[1](jnp.asarray(g))[0])
    st = torch.from_numpy(sig).requires_grad_(True)
    w = tcomp.composite_weights(st, torch.from_numpy(z), torch.from_numpy(dn))
    got, = torch.autograd.grad((w * torch.from_numpy(g)).sum(), st)
    # the TPU kernel's log-space prefix sums vs direct products and a
    # reverse cumulative sum: f32 rounding, relative to the largest entry
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 0.01
    np.testing.assert_array_equal(got.numpy()[0], 0.0)  # relu'(0) = 0


def test_render_net_particle_gradient_matches_jax():
    """The particle gradient of the coarse + fine render loss: it must be
    nonzero, or no image gradient reaches the simulator.

    The gradient through the encoded variance feature (a difference of
    near-equal sums) is ill-conditioned in f32: here JAX's own jitted and
    eager gradients differ by 6e-4 of the largest entry (the port is within
    1.3e-4 of the eager one), and at the default top frequency 2^9 by ~2%.
    So the encodings of the sample, smoothed position and variance stop at
    2^4 here."""
    rng = np.random.default_rng(6)
    small = dict(near=1.0, far=3.0, n_samples=16, n_importance=16,
                 nerf_depth=4, nerf_width=32, grid_lower=(-0.5, -0.5, -0.5),
                 grid_upper=(0.5, 0.5, 0.5), grid_max_per_cell=48,
                 xyz_freqs=5)
    particles = rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    ro = np.asarray([0.0, 0.05, 2.0], np.float32)
    d = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (8, 1))
    d[:, 0] += np.linspace(-0.12, 0.12, 8, dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([np.tile(ro, (8, 1)), d], -1).astype(np.float32)
    target = rng.uniform(size=(8, 3)).astype(np.float32)

    jnet = JRenderNet(**small)
    params = jnet.init(jax.random.PRNGKey(3), jnp.asarray(particles),
                       jnp.asarray(ro), jnp.asarray(rays))

    def loss_j(p):
        out = jnet.apply(params, p, jnp.asarray(ro), jnp.asarray(rays))
        return (jnp.mean((out["rgb0"] - target) ** 2)
                + jnp.mean((out["rgb1"] - target) ** 2))

    want = np.asarray(jax.jit(jax.grad(loss_j))(jnp.asarray(particles)))
    tnet = RenderNet(device="cpu", **small)
    tnet.load_state_dict(renderer_state_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    p = torch.from_numpy(particles).requires_grad_(True)
    out = tnet(p, torch.from_numpy(ro), torch.from_numpy(rays))
    loss = sum(torch.mean((out[k] - torch.from_numpy(target)) ** 2)
               for k in ("rgb0", "rgb1"))
    got, = torch.autograd.grad(loss, p)
    assert (np.abs(want).max(-1) > 0).sum() > 30
    # relative to the largest entry, above JAX's own jit/eager spread
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
