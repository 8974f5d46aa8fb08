"""Port parity: ray sampling and compositing weights (K5's plain version)
against neurofluid_tpu.ops.ray_ops and the Pallas compositing kernel in
interpret mode. Same numpy inputs through both packages, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.ops import pallas_kernels
from neurofluid_tpu.ops import ray_ops as jray
from neurofluid_torch.ops import composite as tcomp
from neurofluid_torch.ops import ray_ops as tray


def _rays(rng, n):
    o = np.tile(np.asarray([0.0, -10.5, 1.0], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    d[:, 1] += 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1).astype(np.float32)


def _sigma_z(rng, n, s):
    """Sigmas with negatives (relu), zeros and huge values (alpha == 1),
    and sorted z values with a repeated sample (delta == 0)."""
    sig = rng.normal(size=(n, s)).astype(np.float32) * 5.0
    sig[:, s // 3] = 1e6
    sig[0, :] = 0.0
    z = np.sort(rng.uniform(9.0, 13.0, size=(n, s)).astype(np.float32), -1)
    z[1, 4] = z[1, 3]
    return sig, z


def test_coarse_sample_rays_matches_jax(rng):
    rays = _rays(rng, 7)
    zt, xt = tray.coarse_sample_rays(9.0, 13.0, torch.from_numpy(rays), 64)
    zj, xj = jray.coarse_sample_rays(9.0, 13.0, jnp.asarray(rays), 64)
    # linspace and the affine map round differently by an ulp (z ~ 13)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-5)


def test_sample_pdf_det_matches_jax(rng):
    n, b = 9, 64
    bins = np.sort(rng.uniform(9.0, 13.0, size=(n, b)).astype(np.float32), -1)
    w = rng.uniform(size=(n, b - 1)).astype(np.float32)
    w[0] = 0.0  # all-flat pdf: every denominator hits the 1e-5 guard
    w[1, 10:] = 0.0
    zt = tray.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 128)
    zj = jray.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 128, det=True)
    # the cdf's cumsum order may differ by an ulp; samples are z ~ 13
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=2e-5)


@pytest.mark.parametrize("s", [64, 192])
def test_composite_weights_plain_matches_pallas_interpret(rng, s):
    n = 40
    sig, z = _sigma_z(rng, n, s)
    rays = _rays(rng, n)
    wj = pallas_kernels.composite_weights_pallas(
        jnp.asarray(sig), jnp.asarray(z), jnp.asarray(rays), block_rays=16,
        interpret=True)
    dnorm = torch.linalg.norm(torch.from_numpy(rays[:, 3:]), dim=-1)
    wt = tcomp.composite_weights(torch.from_numpy(sig), torch.from_numpy(z),
                                 dnorm)
    # the TPU kernel's log-space prefix sum vs a direct product: f32 rounding
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=2e-6)
    assert np.isfinite(wt.numpy()).all()


def test_composite_matches_jax_xla(rng):
    n, s = 12, 48
    sig, z = _sigma_z(rng, n, s)
    rgb = rng.uniform(size=(n, s, 3)).astype(np.float32)
    rgbsigma = np.concatenate([rgb, sig[..., None]], -1)
    rays = _rays(rng, n)
    for white in (True, False):
        out_t = tray.composite(torch.from_numpy(rgbsigma), torch.from_numpy(z),
                               torch.from_numpy(rays), white)
        out_j = jray.composite(jnp.asarray(rgbsigma), jnp.asarray(z),
                               jnp.asarray(rays), white_background=white,
                               backend="xla")
        # depth sums weights * z (z ~ 13): tolerance scaled by that
        for a, b, tol in zip(out_t, out_j, (2e-6, 3e-5, 2e-6)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=tol)


def _c2w(rng):
    """A camera-to-world (3, 4): a random rotation and an origin ~11 away."""
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    origin = rng.normal(size=3) * 6.0
    return np.concatenate([rot, origin[:, None]], 1).astype(np.float32)


@pytest.mark.parametrize("hw,focal", [((8, 8), 120.0), ((6, 10), 33.3)])
def test_pixel_rays_match_jax(rng, hw, focal):
    """get_ray_directions, get_rays and make_ray_bundle: the directions
    exactly (the same f32 operations), the rotated and normalized rays
    within 1e-6 (a 3-term product in another order)."""
    h, w = hw
    dt = tray.get_ray_directions(h, w, focal, device="cpu")
    dj = jray.get_ray_directions(h, w, focal)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert dt.shape == (h, w, 3) and dt.dtype == torch.float32
    c2w = _c2w(rng)
    ot, rt = tray.get_rays(dt, torch.from_numpy(c2w))
    oj, rj = jray.get_rays(dj, jnp.asarray(c2w))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-6)
    bt = tray.make_ray_bundle(dt, torch.from_numpy(c2w))
    bj = jray.make_ray_bundle(dj, jnp.asarray(c2w))
    assert bt.shape == (h, w, 6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(bt[..., 3:].numpy(), axis=-1),
                               1.0, atol=1e-6)


def test_ndc_rays_match_jax(rng):
    h, w, focal, near = 10, 12, 25.0, 1.0
    c2w = _c2w(rng)
    c2w[:, 3] = (0.1, -0.2, 3.0)  # in front of the near plane
    o, d = jray.get_rays(jray.get_ray_directions(h, w, focal),
                         jnp.asarray(c2w))
    o, d = np.array(o), np.array(d)
    ot, dt = tray.get_ndc_rays(h, w, focal, near, torch.from_numpy(o),
                               torch.from_numpy(d))
    oj, dj = jray.get_ndc_rays(h, w, focal, near, jnp.asarray(o),
                               jnp.asarray(d))
    # elementwise in the same order; relative to the largest entry
    for a, b in ((ot, oj), (dt, dj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def test_importance_sampling_det_matches_jax(rng, monkeypatch):
    """The fine samples of the deterministic path: merged, sorted z values
    (z ~ 13, so within 2e-5 as sample_pdf) and their points; the new
    samples carry no gradient. det=False on JAX's uniforms, fed through
    `ray_ops.uniform`, places the same samples; without a generator it is
    refused."""
    n, s0, si = 9, 64, 128
    rays = _rays(rng, n)
    z0 = np.sort(rng.uniform(9.0, 13.0, (n, s0)).astype(np.float32), -1)
    w = rng.uniform(size=(n, s0)).astype(np.float32)
    w[0] = 0.0
    wt = torch.from_numpy(w).requires_grad_(True)
    xt, zt = tray.importance_sampling(torch.from_numpy(z0), wt, si,
                                      torch.from_numpy(rays[:, :3]),
                                      torch.from_numpy(rays[:, 3:]), True)
    xj, zj = jray.importance_sampling(jnp.asarray(z0), jnp.asarray(w), si,
                                      jnp.asarray(rays[:, :3]),
                                      jnp.asarray(rays[:, 3:]), True)
    assert zt.shape == (n, s0 + si) and xt.shape == (n, s0 + si, 3)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), rtol=0,
                               atol=3e-5)
    assert bool((zt[:, 1:] >= zt[:, :-1]).all())
    assert not zt.requires_grad
    # det=False: uniform CDF levels from the generator; fed JAX's own
    # draws through `ray_ops.uniform` it places the same samples
    key = jax.random.PRNGKey(2)
    u = np.array(jax.random.uniform(key, (n, si)))
    seen = []

    def fed(shape, generator, dtype, device):
        seen.append(tuple(shape))
        return torch.from_numpy(u).to(dtype)

    with monkeypatch.context() as m:
        m.setattr(tray, "uniform", fed)
        xt, zt = tray.importance_sampling(
            torch.from_numpy(z0), wt, si, torch.from_numpy(rays[:, :3]),
            torch.from_numpy(rays[:, 3:]), False,
            generator=torch.Generator())
    xj, zj = jray.importance_sampling(jnp.asarray(z0), jnp.asarray(w), si,
                                      jnp.asarray(rays[:, :3]),
                                      jnp.asarray(rays[:, 3:]), False,
                                      key=key)
    assert seen == [(n, si)]
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), rtol=0,
                               atol=3e-5)
    # without a generator the random form refuses, as JAX's without a key
    with pytest.raises(ValueError, match="torch.Generator"):
        tray.importance_sampling(torch.from_numpy(z0), wt, si,
                                 torch.from_numpy(rays[:, :3]),
                                 torch.from_numpy(rays[:, 3:]), False)


def test_ray_directions_default_to_the_card():
    """With no device named, get_ray_directions builds on the card, and
    without one it refuses rather than building on the CPU."""
    if torch.cuda.is_available():
        assert tray.get_ray_directions(4, 4, 10.0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tray.get_ray_directions(4, 4, 10.0)
