"""The order of K5's products and K6's sums (`neurofluid_torch/csrc/
composite.cu` `composite_weights_kernel`, `composite_weights_bwd_kernel`),
emulated in float32 numpy on the CPU and held against JAX's Pallas
compositing kernel and its custom VJP in interpret mode and against the
plain PyTorch versions.

K5 holds a ray in one warp: lane l owns the P samples from l * P of a tile
of 32 P (`samples_per_lane`), forms their product of (s + 1e-10) one by
one, takes the transmittance at the start of its run from a Hillis-Steele
product scan over the lanes (shfl_up) times the transmittance carried
before the tile, and multiplies it by its samples' factors one by one for
their weights; the tile's total (the last lane's inclusive scan) carries to
the next tile of 256.

K6 holds a ray the same way: each lane forms its run's product of
(s + 1e-10) one by one, takes the transmittance at the start of its run
from a Hillis-Steele product scan over the lanes (shfl_up), then the
weighted terms g w and their sum over its run from the last sample, the
suffix after its run from a reverse sum scan (shfl_down); rays of more than
256 samples take tiles of 256, a butterfly product per tile for the
transmittance at each tile's start and the tiles from the last. The
emulation repeats each of those f32 operations in that order; the kernel
itself is held against the plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vjp

from neurofluid_tpu.ops import pallas_kernels
from neurofluid_torch.ops import composite as comp

F32 = np.float32
EPS = F32(1e-10)


def _scan_product(v):
    """Inclusive product scan over the last axis (32 lanes), shfl_up order."""
    v = v.copy()
    o = 1
    while o < 32:
        y = np.concatenate([np.ones_like(v[..., :o]), v[..., :-o]], -1)
        v = v * y  # lanes below o multiply by 1: unchanged
        o *= 2
    return v


def _scan_sum_reverse(v):
    """Inclusive reverse sum scan over the 32 lanes, shfl_down order."""
    v = v.copy()
    o = 1
    while o < 32:
        y = np.concatenate([v[..., o:], np.zeros_like(v[..., :o])], -1)
        v = v + y
        o *= 2
    return v


def _butterfly_product(v):
    """The tile's total product by shfl_xor, as every lane ends with it."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v * v[..., lanes ^ o]
    return v[..., 0]


def _tiles(sig, z, dn, p, *more):
    """The ray padded to whole tiles of 32 p: the scaled deltas d, the
    survivals s, the factors f (1 past the ray), the in-ray mask, the
    padded sigmas and `more`."""
    n = sig.shape[1]
    tile = 32 * p
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    i = np.arange(n_tiles * tile)
    zp, sp, *mp = (np.pad(a, ((0, 0), (0, pad))) for a in (z, sig, *more))
    z_next = np.concatenate([zp[:, 1:], np.zeros_like(zp[:, :1])], 1)
    d = np.where(i + 1 < n, z_next - zp, F32(1e10)) * dn[:, None]
    s = np.exp(-(d * np.maximum(sp, F32(0.0))))
    inside = i < n
    f = np.where(inside, s + EPS, F32(1.0))
    return n_tiles, d, s, f, np.broadcast_to(inside, sp.shape), sp, *mp


def _runs(a, c, p):
    """Tile c of a (R, tiles * 32 p) array as (R, 32 lanes, p)."""
    tile = 32 * p
    return a[:, c * tile:(c + 1) * tile].reshape(a.shape[0], 32, p)


def _run_product(fr):
    prod = np.ones(fr.shape[:2], F32)
    for j in range(fr.shape[-1]):
        prod = prod * fr[..., j]
    return prod


def k5_emulated(sig, z, dn):
    """w (R, S) of K5 in float32, in the kernel's order."""
    n_rays, n = sig.shape
    p = comp.samples_per_lane(n)
    n_tiles, _, s, f, inside, sp = _tiles(sig, z, dn, p)
    out = np.zeros_like(sp)
    carry = np.ones(n_rays, F32)
    for c in range(n_tiles):
        fr, sr, inr = (_runs(a, c, p) for a in (f, s, inside))
        incl = _scan_product(_run_product(fr))
        excl = np.concatenate([np.ones_like(incl[:, :1]), incl[:, :-1]], 1)
        t = carry[:, None] * excl
        w = np.zeros_like(fr)
        for j in range(p):
            w[..., j] = (F32(1.0) - sr[..., j]) * t
            t = np.where(inr[..., j], t * fr[..., j], t)
        out[:, c * 32 * p:(c + 1) * 32 * p] = w.reshape(n_rays, 32 * p)
        carry = carry * incl[:, 31]
    return out[:, :n]


def k6_emulated(sig, z, dn, g):
    """d sigma (R, S) of K6 in float32, in the kernel's order."""
    n_rays, n = sig.shape
    p = comp.bwd_samples_per_lane(n)
    tile = 32 * p
    n_tiles, d, s, f, inside, sp, gp = _tiles(sig, z, dn, p, g)

    def runs(a, c):
        return _runs(a, c, p)

    run_product = _run_product

    carry = [np.ones(n_rays, F32)]
    for c in range(n_tiles - 1):
        carry.append(carry[-1] * _butterfly_product(run_product(runs(f, c))))
    out = np.zeros_like(sp)
    later = np.zeros(n_rays, F32)
    for c in range(n_tiles - 1, -1, -1):
        fr, sr, dr, gr, sigr, inr = (runs(a, c) for a in (
            f, s, d, gp, sp, inside))
        incl = _scan_product(run_product(fr))
        excl = np.concatenate([np.ones_like(incl[:, :1]), incl[:, :-1]], 1)
        t = carry[c][:, None] * excl
        tr, gw = np.zeros_like(fr), np.zeros_like(fr)
        for j in range(p):
            tr[..., j] = t
            gw[..., j] = np.where(inr[..., j],
                                  gr[..., j] * ((F32(1.0) - sr[..., j]) * t),
                                  F32(0.0))
            t = np.where(inr[..., j], t * fr[..., j], t)
        within = np.zeros_like(fr)
        run_sum = np.zeros(fr.shape[:2], F32)
        for j in range(p - 1, -1, -1):
            within[..., j] = run_sum
            run_sum = run_sum + gw[..., j]
        rs = _scan_sum_reverse(run_sum)
        after = np.concatenate([rs[:, 1:], np.zeros_like(rs[:, :1])], 1)
        after = after + later[:, None]
        ds = np.where(sigr > 0, dr * sr * (gr * tr - (after[..., None] + within)
                                           / (sr + EPS)), F32(0.0))
        out[:, c * tile:(c + 1) * tile] = ds.reshape(n_rays, tile)
        later = later + rs[:, 0]
    return out[:, :n]


def _rays(rng, n, s):
    """Sigmas with negatives and zeros (relu), a huge value (alpha == 1) in
    most rays, saturated rays (a long opaque stretch, one all opaque) whose
    transmittance runs down to the 1e-10 floor and below, a repeated sample
    (delta == 0); ||d|| != 1. A ray of one sample has the last delta only
    (1e10), so its sigmas are of the order of 1e-10."""
    sig = rng.normal(size=(n, s)).astype(F32) * (5.0 if s > 1 else 2e-10)
    sig[5:, s // 3] = 1e6
    sig[0, :] = 0.0
    sig[2, s // 4:] = 1e6
    sig[3, :] = 1e6
    sig[4, : s // 2] = 40.0
    z = np.sort(rng.uniform(9.0, 13.0, size=(n, s)).astype(F32), -1)
    if s > 4:
        z[1, 4] = z[1, 3]
    dn = rng.uniform(0.5, 1.5, n).astype(F32)
    g = rng.normal(size=(n, s)).astype(F32)
    return sig, z, dn, g


@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 192, 256, 257, 300])
def test_k5_order_matches_jax(s):
    """K5's order against JAX's forward kernel in interpret mode and the
    plain version (a cumulative product), absolute (weights <= 1), on the
    rays of the K6 test below: σ ≤ 0 everywhere in one, saturated ones, a
    repeated sample; 257 and 300 samples take two tiles."""
    rng = np.random.default_rng(100 + s)
    sig, z, dn, _ = _rays(rng, 24, s)
    want = np.asarray(pallas_kernels.composite_weights(
        jnp.asarray(sig), jnp.asarray(z), jnp.asarray(dn[:, None]), 8, True))
    got = k5_emulated(sig, z, dn)
    plain = comp.composite_weights_plain(
        *(torch.from_numpy(a) for a in (sig, z, dn))).numpy()
    # the TPU kernel's log-space prefix sums, and the plain version's
    # cumulative product, against runs and warp scans: f32 rounding of
    # products of <= 300 factors; chip_smoke.py holds K5 itself to 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0], 0.0)  # no density: no weight
    assert np.all(np.isfinite(got)) and got.max() > 0.5
    if s > 1:  # the saturated rays: the first opaque sample takes it all
        assert got[3, 0] == 1.0 and np.all(got[3, 1:] < 1e-9)


@pytest.mark.parametrize("s", [1, 31, 33, 64, 192, 256, 300])
def test_k6_order_matches_jax_vjp(s):
    rng = np.random.default_rng(s)
    sig, z, dn, g = _rays(rng, 24, s)

    def f(a):
        return pallas_kernels.composite_weights(
            a, jnp.asarray(z), jnp.asarray(dn[:, None]), 8, True)

    want = np.asarray(vjp(f, jnp.asarray(sig))[1](jnp.asarray(g))[0])
    got = k6_emulated(sig, z, dn, g)
    plain = comp.composite_weights_bwd_plain(
        *(torch.from_numpy(a) for a in (sig, z, dn, g))).numpy()
    # the TPU kernel's log-space prefix sums, and the plain version's
    # cumulative products and sums, against runs and warp scans: f32
    # rounding, relative to the largest entry
    scale = np.abs(want).max()
    assert scale > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(got[0], 0.0)  # relu'(0) = 0
    assert np.all(np.isfinite(got))
    if s > 1:  # the saturated rays: T fell through the floor
        _, _, trans = comp._survival(*(torch.from_numpy(a)
                                          for a in (sig, z, dn)))
        assert float(trans[3, -1]) <= 1e-10 and float(trans[2, -1]) <= 1e-10


def test_samples_per_lane_cover_every_ray():
    """One warp covers rays of up to 256 samples in one tile with the fewest
    samples per lane; longer ones take tiles of 256, in K5 at any length,
    in K6 up to 2,048; K6 refuses more."""
    want = {1: 1, 32: 1, 33: 2, 64: 2, 65: 4, 128: 4, 129: 6, 192: 6,
            193: 8, 256: 8, 257: 8, 2048: 8}
    for n, p in want.items():
        assert comp.samples_per_lane(n) == p, n
        assert comp.bwd_samples_per_lane(n) == p, n
    for n in range(1, 257):
        p = comp.samples_per_lane(n)
        assert 32 * p >= n and (p == 1 or 32 * comp.PER_LANE[
            comp.PER_LANE.index(p) - 1] < n)
    assert comp.samples_per_lane(2049) == comp.samples_per_lane(10**6) == 8
    with pytest.raises(ValueError):
        comp.bwd_samples_per_lane(2049)
