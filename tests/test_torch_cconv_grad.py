"""Port parity, backward of the fused continuous conv: the hand-derived
geometry adjoint of neurofluid_torch/ops/cconv.py against autograd of the
plain forward in f64, and the plain K2 (`fused_cconv_bwd_plain`) against
the custom VJP of neurofluid_tpu.ops.fused_cconv, whose Pallas backward
kernel runs in interpret mode on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.ops import fused_cconv as jfc
from neurofluid_torch.ops import cconv as tcc
from neurofluid_torch.ops import fused_cconv as tfc

LOWER = (-0.6, -0.6, -0.6)
UPPER = (0.6, 0.6, 0.6)
RADIUS = 0.25
KSIZE = (4, 4, 4)


def _offsets(rng, n):
    """Offsets in the unit ball, with points near the cap/side boundary
    (1.25 z^2 = x^2 + y^2), near the wedge diagonals (|x| = |y|), on the z
    axis and at the origin (coincident points)."""
    off = rng.uniform(-1, 1, (n, 3))
    off /= np.maximum(1.0, np.linalg.norm(off, axis=-1, keepdims=True))
    k = n // 8
    rho = rng.uniform(0.1, 0.5, k)
    phi = rng.uniform(0, 2 * np.pi, k)
    z = rho / np.sqrt(1.25) * rng.choice([-1, 1], k) * (1 + rng.choice(
        [-1e-3, 1e-3], k))
    off[:k] = np.stack([rho * np.cos(phi), rho * np.sin(phi), z], -1)
    a = rng.uniform(0.05, 0.4, k)
    off[k:2 * k] = np.stack([a * rng.choice([-1, 1], k),
                             a * (1 + rng.choice([-1e-3, 1e-3], k))
                             * rng.choice([-1, 1], k),
                             rng.uniform(-0.2, 0.2, k)], -1)
    off[-2] = [0.0, 0.0, 0.5]
    off[-1] = 0.0
    return off


def test_geometry_adjoint_matches_autograd_f64(rng):
    """tap_weights_vjp against autograd of tap_weights in f64: the two
    differentiate the same branches, so they agree to rounding; the
    coincident offset gets exactly zero."""
    off = torch.tensor(_offsets(rng, 4000), dtype=torch.float64,
                       requires_grad=True)
    g = torch.tensor(rng.normal(size=(4000, 8)))
    _, w = tcc.tap_weights(off, KSIZE)
    want, = torch.autograd.grad((w * g).sum(), off)
    got = tcc.tap_weights_vjp(off.detach(), KSIZE, g)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)
    assert float(got[-1].abs().max()) == 0.0


class _TapWeights(torch.autograd.Function):
    """tap_weights with the hand-derived adjoint as its backward."""

    @staticmethod
    def forward(ctx, off):
        ctx.save_for_backward(off)
        return tcc.tap_weights(off, KSIZE)[1]

    @staticmethod
    def backward(ctx, g):
        off, = ctx.saved_tensors
        return tcc.tap_weights_vjp(off, KSIZE, g)


def test_geometry_adjoint_gradcheck(rng):
    """Against central differences (gradcheck, f64) at offsets 1e-3 from
    the cap/side and wedge boundaries and inside the unit ball: far from
    the measure-zero kinks the map is smooth on the difference stencil."""
    off = _offsets(rng, 64)[:-2]  # the kinks themselves (axis, origin) out
    off = torch.tensor(off, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(_TapWeights.apply, (off,), eps=1e-7,
                                     atol=1e-6, rtol=1e-5)


def _case(rng, exclude_self):
    pq = rng.uniform(-0.5, 0.5, (120, 3)).astype(np.float32)
    pq[7] = pq[3]  # a coincident twin
    pc = pq if exclude_self else rng.uniform(-0.5, 0.5, (90, 3)).astype(
        np.float32)
    cin, cout = 5, 7
    feats = rng.normal(size=(len(pc), cin)).astype(np.float32)
    w = (rng.normal(size=(4, 4, 4, cin, cout)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(len(pq), cout)).astype(np.float32)
    return pq, pc, feats, w, ct


def _port_inputs(pq, pc, feats, exclude_self):
    qplan = tfc.build_plan(torch.from_numpy(pq), LOWER, UPPER, RADIUS)
    cplan = qplan if exclude_self else tfc.build_plan(
        torch.from_numpy(pc), LOWER, UPPER, RADIUS, with_groups=False)
    qpos_s = tfc.sort_values(torch.from_numpy(pq), qplan, qplan.slab_cap,
                             tfc.SENTINEL)
    # separate tensors for the two sides, so dq and dc come back apart
    cpos_s = (qpos_s if exclude_self else cplan.pos_s).clone()
    feats_s = tfc.sort_values(torch.from_numpy(feats), cplan, cplan.slab_cap)
    return qplan, qpos_s, cplan, cpos_s, feats_s


@pytest.mark.parametrize("exclude_self", [True, False])
def test_fused_cconv_bwd_matches_jax_vjp(rng, exclude_self):
    pq, pc, feats, w, ct = _case(rng, exclude_self)
    qplan, qpos_s, cplan, cpos_s, feats_s = _port_inputs(pq, pc, feats,
                                                         exclude_self)
    ct_s = tfc.sort_values(torch.from_numpy(ct), qplan)
    got = tfc.fused_cconv_bwd_plain(torch.from_numpy(w), qplan, qpos_s,
                                    cplan, cpos_s, feats_s, ct_s, RADIUS,
                                    exclude_self, (True,) * 4)

    jq = jfc.build_plan(jnp.asarray(pq), LOWER, UPPER, RADIUS)
    jcp = jq if exclude_self else jfc.build_plan(
        jnp.asarray(pc), LOWER, UPPER, RADIUS, with_groups=False)

    def conv(w_, q_, c_, f_):
        return jfc.fused_cconv(w_, jq, q_, jcp, c_, f_, RADIUS, exclude_self,
                               interpret=True)[0]

    want = jax.jit(lambda *a: jax.vjp(conv, *a[:4])[1](a[4]))(
        jnp.asarray(w), *(jnp.asarray(t.numpy())
                          for t in (qpos_s, cpos_s, feats_s, ct_s)))
    for name, a, b in zip(("dW", "dq", "dc", "dfeats"), got, want):
        b = np.asarray(b)
        # f32 sums over pairs and taps in another order, relative to the
        # largest entry
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-6 * np.abs(b).max(), err_msg=name)
    # sentinel and zero pad rows get exactly zero
    n, nc = qplan.n, cplan.n
    for t in (got[1][n:], got[2][nc:], got[3][nc:]):
        assert float(t.abs().max()) == 0.0
    assert float(got[1][:n].abs().max()) > 0.1


def test_fused_cconv_function_routes_the_plain_backward(rng):
    """Autograd through `fused_cconv` (the FusedCConv Function) equals the
    explicit plain backward, and autograd through the plain forward; when
    one tensor is both query and candidate positions its gradient is
    dq + dc; `needs` skips what autograd does not ask for."""
    pq, pc, feats, w, ct = _case(rng, True)
    qplan, qpos_s, _, _, feats_s = _port_inputs(pq, pc, feats, True)
    ct_s = tfc.sort_values(torch.from_numpy(ct), qplan)
    w_t = torch.from_numpy(w).requires_grad_(True)
    q_t = qpos_s.clone().requires_grad_(True)
    f_t = feats_s.clone().requires_grad_(True)
    out, cnt = tfc.fused_cconv(w_t, qplan, q_t, qplan, q_t, f_t, RADIUS, True)
    assert not cnt.requires_grad
    got = torch.autograd.grad((out * ct_s).sum(), (w_t, q_t, f_t))
    dw, dq, dc, df = tfc.fused_cconv_bwd_plain(
        torch.from_numpy(w), qplan, qpos_s, qplan, qpos_s, feats_s, ct_s,
        RADIUS, True, (True,) * 4)
    np.testing.assert_array_equal(got[0].numpy(), dw.numpy())
    np.testing.assert_array_equal(got[1].numpy(), (dq + dc).numpy())
    np.testing.assert_array_equal(got[2].numpy(), df.numpy())

    args = [t.detach().clone().requires_grad_(True)
            for t in (w_t, q_t, q_t, f_t)]
    out_p, _ = tfc.fused_cconv_plain(args[0], qplan, args[1], qplan, args[2],
                                     args[3], RADIUS, True)
    auto = torch.autograd.grad((out_p * ct_s).sum(), args)
    for a, b in zip(auto, (dw, dq, dc, df)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    only_w = tfc.fused_cconv_bwd_plain(
        torch.from_numpy(w), qplan, qpos_s, qplan, qpos_s, feats_s, ct_s,
        RADIUS, True, (True, False, False, False))
    assert only_w[1:] == (None, None, None)
    np.testing.assert_array_equal(only_w[0].numpy(), dw.numpy())
