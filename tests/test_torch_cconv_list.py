"""Port parity: the continuous convolution over a neighbour list
(`neurofluid_torch.ops.cconv`: `cconv_geometry`, `cconv_tap_matrix`,
`continuous_conv_apply`) against neurofluid_tpu.ops.cconv on one shared
neighbour list, forward and the gradients with respect to the filter, the
features, the points and the queries.

Tolerances, relative to the largest entry: 1e-5 forward (f32 sums over <= 24
neighbours x 8 taps and 64 * Cin filter terms in another order; the port's
disc -> square step uses the atan polynomial of the fused kernel, |error|
<= 1.4e-7), 1e-4 for the gradients (the same through the geometry's
adjoint).

The first threaded vector-math call of a process (here `torch.sqrt` in
`map_sphere_to_cylinder`, 2,880 elements in two chunks) can come back with
about half the mantissa in the worker thread's chunk when the CPU is
contended: a first-use race of the CPU library under torch's unary kernels
(seen with torch 2.13, MKL 2024.2; 4 of ~400 loaded processes, 3e-4
relative, 0 of ~900 after any one threaded call). It made the first test of
this file fail once in 30 to 150 loaded runs, 1.3e-4 off in the forward.
`_first_vector_call` takes that call on throwaway data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.ops import cconv as jcc
from neurofluid_tpu.ops import neighbor_search as jns
from neurofluid_tpu.ops import segment_ops as jso
from neurofluid_torch.ops import cconv as tcc
from neurofluid_torch.ops import neighbor_search as tns
from neurofluid_torch.ops import segment_ops as tso

EXTENT, K, CIN, COUT = 0.45, 24, 5, 7
KS = (4, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def _first_vector_call():
    torch.sqrt(torch.rand(2048 * 64))


def _case(same_points):
    rng = np.random.default_rng(7)
    n, q = 180, 120
    pts = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    qs = pts[:q].copy() if same_points else rng.uniform(
        -0.4, 0.4, (q, 3)).astype(np.float32)
    nb = jns.radius_search_brute(jnp.asarray(qs), jnp.asarray(pts),
                                 EXTENT / 2, K, exclude_self=same_points)
    idx, mask = np.array(nb.idx), np.array(nb.mask)
    assert mask.any(axis=1).all() and not mask.all()
    feats = rng.normal(size=(n, CIN)).astype(np.float32)
    filt = (rng.normal(size=(*KS, CIN, COUT)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(q, COUT)).astype(np.float32)
    return pts, qs, idx, mask, np.array(nb.count), feats, filt, ct


def _jax_conv(filt, feats, pts, qs, idx, mask, count, use_tap_matrix):
    nb = jns.NeighborList(jnp.asarray(idx), jnp.zeros(idx.shape),
                          jnp.asarray(mask), jnp.asarray(count))
    plan = jso.adjoint_plan(jnp.maximum(nb.idx, 0), pts.shape[0])
    corner, tapw = jcc.cconv_geometry(pts, qs, nb, EXTENT, plan=plan)
    tw = jcc.cconv_tap_matrix(corner, tapw, 64) if use_tap_matrix else None
    return jcc.continuous_conv_apply(filt, corner, tapw, feats, nb, plan=plan,
                                     tap_matrix=tw)


def _torch_conv(filt, feats, pts, qs, idx, mask, count, use_tap_matrix):
    nb = tns.NeighborList(idx, torch.zeros(idx.shape), mask, count)
    plan = tso.AdjointPlan(idx, pts.shape[0])
    corner, tapw = tcc.cconv_geometry(pts, qs, nb, EXTENT, KS, plan)
    tw = tcc.cconv_tap_matrix(corner, tapw, 64) if use_tap_matrix else None
    return tcc.continuous_conv_apply(filt, corner, tapw, feats, nb, plan=plan,
                                     tap_matrix=tw)


@pytest.mark.parametrize("same_points", [False, True])
@pytest.mark.parametrize("use_tap_matrix", [False, True])
def test_list_conv_forward_and_gradients_match_jax(same_points,
                                                   use_tap_matrix):
    pts, qs, idx, mask, count, feats, filt, ct = _case(same_points)
    disc = (idx, mask, count, use_tap_matrix)

    def jloss(filt_, feats_, pts_, qs_):
        return jnp.sum(_jax_conv(filt_, feats_, pts_, qs_, *disc)
                       * jnp.asarray(ct))

    jargs = tuple(map(jnp.asarray, (filt, feats, pts, qs)))
    out_j = _jax_conv(*jargs, *disc)
    grads_j = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (filt, feats, pts, qs)]
    out_t = _torch_conv(*targs, torch.from_numpy(idx), torch.from_numpy(mask),
                        torch.from_numpy(count), use_tap_matrix)
    grads_t = torch.autograd.grad((out_t * torch.from_numpy(ct)).sum(), targs)

    out_j = np.asarray(out_j)
    assert np.abs(out_j).max() > 0.1
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0,
                               atol=1e-5 * np.abs(out_j).max())
    for name, gt, gj in zip(("filters", "feats", "points", "queries"),
                            grads_t, grads_j):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0, name
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                                   atol=1e-4 * np.abs(gj).max(), err_msg=name)


def test_geometry_matches_jax_and_masks_padding():
    pts, qs, idx, mask, count, *_ = _case(False)
    nb_j = jns.NeighborList(jnp.asarray(idx), jnp.zeros(idx.shape),
                            jnp.asarray(mask), jnp.asarray(count))
    corner_j, tapw_j = jcc.cconv_geometry(jnp.asarray(pts), jnp.asarray(qs),
                                          nb_j, EXTENT)
    nb_t = tns.NeighborList(torch.from_numpy(idx), torch.zeros(idx.shape),
                            torch.from_numpy(mask), torch.from_numpy(count))
    corner_t, tapw_t = tcc.cconv_geometry(torch.from_numpy(pts),
                                          torch.from_numpy(qs), nb_t, EXTENT)
    # tap weights in [0, 1]; a corner may differ only where a coordinate
    # sits on a tap boundary to rounding, and then its weight is ~0
    np.testing.assert_allclose(tapw_t.numpy(), np.asarray(tapw_j), rtol=0,
                               atol=2e-6)
    differ = corner_t.numpy() != np.asarray(corner_j)
    assert differ.mean() < 1e-3
    assert float(np.abs(np.asarray(tapw_j))[differ].max(initial=0.0)) < 1e-5
    assert float(tapw_t[~torch.from_numpy(mask)].abs().max()) == 0.0
    tw_t = tcc.cconv_tap_matrix(corner_t, tapw_t, 64)
    tw_j = jcc.cconv_tap_matrix(corner_j, tapw_j, 64)
    assert tw_t.shape == (len(qs), 64, K)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), rtol=0,
                               atol=2e-6)


def test_bf16_product_and_its_transpose_match_the_oracle():
    """`cconv.bf16_product` forward and backward against the oracle's
    `DEFAULT` einsum (tests/torch_bf16_oracle.py: both operands of each
    product rounded, the cotangent too, products in float64), batched as the
    basis contraction and plain as the fold: only the f32 sums differ
    (relative to the largest entry, 1e-6); and its backward is not that of
    autograd through bf16 casts, which rounds each gradient after its
    product."""
    from torch_bf16_oracle import bf16_einsum

    rng = np.random.default_rng(5)
    for spec, sa, sb in (("qtk,qkc->qtc", (9, 64, 24), (9, 24, 5)),
                         ("qk,kn->qn", (40, 320), (320, 7))):
        a, b = (rng.normal(size=s).astype(np.float32) for s in (sa, sb))
        ct = rng.normal(size=np.einsum(spec, a, b).shape).astype(np.float32)
        out_j, vjp = jax.vjp(bf16_einsum(spec), jnp.asarray(a), jnp.asarray(b))
        grads_j = vjp(jnp.asarray(ct))
        ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
        out_t = tcc.bf16_product(ta, tb)
        grads_t = torch.autograd.grad(out_t, (ta, tb), torch.from_numpy(ct))
        for name, got, want in (("out", out_t, out_j),
                                ("da", grads_t[0], grads_j[0]),
                                ("db", grads_t[1], grads_j[1])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{spec} {name}")
        ca, cb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
        cast = (ca.to(torch.bfloat16).float() @ cb.to(torch.bfloat16).float())
        g_cast = torch.autograd.grad(cast, (ca, cb), torch.from_numpy(ct))
        assert float((g_cast[0] - grads_t[0]).abs().max()) > 1e-4 * float(
            grads_t[0].abs().max())


@pytest.mark.parametrize("same_points", [False, True])
@pytest.mark.parametrize("use_tap_matrix", [False, True])
def test_list_conv_default_matches_the_bf16_oracle(same_points,
                                                   use_tap_matrix):
    """`continuous_conv_apply(..., precision='default')` forward and its
    four gradients against the oracle (the JAX package's geometry and tap
    matrix, both einsums at the TPU's `DEFAULT`): each at least MARGIN times
    closer to it than to JAX's 'highest' result, by mean absolute
    deviation; 'highest' and 'high' are bitwise the port's f32 result."""
    from torch_bf16_oracle import (
        assert_bf16_oracle, continuous_conv_default,
    )

    pts, qs, idx, mask, count, feats, filt, ct = _case(same_points)
    disc = (idx, mask, count, use_tap_matrix)

    def jconv(apply, filt_, feats_, pts_, qs_):
        nb = jns.NeighborList(jnp.asarray(idx), jnp.zeros(idx.shape),
                              jnp.asarray(mask), jnp.asarray(count))
        plan = jso.adjoint_plan(jnp.maximum(nb.idx, 0), pts.shape[0])
        corner, tapw = jcc.cconv_geometry(pts_, qs_, nb, EXTENT, plan=plan)
        tw = jcc.cconv_tap_matrix(corner, tapw, 64) if use_tap_matrix \
            else None
        return apply(filt_, corner, tapw, feats_, nb, plan=plan,
                     tap_matrix=tw)

    jargs = tuple(map(jnp.asarray, (filt, feats, pts, qs)))
    ref = {}
    for name, apply in (("oracle", continuous_conv_default),
                        ("highest", jcc.continuous_conv_apply)):
        out = jconv(apply, *jargs)
        grads = jax.grad(lambda *a: jnp.sum(jconv(apply, *a)
                                            * jnp.asarray(ct)),
                         argnums=(0, 1, 2, 3))(*jargs)
        ref[name] = (out,) + tuple(grads)

    results = {}
    for prec in ("default", "highest", "high"):
        targs = [torch.from_numpy(a).requires_grad_(True)
                 for a in (filt, feats, pts, qs)]
        nb = tns.NeighborList(torch.from_numpy(idx), torch.zeros(idx.shape),
                              torch.from_numpy(mask), torch.from_numpy(count))
        plan = tso.AdjointPlan(nb.idx, pts.shape[0])
        corner, tapw = tcc.cconv_geometry(targs[2], targs[3], nb, EXTENT, KS,
                                          plan)
        tw = tcc.cconv_tap_matrix(corner, tapw, 64) if use_tap_matrix \
            else None
        out = tcc.continuous_conv_apply(targs[0], corner, tapw, targs[1], nb,
                                        plan=plan, tap_matrix=tw,
                                        precision=prec)
        grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), targs)
        results[prec] = (out.detach(),) + grads
    names = ("out", "filters", "feats", "points", "queries")
    for name, got, oracle, high in zip(names, results["default"],
                                       ref["oracle"], ref["highest"]):
        assert_bf16_oracle(name, got.numpy(), oracle, high)
    for got, want in zip(results["high"], results["highest"]):
        assert torch.equal(got, want)
