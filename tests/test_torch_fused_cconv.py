"""Port parity: the fused continuous conv (K1's plain version), its plan and
its geometry against neurofluid_tpu.ops.fused_cconv (Pallas interpret mode)
and neurofluid_tpu.ops.cconv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.ops import cconv as jcc
from neurofluid_tpu.ops import fused_cconv as jfc
from neurofluid_tpu.ops import neighbor_search as jns
from neurofluid_torch.ops import cconv as tcc
from neurofluid_torch.ops import fused_cconv as tfc

LOWER = (-0.6, -0.6, -0.6)
UPPER = (0.6, 0.6, 0.6)
RADIUS = 0.25


def _points(rng, n, spread=0.5):
    return rng.uniform(-spread, spread, (n, 3)).astype(np.float32)


def test_geometry_matches_jax_cconv(rng):
    off = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    off /= np.maximum(1.0, np.linalg.norm(off, axis=-1, keepdims=True))
    off[:3] = 0.0
    off[3] = [0.0, 0.0, 0.5]  # on the axis: cylinder-degenerate
    cyl_t = tcc.map_sphere_to_cylinder(torch.from_numpy(off))
    cyl_j = jcc.map_sphere_to_cylinder(jnp.asarray(off))
    np.testing.assert_allclose(cyl_t.numpy(), np.asarray(cyl_j), rtol=0,
                               atol=1e-6)
    cube_t = tcc.map_cylinder_to_cube(cyl_t)
    cube_j = jcc.map_cylinder_to_cube(cyl_j)
    # the atan polynomial is within 1.4e-7 of atan, times 4/pi * rho <= 1.6
    np.testing.assert_allclose(cube_t.numpy(), np.asarray(cube_j), rtol=0,
                               atol=1e-6)
    d2 = rng.uniform(0, 2, 100).astype(np.float32)
    np.testing.assert_allclose(tcc.window_poly6(torch.from_numpy(d2)).numpy(),
                               np.asarray(jcc.window_poly6(jnp.asarray(d2))),
                               rtol=0, atol=1e-7)
    ct, wt = tcc.trilinear_taps(cube_t, (4, 4, 4))
    cj, wj = jcc.trilinear_taps(jnp.asarray(cube_t.numpy()), (4, 4, 4))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-7)


def test_plan_matches_jax(rng):
    pts = _points(rng, 300)
    pt = tfc.build_plan(torch.from_numpy(pts), LOWER, UPPER, RADIUS)
    pj = jfc.build_plan(jnp.asarray(pts), LOWER, UPPER, RADIUS)
    for f in ("order", "inv_rank", "pos_s", "pstarts", "gcol", "gzlo",
              "gzhi", "gstart", "overflow"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    assert (pt.dims, pt.n_groups, pt.slab_cap) == (pj.dims, pj.n_groups,
                                                   pj.slab_cap)


def _run_both(pts_q, pts_c, feats, w, exclude_self, cell=RADIUS):
    """Port and JAX fused conv, outputs unsorted to the original order."""
    outs = []
    for lib, arr in ((tfc, torch.from_numpy), (jfc, jnp.asarray)):
        qplan = lib.build_plan(arr(pts_q), LOWER, UPPER, cell, group_size=16)
        cplan = (qplan if exclude_self else
                 lib.build_plan(arr(pts_c), LOWER, UPPER, cell,
                                with_groups=False))
        qpos_s = lib.sort_values(arr(pts_q), qplan, qplan.slab_cap,
                                 1e9)
        feats_s = lib.sort_values(arr(feats), cplan, cplan.slab_cap)
        cpos_s = qpos_s if exclude_self else cplan.pos_s
        kw = dict(interpret=True) if lib is jfc else {}
        out, cnt = lib.fused_cconv(arr(w), qplan, qpos_s, cplan, cpos_s,
                                   feats_s, RADIUS, exclude_self, **kw)
        outs.append((np.asarray(lib.unsort_values(out, qplan)),
                     np.asarray(lib.unsort_values(cnt[:, None], qplan))[:, 0]))
    return outs


@pytest.mark.parametrize("exclude_self", [True, False])
def test_fused_cconv_matches_jax_interpret(rng, exclude_self):
    pts_q = _points(rng, 120)
    pts_q[7] = pts_q[3]  # a coincident twin: excluded by position
    pts_c = _points(rng, 90) if not exclude_self else pts_q
    cin, cout = 5, 7
    feats = rng.normal(size=(len(pts_c), cin)).astype(np.float32)
    w = rng.normal(size=(4, 4, 4, cin, cout)).astype(np.float32) * 0.1
    (ot, ct), (oj, cj) = _run_both(pts_q, pts_c, feats, w, exclude_self)
    np.testing.assert_array_equal(ct, cj)  # in-radius counts: exact
    assert ct.max() > 5
    # f32 sums over taps and pairs in another order
    np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=2e-6)


def test_fused_cconv_preconditions_raise(rng):
    pts = torch.from_numpy(_points(rng, 50))
    w = torch.zeros(4, 4, 4, 3, 2)
    qplan = tfc.build_plan(pts, LOWER, UPPER, RADIUS)
    cand_only = tfc.build_plan(pts, LOWER, UPPER, RADIUS, with_groups=False)
    qpos_s = tfc.sort_values(pts, qplan, qplan.slab_cap, 1e9)
    feats = torch.zeros(len(pts) + qplan.slab_cap, 3)
    with pytest.raises(ValueError, match="no groups"):
        tfc.fused_cconv(w, cand_only, qpos_s, qplan, qpos_s, feats, RADIUS,
                        True)
    with pytest.raises(ValueError, match="cell_size"):
        tfc.fused_cconv(w, qplan, qpos_s, qplan, qpos_s, feats, RADIUS * 1.1,
                        True)
    other = tfc.build_plan(pts, LOWER, UPPER, RADIUS * 2, with_groups=False)
    with pytest.raises(ValueError, match="grid dims"):
        tfc.fused_cconv(w, qplan, qpos_s, other, other.pos_s, feats, RADIUS,
                        False)


def _list_reference(pts_q, pts_c, feats, w, ct, exclude_self, apply):
    """The JAX package's conv over every in-radius pair (its brute-force
    list, its geometry) with `apply` for the contractions: (out, dW, the
    gradients with respect to the query and candidate positions (one array
    when exclude_self: the fused conv's dq + dc), dfeats), the gradients
    those of sum(out * ct)."""
    k = 64
    nb = jns.radius_search_brute(jnp.asarray(pts_q), jnp.asarray(pts_c),
                                 RADIUS, k, exclude_self=exclude_self)
    assert int(np.asarray(nb.count).max()) < k

    def conv(w_, feats_, q_, c_):
        corner, tapw = jcc.cconv_geometry(c_, q_, nb, 2.0 * RADIUS)
        return apply(w_, corner, tapw, feats_, nb)

    if exclude_self:
        def f(w_, feats_, p_):
            return conv(w_, feats_, p_, p_)
        args = (w, feats, pts_q)
    else:
        f = conv
        args = (w, feats, pts_q, pts_c)
    args = tuple(map(jnp.asarray, args))
    out = f(*args)
    dw, dfeats, *dpos = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(ct)),
                                 argnums=tuple(range(len(args))))(*args)
    return (out, dw, *dpos, dfeats)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_fused_cconv_plain_default_matches_the_bf16_oracle(rng,
                                                           exclude_self):
    """The plain K1 and K2 at precision 'default' against the oracle of
    tests/torch_bf16_oracle.py (the JAX package's geometry over every
    in-radius pair, both einsums at the TPU's `DEFAULT`, float64 after the
    rounding): out, dW, the position gradients (dq and dc; their sum when
    queries and candidates are one set) and dfeats, each at least MARGIN
    times closer to the oracle than to JAX's 'highest' result by mean
    absolute deviation; 'high' is bitwise 'highest'."""
    from torch_bf16_oracle import assert_bf16_oracle, continuous_conv_default

    pts_q = _points(rng, 120)
    pts_c = _points(rng, 90) if not exclude_self else pts_q
    cin, cout = 5, 7
    feats = rng.normal(size=(len(pts_c), cin)).astype(np.float32)
    w = rng.normal(size=(4, 4, 4, cin, cout)).astype(np.float32) * 0.1
    ct = rng.normal(size=(len(pts_q), cout)).astype(np.float32)
    oracle = _list_reference(pts_q, pts_c, feats, w, ct, exclude_self,
                             continuous_conv_default)
    highest = _list_reference(pts_q, pts_c, feats, w, ct, exclude_self,
                              jcc.continuous_conv_apply)

    qplan = tfc.build_plan(torch.from_numpy(pts_q), LOWER, UPPER, RADIUS)
    cplan = qplan if exclude_self else tfc.build_plan(
        torch.from_numpy(pts_c), LOWER, UPPER, RADIUS, with_groups=False)
    qpos_s = tfc.sort_values(torch.from_numpy(pts_q), qplan, qplan.slab_cap,
                             tfc.SENTINEL)
    cpos_s = qpos_s if exclude_self else cplan.pos_s
    feats_s = tfc.sort_values(torch.from_numpy(feats), cplan, cplan.slab_cap)
    ct_s = tfc.sort_values(torch.from_numpy(ct), qplan)
    args = (torch.from_numpy(w), qplan, qpos_s, cplan, cpos_s, feats_s)
    got = {}
    for prec in ("default", "high", "highest"):
        out, _ = tfc.fused_cconv_plain(*args, RADIUS, exclude_self, prec)
        dw, dq, dc, df = tfc.fused_cconv_bwd_plain(
            *args, ct_s, RADIUS, exclude_self, (True,) * 4, prec)
        dq, dc = tfc.unsort_values(dq, qplan), tfc.unsort_values(dc, cplan)
        pos = (dq + dc,) if exclude_self else (dq, dc)
        got[prec] = (tfc.unsort_values(out, qplan), dw) + pos + (
            tfc.unsort_values(df, cplan),)
    names = ("out", "dW") + (("dpos",) if exclude_self else ("dq", "dc")) \
        + ("dfeats",)
    for name, g, o, h in zip(names, got["default"], oracle, highest):
        assert_bf16_oracle(name, g.numpy(), o, h)
    for g, h in zip(got["high"], got["highest"]):
        assert torch.equal(g, h)


def test_fused_cconv_precision_unknown_raises(rng):
    pts = torch.from_numpy(_points(rng, 50))
    qplan = tfc.build_plan(pts, LOWER, UPPER, RADIUS)
    qpos_s = tfc.sort_values(pts, qplan, qplan.slab_cap, 1e9)
    feats = torch.zeros(len(pts) + qplan.slab_cap, 3)
    with pytest.raises(ValueError, match="conv precision 'bf16'"):
        tfc.fused_cconv(torch.zeros(4, 4, 4, 3, 2), qplan, qpos_s, qplan,
                        qpos_s, feats, RADIUS, True, "bf16")
