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


# ---- K1d and K2d: the bf16 walks' order of sums, emulated on the CPU

KERNEL_TOL = 2.0 ** -8  # chip_smoke.py's bound on K1d and K2d


def _bf(x):
    """bf16-rounded (ties to even), as float64."""
    return tfc.bf16_round(x.float()).double()


def _rz32(x):
    """float64 -> f32 rounded toward zero: the tensor core's accumulator."""
    f = x.float()
    over = f.double().abs() > x.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def _chain(a, b, k_step):
    """sum_k a[:, k] b[k] as a chain of k-steps from a zero accumulator:
    each k-step's bf16 products summed exactly, then a truncating add."""
    d = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], k_step):
        d = _rz32(d.double() + a[:, k0:k0 + k_step] @ b[k0:k0 + k_step])
    return d


def _walk_pairs(qplan, cplan, qpos_s, cpos_s, exclude_self):
    """Per query row: its in-radius candidates in the walk's order (the
    group's 9 slabs as one sequence), their place in that sequence and
    their offsets over r, the in-radius test in the kernels' order of
    operations."""
    start, length = tfc.slab_ranges(qplan, cplan)
    inv_r = float(np.float32(1.0 / RADIUS))
    gstart = qplan.gstart.long()
    out = {}
    for g in range(qplan.n_groups):
        lo, hi = int(gstart[g]), int(gstart[g + 1])
        if lo >= hi:
            continue
        cand = torch.cat([torch.arange(int(s), int(s) + int(n)) for s, n in
                          zip(start[g], length[g])])
        for r in range(lo, hi):
            off = (cpos_s[cand] - qpos_s[r]) * np.float32(inv_r)
            d2n = off[:, 0] * off[:, 0] + off[:, 1] * off[:, 1] \
                + off[:, 2] * off[:, 2]
            within = d2n <= 1.0
            if exclude_self:
                within &= d2n > 0.0
            idx = torch.nonzero(within)[:, 0]
            out[r] = (cand[idx], idx, off[idx])
    return out


def emulate_k1d_rows(w, qplan, qpos_s, cplan, cpos_s, feats_s, exclude_self):
    """bf(acc) (Nq, n_taps * Cin) as K1d's walk sums it: per query and tile
    (BF16_TILE candidates), its in-radius pairs packed in k-steps of 16,
    each k-step's products (bf16 tap weight x bf16 feature, exact) added to
    the f32 accumulator through the tensor core's truncating add."""
    kz, ky, kx, cin, _ = w.shape
    n_taps = kz * ky * kx
    acc = torch.zeros((qplan.n, n_taps, cin), dtype=torch.float32)
    fb = _bf(feats_s)
    for r, (cand, place, off) in _walk_pairs(qplan, cplan, qpos_s, cpos_s,
                                             exclude_self).items():
        tile = place // tfc.BF16_TILE
        corner, cw = tcc.tap_weights(off, (kz, ky, kx))
        cw = _bf(cw)
        for t in tile.unique():
            sel = torch.nonzero(tile == t)[:, 0]
            for k0 in range(0, len(sel), 16):
                step = sel[k0:k0 + 16]
                part = torch.zeros((n_taps, cin), dtype=torch.float64)
                part.index_add_(0, corner[step].reshape(-1),
                                (cw[step][..., None]
                                 * fb[cand[step]][:, None]).reshape(-1, cin))
                acc[r] = _rz32(acc[r].double() + part)
    return _bf(acc.reshape(qplan.n, n_taps * cin))


def emulate_product(a, b, n_split=1, per=0):
    """The bf16 product of bf16 A (float64 values) and B: B rounded, per
    split of k chains of 32 (two k-steps of 16), each chain's sum added in
    f32; the splits summed in order."""
    b = _bf(b)
    k = a.shape[1]
    per = per if n_split > 1 else max(k, 1)
    out = None
    for s0 in range(0, max(k, 1), per):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
        for c0 in range(s0, min(k, s0 + per), 32):
            acc = acc + _chain(a[:, c0:c0 + 32], b[c0:c0 + 32], 16)
        out = acc if out is None else out + acc
    return out


def emulate_k1d(w, qplan, qpos_s, cplan, cpos_s, feats_s, exclude_self):
    """K1d's out: the walk's rows, then the fold: the bf16 product in the
    splits `product_splits` gives it where W does not fit shared memory;
    else the in-walk fold, k-steps of 16 dealt to the 8 warps in turn,
    each warp's chain through the tensor core, the warps' sums added in
    order."""
    kz, ky, kx, cin, cout = w.shape
    klen = kz * ky * kx * cin
    rows = emulate_k1d_rows(w, qplan, qpos_s, cplan, cpos_s, feats_s,
                            exclude_self)
    w2 = w.reshape(klen, cout)
    if not tfc.w_fits_shared(kz * ky * kx, cin, cout):
        chunk = min(tfc.scratch_chunk_rows(qplan.n, klen), qplan.n)
        return emulate_product(rows, w2, *tfc.product_splits(chunk, cout,
                                                             klen))
    wb = _bf(w2)
    out = torch.zeros((qplan.n, cout), dtype=torch.float32)
    for warp in range(8):
        steps = range(16 * warp, klen, 128)
        idx = torch.cat([torch.arange(k0, min(k0 + 16, klen))
                         for k0 in steps]) if steps else torch.zeros(0).long()
        out = out + _chain(rows[:, idx], wb[idx], 16)
    return out


def emulate_k2d(w, qplan, qpos_s, cplan, cpos_s, feats_s, ct, exclude_self):
    """K2d's (dW, dq, dc, dfeats) in its order of sums: d_acc = bf(ct)
    bf(W)^T (chains of 32 in the product, or of 16 in the walk where W fits
    shared memory), rounded to bf16 once; per pair the 8 tap cotangents as
    chains of 16 channels through the tensor core, then the geometry
    adjoint (its plain twin), dq summed per query in pair order; dfeats as
    f32 sums of bf(w) bf(d_acc); dW the walk's bf16 rows against ct in the
    bf16 product's splits of rows."""
    kz, ky, kx, cin, cout = w.shape
    n_taps, n = kz * ky * kx, qplan.n
    klen = n_taps * cin
    inv_r = float(np.float32(1.0 / RADIUS))
    w2 = w.reshape(klen, cout)
    local = tfc.w_fits_shared(n_taps, cin, cout)
    ctb = _bf(ct)
    if local:
        d_acc = _bf(_chain(ctb, _bf(w2.t().contiguous()), 16))
    else:
        d_acc = _bf(emulate_product(ctb, w2.t().contiguous()))
    d_acc = d_acc.reshape(n, n_taps, cin)
    fb = _bf(feats_s)
    dq = torch.zeros_like(qpos_s)
    dc = torch.zeros_like(cpos_s)
    df = torch.zeros_like(feats_s)
    cin16 = -(-cin // 16) * 16
    for r, (cand, _, off) in _walk_pairs(qplan, cplan, qpos_s, cpos_s,
                                         exclude_self).items():
        if not len(cand):
            continue
        corner, cw = tcc.tap_weights(off, (kz, ky, kx))
        d_pair = d_acc[r][corner]  # (P, 8, Cin)
        g8 = torch.stack([
            _chain(torch.nn.functional.pad(d_pair[p], (0, cin16 - cin)),
                   torch.nn.functional.pad(fb[cand[p]], (0, cin16 - cin))
                   [:, None], 16)[:, 0] for p in range(len(cand))])
        g_off = tcc.tap_weights_vjp(off, (kz, ky, kx), g8) * np.float32(inv_r)
        dq[r] -= g_off.sum(0)
        dc.index_add_(0, cand, g_off)
        df.index_add_(0, cand, (_bf(cw)[..., None] * d_pair).sum(1).float())
    chunk = min(tfc.scratch_chunk_rows(n, klen), n)
    n_split, per = tfc.dw_split(chunk, klen, cout)
    rows = emulate_k1d_rows(w, qplan, qpos_s, cplan, cpos_s, feats_s,
                            exclude_self)
    dw = None
    for lo in range(0, n, chunk):
        part = emulate_product(rows[lo:lo + chunk].t().contiguous(),
                               ct[lo:lo + chunk], n_split, per)
        dw = part if dw is None else dw + part
    return dw.reshape(w.shape), dq, dc, df


def _bf16_case(rng, case):
    """Points, features, filter and cotangent of one small layer."""
    cin, cout, exclude_self = {"cin4": (4, 32, True), "cin20": (20, 24, False),
                               "cout3": (64, 3, True),
                               "no_pair": (6, 40, False)}[case]
    pts_q = _points(rng, 120)
    pts_c = pts_q if exclude_self else _points(rng, 90)
    if case == "no_pair":
        # a cluster of queries whose cells' neighbours hold candidates, none
        # of them within the radius: its groups walk tiles and add nothing
        pts_c = _points(rng, 90, 0.3)
        pts_q[:20] = rng.uniform(0.45, 0.55, (20, 3)).astype(np.float32)
        pts_c[:4] = np.float32([[0.21, 0.21, 0.21], [0.22, 0.3, 0.21],
                                [0.21, 0.22, 0.29], [0.28, 0.24, 0.22]])
    feats = rng.normal(size=(len(pts_c), cin)).astype(np.float32)
    w = (rng.normal(size=(4, 4, 4, cin, cout)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(len(pts_q), cout)).astype(np.float32)
    return pts_q, pts_c, feats, w, ct, exclude_self


@pytest.mark.parametrize("case", ["cin4", "cin20", "cout3", "no_pair"])
def test_bf16_walk_order_meets_the_kernel_tolerance(rng, case):
    """K1d's and K2d's order of sums (the packed k-steps of the tap-feature
    contraction, the bf16 rows, the folds, the chains of the tap
    cotangents), emulated, against the oracle of tests/torch_bf16_oracle.py:
    every output within KERNEL_TOL (2^-8) of its largest entry and MARGIN
    times closer to it than to JAX's 'highest' result. The layers: Cin 4
    (the in-walk fold, exclude-self), Cin 20 (no multiple of 16; the
    product), Cout 3 (the in-walk fold of conv3), a cluster of queries with
    no pair in radius; every plan carries empty groups."""
    from torch_bf16_oracle import assert_bf16_oracle, continuous_conv_default

    pts_q, pts_c, feats, w, ct, exclude_self = _bf16_case(rng, case)
    oracle = _list_reference(pts_q, pts_c, feats, w, ct, exclude_self,
                             continuous_conv_default)
    highest = _list_reference(pts_q, pts_c, feats, w, ct, exclude_self,
                              jcc.continuous_conv_apply)
    qplan = tfc.build_plan(torch.from_numpy(pts_q), LOWER, UPPER, RADIUS)
    cplan = qplan if exclude_self else tfc.build_plan(
        torch.from_numpy(pts_c), LOWER, UPPER, RADIUS, with_groups=False)
    d0, d1, _ = qplan.dims
    assert bool((qplan.gcol == d0 * d1).any())  # an empty group
    qpos_s = tfc.sort_values(torch.from_numpy(pts_q), qplan, qplan.slab_cap,
                             tfc.SENTINEL)
    cpos_s = qpos_s if exclude_self else cplan.pos_s
    feats_s = tfc.sort_values(torch.from_numpy(feats), cplan, cplan.slab_cap)
    ct_s = tfc.sort_values(torch.from_numpy(ct), qplan)
    args = (torch.from_numpy(w), qplan, qpos_s, cplan, cpos_s, feats_s)
    out = emulate_k1d(*args, exclude_self)
    dw, dq, dc, df = emulate_k2d(*args, ct_s, exclude_self)
    dq, dc = tfc.unsort_values(dq, qplan), tfc.unsort_values(dc, cplan)
    got = [tfc.unsort_values(out, qplan), dw] + (
        [dq + dc] if exclude_self else [dq, dc]) + [
        tfc.unsort_values(df, cplan)]
    names = ["out", "dW"] + (["dpos"] if exclude_self else ["dq", "dc"]) \
        + ["dfeats"]
    if case == "no_pair":
        _, cnt = tfc.fused_cconv_plain(*args, RADIUS, exclude_self)
        cnt = tfc.unsort_values(cnt[:, None], qplan)[:, 0]
        assert not bool(cnt[:20].any()) and bool(cnt[20:].any())
        assert not bool(got[0][:20].any())
    for name, g, o, h in zip(names, got, oracle, highest):
        o = np.asarray(o, np.float64)
        np.testing.assert_allclose(g.numpy(), o, rtol=0,
                                   atol=KERNEL_TOL * np.abs(o).max(),
                                   err_msg=name)
        assert_bf16_oracle(name, g.numpy(), o, h)
