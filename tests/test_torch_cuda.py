"""The port's CUDA kernels (K1-K10) against their plain versions on the
card, at small shapes, and a gradcheck-style directional-derivative check
of each differentiable wrapper (CompositeWeights, FusedCConv,
BallFeatureSums, take_rows_planned) with its kernels on both sides, and a
unit of each entry point that must never wait for the card. These
need an NVIDIA GPU with nvcc: on a machine without one they skip. Run them
on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which that machine
need not have; this file imports none.)

TF32 is off, so the plain versions' matmuls run in full f32."""

import numpy as np
import pytest
import torch

from neurofluid_torch.ops import ball_features as bf
from neurofluid_torch.ops import composite as comp
from neurofluid_torch.ops import dense_layer as dl
from neurofluid_torch.ops import fused_cconv as fc
from neurofluid_torch.ops import fused_query as fq
from neurofluid_torch.ops import neighbor_search as ns
from neurofluid_torch.ops import ray_ops as tray
from neurofluid_torch.ops import segment_ops as so

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_composite_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    n, s = 37, 192
    sig = torch.tensor(rng.normal(size=(n, s)) * 5, dtype=torch.float32)
    sig[:, 50] = 1e6
    z = torch.sort(torch.tensor(rng.uniform(9, 13, (n, s)),
                                dtype=torch.float32), dim=-1).values
    dn = torch.ones(n)
    want = comp.composite_weights_plain(sig, z, dn)
    before = comp.KERNEL.launches
    got = comp.composite_weights(sig.to(dev), z.to(dev), dn.to(dev))
    assert comp.KERNEL.launches == before + 1
    # a shuffle scan vs a sequential product: f32 rounding
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-6)


# (96, 64), (64, 64) and (96, 20) take the tensor-core route (the filter
# does not fit shared memory; Cout 20 is no multiple of 8), the others fold
# in the walk; 300 queries are no multiple of the product's 64-row tile and
# 173 with 130 candidates leave ragged tiles on both sides
@pytest.mark.parametrize("exclude_self,cin,cout,n_q", [
    (True, 4, 32, 300), (True, 96, 64, 300), (False, 3, 32, 300),
    (True, 64, 64, 300), (True, 64, 3, 300), (False, 96, 20, 173)])
def test_fused_cconv_kernel_matches_plain(dev, exclude_self, cin, cout, n_q):
    outs = []
    for d in ("cpu", dev):
        w, qplan, qpos_s, cplan, cpos_s, fs, _ = _cconv_inputs(
            d, 1, exclude_self, cin, cout, twin=False, n_q=n_q)
        outs.append(fc.fused_cconv(w, qplan, qpos_s, cplan, cpos_s, fs, 0.25,
                                   exclude_self))
    (ow, cw), (og, cg) = outs
    np.testing.assert_array_equal(cg.cpu().numpy(), cw.numpy())
    # f32 sums over pairs and taps in another order
    np.testing.assert_allclose(og.cpu().numpy(), ow.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_ball_sums_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    lo, hi = (-0.7,) * 3, (0.7,) * 3
    pts = torch.tensor(rng.uniform(-0.35, 0.35, (600, 3)), dtype=torch.float32)
    qs = torch.tensor(rng.uniform(-0.65, 0.65, (500, 3)), dtype=torch.float32)
    want, ow = bf.ball_feature_sums(qs, pts, 0.225, 20, lo, hi,
                                    max_per_cell=64)
    before = bf.KERNEL.launches
    got, og = bf.ball_feature_sums(qs.to(dev), pts.to(dev), 0.225, 20, lo, hi,
                                   max_per_cell=64)
    assert bf.KERNEL.launches == before + 1
    assert bool(og) == bool(ow)
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got[:, :3], want.numpy()[:, :3])
    np.testing.assert_allclose(got[:, 3:], want.numpy()[:, 3:], rtol=1e-5,
                               atol=2e-6)


def _packed_walk_inputs(dev, pts, qs, radius, cap, t, max_groups=None):
    """The packed layout a staged walk (K3, K7) takes, built as the
    wrappers' callers build it: (q_rep, tx, ty, tz, ti, gcell, dims) on
    `dev`, every query kept."""
    lo, hi = (-1.05,) * 3, (1.05,) * 3
    pts, qs = pts.to(dev), qs.to(dev)
    grouping = bf.group_queries(qs, pts, radius, lo, hi, qs.shape[0], t,
                                max_groups)
    grid, tx, ty, tz = bf.build_tables(pts, lo, hi, radius, cap)
    q_pad = torch.cat([qs[grouping.order[:grouping.capacity]],
                       torch.full_like(qs[:1], bf.SENTINEL)])
    return (q_pad[grouping.rep_idx].contiguous(), tx, ty, tz,
            grid.table_idx.to(torch.int32), grouping.gcell, grid.dims)


def _walk_shape(q_rep, tx, gcell, dims, t):
    """(live slots, padded slots in live groups, dead groups, largest
    flattened candidate list of a live group, live groups whose 27 rows
    are all empty) of a packed layout."""
    live = (q_rep[:, 0] < 0.5 * bf.SENTINEL).reshape(-1, t).sum(1)
    in_cell = gcell.long() < dims[0] * dims[1] * dims[2]
    extent = (tx < 0.5 * bf.SENTINEL).sum(1)[bf.neighbor_rows(gcell, dims)]
    total = extent.sum(1)[in_cell]
    return (int(live.sum()), int((t - live)[in_cell].sum()),
            int((~in_cell).sum()), int(total.max()), int((total == 0).sum()))


# n points in a cube of half-width `spread` (cells of r = 0.225 filled
# near `cap`; spread None: eight clusters, so some live groups find no
# particle in their 27 rows), queries in a wider cube; `ring`: a stage of
# that many bytes per array set, so the two-stage ring runs with ragged
# batches
@pytest.mark.parametrize("cap,n_pts,spread,ring", [
    (128, 1000, 0.225, None),   # rows of 100-128: four 32-slot chunks
    (72, 700, 0.3, None),       # a cap that is no multiple of 32
    (256, 9000, 0.3375, None),  # 27 prefixes past the one-stage plan
    (40, 700, None, 12 * 61)])  # batches of 61 candidates
def test_ball_sums_staged_walk_matches_plain(dev, monkeypatch, cap, n_pts,
                                             spread, ring):
    """K3's staged walk against its plain version on the same packed
    inputs: the three count columns equal, the sums within 1e-5. The
    groups are partly padded and some are of the sentinel cell."""
    if ring is not None:
        monkeypatch.setattr(bf, "WHOLE_STAGE_BYTES", 0)
        monkeypatch.setattr(bf, "RING_STAGE_BYTES", ring)
    rng = np.random.default_rng(12)
    r, k, t = 0.225, 20, 32
    if spread is None:
        pts, spread = _cloud(rng, n_pts, 0.7), 0.8
    else:
        pts = torch.tensor(rng.uniform(-spread, spread, (n_pts, 3)),
                           dtype=torch.float32)
    qs = torch.tensor(rng.uniform(-spread - 0.2, spread + 0.2, (700, 3)),
                      dtype=torch.float32)
    q_rep, tx, ty, tz, _, gcell, dims = _packed_walk_inputs(dev, pts, qs, r,
                                                            cap, t)
    live, padded, dead, longest, empty = _walk_shape(q_rep, tx, gcell, dims,
                                                     t)
    assert live == 700 and padded > 0 and dead > 0
    assert empty > 0 or ring is None
    stage, n_stages = bf.walk_plan(cap, 3, t, bf.N_SUMS)
    if cap == 128:
        assert n_stages == 1 and int((tx < 5e8).sum(1).max()) > 96
    if cap == 256 or ring is not None:
        assert n_stages == 2 and longest > 2 * stage  # three batches or more
    args = (q_rep, tx, ty, tz, gcell, dims, r, k, t)
    before = bf.KERNEL.launches
    got = bf.ball_sums_cuda(*args)
    assert bf.KERNEL.launches == before + 1
    want = bf.ball_sums_plain(*args)
    assert float(want[:, 0].max()) > k  # truncation
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=1e-5, atol=2e-6)
    assert not got[(q_rep[:, 0] > 5e8).cpu().numpy()].any()  # padded: zeros


def _directional_check(fn, inputs, dirs, g_out, tol):
    """gradcheck-style, in f32 on the card: the derivative of <fn(x), g_out>
    along `dirs` (one step per input, None where the input is held) by
    central differences, against <grad, dirs> from the backward. Checked
    within `tol` of sqrt(sum_i ||grad_i * dir_i||^2), the typical size of
    that derivative for a direction of independent normal entries."""
    leaves = [x.detach().clone().requires_grad_(d is not None)
              for x, d in zip(inputs, dirs)]
    moved = [(x, d) for x, d in zip(leaves, dirs) if d is not None]
    grads = torch.autograd.grad((fn(*leaves) * g_out).sum(),
                                [x for x, _ in moved])
    pairs = [(g.double(), d.double()) for g, (_, d) in zip(grads, moved)]
    analytic = sum(float((g * d).sum()) for g, d in pairs)
    scale = sum(float(((g * d) ** 2).sum()) for g, d in pairs) ** 0.5

    def f(sign):
        with torch.no_grad():
            xs = [x if d is None else x + sign * d
                  for x, d in zip(inputs, dirs)]
            return float((fn(*xs).double() * g_out.double()).sum())

    numeric = (f(1.0) - f(-1.0)) / 2.0
    assert scale > 0
    assert abs(numeric - analytic) <= tol * scale, (numeric, analytic, scale)


def _cconv_inputs(d, rng_seed, exclude_self, cin, cout, twin=True, n_q=300,
                  far=False):
    """(weights, qplan, qpos_s, cplan, cpos_s, feats_s, ct) on device d,
    from one numpy seed; `twin`: query 7 sits on query 3; `far` (separate
    candidates): the first 40 queries sit in cells next to candidates'
    cells with none of them within the radius."""
    rng = np.random.default_rng(rng_seed)
    lo, hi, r = (-0.6,) * 3, (0.6,) * 3, 0.25
    q = torch.tensor(rng.uniform(-0.5, 0.5, (n_q, 3)), dtype=torch.float32)
    if twin:
        q[7] = q[3]
    n_c = 200 if n_q == 300 else 130
    c = q if exclude_self else torch.tensor(rng.uniform(-0.5, 0.5, (n_c, 3)),
                                            dtype=torch.float32)
    if far:
        q[:40] = torch.tensor(rng.uniform(0.47, 0.55, (40, 3)),
                              dtype=torch.float32)
        c = torch.tensor(rng.uniform(-0.5, 0.2, (n_c, 3)),
                         dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(4, 4, 4, cin, cout)) * 0.05,
                     dtype=torch.float32)
    feats = torch.tensor(rng.normal(size=(len(c), cin)), dtype=torch.float32)
    ct = torch.tensor(rng.normal(size=(len(q), cout)), dtype=torch.float32)
    qplan = fc.build_plan(q.to(d), lo, hi, r)
    cplan = qplan if exclude_self else fc.build_plan(c.to(d), lo, hi, r,
                                                     with_groups=False)
    qpos_s = fc.sort_values(q.to(d), qplan, qplan.slab_cap,
                            fc.SENTINEL).contiguous()
    cpos_s = qpos_s if exclude_self else cplan.pos_s.contiguous()
    fs = fc.sort_values(feats.to(d), cplan, cplan.slab_cap).contiguous()
    ct_s = fc.sort_values(ct.to(d), qplan).contiguous()
    return w.to(d), qplan, qpos_s, cplan, cpos_s, fs, ct_s


def test_composite_bwd_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    n, s = 37, 192
    sig = torch.tensor(rng.normal(size=(n, s)) * 5, dtype=torch.float32)
    sig[:, 50] = 1e6
    sig[0] = 0.0
    z = torch.sort(torch.tensor(rng.uniform(9, 13, (n, s)),
                                dtype=torch.float32), dim=-1).values
    z[1, 4] = z[1, 3]
    dn = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(n, s)), dtype=torch.float32)
    want = comp.composite_weights_bwd_plain(sig, z, dn, g)
    before = comp.BWD_KERNEL.launches
    got = comp.composite_weights_bwd_cuda(*(t.to(dev) for t in (sig, z, dn, g)))
    assert comp.BWD_KERNEL.launches == before + 1
    # a shuffle scan vs cumulative products and sums: f32 rounding,
    # relative to the largest entry
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert float(got[0].abs().max()) == 0.0  # relu'(0) = 0


@pytest.mark.parametrize("exclude_self,cin,cout,n_q", [
    (True, 4, 32, 300), (True, 96, 64, 300), (False, 3, 32, 300),
    (True, 64, 3, 300), (True, 64, 64, 300), (False, 96, 20, 173)])
def test_fused_cconv_bwd_kernel_matches_plain(dev, exclude_self, cin, cout,
                                              n_q):
    cpu = _cconv_inputs("cpu", 1, exclude_self, cin, cout, n_q=n_q)
    cud = _cconv_inputs(dev, 1, exclude_self, cin, cout, n_q=n_q)
    r = 0.25
    n, nc = cpu[1].n, cpu[3].n
    # every output, then the e2e step's form (filter and features only)
    for needs in ((True,) * 4, (True, False, False, True)):
        w, qp, qs, cp, cs, fs, ct = cpu
        want = fc.fused_cconv_bwd_plain(w, qp, qs, cp, cs, fs, ct, r,
                                        exclude_self, needs)
        w, qp, qs, cp, cs, fs, ct = cud
        before = fc.BWD_KERNEL.launches
        got = fc.fused_cconv_bwd_cuda(w, qp, qs, cp, cs, fs, ct, r,
                                      exclude_self, needs)
        assert fc.BWD_KERNEL.launches == before + 1
        for name, a, b in zip(("dW", "dq", "dc", "dfeats"), got, want):
            if b is None:
                assert a is None, name
                continue
            # f32 sums over pairs, taps and queries in another order (and
            # atomics for dc, dfeats), relative to the largest entry
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * float(b.abs().max()),
                                       err_msg=f"{name} {needs}")
        for name, t, rows in (("dq", got[1], n), ("dc", got[2], nc),
                              ("dfeats", got[3], nc)):
            if t is not None:  # sentinel and zero pad rows: exactly zero
                assert float(t[rows:].abs().max()) == 0.0, name


def test_fused_cconv_bwd_dw_is_bitwise_repeatable(dev):
    """dW is a tensor-core product over fixed splits of the rows, summed in
    order, and dq is summed in pair order by the block that owns the query:
    two runs agree bit for bit (dc and dfeats add with atomics and need
    not)."""
    w, qp, qs, cp, cs, fs, ct = _cconv_inputs(dev, 1, True, 96, 64)
    runs = [fc.fused_cconv_bwd_cuda(w, qp, qs, cp, cs, fs, ct, 0.25, True,
                                    (True,) * 4) for _ in range(3)]
    for other in runs[1:]:
        assert torch.equal(other[0], runs[0][0])
        assert torch.equal(other[1], runs[0][1])


def test_fused_cconv_scratch_chunks_match_plain(dev, monkeypatch):
    """The tensor-core route with the scratch limit cut to 128 rows: 300
    queries go through K1 and K2 in chunks of 128, 128 and 44 rows (the
    bench point's conv1 takes two chunks), and K2's dW sums the splits of
    all three."""
    cin, cout, r = 96, 64, 0.25
    monkeypatch.setattr(fc, "SCRATCH_LIMIT", 128 * 64 * cin * 4)
    assert fc.scratch_chunk_rows(300, 64 * cin) == 128
    cpu = _cconv_inputs("cpu", 1, True, cin, cout)
    w, qp, qs, cp, cs, fs, ct = _cconv_inputs(dev, 1, True, cin, cout)
    out, cnt = fc.fused_cconv_cuda(w, qp, qs, cp, cs, fs, r, True)
    want, want_cnt = fc.fused_cconv_plain(*cpu[:6], r, True)
    np.testing.assert_array_equal(cnt.cpu().numpy(), want_cnt.numpy())
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    got = fc.fused_cconv_bwd_cuda(w, qp, qs, cp, cs, fs, ct, r, True,
                                  (True,) * 4)
    ref = fc.fused_cconv_bwd_plain(*cpu, r, True, (True,) * 4)
    for name, a, b in zip(("dW", "dq", "dc", "dfeats"), got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()),
                                   err_msg=name)


# m, n, k, trans_a, splits, k per split, a's offset in floats: ragged in
# every dimension, the narrow (n <= 8) and the wide tiles, odd leading
# dimensions (no TMA for a: the kernel's cp.async path), K2's dW form (a
# stored transposed, the k range in splits summed in order); then the five
# bench products at reduced rows (conv1's fold in its two splits, conv2's
# fold, d_acc, dW of conv1 and conv3 in their splits), an `a` one float
# off 16 bytes (the cp.async path again), and the 128-wide N-tile of
# n >= 1,024 with an odd n (C stored by the threads, not TMA), unaligned,
# and transposed
@pytest.mark.parametrize("m,n,k,trans_a,n_split,k_per_split,offset", [
    (100, 7, 50, False, 1, 0, 0), (130, 70, 333, False, 1, 0, 0),
    (64, 64, 6144, False, 1, 0, 0), (300, 6144, 64, False, 1, 0, 0),
    (70, 3, 200, True, 3, 96, 0), (200, 64, 1000, True, 4, 256, 0),
    (257, 20, 129, True, 1, 0, 0),
    (300, 64, 6144, False, 2, 3072, 0), (520, 64, 4096, False, 1, 0, 0),
    (200, 6144, 64, False, 1, 0, 0), (6144, 64, 700, True, 2, 352, 0),
    (4096, 3, 900, True, 4, 256, 0),
    (130, 64, 256, False, 1, 0, 1), (256, 64, 300, True, 2, 160, 1),
    (130, 1030, 40, False, 1, 0, 1), (200, 1024, 300, True, 2, 160, 0)])
def test_split_gemm_matches_float64(dev, m, n, k, trans_a, n_split,
                                    k_per_split, offset):
    """The 3xTF32 tensor-core product against a float64 product of the same
    inputs: within 4e-7 of sum |a||b| (tests/test_torch_split_gemm.py holds
    the scheme's emulation to the same limit; one TF32 pass is ~1e-4), and
    bitwise the same when called again."""
    rng = np.random.default_rng(11)
    shape = (k, m) if trans_a else (m, k)
    buf = torch.empty(m * k + offset, dtype=torch.float32, device=dev)
    a = buf[offset:].view(shape)
    a.copy_(torch.tensor(rng.normal(size=shape), dtype=torch.float32))
    b = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32, device=dev)
    before = fc.GEMM_KERNEL.launches
    got = fc.split_gemm_cuda(a, b, trans_a, n_split, k_per_split)
    assert fc.GEMM_KERNEL.launches == before + 1
    a64 = (a.t() if trans_a else a).double()
    want = a64 @ b.double()
    scale = a64.abs() @ b.double().abs()
    assert float(((got.double() - want).abs() / scale).max()) <= 4e-7
    again = fc.split_gemm_cuda(a, b, trans_a, n_split, k_per_split)
    assert torch.equal(got, again)


def _dense_case(dev, m, k1, k2, n, dir_slice, seed=5):
    """Inputs of one K9 layer: a1 (m, k1) and a2 (m, k2) or None; with
    `dir_slice` a2 is the last k2 columns of (m, k1 + k2) rows, a view off
    16 bytes as the NeRF's direction input; weights at PyTorch's init scale,
    activations of a ReLU net's scale."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32,
                                device=dev)
    k_in = k1 + k2
    if dir_slice:
        x = t(m, 198 + k2).abs()
        a1, a2 = t(m, k1).abs(), x[:, 198:]
    else:
        a1, a2 = t(m, k1).abs(), (t(m, k2).abs() if k2 else None)
    w = t(n, k_in) / k_in ** 0.5
    b = t(n) * 0.1
    return a1, a2, w, b


def _max_err(got, want):
    return float((got.detach().double() - want).abs().max())


# the NeRF's wide layers at a warm-up chunk's rows (131,072): layer 1
# (198), a 256-wide layer, layer 5's skip [input_xyz | h], the ReLU-less
# `xyz_encoding_final` and `dir_encoding` [feat | x[:, 198:]] (N = 128);
# then ragged rows and widths of the small nets the tests build
DENSE_CASES = [(131072, 198, 0, 256, True, False),
               (131072, 256, 0, 256, True, False),
               (131072, 198, 256, 256, True, False),
               (131072, 256, 0, 256, False, False),
               (131072, 256, 54, 128, True, True),
               (1000, 63, 32, 32, True, False), (77, 32, 27, 16, True, True)]


@pytest.mark.parametrize("m,k1,k2,n,relu,dir_slice", DENSE_CASES)
def test_dense_layer_matches_float64(dev, m, k1, k2, n, relu, dir_slice):
    """K9's forward, dX, dW and db against float64 products of the same
    inputs: each within 4x cuBLAS f32's own error and under a tenth of a
    one-pass TF32 product's (nfbench/reference/precision.py's rounding)."""
    from nfbench.reference.precision import rounding

    tf32 = rounding("tf32")
    a1, a2, w, b = _dense_case(dev, m, k1, k2, n, dir_slice)
    x = a1 if a2 is None else torch.cat([a1, a2], 1)
    planes = dl.prepare([(w, k1)], want_dx=True)[0]
    np.testing.assert_array_equal(planes.fwd.cpu().numpy(),
                                  dl.fwd_planes_plain(w.cpu(), k1).numpy())
    np.testing.assert_array_equal(planes.dx.cpu().numpy(),
                                  dl.dx_planes_plain(w.cpu()).numpy())
    before = dl.gemm_launches()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    dl.dense_chain_cuda([(a1, a2, w, b, planes, relu, out)])
    assert dl.gemm_launches() == before + 1
    dy = torch.tensor(np.random.default_rng(6).normal(size=(m, n)),
                      dtype=torch.float32, device=dev)
    da1, da2, dw, db = dl.dense_layer_bwd_cuda(
        dy, a1, a2, w, out, planes, relu, (True, a2 is not None, True, True))
    assert dl.gemm_launches() == before + 3  # dX and dW

    x64, w64, b64 = x.double(), w.double(), b.double()
    pre64 = x64 @ w64.t() + b64
    want = pre64.clamp_min(0) if relu else pre64
    pre32 = x @ w.t() + b
    lib = pre32.clamp_min(0) if relu else pre32
    pre_tf = (tf32(x) @ tf32(w).t() + b).double()
    one_pass = pre_tf.clamp_min(0) if relu else pre_tf
    g64 = dy.double() * (out.detach() > 0) if relu else dy.double()
    g32 = g64.float()
    grads = [  # (name, got, float64, cuBLAS f32, one-pass TF32)
        ("out", out, want, lib, one_pass),
        ("dx", torch.cat([da1] + ([da2] if da2 is not None else []), 1),
         g64 @ w64, g32 @ w, (tf32(g32) @ tf32(w)).double()),
        ("dw", dw, g64.t() @ x64, g32.t() @ x,
         (tf32(g32).t() @ tf32(x)).double()),
        ("db", db, g64.sum(0), g32.sum(0), None)]
    for name, got, want_, lib_, tf_ in grads:
        err, err_lib = _max_err(got, want_), _max_err(lib_, want_)
        assert err <= 4.0 * err_lib, (name, err, err_lib)
        if tf_ is not None:
            assert err <= 0.1 * _max_err(tf_, want_), (name, err)


def test_dense_layer_dw_is_bitwise_repeatable(dev):
    a1, a2, w, b = _dense_case(dev, 65536, 198, 256, 256, False)
    planes = dl.prepare([(w, 198)], want_dx=True)[0]
    out = torch.empty((65536, 256), dtype=torch.float32, device=dev)
    dl.dense_chain_cuda([(a1, a2, w, b, planes, True, out)])
    dy = torch.ones((65536, 256), dtype=torch.float32, device=dev)
    grads = [dl.dense_layer_bwd_cuda(dy, a1, a2, w, out, planes, True,
                                     (False, False, True, True))[2:]
             for _ in range(2)]
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_nerf_runs_its_wide_layers_on_k9(dev, monkeypatch):
    """One f32 NeRF forward on the card: one prep launch, K9 ten times (in
    one chain from the host) and the library's products (`F.linear`) only
    for the sigma and rgb heads; its outputs and gradients match the same
    weights on the CPU's plain layers."""
    import torch.nn.functional as F

    from neurofluid_torch.models.nerf import NeRF

    gen = torch.Generator().manual_seed(4)
    cpu = NeRF(in_channels_xyz=198, in_channels_dir=54, device="cpu",
               generator=gen)
    card = NeRF(in_channels_xyz=198, in_channels_dir=54, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand((4096, 252), generator=gen)

    def counts():
        return [dl.PREP_KERNEL.launches, dl.gemm_launches(),
                dl.CHAIN_KERNEL.launches, dl.BWD_KERNEL.launches]
    linear, heads = F.linear, []
    monkeypatch.setattr(F, "linear", lambda a, w, b=None: heads.append(
        tuple(w.shape)) or linear(a, w, b))
    before = counts()
    with torch.no_grad():
        card(x.to(dev))
    torch.cuda.synchronize()
    monkeypatch.setattr(F, "linear", linear)
    # one prep, the 10 products in one chain from the host, no backward
    assert [a - b for a, b in zip(counts(), before)] == [1, 10, 1, 0]
    assert heads == [(1, 256), (3, 128)]

    outs = []
    for net, d_ in ((cpu, "cpu"), (card, dev)):
        xi = x.detach().to(d_).clone().requires_grad_(True)
        out = net(xi)
        out.square().sum().backward()
        outs.append([out.detach().cpu(), xi.grad.cpu()]
                    + [p.grad.cpu() for p in net.parameters()])
        net.zero_grad()
    # the output within f32 rounding of the CPU's; each gradient as a
    # whole, since a ReLU whose input lies within rounding of 0 may take
    # the other branch in one of the two f32-class products (on an H100
    # 319 of x's 1,032,192 gradient entries moved so, by up to 5e-4)
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(),
                               rtol=0, atol=2e-5)
    for want, got in zip(outs[0][1:], outs[1][1:]):
        assert float((got - want).norm()) <= 1e-3 * float(want.norm())


def test_nerf_preps_its_planes_every_forward(dev):
    """Each forward splits the weights it reads in one prep launch, so a
    weight written in place between two forwards (a `.data` write, an
    Adam step) is what the next one reads: it equals a fresh module with
    the same weights."""
    from neurofluid_torch.models.nerf import NeRF

    net = NeRF(in_channels_xyz=198, in_channels_dir=54, device=dev)
    x = torch.rand((3000, 252), device=dev)

    def fresh_out():
        other = NeRF(in_channels_xyz=198, in_channels_dir=54, device=dev)
        other.load_state_dict(net.state_dict())
        with torch.no_grad():
            return other(x)

    before = dl.PREP_KERNEL.launches
    with torch.no_grad():
        first = net(x)
        assert torch.equal(net(x), first)
        net.xyz_encoding_3[0].weight.data.mul_(1.5)
        changed = net(x)
    assert dl.PREP_KERNEL.launches == before + 3
    assert not torch.equal(changed, first)
    assert torch.equal(changed, fresh_out())
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    net(x).square().sum().backward()
    opt.step()
    with torch.no_grad():
        stepped = net(x)
    assert not torch.equal(stepped, changed)
    assert torch.equal(stepped, fresh_out())


# K10's cases: every encoding, none, and two mixes; the geometry at the
# render's magnitudes (samples up to 12 from the origin, densities up to
# 20), each source's rows strided as K3's sums give them
ENCODE_FLAGS = [(True,) * 4, (False,) * 4, (True, False, False, True),
                (False, True, True, False)]


def _encode_case(dev, flags, n_rays=300, samples=(64, 128), seed=0,
                 dtype=torch.float32):
    """(sources, rays, ro, Encoding) of K10 on `dev`, seeded; `flags`:
    density, var, smoothed_pos, smoothed_dir."""
    from neurofluid_torch.ops import encode as enc

    rng = np.random.default_rng(seed)
    encoding = enc.Encoding(10, 4, 4, flags[0], flags[2], flags[1], flags[3])
    sources = []
    for s in samples:
        n = n_rays * s
        xyz = rng.uniform(-12.0, 12.0, (n, 3))
        wide = np.zeros((n, 16))
        wide[:, 0:3], wide[:, 3] = xyz, rng.uniform(0.0, 20.0, n)
        wide[:, 5:8] = xyz + rng.normal(0.0, 0.05, (n, 3))
        wide[:, 9:12] = rng.uniform(0.0, 1e-2, (n, 3))
        w = torch.tensor(wide, dtype=dtype, device=dev)
        sources.append(enc.Geometry(w[:, 0:3], w[:, 3:4], w[:, 5:8],
                                    w[:, 9:12] if encoding.var else None))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro = np.asarray([0.3, -0.4, 11.0])
    rays = np.concatenate([np.tile(ro, (n_rays, 1)), d], 1)
    return (sources, torch.tensor(rays, dtype=dtype, device=dev),
            torch.tensor(ro, dtype=dtype, device=dev), encoding)


@pytest.mark.parametrize("n_sources", [1, 2])
@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("flags", ENCODE_FLAGS,
                         ids=lambda f: "".join(str(int(x)) for x in f))
def test_encode_kernel_matches_plain(dev, flags, sigma_only, n_sources):
    """K10's rows against the plain composition on the card: bitwise in
    every column but the smoothed direction's (the last 27 where it is
    encoded), where the norm's sum may run in another order: within
    2^-20."""
    from neurofluid_torch.ops import encode as enc

    sources, rays, ro, encoding = _encode_case(
        dev, flags, samples=(64, 128) if n_sources == 2 else (192,))
    want = enc.encode_features_plain(sources, rays, ro, encoding, sigma_only)
    before = enc.KERNEL.launches
    got = enc.encode_features(sources, rays, ro, encoding, sigma_only)
    torch.cuda.synchronize()
    assert enc.KERNEL.launches == before + 1
    assert got.shape == want.shape
    sd = 27 if encoding.smoothed_dir and not sigma_only else 0
    width = got.shape[1]
    assert torch.equal(got[:, :width - sd], want[:, :width - sd])
    if sd:
        assert float((got[:, -sd:] - want[:, -sd:]).abs().max()) <= 2.0 ** -20


@pytest.mark.parametrize("n_sources", [1, 2])
@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("flags", ENCODE_FLAGS,
                         ids=lambda f: "".join(str(int(x)) for x in f))
def test_encode_bwd_kernel_matches_float64(dev, flags, sigma_only,
                                           n_sources):
    """K10's backward against the plain VJP in float64 of the same inputs:
    each cotangent within 1e-6 of the sum of its terms' magnitudes; an
    input that is not encoded gets none."""
    from neurofluid_torch.ops import encode as enc

    samples = (64, 128) if n_sources == 2 else (192,)
    sources, rays, ro, encoding = _encode_case(dev, flags, samples=samples)
    g = torch.randn((rays.shape[0] * sum(samples),
                     encoding.width(sigma_only)), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    before = enc.BWD_KERNEL.launches
    got = enc.encode_features_bwd_cuda(sources, rays, ro, encoding,
                                       sigma_only, g)
    torch.cuda.synchronize()
    assert enc.BWD_KERNEL.launches == before + 1
    src64 = [enc.Geometry(*(None if t is None else t.double() for t in s))
             for s in sources]
    args = (src64, rays.double(), ro.double(), encoding, sigma_only,
            g.double())
    want = enc.encode_features_bwd_plain(*args)
    scale = enc.encode_features_bwd_plain(*args, absolute=True)
    for gs, ws, ss in zip(got, want, scale):
        for name, d, w, sc in zip(enc.Geometry._fields, gs, ws, ss):
            assert (d is None) == (w is None), name
            if w is not None:
                err = float(((d.double() - w).abs() / sc).max())
                assert err <= 1e-6, (name, err)


def test_render_encodes_on_k10(dev, monkeypatch):
    """A render forward on the card makes 2 K10 launches and no sin or cos
    kernel (the profiler's kernel names), its backward 2 more; against
    the same render with the plain composition in K10's place, the outputs
    and the particles' gradient agree (the smoothed direction's norm and
    K4's atomics aside: within 1e-5, and 1e-4 of the gradient's largest
    entry)."""
    from torch.profiler import ProfilerActivity, profile

    from neurofluid_torch.ops import encode as enc

    _, card, (p, ro, rays) = _small_render_case()
    p, ro, rays = p.to(dev), ro.to(dev), rays.to(dev)
    with torch.no_grad():
        card(p, ro, rays)  # builds the library outside the trace
    torch.cuda.synchronize()
    before = enc.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            card(p, ro, rays)
        torch.cuda.synchronize()
    assert enc.KERNEL.launches == before + 2
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("encode_fwd_kernel" in n for n in names) == 2
    assert not [n for n in names if "sin_kernel" in n or "cos_kernel" in n]

    outs = []
    for swap in (False, True):
        if swap:
            monkeypatch.setattr(enc, "encode_features_cuda",
                                enc.encode_features_plain)
        pt = p.detach().clone().requires_grad_(True)
        counts = (enc.KERNEL.launches, enc.BWD_KERNEL.launches)
        out = card(pt, ro, rays)
        (out["rgb0"].sum() + out["rgb1"].sum()).backward()
        torch.cuda.synchronize()
        assert (enc.KERNEL.launches - counts[0],
                enc.BWD_KERNEL.launches - counts[1]) == ((0, 0) if swap
                                                         else (2, 2))
        outs.append(({k: v.detach() for k, v in out.items()}, pt.grad))
    (got, g_got), (want, g_want) = outs
    for key in ("rgb0", "opacity0", "rgb1", "opacity1"):
        assert float((got[key] - want[key]).abs().max()) <= 1e-5, key
    top = float(g_want.abs().max())
    assert top > 0
    assert float((g_got - g_want).abs().max()) <= 1e-4 * top


# the bf16 instantiations (precision 'default') against the plain 'default'
# versions on the CPU: the two sum in another f32 order, so a sum on the edge
# of a bf16 rounding step (bf(acc), bf(d_acc)) can round one way in the
# kernel and the other in the plain version; each output is held within one
# bf16 unit (2^-8) of its largest entry, and its mean deviation from the
# plain 'default' result at least 10x below its deviation from the plain
# 'highest' one (so neither the f32 kernel nor an f32 fallback can pass)
BF16_UNIT = 2.0 ** -8


def _held_to_default(name, got, want_d, want_h):
    got, want_d, want_h = (x.double().cpu() for x in (got, want_d, want_h))
    np.testing.assert_allclose(got.numpy(), want_d.numpy(), rtol=0,
                               atol=BF16_UNIT * float(want_d.abs().max()),
                               err_msg=name)
    dev_d = float((got - want_d).abs().mean())
    dev_h = float((got - want_h).abs().mean())
    assert 10.0 * dev_d <= dev_h, (name, dev_d, dev_h)


# the bench layers' widths (Cin 4, 3 -> 32; 96, 64 -> 64; 64 -> 3), Cout
# 20 (no multiple of 8), Cin 20 (no multiple of 16 or 8: the bf16 walks'
# row copies one entry at a time) and Cin 5 (odd: their pair stores one
# entry at a time), and queries with no pair in radius (`far`); every plan
# carries empty groups
BF16_CASES = [(True, 4, 32, 300, False), (True, 96, 64, 300, False),
              (False, 3, 32, 300, False), (True, 64, 64, 300, False),
              (True, 64, 3, 300, False), (False, 96, 20, 173, False),
              (False, 20, 24, 173, False), (True, 5, 7, 300, False),
              (False, 6, 40, 300, True), (False, 96, 64, 300, True)]


@pytest.mark.parametrize("exclude_self,cin,cout,n_q,far", BF16_CASES)
def test_fused_cconv_bf16_kernel_matches_plain(dev, exclude_self, cin, cout,
                                               n_q, far):
    cpu = _cconv_inputs("cpu", 1, exclude_self, cin, cout, twin=False,
                        n_q=n_q, far=far)
    w, qp, qs, cp, cs, fs, _ = _cconv_inputs(dev, 1, exclude_self, cin, cout,
                                             twin=False, n_q=n_q, far=far)
    k1 = fc.BF16_KERNELS["K1"]
    before = (k1.launches, fc.KERNEL.launches)
    products = fc.product_launches("default")
    out, cnt = fc.fused_cconv_cuda(w, qp, qs, cp, cs, fs, 0.25, exclude_self,
                                   "default")
    assert (k1.launches, fc.KERNEL.launches) == (before[0] + 1, before[1])
    staged = fc.w_fits_shared(64, cin, cout)
    assert fc.product_launches("default") == products + (0 if staged else 1)
    want_d, want_cnt = fc.fused_cconv_plain(*cpu[:6], 0.25, exclude_self,
                                            "default")
    want_h, _ = fc.fused_cconv_plain(*cpu[:6], 0.25, exclude_self)
    np.testing.assert_array_equal(cnt.cpu().numpy(), want_cnt.numpy())
    if far:  # queries that walk tiles and find no pair
        far_rows = fc.unsort_values(want_cnt[:, None], cpu[1])[:40, 0]
        assert not bool(far_rows.any())
    _held_to_default("out", out, want_d, want_h)


@pytest.mark.parametrize("exclude_self,cin,cout,n_q,far", BF16_CASES)
def test_fused_cconv_bf16_bwd_kernel_matches_plain(dev, exclude_self, cin,
                                                   cout, n_q, far):
    cpu = _cconv_inputs("cpu", 1, exclude_self, cin, cout, n_q=n_q, far=far)
    cud = _cconv_inputs(dev, 1, exclude_self, cin, cout, n_q=n_q, far=far)
    k2 = fc.BF16_KERNELS["K2"]
    for needs in ((True,) * 4, (True, False, False, True)):
        want_d = fc.fused_cconv_bwd_plain(*cpu, 0.25, exclude_self, needs,
                                          "default")
        want_h = fc.fused_cconv_bwd_plain(*cpu, 0.25, exclude_self, needs)
        before = (k2.launches, fc.BWD_KERNEL.launches)
        got = fc.fused_cconv_bwd_cuda(*cud, 0.25, exclude_self, needs,
                                      "default")
        assert (k2.launches, fc.BWD_KERNEL.launches) == (before[0] + 1,
                                                         before[1])
        for name, a, b, h in zip(("dW", "dq", "dc", "dfeats"), got, want_d,
                                 want_h):
            if b is None:
                assert a is None, name
                continue
            _held_to_default(f"{name} {needs}", a, b, h)


@pytest.mark.parametrize("m,n,k,trans_a,n_split,k_per_split,offset", [
    (100, 7, 50, False, 1, 0, 0), (130, 70, 333, False, 1, 0, 0),
    (300, 6144, 64, False, 1, 0, 0), (70, 3, 200, True, 3, 96, 0),
    (257, 20, 129, True, 1, 0, 0), (300, 64, 6144, False, 2, 3072, 0),
    (6144, 64, 700, True, 2, 352, 0), (130, 64, 256, False, 1, 0, 1),
    (256, 64, 300, True, 2, 160, 1), (130, 1030, 40, False, 1, 0, 1),
    (200, 1024, 300, True, 2, 160, 0)])
def test_split_gemm_bf16_matches_float64(dev, m, n, k, trans_a, n_split,
                                         k_per_split, offset):
    """The bf16 product, A in bf16 as the walks write their rows (offset 1:
    A two bytes off 16, which TMA cannot take), against a float64 product
    of the bf16 inputs: the products of bf16 values are exact, so only the
    f32 sums differ (each chain of 32 k in the tensor core, then an f32
    add), within 4e-7 of sum |a||b| as the 3xTF32 mode, and against
    `split_gemm_plain` at 'default'; bitwise the same again."""
    rng = np.random.default_rng(12)
    shape = (k, m) if trans_a else (m, k)
    buf = torch.empty(m * k + offset, dtype=torch.bfloat16, device=dev)
    a = buf[offset:].view(shape)
    a.copy_(torch.tensor(rng.normal(size=shape), dtype=torch.float32))
    b = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32, device=dev)
    kern = fc.BF16_KERNELS["product"]
    before = (kern.launches, fc.GEMM_KERNEL.launches)
    products = fc.product_launches("default")
    got = fc.split_gemm_cuda(a, b, trans_a, n_split, k_per_split, "default")
    assert (kern.launches, fc.GEMM_KERNEL.launches) == (before[0] + 1,
                                                        before[1])
    assert fc.product_launches("default") == products + 1
    a64 = fc.bf16_round(a.t() if trans_a else a).double()
    b64 = fc.bf16_round(b).double()
    want = a64 @ b64
    scale = a64.abs() @ b64.abs()
    assert float(((got.double() - want).abs() / scale).max()) <= 4e-7
    plain = fc.split_gemm_plain(a, b, trans_a, "default").double()
    assert float(((got.double() - plain).abs() / scale).max()) <= 4e-7
    # and not the f32 product of the unrounded B
    exact = a64 @ b.double()
    assert float(((got.double() - exact).abs() / scale).max()) > 1e-4
    again = fc.split_gemm_cuda(a, b, trans_a, n_split, k_per_split,
                               "default")
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="dtype"):  # A in f32 at 'default'
        fc.split_gemm_cuda(a.float(), b, trans_a, n_split, k_per_split,
                           "default")


def test_ball_sums_bwd_kernel_matches_plain(dev):
    rng = np.random.default_rng(4)
    lo, hi = (-0.7,) * 3, (0.7,) * 3
    pts = torch.tensor(rng.uniform(-0.35, 0.35, (600, 3)), dtype=torch.float32)
    qs = torch.tensor(rng.uniform(-0.65, 0.65, (500, 3)), dtype=torch.float32)
    qs[:5] = pts[100:105]  # d == 0 pairs
    cot = torch.tensor(rng.normal(size=(500, bf.N_SUMS)), dtype=torch.float32)
    grads = []
    for d in ("cpu", dev):
        p = pts.to(d).requires_grad_(True)
        sums, _ = bf.ball_feature_sums(qs.to(d), p, 0.225, 20, lo, hi,
                                       max_per_cell=64)
        before = bf.BWD_KERNEL.launches
        g, = torch.autograd.grad((sums * cot.to(d)).sum(), p)
        grads.append(g.cpu().numpy())
    assert bf.BWD_KERNEL.launches == before + 1
    want, got = grads[0], grads[1]
    # <= 20 selected terms per query, summed over queries with atomics:
    # f32 rounding, relative to the largest entry
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 1.0


def _bwd_walk_inputs(dev, rng, cap, n_pts, spread, n_q=700):
    """K4's arguments on a packed layout (see _packed_walk_inputs): points
    in a cube of half-width `spread` or, spread None, in clusters (so some
    live groups find no particle in their 27 rows and some queries lie
    apart from every particle); queries in a wider cube; a normal
    cotangent, zero on padded slots and, on a third of the slots, zero in
    the columns 3-12 that carry gradient."""
    r, k, t = 0.225, 20, 32
    if spread is None:
        pts, spread = _cloud(rng, n_pts, 0.7), 0.8
    else:
        pts = torch.tensor(rng.uniform(-spread, spread, (n_pts, 3)),
                           dtype=torch.float32)
    qs = torch.tensor(rng.uniform(-spread - 0.2, spread + 0.2, (n_q, 3)),
                      dtype=torch.float32)
    q_rep, tx, ty, tz, ti, gcell, dims = _packed_walk_inputs(dev, pts, qs, r,
                                                             cap, t)
    cot = rng.normal(size=(q_rep.shape[0], bf.N_SUMS)).astype(np.float32)
    cot[(q_rep[:, 0] > 5e8).cpu().numpy()] = 0.0
    cot[rng.uniform(size=len(cot)) < 0.33, 3:] = 0.0
    cot = torch.from_numpy(cot).to(dev)
    return (q_rep, cot, tx, ty, tz, ti, gcell, dims, r, k, t, n_pts)


# ring: K4's ring stage in bytes of staged arrays (16 per candidate), so
# that the two-stage ring runs with ragged batches of 61 candidates
@pytest.mark.parametrize("cap,n_pts,spread,ring", [
    (128, 1000, 0.225, None),   # the bench cap, on K4's own ring
    (64, 700, 0.3, None),       # one stage: 27 rows and the accumulator
    (40, 700, None, 16 * 61)])  # batches of 61, empty live groups
def test_ball_sums_bwd_staged_walk_matches_plain(dev, monkeypatch, cap,
                                                 n_pts, spread, ring):
    """K4's staged walk against its plain version on the same packed
    inputs, d_points within 1e-5 of its largest entry (atomics in another
    order). The groups hold groups of the sentinel cell, padded slots, live
    slots whose cotangent is zero, and lists past k; with clusters, live
    groups whose 27 rows are empty and queries apart from every
    particle."""
    if ring is not None:
        monkeypatch.setattr(bf, "WHOLE_STAGE_BYTES", 0)
        monkeypatch.setattr(bf, "BWD_RING_STAGE_BYTES", ring)
    args = _bwd_walk_inputs(dev, np.random.default_rng(13), cap, n_pts,
                            spread)
    q_rep, cot, tx, ty, tz, ti, gcell, dims, r, k, t, n_pts = args
    live, padded, dead, longest, empty = _walk_shape(q_rep, tx, gcell, dims,
                                                     t)
    assert live == 700 and padded > 0 and dead > 0
    walked = (cot[:, 3:] != 0).any(1)
    live_slots = q_rep[:, 0] < 5e8
    assert int((live_slots & ~walked).sum()) > 0  # zero cotangents
    sums = bf.ball_sums_plain(q_rep, tx, ty, tz, gcell, dims, r, k, t)
    assert float(sums[:, 0].max()) > k
    if spread is None:
        assert empty > 0 and int(((sums[:, 0] == 0) & walked).sum()) > 0
    stage, n_stages = bf.bwd_walk_plan(cap, t)
    if ring is not None:
        assert n_stages == 2 and longest > 2 * stage
    before = bf.BWD_KERNEL.launches
    got = bf.ball_sums_bwd_cuda(*args)
    assert bf.BWD_KERNEL.launches == before + 1
    want = bf.ball_sums_bwd_plain(*args)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 1.0


def test_ball_sums_bwd_rerun_agrees(dev):
    """K4 twice on the same inputs, near the bench cap's fullness: the
    order of its atomics varies, the sums agree within 1e-5 of the largest
    entry."""
    args = _bwd_walk_inputs(dev, np.random.default_rng(14), 128, 1000,
                            0.225)
    first = bf.ball_sums_bwd_cuda(*args)
    second = bf.ball_sums_bwd_cuda(*args)
    scale = float(first.abs().max())
    assert scale > 1.0
    assert float((first - second).abs().max()) <= 1e-5 * scale


def _composite_bwd_inputs(rng, n, s):
    """Sigmas with negatives and zeros, a huge value (alpha == 1), a
    saturated ray, a repeated sample; one-sample rays take sigmas near
    1e-10 (their only delta is 1e10)."""
    sig = rng.normal(size=(n, s)).astype(np.float32) * (5 if s > 1 else 2e-10)
    sig[4:, s // 3] = 1e6
    sig[0] = 0.0
    sig[2, s // 4:] = 1e6
    z = np.sort(rng.uniform(9, 13, (n, s)).astype(np.float32), axis=-1)
    if s > 4:
        z[1, 4] = z[1, 3]
    dn = rng.uniform(0.5, 1.5, n).astype(np.float32)
    g = rng.normal(size=(n, s)).astype(np.float32)
    return [torch.from_numpy(a) for a in (sig, z, dn, g)]


@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 192, 256, 257, 2048])
def test_composite_bwd_kernel_every_ray_length(dev, s):
    """K6 against its plain version at every run length a lane can hold
    (1, 2, 6 and 8 samples, ragged lanes) and in tiles (257 and 2,048
    samples), within 1e-5 of the largest entry."""
    sig, z, dn, g = _composite_bwd_inputs(np.random.default_rng(s), 37, s)
    want = comp.composite_weights_bwd_plain(sig, z, dn, g)
    before = comp.BWD_KERNEL.launches
    got = comp.composite_weights_bwd_cuda(*(t.to(dev) for t in (sig, z, dn,
                                                                 g)))
    assert comp.BWD_KERNEL.launches == before + 1
    scale = float(want.abs().max())
    assert scale > 0.01
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("s", [64, 192, 256])
def test_composite_bwd_kernel_unaligned_rows(dev, s):
    """Rows that start 4 bytes past a 16-byte boundary take K6's word
    loads and stores: the same result as the plain version."""
    sig, z, dn, g = _composite_bwd_inputs(np.random.default_rng(8), 21, s)
    shifted = []
    for t in (sig, z, g):
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        shifted.append(view)
    assert shifted[0].data_ptr() % 16 == 4
    got = comp.composite_weights_bwd_cuda(shifted[0], shifted[1], dn.to(dev),
                                          shifted[2])
    want = comp.composite_weights_bwd_plain(sig, z, dn, g)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def _shifted(dev, tensors):
    """Copies of `tensors` on the card whose rows start 4 bytes past a
    16-byte boundary."""
    out = []
    for t in tensors:
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        out.append(view)
    assert out[0].data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 192, 257, 300])
def test_composite_kernel_every_ray_length(dev, s):
    """K5 against its plain version at every run length a lane can hold
    (1, 2, 6 and 8 samples, ragged lanes) and in tiles of 256 (257 and 300
    samples), with one ray of sigma <= 0 everywhere (no weight); then on
    rows 4 bytes off alignment (word loads and stores). Absolute, as
    chip_smoke.py holds K5: weights <= 1."""
    sig, z, dn, _ = _composite_bwd_inputs(np.random.default_rng(50 + s), 37,
                                          s)
    sig[3] = -sig[3].abs()
    want = comp.composite_weights_plain(sig, z, dn)
    assert float(want.max()) > 0.01 and float(want[3].abs().max()) == 0.0
    before = comp.KERNEL.launches
    got = comp.composite_weights_cuda(sig.to(dev), z.to(dev), dn.to(dev))
    assert comp.KERNEL.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    assert float(got[3].abs().max()) == 0.0
    sig_u, z_u = _shifted(dev, (sig, z))
    got_u = comp.composite_weights_cuda(sig_u, z_u, dn.to(dev))
    np.testing.assert_allclose(got_u.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


def test_composite_kernel_refuses_another_plan(dev):
    """The C side refuses samples per lane that are not the ray's."""
    sig, z, dn, _ = (t.to(dev) for t in _composite_bwd_inputs(
        np.random.default_rng(10), 5, 64))
    out = torch.empty_like(sig)
    with pytest.raises(RuntimeError):
        comp.KERNEL(sig.data_ptr(), z.data_ptr(), dn.data_ptr(),
                    out.data_ptr(), 5, 64, 4)


def test_composite_bwd_kernel_refuses_longer_rays(dev):
    """2,049 samples are refused, by the wrapper and by the C side."""
    sig, z, dn, g = (t.to(dev) for t in _composite_bwd_inputs(
        np.random.default_rng(9), 5, 2049))
    with pytest.raises(ValueError):
        comp.composite_weights_bwd_cuda(sig, z, dn, g)
    out = torch.empty_like(sig)
    with pytest.raises(RuntimeError):
        comp.BWD_KERNEL(sig.data_ptr(), z.data_ptr(), dn.data_ptr(),
                        g.data_ptr(), out.data_ptr(), 5, 2049, 8)
    with pytest.raises(RuntimeError):  # a plan that is not the ray's
        comp.BWD_KERNEL(sig.data_ptr(), z.data_ptr(), dn.data_ptr(),
                        g.data_ptr(), out.data_ptr(), 5, 64, 4)


def test_composite_weights_gradcheck(dev):
    """K5 forward, K6 backward. Sigmas keep 0.1 away from relu's kink."""
    rng = np.random.default_rng(5)
    n, s = 16, 64
    mag = rng.normal(size=(n, s)) * 3
    sig = torch.tensor(np.sign(mag) * (np.abs(mag) + 0.1), dtype=torch.float32)
    z = torch.sort(torch.tensor(rng.uniform(9, 13, (n, s)),
                                dtype=torch.float32), dim=-1).values
    dn = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32)
    u = torch.tensor(rng.normal(size=(n, s)) * 1e-2, dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(n, s)), dtype=torch.float32)
    z, dn = z.to(dev), dn.to(dev)
    _directional_check(lambda x: comp.composite_weights(x, z, dn),
                       [sig.to(dev)], [u.to(dev)], g.to(dev), tol=1e-2)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_fused_cconv_gradcheck(dev, exclude_self):
    """K1 forward, K2 backward, with respect to the filter, the features and
    the positions. With exclude_self one tensor is both query and candidate
    positions, so autograd adds dq and dc. Positions move by ~2e-5 (r =
    0.25), so few pairs cross a kink of the trilinear taps or of the
    ball -> cube map (the plain versions on the CPU land within 2e-5 of
    the scale); a wrong adjoint is off by O(1). No coincident twins:
    moving them apart would switch their pair on."""
    w, qplan, qpos_s, cplan, cpos_s, fs, ct = _cconv_inputs(
        dev, 2, exclude_self, 8, 16, twin=False)
    rng = np.random.default_rng(6)

    def step(t, eps, live):
        u = torch.tensor(rng.normal(size=tuple(t.shape)) * eps,
                         dtype=torch.float32, device=dev)
        u[live:] = 0.0  # sentinel and zero pad rows stay put
        return u

    n, nc = qplan.n, cplan.n
    dw = step(w, 1e-2, w.shape[0])
    df = step(fs, 1e-2, nc)
    dq = step(qpos_s, 2e-5, n)
    if exclude_self:
        def fn(w_, p_, f_):
            return fc.fused_cconv(w_, qplan, p_, qplan, p_, f_, 0.25, True)[0]
        inputs, dirs = [w, qpos_s, fs], [dw, dq, df]
    else:
        def fn(w_, q_, c_, f_):
            return fc.fused_cconv(w_, qplan, q_, cplan, c_, f_, 0.25,
                                  False)[0]
        inputs, dirs = [w, qpos_s, cpos_s, fs], [dw, dq, step(cpos_s, 2e-5,
                                                              nc), df]
    before = fc.BWD_KERNEL.launches
    _directional_check(fn, inputs, dirs, ct, tol=1e-2)
    assert fc.BWD_KERNEL.launches == before + 1


def test_ball_feature_sums_gradcheck(dev):
    """K3 forward, K4 backward, with respect to the particles. Fewer than K
    neighbours per query, and no particle within 1e-3 of a query's radius
    shell or of the query itself, so a 1e-5 move changes no selection and
    no count."""
    rng = np.random.default_rng(7)
    lo, hi, r = (-0.7,) * 3, (0.7,) * 3, 0.225
    pts = rng.uniform(-0.4, 0.4, (120, 3)).astype(np.float32)
    qs = rng.uniform(-0.55, 0.55, (2000, 3)).astype(np.float32)
    d = np.linalg.norm(qs[:, None] - pts[None], axis=-1)
    qs = qs[np.all((np.abs(d - r) > 1e-3) & (d > 1e-3), axis=1)][:400]
    cot = torch.tensor(rng.normal(size=(len(qs), bf.N_SUMS)),
                       dtype=torch.float32, device=dev)
    u = torch.tensor(rng.normal(size=pts.shape) * 1e-5, dtype=torch.float32,
                     device=dev)
    q_t = torch.from_numpy(qs).to(dev)

    def fn(p):
        sums, _ = bf.ball_feature_sums(q_t, p, r, 20, lo, hi,
                                       max_per_cell=64)
        return sums

    counts = fn(torch.from_numpy(pts).to(dev))[:, 0]
    assert 0 < float(counts.max()) < 20
    _directional_check(fn, [torch.from_numpy(pts).to(dev)], [u], cot,
                       tol=1e-2)


def _cloud(rng, n, spread):
    centers = rng.uniform(-spread, spread, (8, 3))
    pts = centers[rng.integers(0, 8, n)] + rng.normal(size=(n, 3)) * 0.08
    return torch.tensor(np.clip(pts, -1.0, 1.0), dtype=torch.float32)


@pytest.mark.parametrize("exclude_self,k,cap,emit_xyz,spread", [
    (True, 48, 32, False, 0.5), (False, 48, 32, True, 0.5),
    (True, 4, 128, True, 0.1), (True, 64, 40, False, 0.3)])
def test_ball_query_kernel_matches_plain(dev, exclude_self, k, cap, emit_xyz,
                                         spread):
    """K7 against its plain version: ids, counts, masks, coordinates and
    the flag all equal (integers and copies of table entries). k = 4 at cap
    128 truncates most lists; cap 40 is no multiple of the warp."""
    rng = np.random.default_rng(8)
    lo, hi, r = (-1.05,) * 3, (1.05,) * 3, 0.1125
    pts = _cloud(rng, 600, spread)
    qs = pts if exclude_self else _cloud(rng, 256, spread)
    qs = torch.cat([qs, torch.tensor([[50.0, 50.0, 50.0]])])
    res = []
    for d in ("cpu", dev):
        grid = ns.build_cell_grid(pts.to(d), lo, hi, r, cap)
        before = fq.KERNEL.launches
        res.append(fq.ball_query_compact(qs.to(d), grid, r, k,
                                         exclude_self=exclude_self,
                                         emit_xyz=emit_xyz))
    assert fq.KERNEL.launches == before + 1
    (want, ow), (got, og) = res
    assert bool(og) == bool(ow)
    assert int(want.count.max()) > 0
    for name in ("idx", "count", "mask"):
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name).numpy(), name)
    np.testing.assert_allclose(got.sq_dists.cpu().numpy(),
                               want.sq_dists.numpy(), rtol=0, atol=1e-7)
    if emit_xyz:
        for a, b in zip(got.xyz, want.xyz):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


# `max_groups`: groups allotted (most of them dead, of the sentinel cell),
# and queries apart from the particles, so that some live groups find no
# particle in their 27 rows; cap 160 takes the two-stage ring; `ring`
# shrinks its stage to ragged batches of 61 candidates; k 13 and 5 leave
# tails that start and end off 16-byte boundaries; every k truncates the
# fuller lists
@pytest.mark.parametrize("cap,k,emit_xyz,max_groups,ring", [
    (32, 16, False, 20_000, None), (160, 13, True, None, None),
    (40, 5, True, None, 16 * 61)])
def test_ball_query_staged_walk_matches_plain(dev, monkeypatch, cap, k,
                                              emit_xyz, max_groups, ring):
    """K7's staged walk against its plain version on the same packed
    inputs: ids, counts and coordinates equal."""
    if ring is not None:
        monkeypatch.setattr(bf, "WHOLE_STAGE_BYTES", 0)
        monkeypatch.setattr(bf, "RING_STAGE_BYTES", ring)
    rng = np.random.default_rng(13)
    r, t = 0.1125, fq.GROUP_SIZE
    n_pts, spread = (600, 0.5) if cap == 32 else (2700, 0.16875)
    pts = _cloud(rng, n_pts, spread) if cap == 32 else torch.tensor(
        rng.uniform(-spread, spread, (n_pts, 3)), dtype=torch.float32)
    apart = max_groups is not None
    qs = _cloud(rng, 256, spread) if apart else pts
    q_rep, tx, ty, tz, ti, gcell, dims = _packed_walk_inputs(
        dev, pts, qs, r, cap, t, max_groups)
    live, padded, dead, longest, empty = _walk_shape(q_rep, tx, gcell, dims,
                                                     t)
    assert live == qs.shape[0] and padded > 0 and dead > 0
    stage, n_stages = bf.walk_plan(cap, 4, t, 0)
    if apart:
        assert dead > 10 * (gcell.shape[0] - dead) and empty > 0
    else:
        assert n_stages == 2 and longest > stage
    args = (q_rep, tx, ty, tz, ti, gcell, dims, r, k, t, not apart,
            emit_xyz)
    before = fq.KERNEL.launches
    got = fq.ball_query_compact_cuda(*args)
    assert fq.KERNEL.launches == before + 1
    want = fq.ball_query_compact_plain(*args)
    assert int(want[1].max()) > k  # truncation
    assert len(got) == len(want)
    for name, a, b in zip(("idx", "count", "x", "y", "z"), got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), name)


@pytest.mark.parametrize("c", [1, 3, 4, 24, 32, 64, 96, 200])
def test_segment_sum_kernel_matches_plain(dev, c):
    """K8 against its plain version: trash ids, empty segments and one long
    segment; both lane layouts (c <= 32 and wider) and a width past one
    128-channel pass."""
    rng = np.random.default_rng(9)
    m, n = 20_000, 700
    idx = rng.integers(-1, n, size=(m,)).astype(np.int32)
    idx[idx == 5] = 6          # an empty segment
    idx[:3000] = 17            # a long one
    vals = torch.tensor(rng.normal(size=(m, c)), dtype=torch.float32)
    want = so.segment_sum_accumulate(vals, so.AdjointPlan(
        torch.from_numpy(idx), n))
    plan = so.AdjointPlan(torch.from_numpy(idx).to(dev), n)
    before = so.KERNEL.launches
    got = so.segment_sum_accumulate(vals.to(dev), plan)
    assert so.KERNEL.launches == before + 1
    assert float(got[5].abs().max()) == 0.0
    # f32 sums of up to 3,000 rows in another order, relative to the
    # largest entry
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    again = so.segment_sum_accumulate(vals.to(dev), plan)
    assert torch.equal(got, again)  # deterministic: no atomics


def test_take_rows_planned_gradcheck(dev):
    """A gather forward, K8 backward, with respect to the table. The gather
    is linear, so central differences are exact up to f32 rounding."""
    rng = np.random.default_rng(10)
    n, c, q, k = 300, 24, 200, 16
    table = torch.tensor(rng.normal(size=(n, c)), dtype=torch.float32)
    idx = rng.integers(0, n, size=(q, k)).astype(np.int32)
    idx[rng.uniform(size=idx.shape) < 0.25] = -1
    idx = torch.from_numpy(idx).to(dev)
    plan = so.AdjointPlan(idx, n)
    u = torch.tensor(rng.normal(size=(n, c)) * 1e-2, dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(q, k, c)), dtype=torch.float32)
    before = so.KERNEL.launches
    _directional_check(lambda t: so.take_rows_planned(t, idx, plan),
                       [table.to(dev)], [u.to(dev)], g.to(dev), tol=1e-2)
    assert so.KERNEL.launches == before + 1


def _tied_cloud(seed):
    """Points on a lattice of 1/16 (exact in f32), so that many candidate
    distances tie exactly, with queries on lattice points and between."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-8, 8, (600, 3)).astype(np.float32) / 16
    pts = np.unique(pts, axis=0)
    q = np.concatenate([pts[:100], pts[100:200] + 1 / 32]).astype(np.float32)
    return torch.from_numpy(pts), torch.from_numpy(q)


@pytest.mark.parametrize("search", ["grid", "brute"])
@pytest.mark.parametrize("order", ["nearest", "index"])
def test_plain_searches_on_the_card_match_the_cpu(dev, search, order):
    """radius_search_grid / radius_search_brute on the card against the
    same call on the CPU, on a lattice where distances tie exactly at the
    k-th slot: the stable selection keeps `lax.top_k`'s order on CUDA too,
    so ids, masks, counts and distances are equal."""
    pts, q = _tied_cloud(3)
    r, k = 0.2, 12

    def run(p, qq):
        if search == "brute":
            return ns.radius_search_brute(qq, p, r, k, order=order,
                                          exclude_self=True, query_chunk=64)
        grid = ns.build_cell_grid(p, (-0.6,) * 3, (0.6,) * 3, r, 64)
        return ns.radius_search_grid(qq, grid, r, k, order=order,
                                     exclude_self=True, query_chunk=64)[0]

    want, got = run(pts, q), run(pts.to(dev), q.to(dev))
    assert int(want.count.max()) > k  # the k-th slot cuts a tie
    for name in ("idx", "mask", "count", "sq_dists"):
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)


def test_ray_directions_default_to_the_card(dev):
    """get_ray_directions with no device builds on the card, the rays made
    from them stay there, and both agree with the CPU's within 1e-7 (CUDA
    divides by a scalar through its reciprocal: one ulp at these values)."""
    h, w, focal = 6, 10, 33.3
    c2w = torch.tensor([[0.0, 0.0, 1.0, 4.0], [1.0, 0.0, 0.0, -1.0],
                        [0.0, 1.0, 0.0, 2.0]])
    got = tray.get_ray_directions(h, w, focal)
    assert got.device.type == "cuda"
    bundle = tray.make_ray_bundle(got, c2w.to(dev))
    assert bundle.device.type == "cuda"
    want = tray.get_ray_directions(h, w, focal, device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(bundle.cpu().numpy(),
                               tray.make_ray_bundle(want, c2w).numpy(),
                               rtol=0, atol=1e-6)


def _tiny_warmup_cfg(root, expdir):
    from neurofluid_torch.data import synthetic
    from neurofluid_torch.utils.config import ConfigNode

    synthetic.generate_blender_scene(root, n_frames=3, n_side=4,
                                     img_wh=(24, 24), train_views=("view_1",),
                                     test_views=("view_5",))
    return ConfigNode(dict(
        expdir=expdir, expname="warmup", resume_from="", data_type="splishsplash",
        near=9.0, far=13.0,
        train=dict(start_index=0, end_index=3, path=root,
                   views=dict(warmup=["view_1"], dynamic=["view_1"])),
        test=dict(start_index=0, end_index=3, path=root, views=["view_5"]),
        TRAIN=dict(seed=10, N_iters=1, precrop_iters=0, save_interval=100,
                   log_interval=1, imgW=24, imgH=24, scale=1.0,
                   LR=dict(lr=5e-4, use_scheduler=True, decay_epochs=100)),
        TEST=dict(imgW=24, imgH=24, scale=1.0, start_index=0, end_index=3),
        RENDERER=dict(
            use_mask=True,
            ray=dict(ray_chunk=64, N_samples=16, N_importance=8,
                     eval_ray_chunk=100),
            NN_search=dict(particle_radius=0.025, search_radius_scale=9.0,
                           N_neighbor=6, mode="dense"),
            encoding=dict(density=True, var=True, smoothed_pos=True,
                          smoothed_dir=True, exclude_ray=True,
                          same_smooth_factor=False))))


def test_trainer_defaults_to_the_card_and_chunk_render_matches_plain(
        dev, tmp_path):
    """A trainer built with no device argument lives on the card and its
    step launches K3, K5 and K6 (not K4: the particles are constant, so no
    gradient reaches them); its chunked full-image render (576 rays in blocks
    of 100, the last padded) matches one render of the same weights on the
    CPU's plain versions: equal neighbour counts, colours within 1e-4."""
    from neurofluid_torch.models.render_net import RenderNet
    from neurofluid_torch.train.warmup import WarmupTrainer

    cfg = _tiny_warmup_cfg(str(tmp_path / "scene"), str(tmp_path / "exps"))
    tr = WarmupTrainer(cfg)
    assert tr.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in tr.model.parameters())
    kernels = (bf.KERNEL, comp.KERNEL, comp.BWD_KERNEL, bf.BWD_KERNEL)
    before = [k.launches for k in kernels]
    loss = tr.train()
    assert np.isfinite(loss)
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 2, 0]

    data = tr.test_dataset[0]
    ro = data["cw"][0][:, 3]
    out = tr.render_full(tr.to_device(data["particles_pos"]),
                         tr.to_device(ro), data["rays"][0])
    cpu = RenderNet(near=9.0, far=13.0, n_samples=16, n_importance=8,
                    num_neighbors=6, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in tr.model.state_dict().items()})
    with torch.no_grad():
        want = cpu(torch.from_numpy(data["particles_pos"]),
                   torch.from_numpy(ro), torch.from_numpy(data["rays"][0]))
    assert out["overflow"].shape == (6,) and not bool(out["overflow"].any())
    for key in ("num_nn_0", "mask_0"):
        np.testing.assert_array_equal(out[key].cpu().numpy(),
                                      want[key].numpy(), err_msg=key)
    for key in ("rgb0", "opacity0", "rgb1", "opacity1"):
        np.testing.assert_allclose(out[key].cpu().numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-4, err_msg=key)


# the renderer's options and list path at a small size: 400 particles,
# 8 rays, 16 + 16 samples, NeRF 4 x 32, sigma heads opaque
_SMALL_RENDER = dict(near=1.0, far=3.0, n_samples=16, n_importance=16,
                     nerf_depth=4, nerf_width=32,
                     grid_lower=(-0.5, -0.5, -0.5), grid_upper=(0.5, 0.5, 0.5),
                     grid_max_per_cell=48)


def _small_render_case(**kw):
    """(CPU renderer, its copy on the card, (particles, ro, rays) on the
    CPU) from one seed."""
    from neurofluid_torch.models.render_net import RenderNet

    rng = np.random.default_rng(10)
    particles = torch.tensor(rng.uniform(-0.3, 0.3, (400, 3)),
                             dtype=torch.float32)
    ro = torch.tensor([0.0, 0.05, 2.0])
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(8, 1)
    d[:, 0] += torch.linspace(-0.12, 0.12, 8)
    rays = torch.cat([ro.expand(8, 3), d / d.norm(dim=-1, keepdim=True)], 1)
    nets = [RenderNet(device=d_, generator=torch.Generator().manual_seed(3),
                      **_SMALL_RENDER, **kw) for d_ in ("cpu", "cuda")]
    with torch.no_grad():
        for net in nets:
            for nerf in (net.nerf_coarse, net.nerf_fine):
                nerf.sigma.bias.fill_(5.0)
    return nets[0], nets[1], (particles, ro, rays)


@pytest.mark.parametrize("backend", ["grid", "brute"])
def test_list_render_on_the_card_matches_the_cpu(dev, backend):
    """The list render launches K5 twice and no K3, and its backward into
    the particles K8 and K6 twice each; outputs and the particle gradient
    match the CPU's plain versions (coarse counts and masks equal, colours
    within 1e-4, the gradient within 1e-4 of its largest entry)."""
    cpu, card, (p, ro, rays) = _small_render_case(search_mode="list",
                                                  search_backend=backend)
    outs, grads = [], []
    for net, d_ in ((cpu, "cpu"), (card, dev)):
        pt = p.to(d_).detach().clone().requires_grad_(True)
        before = [k.launches for k in (bf.KERNEL, comp.KERNEL,
                                       comp.BWD_KERNEL, so.KERNEL)]
        out = net(pt, ro.to(d_), rays.to(d_))
        (out["rgb0"].sum() + out["rgb1"].sum()).backward()
        launched = [k.launches - b for k, b in zip(
            (bf.KERNEL, comp.KERNEL, comp.BWD_KERNEL, so.KERNEL), before)]
        assert launched == ([0, 0, 0, 0] if d_ == "cpu" else [0, 2, 2, 2])
        outs.append({k: v.detach().cpu() for k, v in out.items()})
        grads.append(pt.grad.cpu())
    want, got = outs
    for key in ("num_nn_0", "mask_0", "overflow"):
        assert torch.equal(got[key], want[key]), key
    for key in ("rgb0", "opacity0", "rgb1", "opacity1"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-4, err_msg=key)
    top = float(grads[0].abs().max())
    assert top > 0
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=0,
                               atol=1e-4 * top)


def test_bf16_render_on_the_card(dev):
    """bf16 products on the card against the CPU's bf16 (another bf16
    product): within one bf16 ulp at 1; and not the f32 render."""
    cpu, card, (p, ro, rays) = _small_render_case(
        compute_dtype=torch.bfloat16)
    _, f32, _ = _small_render_case()
    with torch.no_grad():
        want = cpu(p, ro, rays)
        got = card(p.to(dev), ro.to(dev), rays.to(dev))
        ref = f32(p.to(dev), ro.to(dev), rays.to(dev))
    assert got["rgb1"].dtype == torch.float32
    np.testing.assert_allclose(got["rgb1"].cpu().numpy(),
                               want["rgb1"].numpy(), rtol=0, atol=2.0 ** -8)
    assert float((got["rgb1"] - ref["rgb1"]).abs().max()) > 0.0


def test_random_and_partial_renders_on_the_card(dev):
    """A seeded perturb / noise_std render repeats bitwise from one CUDA
    generator's seed; coarse_rendering and fine_rendering launch K3 and K5
    once and twice each, with finite outputs."""
    _, card, (p, ro, rays) = _small_render_case()
    args = (p.to(dev), ro.to(dev), rays.to(dev))
    with torch.no_grad():
        a, b = (card(*args, generator=torch.Generator(device=dev).manual_seed(5),
                     perturb=1.0, noise_std=1.0) for _ in range(2))
        for key in a:
            assert torch.equal(a[key], b[key]), key
        for method, n in (("coarse_rendering", 1), ("fine_rendering", 2)):
            before = (bf.KERNEL.launches, comp.KERNEL.launches)
            out = getattr(card, method)(*args)
            assert (bf.KERNEL.launches - before[0],
                    comp.KERNEL.launches - before[1]) == (n, n)
            assert all(bool(torch.isfinite(v.float()).all())
                       for v in out.values())


def lpips_weights(path, seed=0):
    """Random VGG16 + LPIPS head weights in the documented `.npz` format:
    He-scaled convs, so the activations keep their scale through 13
    layers; non-negative heads, as trained ones are, in both documented
    shapes ((C,) and (1, C, 1, 1)). Returns the path as a string."""
    from neurofluid_torch.utils import lpips

    rng = np.random.default_rng(seed)
    arrays, cin, i = {}, 3, 0
    for item in lpips._VGG16_CFG:
        if item == "M":
            continue
        arrays[f"vgg_conv{i}_weight"] = (rng.normal(size=(item, cin, 3, 3))
                                         * np.sqrt(2.0 / (9 * cin))).astype(
                                             np.float32)
        arrays[f"vgg_conv{i}_bias"] = (rng.normal(size=(item,)) * 0.01
                                       ).astype(np.float32)
        cin, i = item, i + 1
    for k, c in enumerate(lpips._TAP_CHANNELS):
        shape = (1, c, 1, 1) if k % 2 else (c,)
        arrays[f"lin{k}_weight"] = rng.uniform(0, 0.1, shape).astype(
            np.float32)
    np.savez(path, **arrays)
    return str(path)


def test_chamfer_and_lpips_on_the_card(dev, tmp_path):
    """The chamfer distance and LPIPS on the card against the CPU (TF32
    off): chamfer within 1e-6, LPIPS within 1e-4 relative."""
    from neurofluid_torch.ops import chamfer
    from neurofluid_torch.utils import lpips

    rng = np.random.default_rng(2)
    x = torch.tensor(rng.uniform(-1, 1, (3000, 3)), dtype=torch.float32)
    y = x[:2000] + torch.tensor(rng.normal(size=(2000, 3)) * 0.02,
                                dtype=torch.float32)
    want = float(chamfer.chamfer_distance(x, y))
    got = float(chamfer.chamfer_distance(x.to(dev), y.to(dev)))
    assert abs(got - want) <= 1e-6
    path = lpips_weights(tmp_path / "w.npz")
    a = rng.uniform(size=(48, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    want = lpips.LPIPSEvaluator(path, device="cpu")(a, b)
    got = lpips.LPIPSEvaluator(path, device=dev)(a, b)
    assert want > 0 and abs(got - want) <= 1e-4 * want


def test_world_of_one_nccl_composed_step(dev, tmp_path):
    """The composed e2e step (`make_spmd_e2e_step`, the dry run's tiny
    models with (2, 2, 2) taps) in a world of one over NCCL on the card
    against the replicated step on the CPU from the same weights. The
    renderer's K3-K6 sum in another order than the plain versions, so the
    limits are chip_smoke.py's kernel-against-plain step limits (STEP_TOL):
    loss 1e-4 and the renderer's gradient norm 1e-3 relative, the
    transition's 1e-2 (it passes the encoded variance feature), next
    positions 1e-5."""
    import torch.distributed as dist

    from neurofluid_torch.parallel import dryrun
    from neurofluid_torch.parallel.mesh import init_world

    arrays = dryrun._tiny_problem(1)
    init_world(0, 1, f"file://{tmp_path / 'store'}", "cuda")
    try:
        assert dist.get_backend() == "nccl"
        got = dryrun.composed_stage(arrays, (1, 1), device="cuda")
    finally:
        dist.destroy_process_group()
    want = dryrun.replicated_e2e_steps(arrays, 1, kernel_size=(2, 2, 2))
    assert got["states_equal"] and not got["overflow"][0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm_r"], want["grad_norm_r"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["grad_norm_t"], want["grad_norm_t"],
                               rtol=1e-2)
    np.testing.assert_allclose(got["next_pos"].numpy(),
                               want["next_pos"].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("entry", ["transition", "e2e", "warmup", "frame"])
def test_model_units_never_wait_for_the_card(dev, entry):
    """After a warm-up unit, one more unit of each entry point runs under
    `set_sync_debug_mode('error')`: any call that blocks the host until
    the card drains its queue (a read of a device value, a copy from
    pageable host memory, `torch.nonzero`) raises. The NeRFs' K9 path,
    its prep and backward included, is on every entry but the transition
    step."""
    from test_torch_tracing import _run_entry

    run = _run_entry(entry, dev)
    run()
    torch.cuda.synchronize()
    k9 = dl.gemm_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the renderer's NeRFs run their wide layers on K9 (and its backward)
    assert (dl.gemm_launches() > k9) == (entry != "transition")
    leaves = [t for t in (out.values() if isinstance(out, dict) else out)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert leaves and all(bool(torch.isfinite(t).all()) for t in leaves)
