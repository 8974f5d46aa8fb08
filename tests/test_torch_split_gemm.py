"""The split-precision scheme of the port's tensor-core product
(`neurofluid_torch/csrc/split_gemm.cuh`) emulated on the CPU, and the plain
functions that route a fused-conv call: whether the filter fits a block's
shared memory, the walk's block shape, the chunking of the scratch rows and
the product's splits of k.

The kernel rounds each f32 operand to TF32 (10-bit mantissa, round to
nearest, ties away) as hi, the remainder to TF32 as lo, multiplies the three
pairs lo*hi, hi*lo, hi*hi per 8 terms of k on the tensor core and adds each
8-term sum into an f32 accumulator. The emulation does the same with the
8-term sums in float64 (the tensor core keeps them wider than f32). Limit:
8 units of f32's rounding, 2^-21, relative to sum |a||b|: the same limit
`chip_smoke.py` (GEMM_TOL) and `tests/test_torch_cuda.py` hold the kernel
to on the card. One TF32 pass (hi*hi alone) misses it 40-fold and more;
the three passes in the kernel's order (k in steps of 8) come out as good as
numpy's own f32 product."""

import numpy as np
import pytest
import torch

from neurofluid_torch.ops import fused_cconv as fc

LIMIT = 2.0 ** -21


def tf32_round(x):
    """f32 -> nearest TF32 (ties away from zero, as cvt.rna.tf32.f32)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def emulated_product(a, b, passes):
    """The kernel's sum: per 8 terms of k the chosen passes summed exactly,
    then an f32 add into the accumulator."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = {"lo_hi": (al, bh), "hi_lo": (ah, bl), "hi_hi": (ah, bh)}
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        part = np.zeros(acc.shape, np.float64)
        for name in passes:
            x, y = terms[name]
            part += x[:, k0:k0 + 8].astype(np.float64) @ \
                y[k0:k0 + 8].astype(np.float64)
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def rel_err(got, a, b):
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    return float((np.abs(got - want) / scale).max())


def test_tf32_round_keeps_ten_mantissa_bits():
    x = np.float32(1.0) + np.float32(2.0 ** -11) * np.arange(8, dtype=np.float32)
    r = tf32_round(x)
    assert np.all((r.view(np.uint32) & np.uint32(0x1FFF)) == 0)
    assert np.all(np.abs(r - x) <= 2.0 ** -11)
    hi, lo = split(x)
    assert np.all(np.abs(x - (hi + lo)) <= 2.0 ** -22)


# the three uses at the bench point: the fold over 64 * Cin = 6,144 and
# 4,096 terms, d_acc over Cout = 64; operands of the bench's scale (tap
# sums and cotangents of order one, filters of order 0.05)
@pytest.mark.parametrize("k", [6144, 4096, 64])
def test_three_pass_split_is_f32_class_and_one_pass_is_not(k):
    rng = np.random.default_rng(k)
    a = rng.normal(size=(48, k)).astype(np.float32)
    b = (rng.normal(size=(k, 40)) * 0.05).astype(np.float32)
    three = rel_err(emulated_product(a, b, ("lo_hi", "hi_lo", "hi_hi")), a, b)
    one = rel_err(emulated_product(a, b, ("hi_hi",)), a, b)
    f32 = rel_err(a @ b, a, b)
    assert three <= LIMIT, three
    assert three <= 4.0 * max(f32, 2.0 ** -24), (three, f32)
    assert one > 20.0 * LIMIT, one


def rz32(x):
    """float64 -> f32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def emulated_chains(a, b, span):
    """The `wgmma` kernel's sum: B split by the plain version of its prep
    (K-major hi / lo, N padded), A split in registers; per chain of `span`
    terms of k, from a zero accumulator, the small passes lo*hi and hi*lo of
    each k-step of 8, then the hi*hi of each, every 8-term product exact and
    carried through the tensor core's accumulator, which truncates (rounds
    toward zero to f32); each chain's sum then added to the f32 accumulator
    with a rounded add."""
    k, n = b.shape
    prep = fc.gemm_b_prep_plain(torch.from_numpy(b)).numpy()
    bh, bl = (prep[i, :n, :k].T.astype(np.float64) for i in (0, 1))
    ah, al = (x.astype(np.float64) for x in split(a))
    acc = np.zeros((a.shape[0], n), np.float32)
    for c0 in range(0, k, span):
        d = np.zeros(acc.shape, np.float32)
        steps = [slice(k0, k0 + 8) for k0 in range(c0, min(k, c0 + span), 8)]
        terms = [(s, x, y) for s in steps for x, y in ((al, bh), (ah, bl))]
        for s, x, y in terms + [(s, ah, bh) for s in steps]:
            d = rz32(d.astype(np.float64) + x[:, s] @ y[s])
        acc = (acc + d).astype(np.float32)
    return acc


# the span of k summed inside the tensor core before an f32 add: the
# kernel's 32 (one chain per k-tile) and the 8 of a chain per k-step, at
# K2's d_acc (k = Cout = 64), the folds (4,096, 6,144) and dW over a whole
# chunk (14,336)
@pytest.mark.parametrize("span", [8, 32])
@pytest.mark.parametrize("k", [64, 4096, 6144, 14336])
def test_chains_of_the_wgmma_kernel_meet_the_limit(span, k):
    rng = np.random.default_rng(k + span)
    a = rng.normal(size=(48, k)).astype(np.float32)
    b = (rng.normal(size=(k, 40)) * 0.05).astype(np.float32)
    assert rel_err(emulated_chains(a, b, span), a, b) <= LIMIT


def test_chains_through_the_whole_k_miss_the_limit():
    # what the chains are cut for: one sum carried through the tensor core
    # over all of k = 6,144 drifts far past f32's own error
    rng = np.random.default_rng(1)
    a = rng.normal(size=(48, 6144)).astype(np.float32)
    b = (rng.normal(size=(6144, 40)) * 0.05).astype(np.float32)
    assert rel_err(emulated_chains(a, b, 6144), a, b) > 2.0 * LIMIT


def test_tf32_round_matches_the_emulation_bitwise():
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.normal(size=1000).astype(np.float32),
        # ties: exactly half a TF32 unit above 1 and -1 round away from zero
        np.float32([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 0.0, -0.0, 3e-39])])
    got = fc.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  tf32_round(x).view(np.uint32))
    assert got[1000] == np.float32(1 + 2.0 ** -10)
    assert got[1001] == np.float32(-(1 + 2.0 ** -10))


@pytest.mark.parametrize("k,n", [(50, 3), (333, 70), (64, 20), (6144, 64),
                                 (64, 6144), (1, 9)])
def test_b_prep_plain_is_the_split_transposed_and_padded(k, n):
    rng = np.random.default_rng(k * n)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got = fc.gemm_b_prep_plain(torch.from_numpy(b)).numpy()
    bn = 8 if n <= 8 else 128 if n >= 1024 else 64
    n_pad, k_pad = -(-n // bn) * bn, -(-k // 32) * 32
    assert got.shape == (2, n_pad, k_pad)
    assert got.size == fc.gemm_b_floats(k, n)
    hi, lo = split(b)
    np.testing.assert_array_equal(got[0, :n, :k], hi.T)
    np.testing.assert_array_equal(got[1, :n, :k], lo.T)
    assert not got[:, n:].any() and not got[:, :, k:].any()


# (m, n, k) of the five bench products: the folds of conv1 (a 7,168-row
# scratch chunk) and conv2, d_acc, dW of conv1 and conv3; then odd shapes
@pytest.mark.parametrize("m,n,k", [(7168, 64, 6144), (14336, 64, 4096),
                                   (7168, 6144, 64), (6144, 64, 7168),
                                   (4096, 3, 14336), (100, 7, 50),
                                   (1, 1, 1), (257, 20, 129), (64, 64, 0)])
def test_product_splits_cover_k_in_whole_tiles(m, n, k):
    n_split, per = fc.product_splits(m, n, k)
    assert per % fc.K_TILE == 0 and 1 <= n_split <= 32
    assert (n_split - 1) * per < max(k, 1) <= n_split * per
    assert n_split == 1 or per >= 4 * fc.K_TILE


def test_product_splits_at_the_bench_point():
    # the counts that ran fastest on an H100 (tools/split_gemm_bench.py
    # --sweep): conv1's fold two splits (112 units of 132 SMs), conv2's fold
    # none, conv1's dW five (240 units: 48 tiles in one wave left 36 SMs
    # idle), conv2's and conv3's dW four
    assert fc.product_splits(7168, 64, 6144) == (2, 3072)  # folds
    assert fc.product_splits(14336, 64, 4096) == (1, 4096)
    assert fc.dw_split(7168, 6144, 64) == (5, 1440)
    assert fc.dw_split(14336, 4096, 64) == (4, 3584)
    assert fc.dw_split(14336, 4096, 3) == (4, 3584)
    assert fc.product_splits(7168, 6144, 64) == (1, 64)  # d_acc


@pytest.mark.parametrize("n_taps,cin,cout,fits", [
    (64, 4, 32, True), (64, 3, 32, True), (64, 64, 3, True),
    (64, 96, 64, False), (64, 64, 64, False), (8, 32, 64, True),
    (8, 33, 64, False)])
def test_filter_routing_follows_its_size(n_taps, cin, cout, fits):
    assert fc.w_fits_shared(n_taps, cin, cout) is fits
    assert fits == (n_taps * cin * cout * 4 <= fc.W_SHARED_LIMIT)


@pytest.mark.parametrize("cin,cout", [(4, 32), (3, 32), (96, 64), (64, 64),
                                      (64, 3), (200, 256), (1, 1)])
@pytest.mark.parametrize("backward", [False, True])
def test_walk_blocks_fit_shared_memory(cin, cout, backward):
    staged = fc.w_fits_shared(64, cin, cout)
    qb, threads = fc.walk_config(64, cin, cout, staged, backward)
    assert qb in (1, 2, 4, 8, 16) and threads % 32 == 0
    assert 160 <= threads <= 512 and (not staged or threads >= cout)
    need = fc.bwd_smem_bytes(qb, 64, cin, cout, staged) if backward \
        else fc.fwd_smem_bytes(qb, threads, 64, cin, cout, staged)
    assert need <= fc.SMEM_LIMIT
    if qb < 16:  # no larger block would hold more queries per SM
        big = fc.bwd_smem_bytes(2 * qb, 64, cin, cout, staged) if backward \
            else fc.fwd_smem_bytes(2 * qb, threads, 64, cin, cout, staged)
        held = qb * (fc.SMEM_PER_SM // (need + 1024))
        assert big > fc.SMEM_LIMIT or \
            2 * qb * (fc.SMEM_PER_SM // (big + 1024)) <= held


def test_walk_config_at_the_bench_layers():
    # conv0 holds a whole group per block; conv1's 24 KB accumulators leave
    # 8 queries forward and, beside d_acc's ring, 2 backward
    assert fc.walk_config(64, 4, 32, True) == (16, 256)
    assert fc.walk_config(64, 96, 64, False) == (8, 256)
    assert fc.walk_config(64, 96, 64, False, backward=True) == (2, 256)
    assert fc.walk_config(64, 64, 64, False) == (4, 256)
    with pytest.raises(ValueError):
        fc.walk_config(64, 2000, 8, False)


@pytest.mark.parametrize("n,klen", [(14336, 6144), (14336, 4096), (300, 6144),
                                    (1, 256), (100_000, 6144), (65, 64)])
def test_scratch_chunks_are_bounded_row_tiles(n, klen):
    rows = fc.scratch_chunk_rows(n, klen)
    assert rows % fc.ROW_TILE == 0 and rows >= fc.ROW_TILE
    assert rows * klen * 4 <= fc.SCRATCH_LIMIT or rows == fc.ROW_TILE
    n_chunks = -(-n // rows)
    assert (n_chunks - 1) * rows < n <= n_chunks * rows
    # no chunking beyond what the limit asks for
    assert n_chunks == max(1, -(-n * klen * 4 // fc.SCRATCH_LIMIT)) or \
        n_chunks == -(-n * klen * 4 // fc.SCRATCH_LIMIT) + 1


@pytest.mark.parametrize("n,klen,cout", [(7168, 6144, 64), (14336, 4096, 3),
                                         (14336, 256, 32), (300, 6144, 64),
                                         (33, 512, 20)])
def test_dw_splits_cover_a_chunk_in_multiples_of_32(n, klen, cout):
    n_split, rows = fc.dw_split(n, klen, cout)
    assert rows % 32 == 0 and n_split >= 1
    assert (n_split - 1) * rows < n <= n_split * rows


def test_split_gemm_plain_and_its_argument_checks():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=(5, 7)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(7, 3)), dtype=torch.float32)
    np.testing.assert_allclose(fc.split_gemm_plain(a, b).numpy(),
                               a.numpy() @ b.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        fc.split_gemm_plain(a.t().contiguous(), b, trans_a=True).numpy(),
        a.numpy() @ b.numpy(), rtol=1e-6)
    with pytest.raises(ValueError):  # a CPU tensor never reaches the kernel
        fc.split_gemm_cuda(a, b)


# ---- the bf16 mode (precision 'default')

def bf16_round(x):
    """f32 -> nearest bf16 (ties to even, as cvt.rn.bf16.f32), as f32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = bits + 0x7FFF + ((bits >> 16) & 1)
    return (bits & 0xFFFF0000).astype(np.uint32).view(np.float32)


def emulated_bf16_chains(a, b, span=32):
    """The bf16 mode's sum: both operands rounded to bf16 (B by the plain
    version of its prep), every product exact; per chain of `span` terms of
    k, from a zero accumulator, the k-steps of 16 carried through the
    tensor core's truncating accumulator, then the chain's sum added to the
    f32 accumulator with a rounded add."""
    k, n = b.shape
    prep = fc.gemm_b_prep_plain(torch.from_numpy(b), "default")
    bt = prep.float().numpy()[:n, :k].T.astype(np.float64)
    ar = bf16_round(a).astype(np.float64)
    acc = np.zeros((a.shape[0], n), np.float32)
    for c0 in range(0, k, span):
        d = np.zeros(acc.shape, np.float32)
        for k0 in range(c0, min(k, c0 + span), 16):
            s = slice(k0, k0 + 16)
            d = rz32(d.astype(np.float64) + ar[:, s] @ bt[s])
        acc = (acc + d).astype(np.float32)
    return acc


def test_bf16_round_matches_torch_and_the_helper():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.normal(size=1000).astype(np.float32),
        # ties: half a bf16 unit above 1 rounds to even (down), above the
        # next value up
        np.float32([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8), 0.0,
                    3e-39])])
    want = bf16_round(x)
    assert want[1000] == np.float32(1.0)
    assert want[1001] == np.float32(1 + 2.0 ** -6)
    got = fc.bf16_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("k", [64, 4096, 6144, 14336])
def test_bf16_chains_meet_the_limit_against_the_rounded_inputs(k):
    """Against a float64 product of the bf16-rounded inputs the bf16 mode
    errs only in its f32 sums: chains of 32 k within the 3xTF32 mode's
    limit at K2's d_acc, the folds and dW; the product of the unrounded
    inputs is ~1e-3 away (one bf16 rounding, 2^-9 relative)."""
    rng = np.random.default_rng(k + 7)
    a = rng.normal(size=(48, k)).astype(np.float32)
    b = (rng.normal(size=(k, 40)) * 0.05).astype(np.float32)
    got = emulated_bf16_chains(a, b)
    ar, br = bf16_round(a), bf16_round(b)
    assert rel_err(got, ar, br) <= LIMIT
    assert rel_err(got, a, b) > 100 * LIMIT


@pytest.mark.parametrize("k,n", [(50, 3), (333, 70), (6144, 64), (64, 6144),
                                 (1, 9)])
def test_bf16_b_prep_plain_is_b_rounded_transposed_and_padded(k, n):
    rng = np.random.default_rng(k * n + 1)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got = fc.gemm_b_prep_plain(torch.from_numpy(b), "default")
    bn = 8 if n <= 8 else 128 if n >= 1024 else 64
    n_pad, k_pad = -(-n // bn) * bn, -(-k // 32) * 32
    assert got.dtype == torch.bfloat16 and got.shape == (n_pad, k_pad)
    # bf16 scratch: two entries a float
    assert got.numel() == 2 * fc.gemm_b_floats(k, n, bf16=True)
    got = got.float().numpy()
    np.testing.assert_array_equal(got[:n, :k], bf16_round(b).T)
    assert not got[n:].any() and not got[:, k:].any()


def test_split_gemm_plain_default_is_the_product_of_the_rounded_operands():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(30, 200)).astype(np.float32)
    b = rng.normal(size=(200, 9)).astype(np.float32)
    want = bf16_round(a).astype(np.float64) @ bf16_round(b).astype(np.float64)
    for trans_a, a_in in ((False, a), (True, np.ascontiguousarray(a.T))):
        got = fc.split_gemm_plain(torch.from_numpy(a_in), torch.from_numpy(b),
                                  trans_a=trans_a, precision="default")
        assert rel_err(got.numpy(), bf16_round(a), bf16_round(b)) <= LIMIT
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    high = fc.split_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                               precision="high")
    assert torch.equal(high, torch.from_numpy(a) @ torch.from_numpy(b))
    with pytest.raises(ValueError, match="conv precision"):
        fc.split_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                            precision="tf32")


# ---- the bf16 walks of K1d and K2d: launch plan, shared memory, scratch

@pytest.mark.parametrize("cin,nt", [(1, 1), (4, 1), (8, 1), (9, 2), (16, 2),
                                    (20, 4), (32, 4), (33, 8), (64, 8),
                                    (65, 12), (96, 12), (97, 16), (128, 16)])
def test_bf16_ntiles_cover_the_channels(cin, nt):
    assert fc.bf16_ntiles(cin) == nt
    assert fc.bf16_feat_width(cin) >= max(8 * nt, -(-cin // 16) * 16)
    assert fc.bf16_feat_width(cin) % 16 == 0
    # a thread's accumulator, 2 qb nt floats, within 128 registers
    for fold in (False, True):
        assert 2 * fc.bf16_fwd_qb(nt, fold) * nt <= 128


def test_bf16_walk_takes_at_most_128_channels():
    with pytest.raises(ValueError, match="at most 128"):
        fc.bf16_ntiles(129)
    with pytest.raises(ValueError):
        fc.walk_config_bf16(64, 200, 8, False)


@pytest.mark.parametrize("cin,cout", [(4, 32), (3, 32), (96, 64), (64, 64),
                                      (64, 3), (5, 7), (20, 20), (128, 64),
                                      (1, 1), (1, 256)])
@pytest.mark.parametrize("backward", [False, True])
def test_bf16_walk_blocks_fit_shared_memory(cin, cout, backward):
    staged = fc.w_fits_shared(64, cin, cout)
    qb, threads = fc.walk_config_bf16(64, cin, cout, staged, backward)
    assert threads == fc.BF16_THREADS == 256
    klen = 64 * cin
    if not backward:
        nt = fc.bf16_ntiles(cin)
        assert qb == fc.bf16_fwd_qb(nt, staged)
        need = fc.bf16_fwd_smem_bytes(qb, nt, klen, cout, staged)
        assert need <= fc.SMEM_LIMIT
        return
    assert qb in fc.BF16_BWD_QB
    need = fc.bf16_bwd_smem_bytes(qb, cin, cout, klen, staged)
    assert need <= fc.SMEM_LIMIT
    held = qb * min(fc.SMEM_PER_SM // (need + 1024), fc.BF16_BWD_BLOCKS)
    for other in fc.BF16_BWD_QB:  # no other block holds more queries
        o = fc.bf16_bwd_smem_bytes(other, cin, cout, klen, staged)
        assert o > fc.SMEM_LIMIT or other * min(
            fc.SMEM_PER_SM // (o + 1024), fc.BF16_BWD_BLOCKS) <= held


def test_walk_config_bf16_at_the_bench_layers():
    # forward: 8 queries a block up to Cin 32 and where Cin 64 folds W, 4
    # at Cin 64 writing rows and at Cin 96 (registers); backward: Cin 96 two
    # blocks of 4 (74 KB each), Cin 64 two blocks of 8
    assert fc.walk_config_bf16(64, 4, 32, True) == (8, 256)
    assert fc.walk_config_bf16(64, 3, 32, True) == (8, 256)
    assert fc.walk_config_bf16(64, 96, 64, False) == (4, 256)
    assert fc.walk_config_bf16(64, 64, 64, False) == (4, 256)
    assert fc.walk_config_bf16(64, 64, 3, True) == (8, 256)
    assert fc.walk_config_bf16(64, 96, 64, False, backward=True) == (4, 256)
    assert fc.walk_config_bf16(64, 64, 64, False, backward=True) == (8, 256)
    assert fc.walk_config_bf16(64, 64, 3, True, backward=True) == (4, 256)
    # the bf16 forward walk's block: its registers bound it, not this
    assert fc.bf16_fwd_smem_bytes(4, 12, 6144, 64, False) == 79712
    assert fc.bf16_bwd_smem_bytes(4, 96, 64, 6144, False) == 74448


def _c_layouts(calls):
    """The shared-memory layouts of csrc/fused_cconv_bf16.cu (`bf16_fwd_smem`,
    `bf16_bwd_smem` and the plan helpers above them), compiled on the host
    with g++ and evaluated at `calls`: (name, args) -> bytes."""
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    from neurofluid_torch import cuda

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the C layouts on the host")
    text = (cuda.CSRC / "fused_cconv_bf16.cu").read_text()
    lo = text.index("constexpr int kBf16Threads")
    hi = text.index("// f32 -> bf16 bits, round to nearest even")
    lines = [f"std::printf(\"%d\\n\", {name}({', '.join(map(str, args))})"
             f"{'.bytes' if 'smem' in name else ''});"
             for name, args in calls]
    src = ("#include <cstdio>\n#define __host__\n#define __device__\n"
           "constexpr int kTile = 32;\n" + text[lo:hi]
           + "int main() {\n" + "\n".join(lines) + "\nreturn 0;\n}\n")
    with tempfile.TemporaryDirectory() as tmp:
        cpp, exe = Path(tmp) / "layouts.cpp", Path(tmp) / "layouts"
        cpp.write_text(src)
        subprocess.run([gxx, "-std=c++17", "-o", str(exe), str(cpp)],
                       check=True, capture_output=True, timeout=120)
        out = subprocess.run([str(exe)], check=True, capture_output=True,
                             text=True, timeout=60).stdout.split()
    return [int(v) for v in out]


def test_bf16_plans_and_layouts_match_the_c_source():
    """The Python mirrors of the bf16 walks' plan and shared-memory layouts
    against the C functions the kernels use (a disagreement would pass the
    card a block whose layout overruns its allocation)."""
    cases = []
    for cin, cout in ((4, 32), (3, 32), (96, 64), (64, 64), (64, 3), (5, 7),
                      (20, 20), (128, 64), (1, 256)):
        staged = fc.w_fits_shared(64, cin, cout)
        nt = fc.bf16_ntiles(cin)
        for qb in (2, 4, 8):
            cases.append((("bf16_fwd_smem", (qb, nt, 64 * cin, cout,
                                             int(staged))),
                          fc.bf16_fwd_smem_bytes(qb, nt, 64 * cin, cout,
                                                 staged)))
            cases.append((("bf16_bwd_smem", (qb, cin, cout, 64 * cin,
                                             int(staged))),
                          fc.bf16_bwd_smem_bytes(qb, cin, cout, 64 * cin,
                                                 staged)))
        cases += [(("bf16_ntiles", (cin,)), nt),
                  (("bf16_fwd_qb", (nt, int(staged))),
                   fc.bf16_fwd_qb(nt, staged)),
                  (("bf16_feat_width", (cin,)), fc.bf16_feat_width(cin))]
    got = _c_layouts([c for c, _ in cases])
    assert got == [want for _, want in cases]


@pytest.mark.parametrize("n,klen", [(14336, 6144), (14336, 4096),
                                    (300, 256)])
def test_bf16_scratch_rows_are_half_the_f32_bytes(n, klen):
    # the same chunk of query rows, bf16 rows at 'default' (conv1: 7,168
    # rows of 6,144, 88 MB where the f32 walk's took 176; conv2 one chunk)
    rows = {p: fc.scratch_rows(n, klen, p, "cpu")
            for p in ("highest", "high", "default")}
    assert rows["highest"].shape == (min(fc.scratch_chunk_rows(n, klen), n),
                                     klen)
    assert rows["default"].dtype == torch.bfloat16
    assert rows["default"].shape == rows["highest"].shape
    f32 = rows["highest"].numel() * rows["highest"].element_size()
    assert 2 * rows["default"].numel() * rows["default"].element_size() == f32
    assert rows["high"].dtype == torch.float32
