"""K9, the NeRF's dense layers on one Hopper kernel
(`neurofluid_torch/csrc/dense_layer.cu`, `ops/dense_layer.py`), on the CPU:
the kernel's 3xTF32 chains emulated at the NeRF's widths, the plain layer,
the plain versions of B's planes and the wrapper's checks and routing. The
kernel itself runs in `tests/test_torch_cuda.py` on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neurofluid_torch.models.nerf import NeRF
from neurofluid_torch.ops import dense_layer as dl
from test_torch_split_gemm import (LIMIT, emulated_chains, emulated_product,
                                   rel_err)


def _relu_operands(k, n=256, rows=64, seed=None):
    """A ReLU net's activations (non-negative) and weights at PyTorch's
    init scale."""
    rng = np.random.default_rng(k if seed is None else seed)
    a = np.maximum(rng.normal(size=(rows, k)), 0).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    return a, b


# the NeRF's k: layer 1 (198), the 256-wide layers, dir_encoding (310) and
# layer 5's skip (454)
@pytest.mark.parametrize("k", [198, 256, 310, 454])
def test_chains_of_32_are_f32_class_and_one_pass_is_not(k):
    a, b = _relu_operands(k)
    three = rel_err(emulated_chains(a, b, 32), a, b)
    f32 = rel_err(a @ b, a, b)
    assert three <= LIMIT, three
    assert three <= 4.0 * max(f32, 2.0 ** -24), (three, f32)
    assert rel_err(emulated_product(a, b, ("hi_hi",)), a, b) > 20.0 * LIMIT


def test_a_chain_through_the_whole_k_misses_the_limit():
    # why the kernel keeps a second register accumulator: one sum carried
    # through the tensor core over layer 5's k = 454 drifts past the limit
    a, b = _relu_operands(454)
    assert rel_err(emulated_chains(a, b, 454), a, b) > LIMIT


@pytest.mark.parametrize("k1,k2,relu", [(198, 0, True), (198, 256, True),
                                        (256, 54, True), (256, 0, False)])
def test_plain_two_source_layer_is_linear_on_the_concatenation(k1, k2, relu):
    g = torch.Generator().manual_seed(k1 + k2)
    a1 = torch.randn(300, k1, generator=g)
    x = torch.randn(300, 198 + k2, generator=g)  # a2 a view off its rows
    a2 = x[:, 198:] if k2 else None
    w = torch.randn(128, k1 + k2, generator=g)
    b = torch.randn(128, generator=g)
    got = dl.dense_layer_plain(a1, a2, w, b, relu)
    y = F.linear(a1 if a2 is None else torch.cat([a1, a2], -1), w, b)
    assert torch.equal(got, torch.relu(y) if relu else y)


@pytest.mark.parametrize("n,k1,k_in", [(256, 198, 454), (128, 256, 310),
                                       (256, 198, 198), (16, 32, 59)])
def test_plain_planes_hold_the_split_weight_with_each_source_padded(n, k1,
                                                                    k_in):
    g = torch.Generator().manual_seed(n + k_in)
    w = torch.randn(n, k_in, generator=g)
    fwd = dl.fwd_planes_plain(w, k1)
    kp1 = -(-k1 // 32) * 32
    assert fwd.shape == (2, -(-n // 32) * 32,
                         kp1 + -(-(k_in - k1) // 32) * 32)
    whole = (fwd[0] + fwd[1])[:n]
    assert float((whole[:, :k1] - w[:, :k1]).abs().max()) <= \
        2.0 ** -21 * float(w.abs().max())
    torch.testing.assert_close(whole[:, kp1:kp1 + k_in - k1], w[:, k1:],
                               rtol=2.0 ** -21, atol=0)
    assert not fwd[:, :, k1:kp1].any() and not fwd[:, n:].any()
    dx = dl.dx_planes_plain(w)
    assert dx.shape == (2, -(-k_in // 128) * 128, -(-n // 32) * 32)
    torch.testing.assert_close((dx[0] + dx[1])[:k_in, :n], w.t(),
                               rtol=2.0 ** -21, atol=0)
    assert not dx[:, k_in:].any() and not dx[:, :, n:].any()


def test_planes_times_the_padded_sources_are_the_layer():
    # the kernel's k-tiles of a1 then a2 against the forward's planes: the
    # three passes over the zero-padded sources give the layer's product
    # within the kernel's limit
    g = torch.Generator().manual_seed(9)
    a1, a2 = torch.rand(64, 198, generator=g), torch.rand(64, 256,
                                                          generator=g)
    w = torch.randn(256, 454, generator=g) / 454 ** 0.5
    fwd = dl.fwd_planes_plain(w, 198).double()
    a = torch.cat([F.pad(a1, (0, 26)), a2], 1)
    ah, al = (t.double() for t in dl.split_tf32(a))
    got = al @ fwd[0].t() + ah @ fwd[1].t() + ah @ fwd[0].t()
    x = torch.cat([a1, a2], 1).double()
    err = (got - x @ w.double().t()).abs() / (x.abs() @ w.double().abs().t())
    assert float(err.max()) <= LIMIT


def test_tf32_split_matches_the_emulation():
    from test_torch_split_gemm import split

    x = np.random.default_rng(3).normal(size=1000).astype(np.float32)
    hi, lo = dl.split_tf32(torch.from_numpy(x))
    want_hi, want_lo = split(x)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)


@pytest.mark.parametrize("m,units,sms", [(131072, 4, 132), (393216, 8, 132),
                                         (77, 2, 132), (4096, 4, 132),
                                         (2048, 4, 132), (1, 1, 132)])
def test_dw_splits_cover_the_batch_in_whole_tiles(m, units, sms):
    n_split, per = dl.dw_splits(m, units, sms)
    k_tiles = -(-m // 32)
    assert (n_split - 1) * per < k_tiles <= n_split * per
    assert n_split <= max(1, -(-2 * sms // units))
    assert per >= min(dl.MIN_SPLIT_TILES, k_tiles)


def test_dw_reads_its_sources_where_tma_can():
    # dW's product takes both sources by TMA: a view off 16 bytes (the
    # direction slice) or with rows of no whole 16 bytes is copied into
    # rows that TMA takes; an aligned view is read where it lies
    x = torch.rand(50, 252)
    xyz = x[:, :198]
    assert dl._tma_copy(xyz) is xyz
    for view in (x[:, 198:], torch.rand(50, 63)):
        got = dl._tma_copy(view)
        assert got.data_ptr() % 16 == 0 and got.stride(0) % 4 == 0
        assert torch.equal(got, view)


def _layer_args():
    return (torch.zeros(8, 198), torch.zeros(8, 256), torch.zeros(256, 454),
            torch.zeros(256), dl.Planes(torch.zeros(2, 256, 480), None, 198))


def test_the_wrapper_refuses_a_tensor_off_the_card():
    a1, a2, w, b, planes = _layer_args()
    with pytest.raises(ValueError, match="is on cpu, expected a CUDA"):
        dl.dense_chain_cuda([(a1, a2, w, b, planes, True,
                              torch.empty(8, 256))])
    with pytest.raises(ValueError, match="is on cpu, expected a CUDA"):
        dl.prepare([(w, 198)], want_dx=False)


@pytest.mark.parametrize("change,error", [
    ("a1_dtype", "a1 has dtype torch.float64"),
    ("w_dtype", "weight torch.float64"),
    ("width", "vs an f32 input of 453"), ("rows", "differ in rows"),
    ("bias", "bias torch.float32 \\(255,\\)"), ("split", "planes split at"),
    ("strided", "contiguous rows"), ("dims", "contiguous rows")])
def test_the_wrapper_refuses_types_and_shapes_the_kernel_does_not_take(
        change, error):
    a1, a2, w, b, planes = _layer_args()
    if change == "a1_dtype":
        a1 = a1.double()
    elif change == "w_dtype":
        w = w.double()
    elif change == "width":
        a2 = torch.zeros(8, 255)
    elif change == "rows":
        a2 = torch.zeros(9, 256)
    elif change == "bias":
        b = torch.zeros(255)
    elif change == "split":
        planes = planes._replace(k1=197)
    elif change == "strided":
        a1 = torch.zeros(198, 8).t()
    elif change == "dims":
        a1 = torch.zeros(8, 1, 198)
    with pytest.raises(ValueError, match=error):
        dl.check_args(a1, a2, w, b, planes)
    assert len(dl.check_args(*_layer_args())) == 2


def test_prepare_refuses_more_layers_than_a_launch_takes():
    w = torch.zeros(256, 256)
    with pytest.raises(ValueError, match="at most 12"):
        dl.prepare([(w, 256)] * 13, want_dx=True)


def test_cpu_nerf_stays_on_the_plain_layers():
    # on the CPU every layer is F.linear on the concatenated input, bitwise
    # as before, and nothing reaches the kernel's wrapper
    net = NeRF(in_channels_xyz=198, in_channels_dir=54, device="cpu",
               generator=torch.Generator().manual_seed(1))
    x = torch.rand(50, 252, generator=torch.Generator().manual_seed(2))
    handles = (dl.CHAIN_KERNEL, dl.BWD_KERNEL, dl.PREP_KERNEL)
    before = [k.launches for k in handles]
    got = net(x)
    assert [k.launches for k in handles] == before
    xyz, h = x[:, :198], x[:, :198]
    for i in range(8):
        if i == 4:
            h = torch.cat([xyz, h], -1)
        h = torch.relu(getattr(net, f"xyz_encoding_{i + 1}")(h))
    sigma = net.sigma(h)
    d = torch.relu(net.dir_encoding(torch.cat(
        [net.xyz_encoding_final(h), x[:, 198:]], -1)))
    assert torch.equal(got, torch.cat([net.rgb(d), sigma], -1))


@pytest.mark.parametrize("grad", [False, True])
def test_nerf_preps_its_split_weights_once_a_forward(monkeypatch, grad):
    # one `prepare` a forward for all the wide layers it runs (10, or the
    # trunk's 8 with `sigma_only`), each split at its first source's width,
    # with dX's planes only under autograd; nothing is kept across forwards
    net = NeRF(in_channels_xyz=198, in_channels_dir=54, device="cpu",
               generator=torch.Generator().manual_seed(1))
    x = torch.rand(30, 252, generator=torch.Generator().manual_seed(2))
    _plain_chain(monkeypatch)
    calls = []
    monkeypatch.setattr(dl, "prepare", lambda layers, want_dx: calls.append(
        ([(tuple(w.shape), k1) for w, k1 in layers], want_dx))
        or [None] * len(layers))
    with torch.set_grad_enabled(grad):
        net._forward_k9(x, False)
        net._forward_k9(x, False)
        net._forward_k9(x[:, :198], True)
    trunk = [((256, 198), 198)] + [((256, 256), 256)] * 3 + [
        ((256, 454), 198)] + [((256, 256), 256)] * 3
    full = trunk + [((256, 256), 256), ((128, 310), 256)]
    assert calls == [(full, grad), (full, grad), (trunk, grad)]


def _plain_chain(monkeypatch):
    """K9's calls replaced by the plain layer, so that the card's path
    (its wiring of sources and outputs, its buffers and its backward's
    sums of cotangents) runs on the CPU."""
    def chain(steps):
        for a1, a2, w, b, _, relu, out in steps:
            out.copy_(dl.dense_layer_plain(a1, a2, w, b, relu))

    def bwd(dy, a1, a2, w, out, planes, relu, needs, widths):
        g = dy * (out > 0) if relu else dy
        x = a1 if a2 is None else torch.cat([a1, a2], 1)
        dx = g @ w
        return (dx[:, :widths[0]] if needs[0] else None,
                dx[:, widths[0]:] if a2 is not None and needs[1] else None,
                g.t() @ x if needs[2] else None,
                g.sum(0) if needs[3] else None)

    monkeypatch.setattr(dl, "prepare",
                        lambda layers, want_dx: [None] * len(layers))
    monkeypatch.setattr(dl, "dense_chain_cuda", chain)
    monkeypatch.setattr(dl, "_bwd", bwd)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_nerf_k9_path_wires_the_layers_as_the_plain_path(monkeypatch, grad,
                                                        sigma_only):
    # the forward through the chain's sources and its two buffers taken in
    # turn (without autograd) equals the plain forward bitwise
    net = NeRF(in_channels_xyz=198, in_channels_dir=54, device="cpu",
               generator=torch.Generator().manual_seed(5))
    x = torch.rand(40, 252, generator=torch.Generator().manual_seed(6))
    _plain_chain(monkeypatch)
    with torch.set_grad_enabled(grad):
        want = net(x, sigma_only=sigma_only)
        got = net._forward_k9(x, sigma_only)
    assert torch.equal(got, want)


@pytest.mark.parametrize("x_grad", [False, True])
def test_nerf_k9_chain_sums_the_cotangents_as_autograd(monkeypatch, x_grad):
    # the chain's backward: h7's cotangent from the sigma head and from
    # xyz_encoding_final, input_xyz's from layers 1 and 5, the skip
    # layer's dX cut into its sources, each weight's and bias's gradient
    net = NeRF(in_channels_xyz=198, in_channels_dir=54, device="cpu",
               generator=torch.Generator().manual_seed(7))
    x0 = torch.rand(40, 252, generator=torch.Generator().manual_seed(8))
    _plain_chain(monkeypatch)
    grads = []
    for fwd in (net, lambda x: net._forward_k9(x, False)):
        x = x0.clone().requires_grad_(x_grad)
        fwd(x).square().sum().backward()
        grads.append([x.grad] + [p.grad.clone() for p in net.parameters()])
        net.zero_grad()
    for want, got in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
