"""The render's feature encoding (`ops/encode.py`, K10's plain side) on the
CPU: `encode_features` against the renderer's composition of
`positional_encoding` and concatenations as it stood before the encoding
had a kernel (copied below as `composed_rows`), bitwise, for every
combination of the encode flags with `sigma_only` and `exclude_ray`; the
fine pass's two sources against the concatenation of the two passes' rows
ray by ray; and `EncodeFeatures`' backward (the backward kernel's plain
twin) against autograd through the plain composition in float64."""

import itertools

import numpy as np
import pytest
import torch

from neurofluid_torch.models.embedding import positional_encoding
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.ops import encode as enc

FLAGS = ("encode_density", "encode_var", "encode_smoothed_pos",
         "encode_smoothed_dir")
N_RAYS, S0, S1 = 5, 4, 6


def _renderer(flags, exclude_ray, same_smooth_factor=False):
    return RenderNet(device="cpu", nerf_depth=1, nerf_width=8,
                     exclude_ray=exclude_ray,
                     same_smooth_factor=same_smooth_factor,
                     generator=torch.Generator().manual_seed(0),
                     **dict(zip(FLAGS, flags)))


def _geometry(n_s, seed, dtype=torch.float32, var=True):
    """Seeded local geometry of N_RAYS x n_s samples as the dense path
    gives it: positions about the camera's distance, densities up to 20,
    smoothed positions near the samples, small variances; num_nn and the
    in-radius count up to 24."""
    rng = np.random.default_rng(seed)
    n = N_RAYS * n_s

    def t(a):
        return torch.tensor(a, dtype=dtype)

    xyz = rng.uniform(-2.0, 12.0, (n, 3))
    count = t(rng.integers(0, 25, n))
    geom = enc.Geometry(t(xyz), t(rng.uniform(0.0, 20.0, (n, 1))),
                        t(xyz + rng.normal(0.0, 0.05, (n, 3))),
                        t(rng.uniform(0.0, 1e-3, (n, 3))) if var else None)
    return geom, torch.clamp(count, max=20.0)[:, None], count


def _rays(dtype=torch.float32):
    rng = np.random.default_rng(7)
    d = rng.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile([0.5, -1.0, 11.0], (N_RAYS, 1))
    return (torch.tensor(np.concatenate([o, d], 1), dtype=dtype),
            torch.tensor([0.5, -1.0, 11.0], dtype=dtype))


def composed_rows(ren, flat, density, smoothed_pos, var, num_nn, count, rays,
                  ro, n_s, sigma_only):
    """The renderer's encoding as composed before K10 (its `_encode`):
    (rows, num_nn, full-K mask)."""
    if not ren.exclude_ray:
        if ren.same_smooth_factor:
            alpha = torch.full_like(num_nn, ren.larger_alpha)
        else:
            alpha = torch.where(num_nn <= 20.0, ren.smaller_alpha,
                                ren.larger_alpha)
        smoothed_pos = flat * (1.0 - alpha) + smoothed_pos * alpha
    pos_feats = [positional_encoding(flat, ren.xyz_freqs)]
    if ren.encode_density:
        pos_feats.append(positional_encoding(density, ren.density_freqs))
    if ren.encode_smoothed_pos:
        pos_feats.append(positional_encoding(smoothed_pos, ren.xyz_freqs))
    if ren.encode_var:
        pos_feats.append(positional_encoding(var, ren.xyz_freqs))
    full_mask = (count >= ren.num_neighbors).reshape(-1, n_s, 1)
    if sigma_only:
        return torch.cat(pos_feats, dim=-1), num_nn, full_mask
    hit_dir = positional_encoding(rays[:, 3:], ren.dir_freqs)
    dir_feats = [torch.repeat_interleave(hit_dir, n_s, dim=0)]
    if ren.encode_smoothed_dir:
        sd = smoothed_pos - ro[None, :]
        sd = sd / (torch.linalg.norm(sd, dim=-1, keepdim=True) + 1e-12)
        dir_feats.append(positional_encoding(sd, ren.dir_freqs))
    return torch.cat(pos_feats + dir_feats, dim=-1), num_nn, full_mask


def _encoded(ren, geom, num_nn, sigma_only, sources_before=()):
    """The renderer's rows of `geom` (after its blend), with the geometry
    of `sources_before` ahead of it on each ray."""
    rays, ro = _rays()
    return enc.encode_features([*sources_before, ren._blend(geom, num_nn)],
                               rays, ro, ren.encoding, sigma_only)


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("exclude_ray", [True, False])
@pytest.mark.parametrize("flags", list(itertools.product((True, False),
                                                         repeat=4)),
                         ids=lambda f: "".join(str(int(x)) for x in f))
def test_plain_rows_equal_the_composition(flags, exclude_ray, sigma_only):
    ren = _renderer(flags, exclude_ray)
    geom, num_nn, count = _geometry(S0, 1, var=ren.encode_var)
    rays, ro = _rays()
    want, _, _ = composed_rows(ren, *geom, num_nn, count, rays, ro, S0,
                               sigma_only)
    assert torch.equal(_encoded(ren, geom, num_nn, sigma_only), want)
    # the NeRF's input widths, as the renderer builds its NeRFs with them
    assert want.shape[1] == ren.in_channels_xyz + (
        0 if sigma_only else ren.in_channels_dir)


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("exclude_ray,same", [(True, False), (False, False),
                                              (False, True)])
def test_two_sources_are_the_passes_rows_ray_by_ray(exclude_ray, same,
                                                    sigma_only):
    """The fine pass's rows from the coarse geometry and its own: the
    concatenation of each pass's composed rows on each ray (as `forward`
    concatenated `feats_all` before K10)."""
    ren = _renderer((True,) * 4, exclude_ray, same)
    rays, ro = _rays()
    g0, nn0, c0 = _geometry(S0, 2)
    g1, nn1, c1 = _geometry(S1, 3)
    f0, _, _ = composed_rows(ren, *g0, nn0, c0, rays, ro, S0, sigma_only)
    f1, _, _ = composed_rows(ren, *g1, nn1, c1, rays, ro, S1, sigma_only)
    c = f0.shape[-1]
    want = torch.cat([f0.reshape(N_RAYS, S0, c), f1.reshape(N_RAYS, S1, c)],
                     dim=1).reshape(-1, c)
    b0 = ren._blend(g0, nn0)
    assert torch.equal(_encoded(ren, g1, nn1, sigma_only, (b0,)), want)


@pytest.mark.parametrize("n_sources", [1, 2])
@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)],
                         ids=lambda f: "".join(str(int(x)) for x in f))
def test_encode_features_backward_matches_autograd(flags, sigma_only,
                                                   n_sources):
    """EncodeFeatures on the CPU (the plain forward, then the backward
    kernel's twin) against autograd through the plain composition, in
    float64, for a seeded cotangent: each input's cotangent within 1e-12
    of the sum of its terms' magnitudes (`absolute=True`); inputs that are
    not encoded get none."""
    ren = _renderer(flags, True)
    encoding = ren.encoding
    rays, ro = _rays(torch.float64)
    sources = [_geometry(s, 4 + i, torch.float64)[0]
               for i, s in enumerate((S0, S1)[:n_sources])]
    leaves = [enc.Geometry(*(t.clone().requires_grad_(True) for t in g))
              for g in sources]
    rng = np.random.default_rng(9)
    g = torch.tensor(rng.normal(size=(N_RAYS * sum((S0, S1)[:n_sources]),
                                      encoding.width(sigma_only))))
    want = torch.autograd.grad(
        enc.encode_features_plain(leaves, rays, ro, encoding, sigma_only),
        [t for lf in leaves for t in lf], g, allow_unused=True)
    inputs = [t for lf in leaves for t in lf]
    out = enc.EncodeFeatures.apply(encoding, sigma_only, rays, ro, *inputs)
    assert torch.equal(out, enc.encode_features_plain(
        sources, rays, ro, encoding, sigma_only))
    got = torch.autograd.grad(out, inputs, g, allow_unused=True)
    scale = enc.encode_features_bwd_plain(sources, rays, ro, encoding,
                                          sigma_only, g, absolute=True)
    scale = [t for s in scale for t in s]
    encoded = (True, encoding.density, encoding.smoothed_pos
               or (encoding.smoothed_dir and not sigma_only), encoding.var)
    for i, (w, gt, sc) in enumerate(zip(want, got, scale)):
        on = encoded[i % 4]
        if not on:
            assert gt is None and sc is None
            assert w is None or not bool(w.any())
            continue
        assert float(sc.min()) > 0
        np.testing.assert_array_less((gt - w).abs().numpy(),
                                     1e-12 * sc.numpy() + 1e-300)


def test_cuda_wrapper_refuses_cpu_tensors():
    """K10's wrapper takes CUDA tensors alone: no CPU fallback."""
    geom, _, _ = _geometry(S0, 1)
    rays, ro = _rays()
    with pytest.raises(ValueError, match="CUDA"):
        enc.encode_features_cuda([geom], rays, ro,
                                 _renderer((True,) * 4, True).encoding)


# K10's source run on the host: the CUDA keywords defined away, each block
# run by one thread (every loop of the kernels strides by blockDim.x, so a
# block of one runs each phase whole and its barriers are no-ops), the
# launches a loop over the blocks. It holds the host's plan (columns,
# pairs, the tile), the sources' row map, the staging and the stores, and
# the backward's sums and normalisation VJP, against the plain versions;
# the arithmetic of sinf and cosf is the host's (the card tests hold
# K10's bits).
_HOST_PRELUDE = """
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
#define __shared__
struct float4 { float x, y, z, w; };
struct uint3 { unsigned x, y, z; };
static uint3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline void __syncthreads() {}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
using std::min;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
"""


@pytest.fixture(scope="module")
def k10_on_host(tmp_path_factory):
    import ctypes
    import re
    import shutil
    import subprocess

    from neurofluid_torch import cuda

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile K10's source on the host")
    text = (cuda.CSRC / "encode.cu").read_text()
    text = text.replace("#include <cuda_runtime.h>", "")
    # the dynamic shared memory, one block's at a time
    text = text.replace("namespace {", "namespace {\nfloat4 smem4[3072];", 1)
    text = re.sub(r"(\w+)<<<(\w+),.*?>>>\((\w+)\);",
                  r"for (unsigned b = 0; b < unsigned(\2); ++b) "
                  r"{ blockIdx.x = b; \1(\3); }", text, flags=re.S)
    tmp = tmp_path_factory.mktemp("k10")
    cpp, lib = tmp / "encode_host.cpp", tmp / "encode_host.so"
    cpp.write_text(_HOST_PRELUDE + text)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(lib), str(cpp)], check=True, capture_output=True,
                   timeout=120)
    so = ctypes.CDLL(str(lib))
    for name in ("nf_encode_fwd", "nf_encode_bwd"):
        fn = getattr(so, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def entry(name):
        def call(table, n_args):
            assert getattr(so, name)(table, n_args, None) == 0
        return call

    return entry("nf_encode_fwd"), entry("nf_encode_bwd")


@pytest.mark.parametrize("n_sources", [1, 2])
@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)],
                         ids=lambda f: "".join(str(int(x)) for x in f))
def test_k10_source_on_the_host_matches_plain(k10_on_host, flags,
                                              sigma_only, n_sources):
    """K10's forward and backward, run on the host from csrc/encode.cu,
    against `encode_features_plain` (within 1e-6: the host's sinf and
    torch's sin; the identity columns equal) and `encode_features_bwd_plain`
    (within 1e-5 of the sum of each cotangent's terms' magnitudes), on
    sources whose rows are strided views and rays that are a slice."""
    fwd, bwd = k10_on_host
    encoding = _renderer(flags, True).encoding
    rows_each = (S0, S1)[:n_sources]
    sources = []
    for i, s in enumerate(rows_each):
        g, _, _ = _geometry(s, 20 + i)
        wide = torch.zeros(g.xyz.shape[0], 16)  # strided rows, as K3's sums
        wide[:, 0:3], wide[:, 3:4] = g.xyz, g.density
        wide[:, 5:8], wide[:, 9:12] = g.smoothed_pos, g.var
        sources.append(enc.Geometry(wide[:, 0:3], wide[:, 3:4], wide[:, 5:8],
                                    wide[:, 9:12] if encoding.var else None))
    rays, ro = _rays()
    rays = torch.cat([rays, torch.zeros(N_RAYS, 2)], 1)[:, :6]
    ro_strided = torch.stack([ro, ro], 1)[:, 0]
    want = enc.encode_features_plain(sources, rays, ro, encoding, sigma_only)
    got = torch.full_like(want, float("nan"))
    enc._launch(fwd, sources, rays, ro_strided, encoding, sigma_only, got)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)

    g = torch.tensor(np.random.default_rng(3).normal(size=want.shape),
                     dtype=torch.float32)
    grads = [enc.Geometry(*(torch.full_like(t.contiguous(), float("nan"))
                            if t is not None else None for t in s))
             for s in sources]
    enc._launch(bwd, sources, rays, ro_strided, encoding, sigma_only, g,
                [*grads, (None,) * 4][:2])
    plain = enc.encode_features_bwd_plain(sources, rays, ro, encoding,
                                          sigma_only, g)
    scale = enc.encode_features_bwd_plain(sources, rays, ro, encoding,
                                          sigma_only, g, absolute=True)
    for gr, pl, sc in zip(grads, plain, scale):
        for got_d, want_d, sc_d in zip(gr, pl, sc):
            if want_d is None:
                continue
            np.testing.assert_array_less(
                (got_d - want_d).abs().numpy(), 1e-5 * sc_d.numpy())
