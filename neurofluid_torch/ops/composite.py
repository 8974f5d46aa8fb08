"""Volume-rendering weights: K5 (`csrc/composite.cu`
`nf_composite_weights`), its backward K6 (`nf_composite_weights_bwd`, same
source) and the plain version of each.

    s_i = exp(-delta_i * ||d|| * relu(sigma_i)),  delta_i = z_{i+1} - z_i,
          last delta = 1e10
    w_i = (1 - s_i) * prod_{j<i} (s_j + 1e-10)

The survival factor s_i is computed directly, as the TPU kernel does
(neurofluid_tpu/ops/pallas_kernels.py `_composite_kernel`): the textbook
`1 - alpha + eps` loses eps at alpha == 1.

`composite_weights` is differentiable with respect to sigma only
(`CompositeWeights`); z and ||d|| get zero cotangent by contract, as in
neurofluid_tpu/ops/pallas_kernels.py `composite_weights`: sample depths are
linspaces or detached importance samples, and ray geometry is data.
"""

from __future__ import annotations

import ctypes

import torch

from neurofluid_torch.cuda import Kernel, check_tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("composite.cu", "nf_composite_weights", [_P] * 4 + [_I] * 3)
BWD_KERNEL = Kernel("composite.cu", "nf_composite_weights_bwd",
                    [_P] * 5 + [_I] * 3)

# K5 and K6 hold a ray in registers, a run of samples per lane of one warp:
# the fewest of PER_LANE that cover the ray, else tiles of 32 * 8 samples
# (`samples_per_lane` in csrc/composite.cu); K6 takes rays of up to
# MAX_BWD_SAMPLES, K5 of any length
PER_LANE = (1, 2, 4, 6, 8)
MAX_BWD_SAMPLES = 2048


def samples_per_lane(n_samples: int) -> int:
    """Samples each lane of K5's and K6's warp holds for rays of
    `n_samples`."""
    return next((p for p in PER_LANE if n_samples <= 32 * p), PER_LANE[-1])


def bwd_samples_per_lane(n_samples: int) -> int:
    """`samples_per_lane` for K6, which refuses rays of more than
    MAX_BWD_SAMPLES samples."""
    if n_samples > MAX_BWD_SAMPLES:
        raise ValueError(f"K6 takes rays of at most {MAX_BWD_SAMPLES} "
                         f"samples, not {n_samples}")
    return samples_per_lane(n_samples)


def _survival(sigmas, z_vals, dnorm):
    """(delta * ||d||, s, T): the scaled deltas, the survival factors and
    the exclusive transmittance products."""
    deltas = torch.cat(
        [z_vals[:, 1:] - z_vals[:, :-1],
         torch.full_like(z_vals[:, :1], 1e10)], dim=1)
    deltas = deltas * dnorm[:, None]
    surv = torch.exp(-deltas * torch.relu(sigmas))
    trans = torch.cumprod(
        torch.cat([torch.ones_like(surv[:, :1]), surv[:, :-1] + 1e-10], dim=1),
        dim=1)
    return deltas, surv, trans


def composite_weights_plain(sigmas: torch.Tensor, z_vals: torch.Tensor,
                            dnorm: torch.Tensor) -> torch.Tensor:
    """sigmas, z_vals (R, S); dnorm (R,) = ||ray_d|| -> weights (R, S)."""
    _, surv, trans = _survival(sigmas, z_vals, dnorm)
    return (1.0 - surv) * trans


def composite_weights_bwd_plain(sigmas, z_vals, dnorm, g) -> torch.Tensor:
    """Plain PyTorch twin of K6: g (R, S) cotangent of the weights ->
    d sigma (R, S),

        d sigma_i = delta_i ||d|| s_i 1[sigma_i > 0]
                    (g_i T_i - sum_{k>i} g_k w_k / (s_i + 1e-10)),

    the suffix sum taken as an exclusive reverse cumulative sum."""
    deltas, surv, trans = _survival(sigmas, z_vals, dnorm)
    gw = g * (1.0 - surv) * trans
    incl = torch.flip(torch.cumsum(torch.flip(gw, [1]), dim=1), [1])
    suffix = torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], dim=1)
    return torch.where(sigmas > 0.0,
                       deltas * surv * (g * trans - suffix / (surv + 1e-10)),
                       0.0)


def _check_cuda_args(sigmas, z_vals, dnorm):
    dev = sigmas.device
    n_rays = sigmas.shape[0]
    for name, t in (("sigmas", sigmas), ("z_vals", z_vals), ("dnorm", dnorm)):
        check_tensor(name, t, dev)
    if z_vals.shape != sigmas.shape or dnorm.shape != (n_rays,):
        raise ValueError(
            f"shapes sigmas {tuple(sigmas.shape)}, z_vals "
            f"{tuple(z_vals.shape)}, dnorm {tuple(dnorm.shape)} disagree")


def composite_weights_cuda(sigmas: torch.Tensor, z_vals: torch.Tensor,
                           dnorm: torch.Tensor) -> torch.Tensor:
    """K5: one warp per ray held in registers, a run of samples per lane;
    the transmittance at each run's start by a warp product scan of the
    runs' products (tiles of 256 samples past 256, the transmittance
    carried)."""
    _check_cuda_args(sigmas, z_vals, dnorm)
    n_rays, n_s = sigmas.shape
    w = torch.empty_like(sigmas)
    if n_rays and n_s:
        KERNEL(sigmas.data_ptr(), z_vals.data_ptr(), dnorm.data_ptr(),
               w.data_ptr(), n_rays, n_s, samples_per_lane(n_s))
    return w


def composite_weights_bwd_cuda(sigmas, z_vals, dnorm, g) -> torch.Tensor:
    """K6: one warp per ray held in registers, a run of samples per lane;
    the transmittance by a warp product scan of the runs' products, the
    suffix sum by a reverse warp sum scan of their sums."""
    _check_cuda_args(sigmas, z_vals, dnorm)
    check_tensor("g", g, sigmas.device)
    if g.shape != sigmas.shape:
        raise ValueError(f"g {tuple(g.shape)} != {tuple(sigmas.shape)}")
    n_rays, n_s = sigmas.shape
    per_lane = bwd_samples_per_lane(n_s)
    d_sigma = torch.empty_like(sigmas)
    if n_rays and n_s:
        BWD_KERNEL(sigmas.data_ptr(), z_vals.data_ptr(), dnorm.data_ptr(),
                   g.data_ptr(), d_sigma.data_ptr(), n_rays, n_s, per_lane)
    return d_sigma


class CompositeWeights(torch.autograd.Function):
    """The weights with their backward: K5/K6 for CUDA tensors, the plain
    versions for CPU tensors. z and ||d|| get no gradient."""

    @staticmethod
    def forward(ctx, sigmas, z_vals, dnorm):
        ctx.save_for_backward(sigmas, z_vals, dnorm)
        if sigmas.is_cuda:
            return composite_weights_cuda(sigmas, z_vals, dnorm)
        return composite_weights_plain(sigmas, z_vals, dnorm)

    @staticmethod
    def backward(ctx, g):
        sigmas, z_vals, dnorm = ctx.saved_tensors
        bwd = (composite_weights_bwd_cuda if sigmas.is_cuda
               else composite_weights_bwd_plain)
        return bwd(sigmas, z_vals, dnorm, g.contiguous()), None, None


def composite_weights(sigmas: torch.Tensor, z_vals: torch.Tensor,
                      dnorm: torch.Tensor) -> torch.Tensor:
    """K5 (forward) and K6 (backward) for CUDA tensors, the plain versions
    for CPU tensors."""
    return CompositeWeights.apply(sigmas, z_vals, dnorm)
