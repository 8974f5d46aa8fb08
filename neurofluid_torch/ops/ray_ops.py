"""Ray generation, coarse and hierarchical sampling and volume compositing
(port of neurofluid_tpu/ops/ray_ops.py).

Rays are (R, 6): origin in [:, :3], normalized direction in [:, 3:]. Pixel
rays use the Blender camera convention (x right, y up, the camera looking
along -z) without a half-pixel offset, as the reference does
(utils/ray_utils.py:85-130).

The random forms (stratified jitter, stochastic inverse-CDF levels, sigma
noise) draw from an explicit `torch.Generator`, the counterpart of the JAX
package's PRNG key, and only through `uniform` and `normal`: one draw per
call, so a caller (or a test that feeds in another source's draws) sees
every random number the module uses.
"""

from __future__ import annotations

import torch

from neurofluid_torch.cuda import resolve_device
from neurofluid_torch.ops.composite import composite_weights


def point_to_ray_distance(points: torch.Tensor, rays_o: torch.Tensor,
                          rays_d: torch.Tensor) -> torch.Tensor:
    """(P, R) perpendicular distance of each point (P, 3) to each ray
    (origins and normalized directions (R, 3)); the vectorized form of the
    reference's chunked helper (utils/ray_utils.py:19-34)."""
    vec = points[:, None, :] - rays_o[None, :, :]  # (P, R, 3)
    t = torch.einsum("prc,rc->pr", vec, rays_d)
    closest = rays_o[None] + t[..., None] * rays_d[None]
    return torch.linalg.norm(points[:, None, :] - closest, dim=-1)


def assign_particles_to_rays(points: torch.Tensor,
                             rays: torch.Tensor) -> torch.Tensor:
    """(P,) index of each particle's nearest ray (R, 6) (reference
    utils/ray_utils.py:36-82, a dict built over chunks there)."""
    return torch.argmin(point_to_ray_distance(points, rays[:, :3],
                                              rays[:, 3:]), dim=-1)


def get_ray_directions(height: int, width: int, focal,
                       device="cuda") -> torch.Tensor:
    """Per-pixel ray directions in camera coordinates, (H, W, 3) float32:
    ((i - W/2) / focal, -(j - H/2) / focal, -1) at column i, row j. Built on
    the card unless `device` says otherwise."""
    device = resolve_device(device)
    j, i = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([(i - width / 2) / focal, -(j - height / 2) / focal,
                        -torch.ones_like(i)], dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """World-space rays of one camera: the directions rotated by c2w[:, :3]
    and normalized, and the origin c2w[:, 3] broadcast. Returns (rays_o,
    rays_d), each of the directions' shape."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return c2w[:, 3].expand(rays_d.shape), rays_d


def make_ray_bundle(directions: torch.Tensor, c2w: torch.Tensor):
    """(..., 6) rays: [rays_o, rays_d] of `get_rays`."""
    return torch.cat(get_rays(directions, c2w), dim=-1)


def get_ndc_rays(height, width, focal, near, rays_o: torch.Tensor,
                 rays_d: torch.Tensor):
    """Rays in normalized device coordinates (reference
    utils/ray_utils.py:133-174): origins moved to the near plane, then
    projected. Returns (rays_o, rays_d)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (width / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (height / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (width / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (height / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def _required(generator: torch.Generator | None,
              what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} requires a torch.Generator")
    return generator


def uniform(shape, generator: torch.Generator, dtype: torch.dtype,
            device) -> torch.Tensor:
    """U[0, 1) of `shape`, drawn on the generator's device and moved to
    `device` (so one seeded generator gives the same numbers wherever the
    render runs)."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device).to(device)


def normal(shape, generator: torch.Generator, dtype: torch.dtype,
           device) -> torch.Tensor:
    """N(0, 1) of `shape`, drawn as `uniform` is."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def coarse_sample_rays(near: float, far: float, rays: torch.Tensor,
                       n_samples: int, use_disp: bool = False,
                       perturb: float = 0.0,
                       generator: torch.Generator | None = None):
    """z values in [near, far], evenly spaced in depth (or in inverse depth
    with `use_disp`), and their points (reference utils/ray_utils.py:
    232-256). `perturb > 0` jitters each sample uniformly inside its bin,
    scaled by `perturb`, from `generator`.

    Returns (z_vals (R, S), xyz (R, S, 3))."""
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=rays.dtype,
                             device=rays.device)
    if not use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    z_vals = z_vals.expand(rays.shape[0], n_samples)
    if perturb > 0:
        gen = _required(generator, "perturb > 0")
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
        u = perturb * uniform(z_vals.shape, gen, z_vals.dtype, rays.device)
        z_vals = lower + (upper - lower) * u
    xyz = rays[:, None, 0:3] + rays[:, None, 3:6] * z_vals[:, :, None]
    return z_vals, xyz


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = True,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-CDF sampling: bins (R, B), weights (R, B-1) -> (R,
    n_samples), at evenly spaced CDF levels with `det`, else at uniform
    levels from `generator`. The CDF is detached, as in the reference."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (R, B)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device)
        u = u.expand(cdf.shape[0], n_samples).contiguous()
    else:
        gen = _required(generator, "sample_pdf(det=False)")
        u = uniform((cdf.shape[0], n_samples), gen, cdf.dtype, cdf.device)
    inds = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def importance_sampling(z_vals: torch.Tensor, weights: torch.Tensor,
                        n_importance: int, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, det: bool = True,
                        generator: torch.Generator | None = None):
    """Fine samples from the coarse weights (reference
    utils/ray_utils.py:222-229): `sample_pdf` over the coarse midpoints
    with weights[:, 1:-1] (random levels from `generator` unless `det`),
    the new samples detached, merged with the coarse z values and sorted.
    Returns (xyz (R, S0 + Si, 3), z_vals (R, S0 + Si))."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[:, 1:-1], n_importance, det=det,
                           generator=generator).detach()
    z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
    xyz = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
    return xyz, z_all


def composite(rgbsigma: torch.Tensor, z_vals: torch.Tensor, rays: torch.Tensor,
              white_background: bool = True, noise_std: float = 0.0,
              generator: torch.Generator | None = None):
    """Composite per-sample (rgb, sigma) (R, S, 4) into pixels.

    `noise_std > 0` adds N(0, noise_std^2) noise from `generator` to the
    sigmas first; the noisy sigmas go to the weights as they are. The
    weights come from `composite_weights` (K5 on the card); rgb, depth
    and the white background are plain torch. Returns (rgb (R, 3),
    depth (R,), weights (R, S))."""
    rgbs = rgbsigma[..., :3]
    sigmas = rgbsigma[..., 3]
    if noise_std > 0.0:
        gen = _required(generator, "noise_std > 0")
        sigmas = sigmas + normal(sigmas.shape, gen, sigmas.dtype,
                                 sigmas.device) * noise_std
    dnorm = torch.linalg.norm(rays[:, 3:], dim=-1)
    weights = composite_weights(sigmas.contiguous(), z_vals.contiguous(),
                                dnorm.contiguous())
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    if white_background:
        rgb = rgb + (1.0 - weights.sum(dim=1)[..., None])
    return rgb, depth, weights
