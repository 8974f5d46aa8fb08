"""Plain PyTorch reference of NeuroFluid's particle-driven renderer (Guan et
al., ICML 2022: `models/renderer.py`, `utils/ray_utils.py`), written from
the method's equations.

Per ray: `n_samples` depths evenly spaced in [near, far]; per sample, the
particles within the search radius (strict d < r) give its local
geometry; a NeRF MLP maps the encoded geometry to (rgb, sigma); a sample
with fewer than K neighbours in radius gets zero (the mask); volume
compositing gives the pixel on a white background. The fine pass draws
`n_importance` depths by inverse-CDF sampling of the coarse weights at
evenly spaced levels, runs the fine NeRF on the coarse and the new
samples, sorted by depth, and composites again.

The local geometry of a sample q, from its first K in-radius particles in
cell-candidate order (cells of the search radius on the grid's lower
corner, the 27 cells around q's cell in the order (x, y, z) = (o // 9 - 1,
o // 3 % 3 - 1, o % 3 - 1), then ascending particle index, cells clamped
to the grid as the dense search clamps them), each weighted by
w = max(1 - (d / r)^3, 0):
- density = sum w + (K - selected) * max(1 - (|q| / r)^3, 0), the
  K-slot ball query's empty slots reading as the origin;
- smoothed position = sum w c / (density + 1e-12);
- variance per axis of the offsets c - q of the selected particles with
  d > 0, over min(count, K).
The encodings are sin/cos at 2^0 .. 2^(F-1) of the sample (F = 10),
density (4), smoothed position (10), variance (10), the ray direction (4)
and the direction from the camera to the smoothed position (4).

The NeRF: 8 layers of 256 with ReLU, the xyz input concatenated back
before the fifth; sigma off the trunk; rgb through a 128-wide layer on the
trunk's last layer and the direction encoding, then a sigmoid.

Compositing: s_i = exp(-delta_i |d| relu(sigma_i)) (the last delta 1e10),
w_i = (1 - s_i) prod_{j < i} (s_j + 1e-10); rgb = sum w rgb + 1 - sum w.

Gradients reach the particles through the selected neighbours' positions
(the selection is discrete) and the weights through sigma (depths are
data). `dense` rounds the operands of every MLP product.

Departures: none beyond the order of f32 sums. Imports nothing but torch
and numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from nfbench.reference.precision import linear

BIG = torch.iinfo(torch.int64).max

# the renderer settings this reference writes out: NeuroFluid's published
# encodings on the dense (K-slot ball query) search
PUBLISHED = {"use_mask": True, "encode_density": True, "encode_var": True,
             "encode_smoothed_pos": True, "encode_smoothed_dir": True,
             "exclude_ray": True, "search_mode": "dense"}


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    out = [x]
    for i in range(n_freqs):
        out += [torch.sin(2.0 ** i * x), torch.cos(2.0 ** i * x)]
    return torch.cat(out, -1)


def _cells(x, lower, dims, size):
    lo = x.new_tensor(lower)
    hi = torch.as_tensor(dims, device=x.device) - 1
    return torch.minimum(torch.clamp(torch.floor((x - lo) / size).long(),
                                     min=0), hi)


def local_geometry(queries, particles, radius: float, k: int, lower, upper,
                   block: int = 2048):
    """(density (Q, 1), smoothed position (Q, 3), variance (Q, 3), count
    (Q,)) of each query; differentiable with respect to `particles`."""
    dims = [int(max(1, np.ceil((u - lo) / radius)))
            for lo, u in zip(lower, upper)]
    r2 = float(np.float32(radius * radius))
    n = particles.shape[0]
    pcell = _cells(particles.detach(), lower, dims, radius)
    index = torch.arange(n, device=particles.device)
    outs = []
    for q0 in range(0, queries.shape[0], block):
        q = queries[q0:q0 + block].detach()
        with torch.no_grad():
            d = particles.detach()[None] - q[:, None]
            within = (d * d).sum(-1) < r2
            dc = pcell[None] - _cells(q, lower, dims, radius)[:, None]
            within &= (dc.abs() <= 1).all(-1)
            o = (dc[..., 0] + 1) * 9 + (dc[..., 1] + 1) * 3 + dc[..., 2] + 1
            key = torch.where(within, o * n + index, BIG)
            key_k, _ = torch.topk(key, k, dim=1, largest=False, sorted=True)
            sel = key_k < BIG
            idx = torch.where(sel, key_k % n, 0)
            count = within.sum(1)
            del d, within, dc, o, key
        c = particles[idx]  # (B, k, 3)
        off = c - q[:, None]
        d2 = (off * off).sum(-1)
        selected = sel.float()
        nn = (sel & (d2 > 0.0)).float()
        u = torch.sqrt(torch.clamp(d2, min=1e-24)) / radius
        w = torch.clamp(1.0 - u ** 3, min=0.0) * selected
        qn = torch.sqrt(torch.clamp((q * q).sum(-1), min=1e-24)) / radius
        w0 = torch.clamp(1.0 - qn ** 3, min=0.0)
        density = w.sum(1) + (k - selected.sum(1)) * w0
        smoothed = (w[..., None] * c).sum(1) / (density[:, None] + 1e-12)
        num = torch.clamp(count, max=k).float()[:, None] + 1e-12
        mean = (nn[..., None] * off).sum(1) / num
        var = (nn[..., None] * (off - mean[:, None]) ** 2).sum(1) / num
        outs.append((density[:, None], smoothed, var, count))
    return tuple(torch.cat(t) for t in zip(*outs))


def features(queries, particles, ro, ray_dirs, rcfg):
    """(encoded xyz features (Q, C_xyz), encoded direction features
    (Q, C_dir), the full-K mask (Q,)); `ray_dirs` per query."""
    density, smoothed, var, count = local_geometry(
        queries, particles, rcfg["search_radius"], rcfg["num_neighbors"],
        rcfg["grid_lower"], rcfg["grid_upper"])
    xyz = torch.cat([encode(queries, 10), encode(density, 4),
                     encode(smoothed, 10), encode(var, 10)], -1)
    sd = smoothed - ro[None]
    sd = sd / (torch.linalg.norm(sd, dim=-1, keepdim=True) + 1e-12)
    dirs = torch.cat([encode(ray_dirs, 4), encode(sd, 4)], -1)
    return xyz, dirs, count >= rcfg["num_neighbors"]


def nerf(p: dict, prefix: str, xyz, dirs, prec: str):
    """(Q, 4) [rgb, sigma] of the NeRF whose parameters are p[prefix...]."""
    def lin(name, x):
        return linear(x, p[f"{prefix}{name}.weight"], p[f"{prefix}{name}.bias"],
                      prec)

    h = xyz
    for i in range(8):
        if i == 4:
            h = torch.cat([xyz, h], -1)
        h = torch.relu(lin(f"xyz_encoding_{i + 1}.0", h))
    sigma = lin("sigma", h)
    feat = lin("xyz_encoding_final", h)
    d = torch.relu(lin("dir_encoding.0", torch.cat([feat, dirs], -1)))
    return torch.cat([torch.sigmoid(lin("rgb.0", d)), sigma], -1)


def composite(rgbsigma, z, rays):
    """(rgb (R, 3), weights (R, S)) on a white background."""
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                      1) * torch.linalg.norm(rays[:, 3:], dim=-1)[:, None]
    s = torch.exp(-delta * torch.relu(rgbsigma[..., 3]))
    trans = torch.cumprod(torch.cat([torch.ones_like(s[:, :1]),
                                     s[:, :-1] + 1e-10], 1), 1)
    w = (1.0 - s) * trans
    rgb = (w[..., None] * rgbsigma[..., :3]).sum(1) + (1.0 - w.sum(1))[:, None]
    return rgb, w


def sample_pdf(bins, weights, n: int):
    """Inverse-CDF depths at n evenly spaced levels in [0, 1]."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(
        cdf.shape[0], n).contiguous()
    i = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo = torch.clamp(i - 1, min=0)
    hi = torch.clamp(i, max=cdf.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    den = c_hi - c_lo
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b_lo + (u - c_lo) / den * (b_hi - b_lo)


def render(p: dict, particles, ro, rays, rcfg, prec: str = "f32"):
    """Coarse and fine RGB (R, 3) each of the rays (R, 6) from camera
    origin `ro` (3,)."""
    n_rays, s0, s1 = rays.shape[0], rcfg["n_samples"], rcfg["n_importance"]
    t = torch.linspace(0.0, 1.0, s0, device=rays.device)
    z0 = (rcfg["near"] * (1.0 - t) + rcfg["far"] * t).expand(n_rays, s0)
    xyz0 = rays[:, None, :3] + rays[:, None, 3:] * z0[..., None]
    dirs0 = rays[:, None, 3:].expand(n_rays, s0, 3).reshape(-1, 3)
    f0, d0, m0 = features(xyz0.reshape(-1, 3), particles, ro, dirs0, rcfg)
    out0 = nerf(p, "nerf_coarse.", f0, d0, prec) * m0[:, None]
    rgb0, w0 = composite(out0.reshape(n_rays, s0, 4), z0, rays)

    z_mid = 0.5 * (z0[:, 1:] + z0[:, :-1])
    z_new = sample_pdf(z_mid, w0[:, 1:-1].detach(), s1).detach()
    xyz1 = rays[:, None, :3] + rays[:, None, 3:] * z_new[..., None]
    dirs1 = rays[:, None, 3:].expand(n_rays, s1, 3).reshape(-1, 3)
    f1, d1, m1 = features(xyz1.reshape(-1, 3), particles, ro, dirs1, rcfg)
    cat = lambda a, b: torch.cat([a.reshape(n_rays, s0, -1),  # noqa: E731
                                  b.reshape(n_rays, s1, -1)], 1)
    f_all, d_all = cat(f0, f1), cat(d0, d1)
    out1 = (nerf(p, "nerf_fine.", f_all.reshape(n_rays * (s0 + s1), -1),
                 d_all.reshape(n_rays * (s0 + s1), -1), prec)
            * cat(m0, m1).reshape(-1, 1)).reshape(n_rays, s0 + s1, 4)
    z1, order = torch.sort(torch.cat([z0, z_new], -1), dim=-1, stable=True)
    out1 = out1.gather(1, order[..., None].expand(-1, -1, 4))
    rgb1, _ = composite(out1, z1, rays)
    return rgb0, rgb1
