"""Plain PyTorch reference of the DeepLagrangianFluids transition model
(Ummenhofer et al., ICLR 2020) as NeuroFluid trains it: one step, the
two-step transition loss, written from the published equations.

One step:
1. semi-implicit Euler with gravity: v' = v + g dt, x' = x + (v + v') / 2 dt;
2. four rounds of continuous convolutions over every neighbour within the
   radius (3 * 1.5 * particle radius): layer 0 is a fluid -> fluid conv on
   [1, v'], a box -> fluid conv on the box normals and a dense layer,
   concatenated as [box, fluid, dense]; layers 1-3 are ReLU, conv + dense,
   and a residual where the widths match; the result is scaled by 1/128;
3. x'' = x' + dx, v'' = (x'' - x) / dt.

A continuous convolution sums, per query and in-radius neighbour, the
neighbour's features into the filter taps: the offset over the radius is
mapped from the unit ball to the unit cube (volume preserving: ball ->
cylinder, then the inverse Shirley-Chiu disc -> square), the cube point
picks 8 taps of the 4 x 4 x 4 filter by trilinear interpolation (Open3D's
align-corners convention: filter axis 0 is z, axis 2 is x), and the poly6
window (1 - d^2/r^2)^3 weights them. The tap sums are then contracted with
the (taps * Cin, Cout) filter.

Neighbours are found by brute force: every candidate with d^2/r^2 <= 1,
the query itself left out by position in a fluid -> fluid conv.

Precision: `conv` rounds both operands of each conv contraction (the
window-weighted taps and the features in the tap sums, the sums and the
filter in the fold) and, in the backward, the incoming cotangent before
each product, as JAX transposes a `DEFAULT` dot; `dense` rounds the
operands of the dense layers. Sums are f32.

Departures, each below f32 rounding: arctan is `torch.atan` (the program
uses a minimax polynomial with |error| <= 1.4e-7); the degenerate offsets
(exactly on the z axis, or zero) are guarded with clamps instead of the
program's branches. Imports nothing but torch and numpy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from nfbench.reference.precision import linear, matmul, rounding

EPS = 1e-8


class Pairs(NamedTuple):
    qi: torch.Tensor  # (P,) query index
    ci: torch.Tensor  # (P,) candidate index


def radius_pairs(queries, cands, radius: float, exclude_self: bool,
                 block: int = 2048) -> Pairs:
    """Every (query, candidate) with d^2/r^2 <= 1 (d > 0 with
    `exclude_self`), the distance taken as the program's conv takes it:
    the offset times the f32 reciprocal of the radius."""
    inv_r = float(np.float32(1.0 / radius))
    q, c = queries.detach(), cands.detach()
    qis, cis = [], []
    for q0 in range(0, q.shape[0], block):
        off = (c[None, :, :] - q[q0:q0 + block, None, :]) * inv_r
        d2 = (off * off).sum(-1)
        ok = d2 <= 1.0
        if exclude_self:
            ok &= d2 > 0.0
        qi, ci = torch.nonzero(ok, as_tuple=True)
        qis.append(qi + q0)
        cis.append(ci)
    return Pairs(torch.cat(qis), torch.cat(cis))


def ball_to_cube(p: torch.Tensor) -> torch.Tensor:
    """Volume-preserving unit ball -> unit cube."""
    x, y, z = p.unbind(-1)
    r = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=EPS * EPS))
    rho = torch.sqrt(torch.clamp(x * x + y * y, min=EPS * EPS))
    cap = 1.25 * z * z > x * x + y * y
    s = torch.where(cap, torch.sqrt(3.0 * r / (r + z.abs() + EPS)), r / rho)
    cx, cy = x * s, y * s
    cz = torch.where(cap, torch.sign(z) * r, 1.5 * z)
    crho = torch.sqrt(torch.clamp(cx * cx + cy * cy, min=EPS * EPS))
    major_x = cx.abs() >= cy.abs()
    safe_x = torch.where(cx.abs() < EPS, torch.ones_like(cx), cx)
    safe_y = torch.where(cy.abs() < EPS, torch.ones_like(cy), cy)
    ux = torch.sign(cx) * crho
    vx = 4.0 / math.pi * ux * torch.atan(torch.clamp(cy / safe_x, -1.0, 1.0))
    vy = torch.sign(cy) * crho
    uy = 4.0 / math.pi * vy * torch.atan(torch.clamp(cx / safe_y, -1.0, 1.0))
    u = torch.where(major_x, ux, uy)
    v = torch.where(major_x, vx, vy)
    return torch.stack([u, v, cz], -1)


def taps(off: torch.Tensor, kernel_size=(4, 4, 4)):
    """(corner (P, 8) flat tap index (tz * ky + ty) * kx + tx, weight
    (P, 8) = trilinear weight x poly6 window) of normalized offsets."""
    kz, ky, kx = kernel_size
    d2 = (off * off).sum(-1)
    window = torch.clamp((1.0 - torch.clamp(d2, max=2.0)) ** 3, 0.0, 1.0)
    size = off.new_tensor([kx, ky, kz])
    t = torch.minimum(torch.clamp((ball_to_cube(off) * 0.5 + 0.5)
                                  * (size - 1.0), min=0.0), size - 1.0)
    lo = torch.minimum(torch.floor(t.detach()), size - 2.0)
    f = t - lo
    lo = lo.long()
    corners, weights = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corners.append(((lo[:, 2] + dz) * ky + lo[:, 1] + dy) * kx
                               + lo[:, 0] + dx)
                weights.append((f[:, 2] if dz else 1.0 - f[:, 2])
                               * (f[:, 1] if dy else 1.0 - f[:, 1])
                               * (f[:, 0] if dx else 1.0 - f[:, 0]))
    return torch.stack(corners, -1), torch.stack(weights, -1) * window[:, None]


class TapSums(torch.autograd.Function):
    """(Nq, taps * Cin) sums of round(w) round(f) over each query's pairs;
    the backward rounds the incoming cotangent, then gives the weights'
    cotangent <ct, round(f)> and the features' sum of round(w) ct."""

    @staticmethod
    def forward(ctx, w, feats, qi, ci, corner, nq, n_taps, name):
        rnd = rounding(name)
        w_r, f_r = rnd(w), rnd(feats)
        cin = feats.shape[1]
        acc = feats.new_zeros((nq * n_taps, cin))
        f_pairs = f_r[ci]
        for c in range(8):
            acc.index_add_(0, qi * n_taps + corner[:, c],
                           w_r[:, c, None] * f_pairs)
        ctx.save_for_backward(w_r, f_r, qi, ci, corner)
        ctx.shape = (nq, n_taps, cin, name)
        return acc.reshape(nq, n_taps * cin)

    @staticmethod
    def backward(ctx, ct):
        w_r, f_r, qi, ci, corner = ctx.saved_tensors
        nq, n_taps, cin, name = ctx.shape
        g = rounding(name)(ct).reshape(nq * n_taps, cin)
        f_pairs = f_r[ci]
        g_w = torch.zeros_like(w_r) if ctx.needs_input_grad[0] else None
        g_f = torch.zeros_like(f_r) if ctx.needs_input_grad[1] else None
        for c in range(8):
            rows = g[qi * n_taps + corner[:, c]]
            if g_w is not None:
                g_w[:, c] = (rows * f_pairs).sum(-1)
            if g_f is not None:
                g_f.index_add_(0, ci, w_r[:, c, None] * rows)
        return g_w, g_f, None, None, None, None, None, None


def conv(kernel, bias, queries, cands, feats, pairs: Pairs, radius: float,
         name: str):
    """One continuous convolution of `feats` at `cands` onto `queries`."""
    kz, ky, kx, cin, cout = kernel.shape
    n_taps = kz * ky * kx
    inv_r = float(np.float32(1.0 / radius))
    off = (cands[pairs.ci] - queries[pairs.qi]) * inv_r
    corner, w = taps(off, (kz, ky, kx))
    acc = TapSums.apply(w, feats, pairs.qi, pairs.ci, corner,
                        queries.shape[0], n_taps, name)
    return matmul(acc, kernel.reshape(n_taps * cin, cout), name) + bias


class Precision(NamedTuple):
    conv: str
    dense: str


def step(p: dict, pos, vel, box, box_normals, model: dict, prec: Precision):
    """One transition step with the parameters `p` (the program's names).
    Returns (pos, vel, in-radius fluid neighbour counts)."""
    dt = model["timestep"]
    radius = 3.0 * model["radius_scale"] * model["particle_radius"]
    g = pos.new_tensor(model["gravity"])
    vel_new = vel + g * dt
    pos_new = pos + (vel + vel_new) / 2.0 * dt
    fluid = torch.cat([torch.ones_like(pos_new[:, :1]), vel_new], -1)
    ff = radius_pairs(pos_new, pos_new, radius, True)
    fb = radius_pairs(pos_new, box, radius, False)
    counts = torch.bincount(ff.qi, minlength=pos.shape[0]).float()
    ans_fluid = conv(p["conv0_fluid.kernel"], p["conv0_fluid.bias"], pos_new,
                     pos_new, fluid, ff, radius, prec.conv)
    ans_box = conv(p["conv0_obstacle.kernel"], p["conv0_obstacle.bias"],
                   pos_new, box, box_normals, fb, radius, prec.conv)
    dense = linear(fluid, p["dense0_fluid.weight"], p["dense0_fluid.bias"],
                   prec.dense)
    h = torch.cat([ans_box, ans_fluid, dense], -1)
    for i in range(1, len(model["layer_channels"])):
        inp = torch.relu(h)
        out = (conv(p[f"conv{i}.kernel"], p[f"conv{i}.bias"], pos_new,
                    pos_new, inp, ff, radius, prec.conv)
               + linear(inp, p[f"dense{i}.weight"], p[f"dense{i}.bias"],
                        prec.dense))
        h = out + h if out.shape[-1] == h.shape[-1] else out
    pos_c = pos_new + model["correction_scale"] * h
    return pos_c, (pos_c - pos) / dt, counts


def box_bounds(particle_radius: float, device):
    """NeuroFluid's container, less a particle radius: x, y in +-(1 - r),
    z in [-1 + r, 2.4552 - r]."""
    r = particle_radius
    return (torch.tensor([-1.0 + r, -1.0 + r, -1.0 + r], device=device),
            torch.tensor([1.0 - r, 1.0 - r, 2.4552 - r], device=device))


def boundary_loss(pos, bounds):
    lo, hi = bounds
    return torch.mean(torch.abs(pos - torch.minimum(torch.maximum(pos, lo),
                                                    hi)))


def weighted_distance(pred, gt, counts):
    """mean(exp(-n / 40) * |pred - gt|^0.5), |.| with a 1e-12 floor under
    the root."""
    dist = torch.sqrt(((pred - gt) ** 2).sum(-1) + 1e-12)
    return torch.mean(torch.exp(-counts / 40.0) * dist ** 0.5)


def transition_loss(p, frame, box, box_normals, model, prec):
    """Two chained steps from (pos0, vel0), the gradient through both:
    0.5 d(pred1, pos1) + 0.5 d(pred2, pos2) + boundary(pred1) +
    boundary(pred2)."""
    pos0, vel0, pos1, pos2 = frame
    bounds = box_bounds(model["particle_radius"], pos0.device)
    pred1, v1, n1 = step(p, pos0, vel0, box, box_normals, model, prec)
    pred2, _, n2 = step(p, pred1, v1, box, box_normals, model, prec)
    return (0.5 * weighted_distance(pred1, pos1, n1)
            + 0.5 * weighted_distance(pred2, pos2, n2)
            + boundary_loss(pred1, bounds) + boundary_loss(pred2, bounds))
