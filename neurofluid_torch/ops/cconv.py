"""Continuous-convolution geometry (port of neurofluid_tpu/ops/cconv.py):
the volume-preserving ball -> cube map, the poly6 window and the trilinear
filter taps, as used by the plain fused conv, and their adjoints derived by
hand (the backward of the fused conv, K2 and its plain version, pushes the
tap-weight cotangent of every pair through them); and the continuous
convolution over a neighbour list (`cconv_geometry`, `cconv_tap_matrix`,
`continuous_conv_apply`), differentiable by autograd with respect to the
filter, the features and the positions, the neighbour gathers' adjoint being
the segment sum of `segment_ops` (K8 on the card).

The disc -> square step uses the odd minimax polynomial `atan01` of the
TPU kernel (neurofluid_tpu/ops/fused_cconv.py `_atan01`, |error| <= 1.4e-7
on [-1, 1]) on the clamped ratio, so the plain conv agrees with the kernel
to f32 rounding.

The adjoints are those of the plain forward as written, branch by branch:
the selected branch of every `where` is differentiated, sign' = abs'(0) =
0, a clamp passes the gradient where its input lies inside the closed
range, and the degenerate (coincident) offset gets zero. They agree with
JAX's autodiff of `fused_cconv._slab_contrib` except on measure-zero kinks
(the hat-form taps there, corner/fraction taps here).

The contractions take the JAX package's precision names (`PRECISIONS`,
`conv_bf16`): at 'default' both operands of each are rounded to bf16 and
the product is summed in f32 (`bf16_product`), what the TPU's one `DEFAULT`
MXU pass computes; 'high' and 'highest' are f32 products. (JAX's list conv
runs 'high' as bf16_3x, about 1e-6 relative: the port keeps it f32.)
"""

from __future__ import annotations

import math

import torch

from neurofluid_torch.ops import segment_ops
from neurofluid_torch.ops.neighbor_search import NeighborList
from neurofluid_torch.utils.profiling import sync_span

EPS = 1e-8
# the JAX package's precision names of the conv contractions
# (jax.lax.Precision)
PRECISIONS = ("default", "high", "highest")
ATAN_COEFFS = (
    9.999999880828e-01, -3.333312078100e-01, 1.999371614268e-01,
    -1.421319619692e-01, 1.068142103287e-01, -7.596809867133e-02,
    4.385559905435e-02, -1.682744852802e-02, 3.049968069371e-03,
)


def atan01(t: torch.Tensor) -> torch.Tensor:
    """arctan(t) for t in [-1, 1]."""
    u = t * t
    acc = torch.full_like(u, ATAN_COEFFS[-1])
    for c in ATAN_COEFFS[-2::-1]:
        acc = acc * u + c
    return acc * t


def atan01_grad(t: torch.Tensor) -> torch.Tensor:
    """d atan01 / dt: the derivative of the odd polynomial sum_i c_i t^(2i+1)."""
    u = t * t
    n = len(ATAN_COEFFS)
    acc = torch.full_like(u, (2 * n - 1) * ATAN_COEFFS[-1])
    for i in range(n - 2, -1, -1):
        acc = acc * u + (2 * i + 1) * ATAN_COEFFS[i]
    return acc


def map_sphere_to_cylinder(xyz: torch.Tensor) -> torch.Tensor:
    """Volume-preserving unit ball -> unit cylinder: the cap region
    (5/4 z^2 > x^2 + y^2) maps to the end discs, the side band to the
    lateral surface; the origin maps to 0."""
    x, y, z = xyz.unbind(-1)
    sq_norm = x * x + y * y + z * z
    degenerate = sq_norm < EPS * EPS
    norm = torch.sqrt(torch.where(degenerate, 1.0, sq_norm))
    rho2 = x * x + y * y
    cap = 1.25 * z * z > rho2
    s_cap = torch.sqrt(3.0 * norm / (norm + torch.abs(z) + EPS))
    s_side = norm / torch.sqrt(torch.clamp(rho2, min=EPS * EPS))
    out = torch.stack([
        torch.where(cap, x * s_cap, x * s_side),
        torch.where(cap, y * s_cap, y * s_side),
        torch.where(cap, torch.sign(z) * norm, 1.5 * z),
    ], dim=-1)
    return torch.where(degenerate[..., None], 0.0, out)


def map_cylinder_to_cube(xyz: torch.Tensor) -> torch.Tensor:
    """Area-preserving disc -> square on (x, y) (inverse Shirley-Chiu), z
    unchanged."""
    x, y, z = xyz.unbind(-1)
    rho2 = x * x + y * y
    degenerate = rho2 < EPS * EPS
    rho = torch.sqrt(torch.where(degenerate, 1.0, rho2))
    x_ge = torch.abs(x) >= torch.abs(y)
    safe_x = torch.where(torch.abs(x) < EPS, 1.0, x)
    safe_y = torch.where(torch.abs(y) < EPS, 1.0, y)
    a1 = torch.sign(x) * rho
    b1 = (4.0 / math.pi) * a1 * atan01(torch.clamp(y / safe_x, -1.0, 1.0))
    b2 = torch.sign(y) * rho
    a2 = (4.0 / math.pi) * b2 * atan01(torch.clamp(x / safe_y, -1.0, 1.0))
    u = torch.where(degenerate, 0.0, torch.where(x_ge, a1, a2))
    v = torch.where(degenerate, 0.0, torch.where(x_ge, b1, b2))
    return torch.stack([u, v, z], dim=-1)


def ball_to_cube_volume_preserving(xyz: torch.Tensor) -> torch.Tensor:
    return map_cylinder_to_cube(map_sphere_to_cylinder(xyz))


def window_poly6(normalized_sq_dist: torch.Tensor) -> torch.Tensor:
    """clamp((1 - d^2/r^2)^3, 0, 1)."""
    t = 1.0 - normalized_sq_dist
    return torch.clamp(t * t * t, 0.0, 1.0)


def window_poly6_grad(normalized_sq_dist: torch.Tensor) -> torch.Tensor:
    """d window_poly6 / d(d^2/r^2)."""
    t = 1.0 - normalized_sq_dist
    t3 = t * t * t
    return torch.where((t3 >= 0.0) & (t3 <= 1.0), -3.0 * t * t, 0.0)


def trilinear_taps(cube_xyz: torch.Tensor, kernel_size: tuple):
    """Corner/fraction form of trilinear interpolation on the filter grid
    (align_corners=True). kernel_size (kz, ky, kx), Open3D axis convention:
    filter axis 0 <- z, 1 <- y, 2 <- x. Returns (corner (..., 8) flat tap
    index (tz * ky + ty) * kx + tx, weight (..., 8)), corners ordered z
    outer, x inner."""
    kz, ky, kx = kernel_size
    # each copy of a host constant to the device waits for the stream
    with sync_span("sync.tap_sizes", cube_xyz.device):
        sizes = cube_xyz.new_tensor([kx, ky, kz])
    t = (cube_xyz * 0.5 + 0.5) * (sizes - 1.0)
    t = torch.minimum(torch.clamp(t, min=0.0), sizes - 1.0)
    with sync_span("sync.tap_corner_max", cube_xyz.device):
        corner_max = torch.as_tensor([kx - 2, ky - 2, kz - 2],
                                     device=t.device)
    i0 = torch.minimum(torch.floor(t).long().clamp(min=0), corner_max)
    frac = t - i0.to(t.dtype)
    ix, iy, iz = i0.unbind(-1)
    fx, fy, fz = frac.unbind(-1)
    corners, weights = [], []
    for dz, wz in ((0, 1.0 - fz), (1, fz)):
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                corners.append(((iz + dz) * ky + iy + dy) * kx + ix + dx)
                weights.append(wz * wy * wx)
    return torch.stack(corners, dim=-1), torch.stack(weights, dim=-1)


def trilinear_taps_vjp(cube_xyz: torch.Tensor, kernel_size: tuple,
                       g_weights: torch.Tensor) -> torch.Tensor:
    """Adjoint of `trilinear_taps`' weights: (..., 8) cotangent on the
    corner weights -> (..., 3) cotangent on the cube point. The corner
    indices are discrete."""
    kz, ky, kx = kernel_size
    with sync_span("sync.tap_sizes", cube_xyz.device):
        sizes = cube_xyz.new_tensor([kx, ky, kz])
    t_raw = (cube_xyz * 0.5 + 0.5) * (sizes - 1.0)
    t = torch.minimum(torch.clamp(t_raw, min=0.0), sizes - 1.0)
    with sync_span("sync.tap_corner_max", cube_xyz.device):
        corner_max = torch.as_tensor([kx - 2, ky - 2, kz - 2],
                                     device=t.device)
    i0 = torch.minimum(torch.floor(t).long().clamp(min=0), corner_max)
    fx, fy, fz = (t - i0.to(t.dtype)).unbind(-1)
    g = g_weights.unbind(-1)
    g_f = [torch.zeros_like(fx) for _ in range(3)]  # x, y, z
    c = 0
    for dz, wz in ((0, 1.0 - fz), (1, fz)):
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                sx, sy, sz = (1.0 if d else -1.0 for d in (dx, dy, dz))
                g_f[0] = g_f[0] + g[c] * (sx * wz * wy)
                g_f[1] = g_f[1] + g[c] * (sy * wz * wx)
                g_f[2] = g_f[2] + g[c] * (sz * wy * wx)
                c += 1
    inside = (t_raw >= 0.0) & (t_raw <= sizes - 1.0)
    return torch.where(inside, torch.stack(g_f, -1) * (0.5 * (sizes - 1.0)),
                       0.0)


def ball_to_cube_vjp(xyz: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Adjoint of `ball_to_cube_volume_preserving` at `xyz`: (..., 3)
    cotangent on the cube point -> (..., 3) on `xyz`."""
    x, y, z = xyz.unbind(-1)
    gu, gv, gw = g.unbind(-1)
    # ball -> cylinder, forward
    sq_norm = x * x + y * y + z * z
    degenerate = sq_norm < EPS * EPS
    norm = torch.sqrt(torch.where(degenerate, 1.0, sq_norm))
    rho2 = x * x + y * y
    cap = 1.25 * z * z > rho2
    den = norm + torch.abs(z) + EPS
    s_cap = torch.sqrt(3.0 * norm / den)
    m = torch.sqrt(torch.clamp(rho2, min=EPS * EPS))
    s = torch.where(cap, s_cap, norm / m)
    cx = torch.where(degenerate, 0.0, x * s)
    cy = torch.where(degenerate, 0.0, y * s)
    # cylinder -> cube, forward: `lead` is the output on the wedge's major
    # axis, the other output is 4/pi * lead * atan01(ratio)
    crho2 = cx * cx + cy * cy
    cdeg = crho2 < EPS * EPS
    crho = torch.sqrt(torch.where(cdeg, 1.0, crho2))
    x_ge = torch.abs(cx) >= torch.abs(cy)
    num = torch.where(x_ge, cy, cx)
    dnm = torch.where(x_ge, cx, cy)
    small = torch.abs(dnm) < EPS
    safe = torch.where(small, 1.0, dnm)
    ratio_raw = num / safe
    ratio = torch.clamp(ratio_raw, -1.0, 1.0)
    lead = torch.sign(dnm) * crho
    k4 = 4.0 / math.pi
    # cylinder -> cube, backward
    g_lead_out = torch.where(x_ge, gu, gv)
    g_other = torch.where(x_ge, gv, gu)
    g_crho = (g_lead_out + g_other * k4 * atan01(ratio)) * torch.sign(dnm)
    g_ratio = g_other * k4 * lead * atan01_grad(ratio)
    g_ratio = torch.where((ratio_raw >= -1.0) & (ratio_raw <= 1.0), g_ratio,
                          0.0)
    g_num = g_ratio / safe
    g_dnm = torch.where(small, 0.0, -g_ratio * ratio_raw / safe)
    g_cx = torch.where(x_ge, g_dnm, g_num) + g_crho * cx / crho
    g_cy = torch.where(x_ge, g_num, g_dnm) + g_crho * cy / crho
    g_cx = torch.where(cdeg, 0.0, g_cx)
    g_cy = torch.where(cdeg, 0.0, g_cy)
    # ball -> cylinder, backward
    g_s = g_cx * x + g_cy * y
    g_x, g_y = g_cx * s, g_cy * s
    # cap: s = sqrt(3 norm / den), den = norm + |z| + eps, cz = sign(z) norm
    g_v = g_s / (2.0 * s_cap)
    g_norm_cap = gw * torch.sign(z) + g_v * 3.0 / den * (1.0 - norm / den)
    g_z_cap = -g_v * 3.0 * norm / (den * den) * torch.sign(z)
    # side: s = norm / m, m = sqrt(max(rho2, eps^2)), cz = 1.5 z
    g_m = torch.where(rho2 >= EPS * EPS, -g_s * norm / (m * m * m), 0.0)
    g_norm = torch.where(cap, g_norm_cap, g_s / m)
    g_x = g_x + torch.where(cap, 0.0, g_m * x)
    g_y = g_y + torch.where(cap, 0.0, g_m * y)
    g_z = torch.where(cap, g_z_cap, 1.5 * gw)
    # norm = sqrt(x^2 + y^2 + z^2)
    out = torch.stack([g_x, g_y, g_z], -1) + (g_norm / norm)[..., None] * xyz
    return torch.where(degenerate[..., None], 0.0, out)


def conv_bf16(precision) -> bool:
    """Whether the conv contractions at `precision` (a name of PRECISIONS,
    any case) take bf16-rounded operands: 'default' only. An unknown name
    raises."""
    name = str(precision).lower()
    if name not in PRECISIONS:
        raise ValueError(f"unknown conv precision {precision!r}: expected "
                         f"one of {PRECISIONS}")
    return name == "default"


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (8 exponent, 7 mantissa bits; ties to
    even, as `lax.reduce_precision(x, 8, 7)`), kept in f32."""
    return x.to(torch.bfloat16).to(x.dtype)


class Bf16Product(torch.autograd.Function):
    """a @ b (matrices or a batch of them) of the bf16-rounded operands,
    products and sums in f32; the backward rounds the cotangent and the
    other operand before each product, as JAX transposes a `DEFAULT` dot:
    da = bf(ct) bf(b)^T, db = bf(a)^T bf(ct). Autograd through `.to(bf16)`
    casts would round each cotangent after its product instead."""

    @staticmethod
    def forward(ctx, a, b):
        a_r, b_r = bf16_round(a), bf16_round(b)
        ctx.save_for_backward(a_r, b_r)
        return a_r @ b_r

    @staticmethod
    def backward(ctx, ct):
        a_r, b_r = ctx.saved_tensors
        ct_r = bf16_round(ct)
        da = ct_r @ b_r.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        db = a_r.transpose(-1, -2) @ ct_r if ctx.needs_input_grad[1] else None
        return da, db


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`Bf16Product`: the list conv's contractions at 'default'. The
    products are plain in the JAX package too (outside Pallas), so they run
    as torch.matmul on the rounded operands, TF32 off."""
    return Bf16Product.apply(a, b)


def tap_weights(off: torch.Tensor, kernel_size: tuple):
    """Per pair of normalized offset `off` (..., 3): (corner (..., 8), the 8
    trilinear tap weights times the poly6 window (..., 8)). The window
    reads min(d^2/r^2, 2), so far pairs keep finite derivatives."""
    d2n = off[..., 0] * off[..., 0] + off[..., 1] * off[..., 1] \
        + off[..., 2] * off[..., 2]
    win = window_poly6(torch.clamp(d2n, max=2.0))
    corner, w8 = trilinear_taps(ball_to_cube_volume_preserving(off),
                                kernel_size)
    return corner, w8 * win[..., None]


def tap_weights_vjp(off: torch.Tensor, kernel_size: tuple,
                    g_weights: torch.Tensor) -> torch.Tensor:
    """Adjoint of `tap_weights`: (..., 8) cotangent on the windowed tap
    weights -> (..., 3) cotangent on `off`."""
    d2n = off[..., 0] * off[..., 0] + off[..., 1] * off[..., 1] \
        + off[..., 2] * off[..., 2]
    win = window_poly6(torch.clamp(d2n, max=2.0))
    cube = ball_to_cube_volume_preserving(off)
    _, w8 = trilinear_taps(cube, kernel_size)
    g_win = (g_weights * w8).sum(-1)
    g_off = ball_to_cube_vjp(off, trilinear_taps_vjp(
        cube, kernel_size, g_weights * win[..., None]))
    g_d2n = torch.where(d2n <= 2.0, g_win * window_poly6_grad(
        torch.clamp(d2n, max=2.0)), 0.0)
    return g_off + (2.0 * g_d2n)[..., None] * off


def cconv_geometry(points: torch.Tensor, queries: torch.Tensor,
                   neighbors: NeighborList, extent: float,
                   kernel_size: tuple = (4, 4, 4),
                   plan: segment_ops.AdjointPlan | None = None):
    """What a conv over `neighbors` needs of the positions, computed once
    and shared by every layer on the same list: (corner (Q, K, 8) flat tap
    ids, discrete; tapw (Q, K, 8) trilinear tap weights times the poly6
    window, 0 at masked slots, differentiable with respect to `points` and
    `queries`). `extent` is the full filter extent (radius = extent / 2);
    `plan` the shared `segment_ops.AdjointPlan(neighbors.idx, N)`."""
    radius = extent / 2.0
    if plan is None:
        plan = segment_ops.AdjointPlan(neighbors.idx, points.shape[0])
    if neighbors.xyz is not None:
        nb = segment_ops.gather3_values(points, neighbors.idx, *neighbors.xyz,
                                        plan)
    else:
        nb = segment_ops.take_rows_planned(points, neighbors.idx,
                                           plan).unbind(-1)
    off = torch.stack([
        torch.where(neighbors.mask, (nb[ax] - queries[:, ax, None]) / radius,
                    0.0) for ax in range(3)], dim=-1)
    norm_sq = off[..., 0] ** 2 + off[..., 1] ** 2 + off[..., 2] ** 2
    corner, w8 = trilinear_taps(ball_to_cube_volume_preserving(off),
                                kernel_size)
    win = torch.where(neighbors.mask, window_poly6(norm_sq), 0.0)
    return corner, w8 * win[..., None]


def cconv_tap_matrix(corner: torch.Tensor, tapw: torch.Tensor,
                     num_taps: int) -> torch.Tensor:
    """Dense per-pair tap weights tw (Q, T, K): tw[q, t, k] = sum_j
    tapw[q, k, j] * [corner[q, k, j] == t]. It depends on the positions
    only, so the layers that share a neighbour list share it. Taps come
    before neighbours so that `tw @ feats` is a batched matrix product as it
    stands. A pair's 8 corners are 8 different taps, so the scatter has no
    collisions and its sums no order."""
    q, k = corner.shape[:2]
    tw = tapw.new_zeros((q, num_taps, k))
    return tw.scatter_add(1, corner.transpose(1, 2), tapw.transpose(1, 2))


def continuous_conv_apply(filters: torch.Tensor, corner, tapw,
                          feats: torch.Tensor, neighbors: NeighborList,
                          plan: segment_ops.AdjointPlan | None = None,
                          tap_matrix: torch.Tensor | None = None,
                          precision: str = "highest"):
    """Contract one layer's features against the shared geometry.

    filters (kz, ky, kx, Cin, Cout); corner/tapw from `cconv_geometry`, or
    `tap_matrix` (Q, T, K) from `cconv_tap_matrix`, then corner/tapw are
    ignored; feats (N, Cin), gathered at neighbors.idx (zero rows at masked
    slots). Returns (Q, Cout):

        basis[q, t, c] = sum_k tw[q, t, k] * feats[idx[q, k], c]
        out[q, o]      = sum_{t, c} basis[q, t, c] * filters[t, c, o]

    Both contractions are plain matrix products, as in the JAX package; at
    `precision` 'default' of bf16-rounded operands (`bf16_product`)."""
    bf16 = conv_bf16(precision)
    *ks, cin, cout = filters.shape
    num_taps = math.prod(ks)
    if plan is None:
        plan = segment_ops.AdjointPlan(neighbors.idx, feats.shape[0])
    nb_feats = segment_ops.take_rows_planned(feats, neighbors.idx, plan)
    tw = tap_matrix if tap_matrix is not None else cconv_tap_matrix(
        corner, tapw, num_taps)
    w2 = filters.reshape(num_taps * cin, cout)
    if bf16:
        basis = bf16_product(tw, nb_feats)  # (Q, T, Cin)
        return bf16_product(basis.reshape(-1, num_taps * cin), w2)
    basis = torch.bmm(tw, nb_feats)  # (Q, T, Cin)
    return basis.reshape(-1, num_taps * cin) @ w2


def continuous_conv(filters: torch.Tensor, points: torch.Tensor,
                    feats: torch.Tensor, queries: torch.Tensor,
                    neighbors: NeighborList, extent: float) -> torch.Tensor:
    """One continuous convolution in one call (Open3D ContinuousConv,
    normalize=False): the geometry of `neighbors` (a list of `points`
    around `queries`, searched at radius extent / 2) and its contraction
    with filters (kz, ky, kx, Cin, Cout) and feats (N, Cin); (Q, Cout).
    Layers that share a list should call `cconv_geometry` once and
    `continuous_conv_apply` per layer."""
    plan = segment_ops.AdjointPlan(neighbors.idx, points.shape[0])
    corner, tapw = cconv_geometry(points, queries, neighbors, extent,
                                  tuple(filters.shape[:3]), plan)
    return continuous_conv_apply(filters, corner, tapw, feats, neighbors,
                                 plan=plan)
