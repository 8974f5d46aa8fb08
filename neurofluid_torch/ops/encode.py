"""K10: the render's feature encoding (`csrc/encode.cu`), each sample's
NeRF input row written once from its local geometry, with its backward
(`EncodeFeatures`), and the plain version of each.

A row holds, in this order, the positional encoding (`models/embedding.py`:
[v, sin(2^0 v), cos(2^0 v), sin(2^1 v), ...]) of the sample position
(`xyz_freqs`), its density (`density_freqs`) where `density`, the smoothed
position (`xyz_freqs`) where `smoothed_pos`, the neighbour-offset variance
(`xyz_freqs`) where `var`; then, unless `sigma_only`, of the ray direction
(`dir_freqs`) and, where `smoothed_dir`, of the direction from the camera
origin to the smoothed position, normalised (`dir_freqs`). Checkpoints
depend on this order.

A render pass encodes its samples from one source of geometry; the fine
pass encodes the coarse samples and its new ones from two, ray by ray: row
r (s0 + s1) + s is source 0's row r s0 + s for s < s0, else source 1's row
r s1 + s - s0, so its NeRF's input is written once, with no concatenation.

`encode_features` launches K10 for CUDA tensors (f32 only; anything else
raises) and runs the plain composition on the CPU: `positional_encoding`
and the concatenations, whose autograd is the CPU's backward. On the card
the ray direction and the camera origin get no gradient: they are data, and
a call with either asking for one raises. `encode_features_bwd_plain` is
the backward kernel's plain twin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from neurofluid_torch.cuda import Kernel
from neurofluid_torch.models.embedding import (
    embedding_channels, positional_encoding,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("encode.cu", "nf_encode_fwd", [_P, _I])
BWD_KERNEL = Kernel("encode.cu", "nf_encode_bwd", [_P, _I])
N_ARGS = 36  # int64 entries of a call's table (`kArgs`)
MAX_FREQS = 24  # frequencies of an encoding at most (`kMaxFreqs`)
MAX_WIDTH = 1024  # columns of a row at most (`kMaxWidth`)
# flags of a call (`kFlag*`)
DENSITY, SMOOTHED_POS, VAR, SMOOTHED_DIR, SIGMA_ONLY = 1, 2, 4, 8, 16


class Geometry(NamedTuple):
    """The local geometry of R * S samples, rows ray by ray: xyz (N, 3),
    density (N, 1), smoothed_pos (N, 3), var (N, 3) or None where it is
    not encoded."""
    xyz: torch.Tensor
    density: torch.Tensor
    smoothed_pos: torch.Tensor
    var: torch.Tensor | None


class Encoding(NamedTuple):
    """Frequencies of each encoding and which of them a row holds."""
    xyz_freqs: int
    density_freqs: int
    dir_freqs: int
    density: bool = True
    smoothed_pos: bool = True
    var: bool = True
    smoothed_dir: bool = True

    def flags(self, sigma_only: bool) -> int:
        return (DENSITY * self.density + SMOOTHED_POS * self.smoothed_pos
                + VAR * self.var + SMOOTHED_DIR * self.smoothed_dir
                + SIGMA_ONLY * sigma_only)

    def width(self, sigma_only: bool) -> int:
        """Columns of a row."""
        c = embedding_channels(3, self.xyz_freqs) * (
            1 + self.smoothed_pos + self.var)
        if self.density:
            c += embedding_channels(1, self.density_freqs)
        if not sigma_only:
            c += embedding_channels(3, self.dir_freqs) * (
                1 + self.smoothed_dir)
        return c


def smoothed_dir(smoothed_pos: torch.Tensor, ro: torch.Tensor) -> torch.Tensor:
    """The unit direction from the camera origin to each smoothed
    position."""
    sd = smoothed_pos - ro[None, :]
    return sd / (torch.linalg.norm(sd, dim=-1, keepdim=True) + 1e-12)


def _encode_plain(g: Geometry, rays, ro, enc: Encoding, sigma_only: bool):
    pos_feats = [positional_encoding(g.xyz, enc.xyz_freqs)]
    if enc.density:
        pos_feats.append(positional_encoding(g.density, enc.density_freqs))
    if enc.smoothed_pos:
        pos_feats.append(positional_encoding(g.smoothed_pos, enc.xyz_freqs))
    if enc.var:
        pos_feats.append(positional_encoding(g.var, enc.xyz_freqs))
    if sigma_only:
        return torch.cat(pos_feats, dim=-1)
    hit_dir = positional_encoding(rays[:, 3:], enc.dir_freqs)
    n_s = g.xyz.shape[0] // rays.shape[0]
    dir_feats = [torch.repeat_interleave(hit_dir, n_s, dim=0)]
    if enc.smoothed_dir:
        dir_feats.append(positional_encoding(
            smoothed_dir(g.smoothed_pos, ro), enc.dir_freqs))
    return torch.cat(pos_feats + dir_feats, dim=-1)


def encode_features_plain(sources: list, rays: torch.Tensor, ro: torch.Tensor,
                          enc: Encoding, sigma_only: bool = False):
    """The rows of `sources` (one or two `Geometry`) for rays (R, 6) and the
    camera origin ro (3,): each source's encoding, then, for two, their
    concatenation ray by ray."""
    parts = [_encode_plain(g, rays, ro, enc, sigma_only) for g in sources]
    if len(parts) == 1:
        return parts[0]
    n_rays, c = rays.shape[0], parts[0].shape[-1]
    return torch.cat([p.reshape(n_rays, -1, c) for p in parts],
                     dim=1).reshape(-1, c)


def _block_vjp(v, g, col, n_freqs, absolute):
    """The cotangent of v (N, C) from the columns of its encoding that start
    at `col` of g, and the column after them: g's identity column, then per
    frequency 2^k (cos(2^k v) g_sin - sin(2^k v) g_cos); `absolute` sums
    the terms' magnitudes instead."""
    c = v.shape[1]
    d = g[:, col:col + c]
    d = d.abs() if absolute else d
    col += c
    for k in range(n_freqs):
        fx = float(2.0 ** k) * v
        a = torch.cos(fx) * g[:, col:col + c]
        b = torch.sin(fx) * g[:, col + c:col + 2 * c]
        d = d + float(2.0 ** k) * ((a.abs() + b.abs()) if absolute else a - b)
        col += 2 * c
    return d, col


def encode_features_bwd_plain(sources: list, rays, ro, enc: Encoding,
                              sigma_only: bool, g: torch.Tensor,
                              absolute: bool = False) -> list:
    """The backward kernel's plain twin: per source a `Geometry` of the
    cotangents of its inputs from the rows' cotangent g, None where an
    input is not encoded. The smoothed direction's cotangent goes through
    its normalisation (u = smoothed - ro, e = |u| + 1e-12: d u = d sd / e -
    u (u . d sd) / (e^2 |u|)) into the smoothed position's. `absolute`:
    each cotangent as the sum of its terms' magnitudes (the scale a
    tolerance is set against)."""
    n_rays = rays.shape[0]
    samples = [s.xyz.shape[0] // n_rays for s in sources]
    rows = g.reshape(n_rays, sum(samples), g.shape[-1]).split(samples, dim=1)
    out = []
    for src, gs in zip(sources, rows):
        gs = gs.reshape(-1, g.shape[-1])
        d_xyz, col = _block_vjp(src.xyz, gs, 0, enc.xyz_freqs, absolute)
        d_density = d_sp = d_var = None
        if enc.density:
            d_density, col = _block_vjp(src.density, gs, col,
                                        enc.density_freqs, absolute)
        if enc.smoothed_pos:
            d_sp, col = _block_vjp(src.smoothed_pos, gs, col, enc.xyz_freqs,
                                   absolute)
        if enc.var:
            d_var, col = _block_vjp(src.var, gs, col, enc.xyz_freqs, absolute)
        if not sigma_only and enc.smoothed_dir:
            col += embedding_channels(3, enc.dir_freqs)  # the ray direction's
            d_sd, _ = _block_vjp(smoothed_dir(src.smoothed_pos, ro), gs, col,
                                 enc.dir_freqs, absolute)
            u = src.smoothed_pos - ro[None, :]
            n = torch.linalg.norm(u, dim=-1, keepdim=True)
            e = n + 1e-12
            dot = ((u * d_sd).abs() if absolute else u * d_sd).sum(
                -1, keepdim=True)
            coef = torch.where(n > 0, dot / (e * e * n), 0.0)
            d_u = d_sd / e + (u.abs() * coef if absolute else -u * coef)
            d_sp = d_u if d_sp is None else d_sp + d_u
        out.append(Geometry(d_xyz, d_density, d_sp, d_var))
    return out


def _rows(name: str, t, n: int, width: int, dev) -> None:
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                         f"float32 on {dev}")
    if t.shape != (n, width) or (t.stride(1) != 1 and width > 1):
        raise ValueError(f"{name} must be ({n}, {width}) with contiguous "
                         f"rows, not shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


def _check(sources, rays, ro, enc: Encoding, sigma_only: bool) -> None:
    """Raise unless K10 takes the call."""
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"rays are on {dev}, expected a CUDA device")
    if not 1 <= len(sources) <= 2:
        raise ValueError(f"{len(sources)} sources: K10 reads one or two")
    n_rays = rays.shape[0]
    _rows("rays", rays, n_rays, 6, dev)
    if ro.device != dev or ro.dtype != torch.float32 or ro.shape != (3,):
        raise ValueError(f"ro is {ro.dtype} {tuple(ro.shape)} on "
                         f"{ro.device}, expected float32 (3,) on {dev}")
    if not all(0 <= f <= MAX_FREQS for f in enc[:3]):
        raise ValueError(f"frequencies {tuple(enc[:3])}: at most {MAX_FREQS}")
    if enc.width(sigma_only) > MAX_WIDTH:
        raise ValueError(f"rows of {enc.width(sigma_only)} columns: at most "
                         f"{MAX_WIDTH}")
    for i, g in enumerate(sources):
        n = g.xyz.shape[0]
        if (n % n_rays or not n) if n_rays else n:
            raise ValueError(f"source {i}: {n} rows for {n_rays} rays")
        if enc.var and g.var is None:
            raise ValueError(f"source {i}: the variance is encoded, none "
                             f"given")
        for name, t, w in (("xyz", g.xyz, 3), ("density", g.density, 1),
                           ("smoothed_pos", g.smoothed_pos, 3),
                           ("var", g.var, 3)):
            if t is not None:
                _rows(f"source {i} {name}", t, n, w, dev)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(kernel: Kernel, sources, rays, ro, enc, sigma_only, feats,
            grads=((None,) * 4,) * 2) -> None:
    """One call of K10's forward or backward: its int64 table (`make_plan`
    in csrc/encode.cu reads it)."""
    n_rays = rays.shape[0]
    table = []
    for g in (*sources, None)[:2]:
        if g is None:
            table += [0] * 9
            continue
        for t in g:
            table += [0, 0] if t is None else [t.data_ptr(), t.stride(0)]
        table.append(g.xyz.shape[0] // n_rays)
    table += [rays.data_ptr(), rays.stride(0), ro.data_ptr(), ro.stride(0),
              feats.data_ptr(), n_rays, enc.flags(sigma_only), enc.xyz_freqs,
              enc.density_freqs, enc.dir_freqs]
    table += [_ptr(t) for gr in grads for t in gr]
    rows = (ctypes.c_longlong * N_ARGS)(*table)
    kernel(ctypes.addressof(rows), N_ARGS)


def _fwd(sources, rays, ro, enc, sigma_only) -> torch.Tensor:
    if not rays.is_cuda:
        return encode_features_plain(sources, rays, ro, enc, sigma_only)
    n_rows = sum(g.xyz.shape[0] for g in sources)
    out = torch.empty((n_rows, enc.width(sigma_only)), dtype=torch.float32,
                      device=rays.device)
    if n_rows:
        _launch(KERNEL, sources, rays, ro, enc, sigma_only, out)
    return out


def encode_features_bwd_cuda(sources, rays, ro, enc: Encoding,
                             sigma_only: bool, g: torch.Tensor,
                             needs=(True,) * 8) -> list:
    """K10's backward: per source a `Geometry` of the cotangents of its
    inputs from the rows' cotangent g (contiguous), None where an input is
    not encoded or `needs` (xyz, density, smoothed_pos, var of each source
    in turn) says no."""
    _check(sources, rays, ro, enc, sigma_only)
    if g.dtype != torch.float32 or g.device != rays.device or \
            not g.is_contiguous() or g.shape != (
                sum(s.xyz.shape[0] for s in sources), enc.width(sigma_only)):
        raise ValueError(f"g {g.dtype} {tuple(g.shape)} on {g.device} is not "
                         f"the contiguous f32 cotangent of the rows")
    encoded = (True, enc.density,
               enc.smoothed_pos or (enc.smoothed_dir and not sigma_only),
               enc.var)
    grads = [Geometry(*(torch.empty_like(t) if t is not None and on and nd
                        else None
                        for t, on, nd in zip(s, encoded, needs[4 * i:])))
             for i, s in enumerate(sources)]
    if g.shape[0]:
        _launch(BWD_KERNEL, sources, rays, ro, enc, sigma_only, g,
                [*grads, (None,) * 4][:2])
    return grads


class EncodeFeatures(torch.autograd.Function):
    """The rows with their backward: K10 on the card; on the CPU the plain
    forward and `encode_features_bwd_plain` (the kernels' twins). The
    arguments after the rays and the camera origin are each source's
    inputs in turn."""

    @staticmethod
    def forward(ctx, enc, sigma_only, rays, ro, *inputs):
        sources = [Geometry(*inputs[i:i + 4]) for i in range(0, len(inputs), 4)]
        ctx.save_for_backward(rays, ro, *inputs)
        ctx.enc, ctx.sigma_only = enc, sigma_only
        return _fwd(sources, rays, ro, enc, sigma_only)

    @staticmethod
    def backward(ctx, g):
        rays, ro, *inputs = ctx.saved_tensors
        sources = [Geometry(*inputs[i:i + 4]) for i in range(0, len(inputs), 4)]
        needs = ctx.needs_input_grad[4:]
        if rays.is_cuda:
            grads = encode_features_bwd_cuda(sources, rays, ro, ctx.enc,
                                             ctx.sigma_only, g.contiguous(),
                                             needs)
        else:
            grads = encode_features_bwd_plain(sources, rays, ro, ctx.enc,
                                              ctx.sigma_only, g)
            grads = [Geometry(*(d if nd else None for d, nd in
                                zip(gr, needs[4 * i:])))
                     for i, gr in enumerate(grads)]
        return (None,) * 4 + tuple(d for gr in grads for d in gr)


def encode_features_cuda(sources: list, rays, ro, enc: Encoding,
                         sigma_only: bool = False) -> torch.Tensor:
    """K10: the rows of `sources` in one launch, under autograd one node
    (`EncodeFeatures`) whose backward is one launch."""
    _check(sources, rays, ro, enc, sigma_only)
    if torch.is_grad_enabled():
        if rays.requires_grad or ro.requires_grad:
            raise ValueError("K10 gives the rays and the camera origin no "
                             "gradient")
        inputs = [t for g in sources for t in g]
        if any(t is not None and t.requires_grad for t in inputs):
            return EncodeFeatures.apply(enc, sigma_only, rays, ro, *inputs)
    return _fwd(sources, rays, ro, enc, sigma_only)


def encode_features(sources: list, rays: torch.Tensor, ro: torch.Tensor,
                    enc: Encoding, sigma_only: bool = False) -> torch.Tensor:
    """The NeRF's input rows (R * (S0 [+ S1]), C) of one or two sources of
    geometry (`Geometry`, R * S_i rows each) for rays (R, 6) and the camera
    origin ro (3,): K10 for CUDA tensors, the plain composition for CPU
    tensors."""
    if rays.is_cuda:
        return encode_features_cuda(sources, rays, ro, enc, sigma_only)
    return encode_features_plain(sources, rays, ro, enc, sigma_only)
