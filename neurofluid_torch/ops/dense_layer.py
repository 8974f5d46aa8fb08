"""K9: the NeRF's wide dense layers, `act([a1 | a2] W^T + b)`, on one
hand-written Hopper kernel (`csrc/dense_layer.cu`),
with its backward on the same kernel, and the plain version of each.

The product is 3xTF32 on `wgmma` (each f32 operand split into TF32 hi and
lo, three passes, chains of 32 k summed in f32): f32 class, as
`csrc/split_gemm.cuh`'s conv product. The bias and the ReLU are applied in
the kernel's epilogue; a second source of A (the NeRF's skip input, its
direction input) is read where it lies, so no concatenation is made.

B is split ahead of the product into K-major planes: `prepare` splits the
weights of all the layers of one NeRF forward in one launch (the forward's
planes, and dX's transposed ones when autograd records). A layer's
backward is one call from the host (`nf_dense_layer_bwd`): its masked
cotangent G, written once with its split planes and db's partial column
sums, then dX = G W, then dW^T = [a1 | a2]^T G in the kernel's TRANS_A
form over the batch cut into splits whose partial products are summed in
a fixed order: bitwise repeatable, no atomics.

`nerf_layers` runs the NeRF's 10 wide layers (the trunk with its skip
layer, `xyz_encoding_final`, `dir_encoding`): one prep launch and one
chain of products from the host (`nf_dense_layer_chain`), under autograd
one node whose backward calls each layer's in reverse order.
`dense_layer_plain` is the plain version of one layer: `F.linear` on the
concatenated input, then ReLU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from neurofluid_torch import cuda
from neurofluid_torch.cuda import Kernel, check_tensor
from neurofluid_torch.ops.fused_cconv import (
    GEMM_SMS, K_TILE, ROW_TILE, tf32_round,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry points: a chain of forward products in one call from the host;
# one layer's backward (G's prep, dX, dW and its split sum, db); B's
# planes of several layers. `gemm_launches()` counts the product kernel's
# launches by any of them.
CHAIN_KERNEL = Kernel("dense_layer.cu", "nf_dense_layer_chain", [_P, _I])
BWD_KERNEL = Kernel("dense_layer.cu", "nf_dense_layer_bwd",
                    [_P] * 5 + [_I] * 3 + [_P, _I, _I, _I, _P, _I, _P, _I, _I,
                                           _P, _I, _I, _P, _I, _I, _P, _P])
PREP_KERNEL = Kernel("dense_layer.cu", "nf_dense_layer_prep", [_P, _I])

N_TILE = 128  # columns of C per unit (rows: ROW_TILE, k: K_TILE)
MAX_PREP_JOBS = 24  # planes per prep launch (`kMaxPrepJobs`)
BWD_PREP_ROWS = 256  # rows per block of the backward's prep: db's partials
MIN_SPLIT_TILES = 8  # k-tiles (256 rows) at least in each of dW's splits


def _up(x: int, to: int) -> int:
    return -(-x // to) * to


def gemm_launches() -> int:
    """Launches of K9's product kernel so far in this process, counted by
    its library where the runtime accepts each; 0 before it is loaded."""
    lib = cuda.loaded("dense_layer.cu")
    if lib is None:
        return 0
    fn = lib.nf_dense_layer_launches
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


class Planes(NamedTuple):
    """B's split planes of one layer: `fwd` (2, n padded to 32, k1 and k2
    each padded to 32) for the forward; `dx` (2, k_in padded to 128, n
    padded to 32), W^T split, for dX, or None; `k1` the width of the
    layer's first source."""
    fwd: torch.Tensor
    dx: torch.Tensor | None
    k1: int


def fwd_planes_plain(weight: torch.Tensor, k1: int) -> torch.Tensor:
    """The forward's planes of `weight` (n, k_in) as the prep kernel writes
    them: row o holds W's row o, its first k1 columns then the rest, each
    zero-padded to 32, split into TF32 hi (plane 0) and lo (plane 1)."""
    n, k_in = weight.shape
    parts = [weight[:, :k1], weight[:, k1:]] if k1 < k_in else [weight]
    padded = torch.cat([F.pad(p, (0, _up(p.shape[1], K_TILE) - p.shape[1]))
                        for p in parts], dim=1)
    padded = F.pad(padded, (0, 0, 0, _up(n, K_TILE) - n))
    return torch.stack(split_tf32(padded))


def dx_planes_plain(weight: torch.Tensor) -> torch.Tensor:
    """dX's planes of `weight` (n, k_in): W^T zero-padded to (k_in padded
    to 128, n padded to 32), split into TF32 hi and lo."""
    n, k_in = weight.shape
    wt = F.pad(weight.t(), (0, _up(n, K_TILE) - n, 0, _up(k_in, N_TILE) - k_in))
    return torch.stack(split_tf32(wt))


def split_tf32(x: torch.Tensor) -> tuple:
    """(hi, lo) = (tf32(x), tf32(x - hi)), as the kernels split."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def dense_layer_plain(a1: torch.Tensor, a2: torch.Tensor | None,
                      weight: torch.Tensor, bias: torch.Tensor | None,
                      relu: bool) -> torch.Tensor:
    """act([a1 | a2] W^T + b): `F.linear` on the concatenated input, then
    ReLU (or the identity)."""
    x = a1 if a2 is None else torch.cat([a1, a2], dim=-1)
    y = F.linear(x, weight, bias)
    return torch.relu(y) if relu else y


def prepare(layers: list, want_dx: bool) -> list:
    """B's planes of each of `layers`, a list of (weight (n, k_in), k1), in
    one launch on their CUDA device; dX's planes too when `want_dx`."""
    if not 1 <= len(layers) * (2 if want_dx else 1) <= MAX_PREP_JOBS:
        raise ValueError(f"{len(layers)} layers: at most "
                         f"{MAX_PREP_JOBS // (2 if want_dx else 1)} a launch")
    dev = layers[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"weight is on {dev}, expected a CUDA device")
    shapes = []
    for w, k1 in layers:
        check_tensor("weight", w, dev)
        n, k_in = w.shape
        if not 1 <= k1 <= k_in:
            raise ValueError(f"k1 = {k1} for a weight of {k_in} columns")
        fwd = (_up(n, K_TILE), _up(k1, K_TILE) + _up(k_in - k1, K_TILE))
        dx = (_up(k_in, N_TILE), _up(n, K_TILE)) if want_dx else None
        shapes.append((fwd, dx))
    size = sum(2 * s[0] * s[1] for pair in shapes for s in pair if s)
    buf = torch.empty(size, dtype=torch.float32, device=dev)
    table, planes, at = [], [], 0
    for (w, k1), (fwd, dx) in zip(layers, shapes):
        got = []
        for kind, shape in ((0, fwd), (1, dx)):
            if shape is None:
                got.append(None)
                continue
            view = buf[at:at + 2 * shape[0] * shape[1]].view(2, *shape)
            at += view.numel()
            table += [w.data_ptr(), view.data_ptr(), kind, *w.shape, k1,
                      *shape]
            got.append(view)
        planes.append(Planes(got[0], got[1], k1))
    rows = (ctypes.c_longlong * len(table))(*table)
    PREP_KERNEL(ctypes.addressof(rows), len(table) // 8)
    return planes


def _layout(name: str, t: torch.Tensor) -> tuple:
    """(pointer, row stride, width) of a 2-D f32 view whose rows are
    contiguous."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if t.dim() != 2 or t.shape[1] < 1 or (t.stride(1) != 1 and t.shape[1] > 1):
        raise ValueError(f"{name} must be 2-D with contiguous rows, not "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    return t.data_ptr(), t.stride(0), t.shape[1]


def check_args(a1, a2, weight, bias, planes: Planes) -> list:
    """The sources' (pointer, row stride, width) after checking the layer's
    types and shapes, on whatever device the tensors lie."""
    srcs = [_layout("a1", a1)]
    if a2 is not None:
        srcs.append(_layout("a2", a2))
        if a2.shape[0] != a1.shape[0]:
            raise ValueError(f"a1 {tuple(a1.shape)} and a2 {tuple(a2.shape)} "
                             f"differ in rows")
    width = sum(s[2] for s in srcs)
    if weight.dtype != torch.float32 or weight.dim() != 2 or \
            weight.shape[1] != width:
        raise ValueError(f"weight {weight.dtype} {tuple(weight.shape)} vs an "
                         f"f32 input of {width} columns")
    if planes.k1 != a1.shape[1]:
        raise ValueError(f"planes split at {planes.k1}, a1 has "
                         f"{a1.shape[1]} columns")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (weight.shape[0],)):
        raise ValueError(f"bias {bias.dtype} {tuple(bias.shape)} vs "
                         f"{weight.shape[0]} f32 outputs")
    return srcs


def _check(a1, a2, weight, bias, planes):
    dev = a1.get_device()  # -1 on the CPU
    for name, t in (("a1", a1), ("a2", a2), ("weight", weight),
                    ("bias", bias)):
        if t is not None and (dev < 0 or t.get_device() != dev):
            raise ValueError(f"{name} is on {t.device}, expected a CUDA "
                             f"device ({a1.device})")
    return check_args(a1, a2, weight, bias, planes)


def _ptr(t):
    return None if t is None else t.data_ptr()


def dense_chain_cuda(steps: list) -> None:
    """K9's forward of several layers in one call from the host, in order
    and without autograd: each step (a1, a2, weight, bias, planes, relu,
    out) writes act([a1 | a2] W^T + b) into `out`, which a later step may
    read."""
    table = []
    for a1, a2, weight, bias, planes, relu, out in steps:
        (p1, l1, w1), *rest = _check(a1, a2, weight, bias, planes)
        p2, l2, w2 = rest[0] if rest else (0, 0, 0)
        m, n = a1.shape[0], weight.shape[0]
        check_tensor("out", out, a1.device)
        if out.shape != (m, n):
            raise ValueError(f"out {tuple(out.shape)} vs ({m}, {n})")
        table += [p1, l1, w1, p2, l2, w2, planes.fwd.data_ptr(),
                  planes.fwd.shape[1], planes.fwd.shape[2],
                  0 if bias is None else bias.data_ptr(), int(relu),
                  out.data_ptr(), n, m, n]
    if steps and steps[0][0].shape[0]:
        rows = (ctypes.c_longlong * len(table))(*table)
        CHAIN_KERNEL(ctypes.addressof(rows), len(steps))


def dw_splits(m: int, units: int, sms: int = GEMM_SMS) -> tuple:
    """(splits, k-tiles per split) of dW's product over a batch of m rows
    with `units` tiles of C: about two units a block on `sms` blocks (one
    per SM), the splits in whole k-tiles, each at least MIN_SPLIT_TILES (a
    small batch is not cut into partial sums that cost more to write and
    add than to compute)."""
    k_tiles = -(-max(m, 1) // K_TILE)
    want = max(1, min(k_tiles // MIN_SPLIT_TILES,
                      -(-2 * sms // max(units, 1))))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per


def _tma_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` itself where TMA can read it (a 16-byte base, rows of whole 16
    bytes), else a copy that it can: dW's product reads its sources so
    (the NeRF's direction slice, 54 columns of x, is copied)."""
    if t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0:
        return t
    m, w = t.shape
    return torch.empty((m, _up(w, 4)), dtype=t.dtype,
                       device=t.device)[:, :w].copy_(t)


def dense_layer_bwd_cuda(dy, a1, a2, weight, out, planes: Planes, relu: bool,
                         needs: tuple) -> tuple:
    """(da1, da2, dW, db) of K9's layer from the cotangent dy of its output
    `out`, each None where `needs` (a1, a2, weight, bias) says no."""
    dev, (m, n) = dy.device, dy.shape
    srcs = _check(a1, a2, weight, None, planes)
    check_tensor("dy", dy, dev)
    check_tensor("out", out, dev)
    if out.shape != (m, n) or a1.shape[0] != m:
        raise ValueError(f"dy {tuple(dy.shape)}, out {tuple(out.shape)} vs "
                         f"{a1.shape[0]} rows")
    return _bwd(dy, a1, a2, weight, out, planes, relu, needs,
                [s[2] for s in srcs])


def _bwd(dy, a1, a2, weight, out, planes, relu, needs, widths) -> tuple:
    """`dense_layer_bwd_cuda` on arguments already checked (the sources'
    widths given)."""
    dev, (m, n) = dy.device, dy.shape
    need_x = [needs[0], a2 is not None and needs[1]]
    if m == 0:
        bias_like = weight.new_empty(n)
        return tuple(torch.zeros_like(t) if nd else None
                     for t, nd in ((a1, needs[0]), (a2, needs[1]),
                                   (weight, needs[2]), (bias_like, needs[3])))
    m_pad = _up(m, K_TILE)
    k_in = sum(widths)
    n_split, per = (dw_splits(m, sum(-(-w // ROW_TILE) for w in widths)
                              * -(-n // N_TILE)) if needs[2] else (1, 1))
    # one scratch for G's split planes, db's partial sums, G and dW's
    # partial products, each part on 128 bytes
    parts = [2 * n * m_pad, -(-m_pad // BWD_PREP_ROWS) * n,
             m * n if relu and any(need_x) else 0,
             n_split * k_in * n if needs[2] else 0]
    at = [0]
    for size in parts:
        at.append(at[-1] + _up(size, 32))
    scratch = torch.empty(at[-1], dtype=torch.float32, device=dev)
    gt, db_part, g, part = (scratch.data_ptr() + 4 * a if size else None
                            for a, size in zip(at, parts))
    da, dx, c0, dx_n = [None, None], None, 0, 0
    if any(need_x):
        if planes.dx is None:
            raise ValueError("dX needs the planes prepared with want_dx")
        c0 = 0 if need_x[0] else widths[0]
        dx_n = (widths[0] if not need_x[1] else k_in) - c0
        dx = torch.empty((m, dx_n), dtype=torch.float32, device=dev)
        if need_x[0]:
            da[0] = dx[:, :widths[0]]
        if need_x[1]:
            da[1] = dx[:, widths[0] - c0:]
    dw = db = None
    xs = [(None, 0, 0)] * 2
    if needs[2]:
        dw = torch.empty((n, k_in), dtype=torch.float32, device=dev)
        copies = [_tma_copy(t) for t in (a1, a2) if t is not None]  # alive
        xs = ([_layout("a", t) for t in copies] + xs)[:2]
    if needs[3]:
        db = torch.empty(n, dtype=torch.float32, device=dev)
    dx_planes = planes.dx if dx is not None else None
    BWD_KERNEL(dy.data_ptr(), out.data_ptr() if relu else None, g, gt,
               db_part, m, n, m_pad, _ptr(dx_planes),
               0 if dx is None else dx_planes.shape[1],
               0 if dx is None else dx_planes.shape[2], c0, _ptr(dx), dx_n,
               *xs[0], *xs[1], part, n_split, per, _ptr(dw), _ptr(db))
    return da[0], da[1], dw, db




XYZ, DIRS = -1, -2  # the NeRF's inputs among a layer's sources


def _sources(j: int, depth: int, skips: tuple) -> tuple:
    """Layer j's two sources in the NeRF, each an earlier layer's index,
    XYZ or DIRS (None: no second source): layer 0 reads the xyz embedding,
    a skip layer [xyz | h], the trunk's other layers and
    `xyz_encoding_final` h, `dir_encoding` [feat | dirs]."""
    if j == 0:
        return XYZ, None
    if j < depth and j in skips:
        return XYZ, j - 1
    if j <= depth:
        return j - 1, None
    return depth, DIRS


def _nerf_forward(xyz, dirs, params, depth, skips, keep: bool) -> tuple:
    """(the outputs of the NeRF's wide layers, their planes): the planes of
    every layer from one `prepare` launch (dX's too when `keep`), then the
    products as one chain from the host. `keep`: every output in a tensor
    of its own, as the backward reads them; else the trunk's layers and
    `xyz_encoding_final` write two buffers in turn (stream order keeps a
    buffer read before it is written again)."""
    n_layers = len(params) // 2
    m, dev = xyz.shape[0], xyz.device
    srcs = [_sources(j, depth, skips) for j in range(n_layers)]
    k1s = [xyz.shape[1] if s1 == XYZ else params[2 * s1].shape[0]
           for s1, _ in srcs]
    planes = prepare([(params[2 * j], k1) for j, k1 in enumerate(k1s)],
                     want_dx=keep)
    inputs = {XYZ: xyz, DIRS: dirs, None: None}
    outs, bufs, steps = [], [None, None], []
    for j, (s1, s2) in enumerate(srcs):
        w, b = params[2 * j], params[2 * j + 1]
        shape = (m, w.shape[0])
        reuse = not keep and j <= depth
        out = bufs[j % 2] if reuse else None
        if out is None or out.shape != shape:
            out = torch.empty(shape, dtype=torch.float32, device=dev)
            if reuse:
                bufs[j % 2] = out
        a1, a2 = (outs[s] if s is not None and s >= 0 else inputs[s]
                  for s in (s1, s2))
        steps.append((a1, a2, w, b, planes[j], j != depth, out))
        outs.append(out)
    dense_chain_cuda(steps)
    return outs, planes


class NeRFLayers(torch.autograd.Function):
    """The NeRF's wide layers on K9 as one autograd node (`nerf_layers`):
    the forward one chain from the host, the backward each layer's in
    reverse order, one call from the host each (`nf_dense_layer_bwd`)."""

    @staticmethod
    def forward(ctx, depth, skips, xyz, dirs, *params):
        outs, planes = _nerf_forward(xyz, dirs, params, depth, skips,
                                     keep=True)
        ctx.save_for_backward(xyz, dirs, *params, *outs)
        ctx.depth, ctx.skips, ctx.planes = depth, skips, planes
        return (outs[depth - 1], *outs[depth + 1:])

    @staticmethod
    def backward(ctx, *grads):
        depth, skips, planes = ctx.depth, ctx.skips, ctx.planes
        n_layers = len(planes)
        xyz, dirs, *rest = ctx.saved_tensors
        params, outs = rest[:2 * n_layers], rest[2 * n_layers:]
        needs = ctx.needs_input_grad[2:]  # xyz, dirs, then the parameters
        # whether layer j's output carries a gradient back to anything: xyz
        # or a parameter of layer j or below
        below = [needs[0] or any(needs[2:2 * j + 4]) for j in range(n_layers)]
        need = {XYZ: needs[0], DIRS: needs[1], None: False}
        inputs = {XYZ: xyz, DIRS: dirs, None: None}
        # cotangents by source: h's from the sigma head and from
        # xyz_encoding_final, xyz's from layer 0 and the skip layers
        cot = {depth - 1: grads[0]}
        if n_layers > depth:
            cot[n_layers - 1] = grads[1]
        d_par = [None] * (2 * n_layers)
        for j in reversed(range(n_layers)):
            dy = cot.pop(j, None)
            if dy is None:
                continue
            s1, s2 = _sources(j, depth, skips)
            a1, a2 = (outs[s] if s is not None and s >= 0 else inputs[s]
                      for s in (s1, s2))
            widths = [a1.shape[1]] + ([] if a2 is None else [a2.shape[1]])
            da1, da2, d_par[2 * j], d_par[2 * j + 1] = _bwd(
                dy.contiguous(), a1, a2, params[2 * j], outs[j], planes[j],
                j != depth, tuple(below[s] if s is not None and s >= 0
                                  else need[s] for s in (s1, s2))
                + (needs[2 + 2 * j], needs[3 + 2 * j]), widths)
            for s, d in ((s1, da1), (s2, da2)):
                if d is not None:
                    cot[s] = d if cot.get(s) is None else cot[s] + d
        return (None, None, cot.get(XYZ), cot.get(DIRS), *d_par)


def nerf_layers(xyz: torch.Tensor, dirs: torch.Tensor, params: list,
                depth: int, skips: tuple) -> list:
    """The NeRF's wide layers on K9, on CUDA tensors: the `depth` layers of
    the trunk (ReLU; a skip layer reads [xyz | h]) and, where `params`
    holds two more layers, `xyz_encoding_final` (identity) and
    `dir_encoding` ([feat | dirs], ReLU). `params`: each layer's weight
    and bias in order. Returns [h] or [h, d]. Without autograd one chain
    from the host; with it one autograd node."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xyz, dirs, *params)):
        return list(NeRFLayers.apply(depth, tuple(skips), xyz, dirs, *params))
    outs, _ = _nerf_forward(xyz, dirs, params, depth, skips, keep=False)
    return [outs[depth - 1], *outs[depth + 1:]]
