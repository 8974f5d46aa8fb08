"""Fused continuous convolution: K1 (`csrc/fused_cconv.cu`
`nf_fused_cconv_fwd`), its backward K2 (`nf_fused_cconv_bwd`, same source),
their forms at precision 'default', K1d and K2d (`csrc/fused_cconv_bf16.cu`),
and the plain version of each (port of neurofluid_tpu/ops/fused_cconv.py).
Both kernels are a candidate walk plus tensor-core matrix products with the
filter (`csrc/split_gemm.cuh`, also callable alone as `split_gemm_cuda`);
the wrappers here choose, from the shapes alone, whether the filter fits a
block's shared memory (`w_fits_shared`), the walk's block shape
(`walk_config`) and the chunking of the scratch rows (`scratch_chunk_rows`).

Particles are sorted by grid cell (cell size >= radius), so a cell's
particles are a contiguous row range and the 27-cell neighbourhood of a
query column is 9 contiguous slabs, one per (dx, dy) neighbour column over
the query's z range +-1. Queries are the sorted particles themselves, split
into groups of `group_size` consecutive rows inside one (x, y) column; a
group's 9 slabs hold every candidate of every query in it. The conv sums
over every candidate with d^2/r^2 <= 1: the poly6 window is zero at and
beyond the radius, so the sum over this superset is the exact uncapped
neighbourhood sum, with no neighbour list and no cap.

Per (query, candidate) pair: offset / radius -> ball-to-cube map ->
trilinear taps on the (kz, ky, kx) filter grid, weighted by the window;
the tap-feature sums are contracted with the (kz*ky*kx*Cin, Cout) filter.
Outputs are in sorted query order; `unsort_values` restores the original.

`fused_cconv` is differentiable with respect to the filter, the sorted
query and candidate positions and the sorted candidate features
(`FusedCConv`); the in-radius counts are discrete. Sentinel and zero pad
rows get exactly zero gradient.

`precision` takes the JAX package's names (`cconv.PRECISIONS`). At
'default' every operand of every contraction is rounded to bf16 (round to
nearest even) and products and sums stay f32, as the TPU's `DEFAULT` MXU
pass computes the Pallas bodies' dots: the slab sum bf(w) bf(f) per pair
and tap, the fold bf(acc) bf(W), d_acc = bf(ct) bf(W)^T, the tap-weight
cotangent <bf(d_acc), bf(f)>, dfeats += bf(w) bf(d_acc) and dW = bf(acc)^T
bf(ct). The kernels there are K1d and K2d, entry points of their own with
a launch count each (`BF16_KERNELS`): bf16 walks that round each operand
once where it is staged (the features into a bf16 copy per call) and
contract the pairs' tap weights with their features on the bf16 tensor
cores, their scratch rows in bf16 (`walk_config_bf16`,
`bf16_fwd_smem_bytes`, `bf16_bwd_smem_bytes`), and the product's bf16 mode
(one bf16 `wgmma` pass, A in bf16). 'high' and 'highest' are f32 class.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from neurofluid_torch import cuda
from neurofluid_torch.cuda import Kernel, check_tensor
from neurofluid_torch.ops import cconv
from neurofluid_torch.ops.cconv import bf16_round, conv_bf16
from neurofluid_torch.ops.neighbor_search import cell_dims, cell_ids

SENTINEL = 1e9
GROUP_SIZE = 16
SLAB_CAP = 128
_MIN_PAD = 64  # sorted arrays carry at least this many sentinel/zero rows

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("fused_cconv.cu", "nf_fused_cconv_fwd",
                [_P] * 14 + [_I] * 16 + [_F, _I])
BWD_KERNEL = Kernel("fused_cconv.cu", "nf_fused_cconv_bwd",
                    [_P] * 17 + [_I] * 19 + [_F, _I])
GEMM_KERNEL = Kernel("fused_cconv.cu", "nf_split_gemm", [_P] * 5 + [_I] * 6)
# precision 'default': K1d, K2d and the bf16 product (`csrc/fused_cconv_bf16.cu`)
BF16_KERNELS = {
    "K1": Kernel("fused_cconv_bf16.cu", "nf_fused_cconv_fwd_bf16",
                 [_P] * 15 + [_I] * 17 + [_F, _I]),
    "K2": Kernel("fused_cconv_bf16.cu", "nf_fused_cconv_bwd_bf16",
                 [_P] * 19 + [_I] * 18 + [_F, _I]),
    "product": Kernel("fused_cconv_bf16.cu", "nf_split_gemm_bf16",
                      [_P] * 5 + [_I] * 6)}

# dynamic shared memory one block may take on the H100 and what an SM
# holds, the largest filter that is staged into a block, the scratch rows
# one call may hold; the tensor-core product's (csrc/split_gemm.cuh) row
# tile, its k-tile, its N-tiles (for N <= 8, below WIDE_N, from it) and
# the SMs its persistent blocks walk
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
W_SHARED_LIMIT = 64 * 1024
SCRATCH_LIMIT = 256 * 2 ** 20
ROW_TILE = 128
K_TILE = 32
N_TILES = (8, 64, 128)
WIDE_N = 1024  # N from which the product takes its widest N-tile
GEMM_SMS = 132
UNIT_TILES = 2  # a unit's start and store, in k-tiles (`product_splits`)
_TILE = 32  # candidates per tile of the walk
# the bf16 walks: threads per block, the forward walk's candidates per
# tile, the n-tiles of 8 channels it is instantiated for, the queries per
# block of the backward walk
BF16_THREADS = 256
BF16_TILE = 128
BF16_NTILES = (1, 2, 4, 8, 12, 16)
BF16_BWD_QB = (8, 4, 2)
# blocks of the backward bf16 walk an SM holds by its registers
# (`__launch_bounds__(256, 2)`)
BF16_BWD_BLOCKS = 2


class CConvPlan(NamedTuple):
    """Cell sort + column grouping of one point set.

    order/inv_rank: (N,) int64 sort order (sorted row r holds point
        order[r]) and its inverse.
    pos_s: (N + slab_cap, 3) sorted positions, tail at SENTINEL.
    pstarts: (num_cells + 1,) int32 first sorted row of each cell.
    gcol: (NG,) int32 column id cx * d1 + cy per group (n_cols for empty
        groups); gzlo/gzhi: (NG,) int32 z-cell range of the group's rows;
        gstart: (NG + 1,) int32 first sorted row of each group.
    overflow: () bool, the defensive group-count bound was hit.
    A candidate-only plan (`with_groups=False`) has n_groups == 0.
    """

    order: torch.Tensor
    inv_rank: torch.Tensor
    pos_s: torch.Tensor
    pstarts: torch.Tensor
    gcol: torch.Tensor
    gzlo: torch.Tensor
    gzhi: torch.Tensor
    gstart: torch.Tensor
    overflow: torch.Tensor
    dims: tuple
    n: int
    n_groups: int
    group_size: int
    slab_cap: int
    cell_size: float


def build_plan(points: torch.Tensor, lower, upper, cell_size: float,
               group_size: int = GROUP_SIZE, slab_cap: int = SLAB_CAP,
               with_groups: bool = True) -> CConvPlan:
    """Stable-sort `points` by cell and build the column grouping."""
    pts = points.detach()
    n, t, dev = pts.shape[0], int(group_size), pts.device
    slab_cap = max(int(slab_cap), _MIN_PAD, t)
    dims = cell_dims(lower, upper, cell_size)
    d0, d1, d2 = dims
    num_cells, n_cols = d0 * d1 * d2, d0 * d1
    i32 = torch.int32

    sorted_id, order = torch.sort(cell_ids(pts, lower, dims, cell_size),
                                  stable=True)
    iota = torch.arange(n, device=dev)
    inv_rank = torch.empty_like(order)
    inv_rank[order] = iota
    pstarts = torch.searchsorted(
        sorted_id, torch.arange(num_cells + 1, device=dev)).to(i32)
    pos_s = torch.cat([pts[order], pts.new_full((slab_cap, 3), SENTINEL)])

    if not with_groups:
        z = torch.zeros(1, dtype=i32, device=dev)
        return CConvPlan(order, inv_rank, pos_s, pstarts, z, z, z,
                         torch.zeros(2, dtype=i32, device=dev),
                         torch.zeros((), dtype=torch.bool, device=dev),
                         dims, n, 0, t, slab_cap, float(cell_size))

    col_of_sorted = sorted_id // d2
    zc_of_sorted = sorted_id % d2
    cstarts = torch.searchsorted(col_of_sorted,
                                 torch.arange(n_cols + 1, device=dev))
    gpc = -(-torch.diff(cstarts) // t)  # groups per column (ceil)
    gbase = torch.cat([gpc.new_zeros(1), torch.cumsum(gpc, 0)])
    # static group bound: every non-empty column wastes < 1 group
    ng = -(-n // t) + n_cols + 1
    overflow = gbase[-1] > ng
    rank_in_col = iota - cstarts[col_of_sorted]
    group_of_q = torch.clamp(gbase[col_of_sorted] + rank_in_col // t,
                             max=ng - 1)
    gstart = torch.searchsorted(group_of_q, torch.arange(ng + 1, device=dev))
    nonempty = torch.diff(gstart) > 0
    first = torch.clamp(gstart[:-1], max=n - 1)
    last = torch.clamp(gstart[1:] - 1, 0, n - 1)
    gcol = torch.where(nonempty, col_of_sorted[first], n_cols)
    gzlo = torch.where(nonempty, zc_of_sorted[first], 0)
    gzhi = torch.where(nonempty, zc_of_sorted[last], 0)
    return CConvPlan(order, inv_rank, pos_s, pstarts, gcol.to(i32),
                     gzlo.to(i32), gzhi.to(i32), gstart.to(i32), overflow,
                     dims, n, ng, t, slab_cap, float(cell_size))


def sort_values(values: torch.Tensor, plan: CConvPlan, pad_rows: int = 0,
                pad_value: float = 0.0) -> torch.Tensor:
    """(N, C) -> sorted (N + pad_rows, C)."""
    out = values[plan.order]
    if pad_rows:
        out = torch.cat([out, out.new_full((pad_rows,) + out.shape[1:],
                                           pad_value)])
    return out


def unsort_values(values_s: torch.Tensor, plan: CConvPlan) -> torch.Tensor:
    """Inverse of `sort_values` (drops the padding rows)."""
    return values_s[: plan.n][plan.inv_rank]


def check_plans(qplan: CConvPlan, cplan: CConvPlan, radius: float) -> None:
    """Preconditions of the 27-cell cover; violating any would drop true
    neighbours or read no query at all, so each raises."""
    if qplan.dims != cplan.dims:
        raise ValueError(f"query/candidate plans disagree on grid dims: "
                         f"{qplan.dims} vs {cplan.dims}")
    cell = min(qplan.cell_size, cplan.cell_size)
    if radius > cell * (1 + 1e-6):
        raise ValueError(f"radius {radius} > plan cell_size {cell}: the "
                         f"27-cell candidate cover would miss true neighbors")
    if qplan.n_groups == 0:
        raise ValueError("the query plan has no groups (a candidate-only "
                         "plan, with_groups=False, cannot be queried)")


def slab_ranges(qplan: CConvPlan, cplan: CConvPlan):
    """(NG, 9) start row and length in cplan's sorted rows of each group's
    candidate slabs; slab i is neighbour column (dx, dy) = (i//3 - 1,
    i%3 - 1) over the group's z cells -1..+1. Out-of-grid columns and empty
    groups have length 0."""
    d0, d1, d2 = qplan.dims
    n_cols = d0 * d1
    col = qplan.gcol.long()[:, None]
    i = torch.arange(9, device=col.device)
    nx, ny = col // d1 + i // 3 - 1, col % d1 + i % 3 - 1
    ok = (col < n_cols) & (nx >= 0) & (nx < d0) & (ny >= 0) & (ny < d1)
    base = torch.clamp(nx * d1 + ny, 0, n_cols - 1) * d2
    z0 = torch.clamp(qplan.gzlo.long() - 1, min=0)[:, None]
    z1 = torch.clamp(qplan.gzhi.long() + 1, max=d2 - 1)[:, None]
    ps = cplan.pstarts.long()
    start = ps[base + z0]
    return start, torch.where(ok, ps[base + z1 + 1] - start, 0)


def _pairs(rows, row_group, start, length, qpos_s, cpos_s, inv_r: float,
           exclude_self: bool):
    """In-radius pairs of the sorted query `rows`: every candidate of the
    query's 9 slabs with d^2/r^2 <= 1 (and d > 0 when exclude_self:
    positional self exclusion, a coincident twin goes too). Returns (index
    into rows, candidate row, offset / radius (P, 3), counts (len(rows),))."""
    nr, dev = rows.shape[0], rows.device
    g = row_group[rows]
    s, ln = start[g], length[g]  # (C, 9)
    lane = torch.arange(max(int(ln.max()), 1), device=dev)
    ok = (lane < ln[..., None]).reshape(nr, -1)
    cand = torch.where(ok, (s[..., None] + lane).reshape(nr, -1), 0)
    off = (cpos_s[cand] - qpos_s[rows][:, None, :]) * inv_r
    ox, oy, oz = off.unbind(-1)
    d2n = ox * ox + oy * oy + oz * oz
    within = ok & (d2n <= 1.0)
    if exclude_self:
        within = within & (d2n > 0.0)
    qi, ki = torch.nonzero(within, as_tuple=True)
    return qi, cand[qi, ki], off[qi, ki], within.sum(dim=1)


def _row_walk(qplan, cplan, radius, chunk_rows):
    """(chunks of sorted query rows, the pair finder of `_pairs`)."""
    n, dev = qplan.n, qplan.gstart.device
    start, length = slab_ranges(qplan, cplan)
    row_group = torch.searchsorted(qplan.gstart.long(),
                                   torch.arange(n, device=dev), right=True) - 1
    inv_r = float(np.float32(1.0 / radius))
    chunks = [torch.arange(r0, min(n, r0 + chunk_rows), device=dev)
              for r0 in range(0, n, chunk_rows)]
    return chunks, lambda rows, qpos_s, cpos_s, excl: _pairs(
        rows, row_group, start, length, qpos_s, cpos_s, inv_r, excl)


def _tap_sums(rows, qi, cand, corner, cw, feats_s, n_taps):
    """(len(rows) * n_taps, Cin) tap-feature sums of the pairs."""
    cin = feats_s.shape[1]
    contrib = cw[..., None] * feats_s[cand][:, None]
    taps = feats_s.new_zeros((rows.shape[0] * n_taps, cin))
    return taps.index_add(0, (qi[:, None] * n_taps + corner).reshape(-1),
                          contrib.reshape(-1, cin))


def _rounding(precision):
    """The rounding of every contraction operand at `precision`: bf16 at
    'default', none otherwise."""
    return bf16_round if conv_bf16(precision) else (lambda x: x)


def fused_cconv_plain(weights, qplan, qpos_s, cplan, cpos_s, feats_s,
                      radius: float, exclude_self: bool,
                      precision: str = "highest", chunk_rows: int = 2048):
    """Plain PyTorch twin of K1: the in-radius pairs of `_pairs`, window on
    min(d^2/r^2, 2), corner/fraction taps, an index_add of the tap-feature
    sums, then one matmul with the filter (at 'default' each on
    bf16-rounded operands). Returns (out (Nq, Cout), counts (Nq,))."""
    check_plans(qplan, cplan, radius)
    rnd = _rounding(precision)
    kz, ky, kx, cin, cout = weights.shape
    n_taps = kz * ky * kx
    w2 = rnd(weights.reshape(n_taps * cin, cout))
    feats_r = rnd(feats_s)
    chunks, pairs = _row_walk(qplan, cplan, radius, chunk_rows)
    outs, counts = [], []
    for rows in chunks:
        qi, cand, off, cnt = pairs(rows, qpos_s, cpos_s, exclude_self)
        counts.append(cnt.float())
        corner, cw = cconv.tap_weights(off, (kz, ky, kx))
        taps = _tap_sums(rows, qi, cand, corner, rnd(cw), feats_r, n_taps)
        outs.append(rnd(taps.reshape(rows.shape[0], n_taps * cin)) @ w2)
    if not outs:
        return qpos_s.new_zeros((0, cout)), qpos_s.new_zeros((0,))
    return torch.cat(outs), torch.cat(counts)


def fused_cconv_bwd_plain(weights, qplan, qpos_s, cplan, cpos_s, feats_s,
                          ct, radius: float, exclude_self: bool, needs,
                          precision: str = "highest", chunk_rows: int = 512):
    """Plain PyTorch twin of K2, an explicit adjoint (not autograd through
    the forward). ct: (Nq, Cout) cotangent of the conv output in sorted
    query order; needs: which of (dW, dq, dc, dfeats) to compute.

    Per chunk of query rows: d_acc = ct W^T as (rows, taps, Cin); per
    in-radius pair, dfeats[c] += sum over its 8 taps of w * d_acc, and the
    tap-weight cotangent <d_acc[tap], f_c> goes through
    `cconv.tap_weights_vjp` into dq (minus) and dc (plus), over r; the
    recomputed tap-feature sums give dW += acc^T ct. At 'default' both
    operands of each of those products are rounded to bf16 (JAX's
    transpose of a `DEFAULT` dot). Returns (dW, dq, dc, dfeats) shaped as
    their inputs, None where not needed."""
    check_plans(qplan, cplan, radius)
    rnd = _rounding(precision)
    need_w, need_q, need_c, need_f = needs
    kz, ky, kx, cin, cout = weights.shape
    n_taps = kz * ky * kx
    w2 = rnd(weights.reshape(n_taps * cin, cout))
    feats_r = rnd(feats_s)
    inv_r = float(np.float32(1.0 / radius))
    dw = torch.zeros_like(w2) if need_w else None
    dq = torch.zeros_like(qpos_s) if need_q else None
    dc = torch.zeros_like(cpos_s) if need_c else None
    df = torch.zeros_like(feats_s) if need_f else None
    chunks, pairs = _row_walk(qplan, cplan, radius, chunk_rows)
    for rows in chunks:
        qi, cand, off, _ = pairs(rows, qpos_s, cpos_s, exclude_self)
        corner, cw = cconv.tap_weights(off, (kz, ky, kx))
        cw_r = rnd(cw)
        ct_rows = rnd(ct[rows])
        if need_w:
            acc = _tap_sums(rows, qi, cand, corner, cw_r, feats_r, n_taps)
            dw += rnd(acc.reshape(rows.shape[0], n_taps * cin)).T @ ct_rows
        if not (need_q or need_c or need_f):
            continue
        d_acc = rnd((ct_rows @ w2.T).reshape(rows.shape[0] * n_taps, cin))
        d_pair = d_acc[qi[:, None] * n_taps + corner]  # (P, 8, Cin)
        if need_f:
            df.index_add_(0, cand, (cw_r[..., None] * d_pair).sum(1))
        if need_q or need_c:
            g_cw = (d_pair * feats_r[cand][:, None, :]).sum(-1)
            g_off = cconv.tap_weights_vjp(off, (kz, ky, kx), g_cw) * inv_r
            if need_q:
                dq.index_add_(0, rows[qi], -g_off)
            if need_c:
                dc.index_add_(0, cand, g_off)
    return (dw.reshape(weights.shape) if need_w else None), dq, dc, df


def w_fits_shared(n_taps: int, cin: int, cout: int) -> bool:
    """The (n_taps * Cin, Cout) filter is small enough to be staged into a
    walk block's shared memory: the walk then folds it (K1) or contracts
    d_acc (K2) itself. Otherwise those contractions are tensor-core products
    over scratch rows."""
    return n_taps * cin * cout * 4 <= W_SHARED_LIMIT


def fwd_smem_bytes(qb: int, threads: int, n_taps: int, cin: int, cout: int,
                   fold: bool) -> int:
    """Dynamic shared memory of a forward-walk block (the layout at the top
    of `walk_fwd_kernel`)."""
    tap_len, pairs = n_taps * cin, qb * _TILE
    words = (qb * tap_len + 2 * _TILE * cin + 2 * _TILE * 3 + 8 * pairs
             + pairs + qb * 3 + 2 * qb)
    if fold:
        words += tap_len * cout + threads * qb
    return 4 * words


def bwd_smem_bytes(qb: int, n_taps: int, cin: int, cout: int,
                   local: bool) -> int:
    """Dynamic shared memory of a backward-walk block (the layout at the
    top of `walk_bwd_kernel`)."""
    tap_len, pairs = n_taps * cin, qb * _TILE
    words = (qb * tap_len + 2 * _TILE * cin + 2 * _TILE * 3 + 16 * pairs
             + pairs + 7 * qb)
    if local:
        words += tap_len * cout + qb * cout
    return 4 * words


@functools.lru_cache(maxsize=None)
def walk_config(n_taps: int, cin: int, cout: int, staged: bool,
                backward: bool = False) -> tuple:
    """(queries per block, threads per block) of a walk kernel. On the card
    the walks ran fastest, within a few percent at every layer of the bench
    point, with as many queries resident on an SM as its shared memory
    holds: the power of two <= 16 (a whole group) that maximises queries
    per block times blocks per SM (a block takes its shared memory, with
    the filter when it is `staged`, plus 1 KB the card reserves); among
    equals, one that leaves two blocks per SM, then the larger. 256
    threads: one per (query, candidate) pair of an 8-query tile."""
    threads, best = 256, None
    for qb in (16, 8, 4, 2, 1):
        need = bwd_smem_bytes(qb, n_taps, cin, cout, staged) if backward \
            else fwd_smem_bytes(qb, threads, n_taps, cin, cout, staged)
        if need > SMEM_LIMIT:
            continue
        blocks = SMEM_PER_SM // (need + 1024)
        key = (qb * blocks, blocks >= 2, qb)
        if best is None or key > best[0]:
            best = (key, qb)
    if best is None:
        raise ValueError(f"no walk block fits shared memory at n_taps "
                         f"{n_taps}, Cin {cin}, Cout {cout}")
    return best[1], threads


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def bf16_ntiles(cin: int) -> int:
    """n-tiles of 8 channels the bf16 forward walk holds per tap (its
    template constant, `csrc/fused_cconv_bf16.cu` `bf16_ntiles`); past 128
    channels it has none and raises."""
    for nt in BF16_NTILES:
        if 8 * nt >= cin:
            return nt
    raise ValueError(f"the bf16 walk takes at most {8 * BF16_NTILES[-1]} "
                     f"channels, not {cin}")


def bf16_fwd_qb(nt: int, fold: bool = False) -> int:
    """Queries per block of the bf16 forward walk: a thread holds 2 qb nt
    accumulator floats, kept within 128; at Cin 64 8 where the block folds
    W, 4 where it writes rows (the faster of the two on an H100)."""
    return 8 if nt <= 4 or (fold and nt <= 8) else 4 if nt <= 12 else 2


def bf16_feat_width(cin: int) -> int:
    """Channels of a row of the features' bf16 copy (zero past cin)."""
    return _round16(8 * bf16_ntiles(cin))


def bf16_fwd_smem_bytes(qb: int, nt: int, klen: int, cout: int,
                        fold: bool) -> int:
    """Dynamic shared memory of a bf16 forward-walk block (the layout of
    `bf16_fwd_smem`): two tiles of BF16_TILE bf16 feature rows (8 nt + 8
    channels apart) and a zero row, 8 bf16 weights, a corner code, a ballot
    bit and a rank byte per pair, positions, the 8 warps' A tiles (qb / 2
    m-tiles of 16 x 16 bf16 each, rows 48 bytes apart); with the fold, bf16
    W^T and the block's bf16 accumulator rows (klen padded to 16, + 8) and
    the warps' partial sums."""
    fs, pairs = 8 * nt + 8, qb * BF16_TILE
    kw = _round16(klen) + 8 if fold else 0
    out = (2 * BF16_TILE * fs * 2 + fs * 2 + pairs * 16
           + 2 * BF16_TILE * 3 * 4 + pairs * 4 + pairs // 8 + qb * 3072)
    if fold:
        out += cout * kw * 2 + qb * kw * 2 + 8 * qb * 32 * 4
    return out + qb * 3 * 4 + 2 * qb * 4 + pairs


def bf16_bwd_smem_bytes(qb: int, cin: int, cout: int, klen: int,
                        local: bool) -> int:
    """Dynamic shared memory of a bf16 backward-walk block (the layout of
    `bf16_bwd_smem`): d_acc of qb queries and two tiles in bf16 rows of
    round16(Cin) + 8, a zero row, 8 bf16 weights, 8 f32 tap cotangents, a
    corner code and a rank byte per pair, positions; `local` adds bf16 W^T
    (klen + 8 a row, to 16 bytes) and bf(ct)."""
    ds, pairs = _round16(cin) + 8, qb * _TILE
    out = (qb * 64 * ds * 2 + 2 * _TILE * ds * 2 + ds * 2 + pairs * 16
           + pairs * 32 + 2 * _TILE * 3 * 4 + pairs * 4)
    if local:
        out += -(-cout * (klen + 8) * 2 // 16) * 16 \
            + qb * (_round16(cout) + 8) * 2
    return out + 2 * qb * 3 * 4 + 2 * qb * 4 + pairs


@functools.lru_cache(maxsize=None)
def walk_config_bf16(n_taps: int, cin: int, cout: int, staged: bool,
                     backward: bool = False) -> tuple:
    """(queries per block, threads per block) of a bf16 walk, 256 threads.
    Forward: `bf16_fwd_qb` of the channels' n-tiles (registers bound it;
    its shared memory is small). Backward: of 8, 4 and 2 queries, the one
    that keeps the most queries on an SM, at most BF16_BWD_BLOCKS blocks
    (registers) and as many as its shared memory allows; among equals one
    that leaves two blocks per SM, then the larger."""
    klen = n_taps * cin
    nt = bf16_ntiles(cin)
    if not backward:
        qb = bf16_fwd_qb(nt, staged)
        if bf16_fwd_smem_bytes(qb, nt, klen, cout, staged) > SMEM_LIMIT:
            raise ValueError(f"no bf16 walk block fits shared memory at "
                             f"Cin {cin}, Cout {cout}")
        return qb, BF16_THREADS
    best = None
    for qb in BF16_BWD_QB:
        need = bf16_bwd_smem_bytes(qb, cin, cout, klen, staged)
        if need > SMEM_LIMIT:
            continue
        blocks = min(SMEM_PER_SM // (need + 1024), BF16_BWD_BLOCKS)
        key = (qb * blocks, blocks >= 2, qb)
        if best is None or key > best[0]:
            best = (key, qb)
    if best is None:
        raise ValueError(f"no bf16 backward walk block fits shared memory at "
                         f"Cin {cin}, Cout {cout}")
    return best[1], BF16_THREADS


def scratch_chunk_rows(n: int, klen: int) -> int:
    """Query rows per chunk of the (rows, klen) f32 scratch: the fewest
    equal chunks that keep it within SCRATCH_LIMIT, a multiple of the
    product's row tile."""
    n_chunks = max(1, -(-n * klen * 4 // SCRATCH_LIMIT))
    rows = -(-n // n_chunks)
    rows = -(-rows // ROW_TILE) * ROW_TILE
    if rows * klen * 4 > SCRATCH_LIMIT and rows > ROW_TILE:
        rows -= ROW_TILE
    return rows


def gemm_bn(n: int) -> int:
    """N-tile of the tensor-core product: 8 for N <= 8, 128 from WIDE_N
    (K2's d_acc, N = 64 Cin), else 64."""
    if n <= N_TILES[0]:
        return N_TILES[0]
    return N_TILES[2] if n >= WIDE_N else N_TILES[1]


def gemm_b_floats(k: int, n: int, bf16: bool = False) -> int:
    """Floats of the product's B scratch for a (k, n) B: its TF32 hi and lo
    parts, each (N padded to the N-tile, k padded to K_TILE), K-major; or,
    for the bf16 product, one such array of bf16 (half a float each)."""
    bn = gemm_bn(n)
    size = (-(-n // bn) * bn) * (-(-max(k, 1) // K_TILE) * K_TILE)
    return size // 2 if bf16 else 2 * size


def product_splits(m: int, n: int, k: int) -> tuple:
    """(splits, k per split) of an (m, k) x (k, n) tensor-core product, the
    splits summed in order. Its GEMM_SMS persistent blocks walk (ROW_TILE,
    N-tile, split) units, so a split count s costs about the busiest
    block's k-tiles, ceil(units / GEMM_SMS) * (k-tiles per split +
    UNIT_TILES for a unit's start and store), times the partial sums'
    traffic, 1 + 2 s n / k of the bytes of A; the cheapest s (the fewest
    among equals) is taken, each split at least 4 k-tiles. On an H100 this
    picked the fastest measured count at each bench product
    (tools/split_gemm_bench.py --sweep)."""
    tiles = -(-m // ROW_TILE) * -(-n // gemm_bn(n))
    k_tiles = -(-max(k, 1) // K_TILE)
    best = None
    for want in range(1, max(1, min(32, k_tiles // 4)) + 1):
        per = -(-k_tiles // want)
        s = -(-k_tiles // per)
        cost = (-(-tiles * s // GEMM_SMS) * (per + UNIT_TILES)
                * (1 + 2 * s * n / max(k, 1)))
        if best is None or cost < best[0]:
            best = (cost, s, per * K_TILE)
    return best[1], best[2]


def dw_split(n: int, klen: int, cout: int) -> tuple:
    """(splits over the rows of one chunk, rows per split) of K2's dW
    product rows^T ct, each split a multiple of 32 rows."""
    return product_splits(klen, cout, n)


def _check_cuda_args(weights, qplan, qpos_s, cplan, cpos_s, feats_s):
    dev = qpos_s.device
    kz, ky, kx, cin, _ = weights.shape
    if kz * ky * kx > 64 or min(kz, ky, kx) < 2:
        raise ValueError(f"filter grid {(kz, ky, kx)}: each axis needs 2 to "
                         f"4 taps")
    for name, t in (("weights", weights), ("qpos_s", qpos_s),
                    ("cpos_s", cpos_s), ("feats_s", feats_s)):
        check_tensor(name, t, dev)
    for name in ("gcol", "gzlo", "gzhi", "gstart"):
        check_tensor(f"qplan.{name}", getattr(qplan, name), dev, torch.int32)
    check_tensor("cplan.pstarts", cplan.pstarts, dev, torch.int32)
    if qpos_s.shape[0] < qplan.n or qpos_s.shape[1] != 3:
        raise ValueError(f"qpos_s {tuple(qpos_s.shape)} vs {qplan.n} queries")
    if cpos_s.shape[0] < cplan.n or cpos_s.shape[1] != 3:
        raise ValueError(f"cpos_s {tuple(cpos_s.shape)} vs {cplan.n} points")
    if feats_s.shape[0] < cplan.n or feats_s.shape[1] != cin:
        raise ValueError(f"feats_s {tuple(feats_s.shape)} vs ({cplan.n}, "
                         f"{cin})")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _scratch(floats: int, dev):
    return torch.empty((floats,), dtype=torch.float32, device=dev)


def _bf16(shape, dev):
    return torch.empty(shape, dtype=torch.bfloat16, device=dev)


def scratch_rows(n: int, klen: int, precision: str, dev) -> torch.Tensor:
    """The scratch rows one K1 or K2 call holds: a chunk of query rows of
    klen entries, f32, or bf16 at 'default' (the bf16 walks write their
    rows, and the product's epilogue d_acc, in bf16: half the bytes)."""
    dtype = torch.bfloat16 if conv_bf16(precision) else torch.float32
    return torch.empty((min(scratch_chunk_rows(n, klen), n), klen),
                       dtype=dtype, device=dev)


def fused_cconv_cuda(weights, qplan, qpos_s, cplan, cpos_s, feats_s,
                     radius: float, exclude_self: bool,
                     precision: str = "highest"):
    """K1. Returns (out (Nq, Cout), counts (Nq,)) in sorted query order. A
    filter that fits shared memory is folded by the walk; otherwise the walk
    writes its tap-feature rows to a scratch chunk and the tensor-core
    product folds them. At 'default' the bf16 instantiations run."""
    check_plans(qplan, cplan, radius)
    _check_cuda_args(weights, qplan, qpos_s, cplan, cpos_s, feats_s)
    bf16 = conv_bf16(precision)
    dev = qpos_s.device
    kz, ky, kx, cin, cout = weights.shape
    n_taps, n = kz * ky * kx, qplan.n
    out = torch.empty((n, cout), dtype=torch.float32, device=dev)
    cnt = torch.empty((n,), dtype=torch.float32, device=dev)
    d0, d1, d2 = qplan.dims
    if n:
        fold = w_fits_shared(n_taps, cin, cout)
        qb, threads = (walk_config_bf16 if bf16 else walk_config)(
            n_taps, cin, cout, fold)
        klen = n_taps * cin
        chunk = 0 if fold else scratch_chunk_rows(n, klen)
        rows = bt = part = None
        k_splits, k_per = 1, 0
        if not fold:
            rows = scratch_rows(n, klen, precision, dev)
            bt = _scratch(gemm_b_floats(klen, cout, bf16), dev)
            k_splits, k_per = product_splits(min(chunk, n), cout, klen)
            if k_splits > 1:
                part = _scratch(k_splits * min(chunk, n) * cout, dev)
        geometry = (d0, d1, d2, kz, ky, kx, cin, cout,
                    float(np.float32(1.0 / radius)), int(exclude_self))
        plans = (qplan.gcol.data_ptr(), qplan.gzlo.data_ptr(),
                 qplan.gzhi.data_ptr(), qplan.gstart.data_ptr(),
                 cplan.pstarts.data_ptr(), qpos_s.data_ptr(),
                 cpos_s.data_ptr(), feats_s.data_ptr())
        if bf16:
            fbf = _bf16((feats_s.shape[0], bf16_feat_width(cin)), dev)
            BF16_KERNELS["K1"](
                *plans, fbf.data_ptr(), weights.data_ptr(), out.data_ptr(),
                cnt.data_ptr(), _ptr(rows), _ptr(bt), _ptr(part),
                feats_s.shape[0], qplan.n_groups, qplan.group_size, n, chunk,
                k_splits, k_per, qb, threads, *geometry)
        else:
            KERNEL(*plans, weights.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                   _ptr(rows), _ptr(bt), _ptr(part), qplan.n_groups,
                   qplan.group_size, n, chunk, k_splits, k_per, qb, threads,
                   *geometry)
    return out, cnt


def fused_cconv_bwd_cuda(weights, qplan, qpos_s, cplan, cpos_s, feats_s, ct,
                         radius: float, exclude_self: bool, needs,
                         precision: str = "highest"):
    """K2: one call computes what `needs` asks of (dW, dq, dc, dfeats).
    d_acc = ct W^T is a tensor-core product into scratch rows (or contracted
    by the walk from a filter that fits shared memory); the backward walk
    stores dq rows from the block that owns the query and adds dc and
    dfeats with f32 atomics (their summation order varies from run to run);
    dW is the forward walk's tap-feature rows against ct, a tensor-core
    product over fixed splits of the rows summed in order. One scratch
    buffer serves d_acc and the rows in turn, a chunk of query rows at a
    time. At 'default' the bf16 instantiations run."""
    check_plans(qplan, cplan, radius)
    _check_cuda_args(weights, qplan, qpos_s, cplan, cpos_s, feats_s)
    check_tensor("ct", ct, qpos_s.device)
    bf16 = conv_bf16(precision)
    need_w, need_q, need_c, need_f = needs
    dev = qpos_s.device
    kz, ky, kx, cin, cout = weights.shape
    n_taps, n = kz * ky * kx, qplan.n
    if ct.shape != (n, cout):
        raise ValueError(f"ct {tuple(ct.shape)} != ({n}, {cout})")
    klen = n_taps * cin
    need_pos = need_q or need_c
    dq = torch.zeros_like(qpos_s) if need_pos else None
    dc = torch.zeros_like(cpos_s) if need_pos else None
    df = torch.zeros_like(feats_s) if need_f else None
    dw = torch.empty((klen, cout), dtype=torch.float32, device=dev) \
        if need_w else None
    if n and (need_w or need_pos or need_f):
        local = w_fits_shared(n_taps, cin, cout)
        config = walk_config_bf16 if bf16 else walk_config
        qb_f, threads_f = config(n_taps, cin, cout, False)
        qb_b, threads_b = config(n_taps, cin, cout, local, backward=True)
        chunk = scratch_chunk_rows(n, klen)
        n_split, rows = dw_split(min(chunk, n), klen, cout)
        scratch = scratch_rows(n, klen, precision, dev) \
            if need_w or not local else None
        part = torch.empty((-(-n // chunk) * n_split, klen, cout),
                           dtype=torch.float32, device=dev) \
            if need_w else None
        b_floats = max(
            gemm_b_floats(min(chunk, n), cout, bf16) if need_w else 0,
            gemm_b_floats(cout, klen, bf16)
            if (need_pos or need_f) and not local else 0)
        bt = _scratch(b_floats, dev) if b_floats else None
        wt = weights.reshape(klen, cout).t().contiguous()
        d0, d1, d2 = qplan.dims
        geometry = (d0, d1, d2, kz, ky, kx, cin, cout,
                    float(np.float32(1.0 / radius)), int(exclude_self))
        plans = (qplan.gcol.data_ptr(), qplan.gzlo.data_ptr(),
                 qplan.gzhi.data_ptr(), qplan.gstart.data_ptr(),
                 cplan.pstarts.data_ptr(), qpos_s.data_ptr(),
                 cpos_s.data_ptr(), feats_s.data_ptr())
        outs = (_ptr(dw), _ptr(dq), _ptr(dc), _ptr(df))
        if bf16:
            fbf = _bf16((feats_s.shape[0], bf16_feat_width(cin)), dev)
            ct16 = _bf16((n, cout), dev) if (need_pos or need_f) \
                and not local else None
            BF16_KERNELS["K2"](
                *plans, fbf.data_ptr(), wt.data_ptr(), ct.data_ptr(),
                _ptr(ct16), _ptr(scratch), _ptr(part), _ptr(bt), *outs,
                feats_s.shape[0], qplan.n_groups, qplan.group_size, n, chunk,
                n_split, rows, int(local), qb_f, qb_b, *geometry)
        else:
            BWD_KERNEL(*plans, wt.data_ptr(), ct.data_ptr(), _ptr(scratch),
                       _ptr(part), _ptr(bt), *outs, qplan.n_groups,
                       qplan.group_size, n, chunk, n_split, rows, int(local),
                       qb_f, threads_f, qb_b, threads_b, *geometry)
    elif need_w:
        dw.zero_()
    return ((dw.reshape(weights.shape) if need_w else None),
            dq if need_q else None, dc if need_c else None, df)


def split_gemm_plain(a, b, trans_a: bool = False, precision: str = "highest"):
    """Plain version of the tensor-core product: a b, or a^T b, at
    'default' of the bf16-rounded operands (a may be bf16 there, as
    `split_gemm_cuda` takes it; the plain K1 and K2 contract with `@`
    themselves; the tests and `chip_smoke.py` hold `split_gemm_cuda`
    against a float64 product)."""
    rnd = _rounding(precision)
    return rnd((a.t() if trans_a else a).float()) @ rnd(b)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32):
    half a TF32 unit added to the magnitude's bits, the low 13 dropped."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def gemm_b_prep_plain(b: torch.Tensor, precision: str = "highest"
                      ) -> torch.Tensor:
    """Plain version of the product's B prep (`split_gemm_kernel_b`): b (K,
    N) transposed to K-major, split into TF32 hi = tf32(b) and lo =
    tf32(b - hi), zero-padded to (N-tile, K_TILE) multiples: (2, N_pad,
    K_pad), the layout of its scratch (`gemm_b_floats`). At 'default'
    (`split_gemm_kernel_b_bf16`) b^T rounded to bf16, padded the same:
    (N_pad, K_pad) in torch.bfloat16."""
    k, n = b.shape
    bn = gemm_bn(n)
    if conv_bf16(precision):
        out = b.new_zeros((-(-n // bn) * bn, -(-max(k, 1) // K_TILE) * K_TILE),
                          dtype=torch.bfloat16)
        out[:n, :k] = b.t().to(torch.bfloat16)
        return out
    out = b.new_zeros((2, -(-n // bn) * bn, -(-max(k, 1) // K_TILE) * K_TILE))
    hi = tf32_round(b.t())
    out[0, :n, :k] = hi
    out[1, :n, :k] = tf32_round(b.t() - hi)
    return out


def split_gemm_cuda(a, b, trans_a: bool = False, n_split: int = 1,
                    k_per_split: int = 0, precision: str = "highest"):
    """The tensor-core product of `csrc/split_gemm.cuh` on its own: a (M, K)
    (or (K, M) with trans_a) times b (K, N), f32, each operand split into
    two TF32 parts and three products summed in f32; at 'default' a in
    bf16 (as K1d's and K2d's walks write their rows), b rounded to bf16,
    one bf16 product, each chain of 32 k summed in f32. With n_split > 1
    the K range is cut into splits of k_per_split (a multiple of 32) whose
    products are summed in order, as K1's fold and K2's dW do
    (`product_splits`)."""
    bf16 = conv_bf16(precision)
    dev = a.device
    check_tensor("a", a, dev, torch.bfloat16 if bf16 else torch.float32)
    check_tensor("b", b, dev)
    k, m = a.shape if trans_a else a.shape[::-1]
    if b.shape[0] != k:
        raise ValueError(f"a {tuple(a.shape)} (trans_a {trans_a}) vs b "
                         f"{tuple(b.shape)}")
    n = b.shape[1]
    if n_split > 1 and (k_per_split % 32 or n_split * k_per_split < k):
        raise ValueError(f"{n_split} splits of {k_per_split} do not cover "
                         f"k = {k} in multiples of 32")
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((n_split, m, n), dtype=torch.float32, device=dev) \
        if n_split > 1 else None
    if m and n:
        bt = _scratch(gemm_b_floats(k, n, bf16), dev)
        kernel = BF16_KERNELS["product"] if bf16 else GEMM_KERNEL
        kernel(a.data_ptr(), b.data_ptr(), c.data_ptr(), _ptr(part),
               bt.data_ptr(), m, n, k, int(trans_a), n_split, k_per_split)
    return c


def product_launches(precision: str = "highest") -> int:
    """Launches of the tensor-core product at `precision` so far in this
    process, inside K1 and K2 (K1d and K2d) and alone, as the library of
    that precision counts them where it launches them
    (`nf_product_launches`); 0 before it is loaded."""
    bf16 = conv_bf16(precision)
    lib = cuda.loaded("fused_cconv_bf16.cu" if bf16 else "fused_cconv.cu")
    if lib is None:
        return 0
    fn = lib.nf_product_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return int(fn(int(bf16)))


class FusedCConv(torch.autograd.Function):
    """The fused conv with its backward: K1/K2 for CUDA tensors, the plain
    versions for CPU tensors. When one tensor is passed as both query and
    candidate positions, autograd adds its dq and dc."""

    @staticmethod
    def forward(ctx, weights, qpos_s, cpos_s, feats_s, qplan, cplan,
                radius, exclude_self, precision):
        fwd = fused_cconv_cuda if qpos_s.is_cuda else fused_cconv_plain
        out, cnt = fwd(weights, qplan, qpos_s, cplan, cpos_s, feats_s,
                       radius, exclude_self, precision)
        ctx.save_for_backward(weights, qpos_s, cpos_s, feats_s)
        ctx.plans = (qplan, cplan, radius, exclude_self, precision)
        ctx.mark_non_differentiable(cnt)
        return out, cnt

    @staticmethod
    def backward(ctx, g_out, _g_cnt):
        weights, qpos_s, cpos_s, feats_s = ctx.saved_tensors
        qplan, cplan, radius, exclude_self, precision = ctx.plans
        needs = tuple(ctx.needs_input_grad[:4])
        bwd = fused_cconv_bwd_cuda if qpos_s.is_cuda else fused_cconv_bwd_plain
        dw, dq, dc, df = bwd(weights, qplan, qpos_s, cplan, cpos_s, feats_s,
                             g_out.contiguous(), radius, exclude_self, needs,
                             precision)
        return dw, dq, dc, df, None, None, None, None, None


def fused_cconv(weights, qplan, qpos_s, cplan, cpos_s, feats_s,
                radius: float, exclude_self: bool,
                precision: str = "highest"):
    """Fused continuous conv over the 27-cell candidate range.

    weights: (kz, ky, kx, Cin, Cout) filter grid. qplan/qpos_s: query
    grouping and sorted query positions (Nq + pad, 3). cplan/cpos_s/feats_s:
    candidate layout, sorted positions and features (Nc + pad, .). For
    fluid -> fluid pass the same plan and positions on both sides with
    exclude_self=True. Returns (out (Nq, Cout), counts (Nq,) true in-radius
    neighbour counts), both in sorted query order. K1 (forward) and K2
    (backward) for CUDA tensors, the plain versions for CPU tensors.
    `precision`: a JAX `conv_precision` name (see the module docstring);
    an unknown one raises."""
    conv_bf16(precision)
    return FusedCConv.apply(weights, qpos_s, cpos_s, feats_s, qplan, cplan,
                            radius, exclude_self, precision)
