"""Ball-query feature sums for the renderer: K3 (`csrc/ball_features.cu`
`nf_ball_sums`), its backward K4 (`nf_ball_sums_bwd`, same source) and the
plain version of each (port of neurofluid_tpu/ops/ball_features.py).

Per query, 13 sums over the particles within `radius` (strict d^2 < r^2):

    0  count      all in-radius particles (uncapped)
    1  n_sel      selected neighbours (<= k)
    2  nn_count   selected neighbours with d^2 > 0
    3  w_sum      sum of w = max(1 - (d/r)^3, 0) over selected
    4-6           sum of w * neighbour coordinate
    7-9           sum over nn of (c - q)
    10-12         sum over nn of (c - q)^2

Selection is first-k in candidate order: the 27 neighbour cells in order
o -> (o//9 - 1, (o//3)%3 - 1, o%3 - 1) on (x, y, z), then table slots in
order (ascending original particle index, see neighbor_search). Queries are
culled to the particle AABB + radius, sorted by cell and packed into groups
of `group_size` that share one cell, so a group reads exactly 27 table rows.

`ball_feature_sums` is differentiable with respect to the particles only
(`BallFeatureSums`); queries are detached, as in JAX. The gradient reaches a
particle through the cell tables' slot -> particle map (`table_idx`), so a
particle truncated by `max_per_cell` gets none (the overflow flag is set).
Selection is discrete: only w and the coordinates of selected neighbours
carry gradient.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from neurofluid_torch.cuda import Kernel, check_tensor
from neurofluid_torch.ops.neighbor_search import (
    build_cell_grid, cell_dims, cell_ids,
)

N_SUMS = 13
SENTINEL = 1e9

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("ball_features.cu", "nf_ball_sums",
                [_P] * 6 + [_I] * 6 + [_F, _F, _I] + [_I] * 3)
BWD_KERNEL = Kernel("ball_features.cu", "nf_ball_sums_bwd",
                    [_P] * 8 + [_I] * 6 + [_F, _F, _I] + [_I] * 3)


# The staged walk of K3, K4 and K7 (`csrc/ball_walk.cuh`): one block per
# group copies the occupied prefixes of the group's 27 table rows into
# shared memory as one flattened candidate list, `stage` candidates per
# batch. Up to WHOLE_STAGE_BYTES the 27 rows, with any per-candidate
# accumulator, fit one stage at their full width (one batch, whatever the
# data); a larger cap takes a ring of two stages of RING_STAGE_BYTES each
# (K4: BWD_RING_STAGE_BYTES), batch b + 1 arriving while batch b is walked.
SMEM_LIMIT = 232_448  # a block's shared memory on the H100
GROUP_STATIC_BYTES = 1024  # above the static `Group` of ball_walk.cuh
WHOLE_STAGE_BYTES = 64 * 1024
RING_STAGE_BYTES = 32 * 1024
THREADS = 256  # K3's block: 8 warps take a group's live slots in turn
# K4: x, y, z and the particle id staged; per candidate a (gx, gy, gz)
# accumulator; per live slot its cotangent columns 3-12
BWD_ARRAYS, BWD_ACC_ARRAYS, BWD_STATE_WORDS = 4, 3, N_SUMS - 3
BWD_RING_STAGE_BYTES = 16 * 1024
BWD_THREADS = 256


def walk_plan(cap: int, n_arrays: int, group_size: int, state_words: int,
              acc_arrays: int = 0, ring_bytes: int | None = None) -> tuple:
    """(candidates per stage, stages) of the staged walk over tables of
    width `cap`, staged as `n_arrays` 4-byte arrays (3 for K3, 4 for K4
    and K7) with `acc_arrays` 4-byte accumulators per staged candidate (3
    for K4), for groups of `group_size` slots with `state_words` words of
    per-slot state; a ring's stage holds `ring_bytes` of staged arrays
    (RING_STAGE_BYTES by default). Any cap has a plan; only a group too
    large for one block's shared memory raises (the C side refuses it
    too)."""
    per = 4 * n_arrays
    if 27 * cap * (per + 4 * acc_arrays) <= WHOLE_STAGE_BYTES:
        stage, n_stages = 27 * cap, 1
    else:
        ring = RING_STAGE_BYTES if ring_bytes is None else ring_bytes
        stage, n_stages = ring // per, 2
    need = walk_smem_bytes(stage, n_stages, n_arrays, group_size,
                           state_words, acc_arrays)
    if need + GROUP_STATIC_BYTES > SMEM_LIMIT:
        raise ValueError(f"a group of {group_size} slots needs {need} bytes "
                         f"of shared memory, more than a block has")
    return stage, n_stages


def bwd_walk_plan(cap: int, group_size: int) -> tuple:
    """K4's (candidates per stage, stages) over tables of width `cap`."""
    return walk_plan(cap, BWD_ARRAYS, group_size, BWD_STATE_WORDS,
                     BWD_ACC_ARRAYS, BWD_RING_STAGE_BYTES)


def walk_smem_bytes(stage: int, n_stages: int, n_arrays: int,
                    group_size: int, state_words: int,
                    acc_arrays: int = 0) -> int:
    """Dynamic shared memory of a staged-walk block (`smem_bytes` in
    ball_walk.cuh): the stages, the per-candidate accumulators (one copy),
    then per slot its query, its place in the slot order, its running count
    and the kernel's own state words."""
    return 4 * (n_stages * stage * n_arrays + stage * acc_arrays
                + group_size * (5 + state_words))


class BallGrouping(NamedTuple):
    """order/inv_rank: (Q,) sort of the culled-last cell keys and its
    inverse; gcell: (NG,) int32 cell per group (num_cells for empty groups);
    rep_idx: (NG * T,) sorted-query index per packed slot (capacity for
    padding); cull_overflow: () bool, more in-AABB queries than capacity."""

    order: torch.Tensor
    inv_rank: torch.Tensor
    gcell: torch.Tensor
    rep_idx: torch.Tensor
    capacity: int
    n_groups: int
    group_size: int
    cull_overflow: torch.Tensor


def group_queries(queries, points, radius: float, lower, upper,
                  capacity: int, group_size: int = 32,
                  max_groups: int | None = None) -> BallGrouping:
    """Cull to the particle AABB (+radius), stable-sort by clamped cell id,
    and split each cell's run into groups of <= group_size. The static
    group bound is capacity // T + num_cells + 2.

    `max_groups` caps that bound. Group ids are assigned compactly (empty
    cells get none), so the groups really used number about capacity // T
    plus the occupied cells, far below the bound on a fine grid. A query
    whose group id passes the cap has no packed slot; that is detected and
    OR-ed into `cull_overflow`."""
    return group_queries_on(queries, points, radius, lower,
                            cell_dims(lower, upper, radius), capacity,
                            group_size, max_groups)


def group_queries_on(queries, points, radius: float, lower, dims: tuple,
                     capacity: int, group_size: int = 32,
                     max_groups: int | None = None) -> BallGrouping:
    """`group_queries` on the cells of a given geometry, the lower corner
    and `dims` (cell = radius) as a `CellGrid` holds them (`origin`,
    `dims`)."""
    q, p = queries.detach(), points.detach()
    n_q, t, dev = q.shape[0], int(group_size), q.device
    capacity = int(min(max(capacity, t), n_q))
    num_cells = dims[0] * dims[1] * dims[2]

    lo = p.min(dim=0).values - radius
    hi = p.max(dim=0).values + radius
    inside = torch.all((q >= lo) & (q <= hi), dim=-1)
    cull_overflow = inside.sum() > capacity
    key = torch.where(inside, cell_ids(q, lower, dims, radius), num_cells)
    key_sorted, order = torch.sort(key, stable=True)
    inv_rank = torch.empty_like(order)
    inv_rank[order] = torch.arange(n_q, device=dev)
    qcell = key_sorted[:capacity]

    # every key is at most num_cells, so the run of cell num_cells + 1
    # starts at capacity: the last count ends there
    bounds = torch.searchsorted(qcell, torch.arange(num_cells + 2, device=dev))
    starts_cell, counts = bounds[:-1], torch.diff(bounds)
    gbase = torch.cat([counts.new_zeros(1), torch.cumsum(-(-counts // t), 0)])
    rank_in_cell = torch.arange(capacity, device=dev) - starts_cell[qcell]
    group_of_q = gbase[qcell] + rank_in_cell // t
    ng = capacity // t + num_cells + 2
    if max_groups is not None:
        ng = min(ng, max(int(max_groups), capacity // t + 2))
        cull_overflow = cull_overflow | (gbase[-1] > ng)
    gstart = torch.searchsorted(group_of_q, torch.arange(ng + 1, device=dev))
    gcount = torch.diff(gstart)
    first = torch.clamp(gstart[:-1], max=capacity - 1)
    gcell = torch.where(gcount > 0, qcell[first], num_cells).to(torch.int32)
    slot = torch.arange(t, device=dev)[None, :]
    rep_idx = torch.where(slot < gcount[:, None], gstart[:-1, None] + slot,
                          capacity).reshape(-1)
    return BallGrouping(order, inv_rank, gcell, rep_idx, capacity, ng, t,
                        cull_overflow)


def packed_slots(rep_idx: torch.Tensor, capacity: int) -> torch.Tensor:
    """(capacity,) the packed slot of each kept sorted query, from the
    grouping's `rep_idx` (the sorted query of each slot, `capacity` at
    padded slots); 0 for a query with no slot (only a grouping capped by
    `max_groups` leaves one). A kept query has at most one slot, so the
    map is one scatter of fixed size, with no count of the live slots on
    the host: the padded slots write to the extra row `capacity`, which
    is dropped."""
    n_slots, dev = rep_idx.shape[0], rep_idx.device
    slot = torch.zeros(capacity + 1, dtype=torch.long, device=dev)
    slot.scatter_(0, rep_idx, torch.arange(n_slots, device=dev))
    return slot[:capacity]


def build_tables(points, lower, upper, radius: float, max_per_cell: int):
    """Cell tables with empty slots at coordinate SENTINEL, so the distance
    test alone rejects them. Returns (grid, tx, ty, tz)."""
    grid = build_cell_grid(points, lower, upper, radius, max_per_cell)
    empty = grid.table_idx < 0
    tx, ty, tz = (torch.where(empty, SENTINEL, c).contiguous()
                  for c in (grid.table_x, grid.table_y, grid.table_z))
    return grid, tx, ty, tz


def neighbor_rows(gcell: torch.Tensor, dims: tuple) -> torch.Tensor:
    """(NG, 27) table rows of each group's neighbour cells in selection
    order; out-of-grid cells and the sentinel cell map to row num_cells."""
    d0, d1, d2 = dims
    num_cells = d0 * d1 * d2
    c = gcell.long()[:, None]
    o = torch.arange(27, device=c.device)
    ox, oy, oz = o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1
    cx, cy, cz = c // (d1 * d2), (c // d2) % d1, c % d2
    ok = ((c < num_cells) & (cx + ox >= 0) & (cx + ox < d0)
          & (cy + oy >= 0) & (cy + oy < d1) & (cz + oz >= 0) & (cz + oz < d2))
    return torch.where(ok, c + ox * d1 * d2 + oy * d2 + oz, num_cells)


def _select(qc, cx, cy, cz, r2: float, k: int):
    """The plain selection of a chunk of groups: (dx, dy, dz, d2, within,
    selected) over (G, T, 27, cap)."""
    dx = cx - qc[:, :, 0, None, None]
    dy = cy - qc[:, :, 1, None, None]
    dz = cz - qc[:, :, 2, None, None]
    d2 = dx * dx + dy * dy + dz * dz
    within = (cx < 0.5 * SENTINEL) & (d2 < r2)
    rank = torch.cumsum(within.float(), dim=-1)
    cnt = rank[..., -1]
    off = torch.cumsum(cnt, dim=-1) - cnt
    return dx, dy, dz, d2, within, within & (off[..., None] + rank <= k)


def _cell_groups(gcell: torch.Tensor, dims: tuple) -> torch.Tensor:
    """Ids of the groups of a grid cell. The others (the sentinel cell) see
    only the empty row: their sums and gradients are zero, so the plain
    versions skip them."""
    return torch.nonzero(gcell.long() < dims[0] * dims[1] * dims[2])[:, 0]


def ball_sums_plain(q_rep, tx, ty, tz, gcell, dims, radius: float, k: int,
                    group_size: int, chunk_groups: int = 64) -> torch.Tensor:
    """(NG * T, 3) packed queries -> (NG * T, N_SUMS), the math of the TPU
    kernel (`_block_sums_vec`): within-row ranks as a cumulative count, the
    running budget across the 27 rows as an exclusive cumulative count.
    Empty table slots are masked explicitly, so padded query slots (at
    SENTINEL themselves) and sentinel groups sum to zero."""
    ng, t = gcell.shape[0], group_size
    rows = neighbor_rows(gcell, dims)
    qg = q_rep.reshape(ng, t, 3)
    r2 = float(np.float32(radius * radius))
    out = q_rep.new_zeros((ng, t, N_SUMS))
    for chunk in _cell_groups(gcell, dims).split(chunk_groups):
        qc, rc = qg[chunk], rows[chunk]
        cx, cy, cz = tx[rc][:, None], ty[rc][:, None], tz[rc][:, None]
        dx, dy, dz, d2, within, sel = _select(qc, cx, cy, cz, r2, k)
        wf, sf = within.float(), sel.float()
        nn = sf * (d2 > 0.0)
        u = torch.sqrt(torch.clamp(d2, min=1e-24)) / radius
        w = torch.clamp(1.0 - u * u * u, min=0.0) * sf
        terms = (wf, sf, nn, w, w * cx, w * cy, w * cz, nn * dx, nn * dy,
                 nn * dz, nn * dx * dx, nn * dy * dy, nn * dz * dz)
        out[chunk] = torch.stack([v.sum(dim=(2, 3)) for v in terms], dim=-1)
    return out.reshape(ng * t, N_SUMS)


def ball_sums_bwd_plain(q_rep, cot_rep, tx, ty, tz, table_idx, gcell, dims,
                        radius: float, k: int, group_size: int,
                        n_points: int, chunk_groups: int = 64):
    """Plain PyTorch twin of K4, an explicit adjoint: cot_rep (NG * T,
    N_SUMS) cotangent per packed slot -> d_points (n_points, 3). Per
    selected pair, the derivative of the float sums (columns 3-12) with
    respect to the neighbour's coordinates, summed over the group's queries,
    then added into the particles through `table_idx`."""
    ng, t = gcell.shape[0], group_size
    rows = neighbor_rows(gcell, dims)
    qg = q_rep.reshape(ng, t, 3)
    cg = cot_rep.reshape(ng, t, N_SUMS)
    r2 = float(np.float32(radius * radius))
    d_points = q_rep.new_zeros((n_points + 1, 3))  # the last row: empty slots
    idx = torch.where(table_idx < 0, n_points, table_idx)
    for chunk in _cell_groups(gcell, dims).split(chunk_groups):
        qc, rc = qg[chunk], rows[chunk]
        cx, cy, cz = tx[rc][:, None], ty[rc][:, None], tz[rc][:, None]
        dx, dy, dz, d2, _, sel = _select(qc, cx, cy, cz, r2, k)
        c = [v[..., None, None] for v in cg[chunk].unbind(-1)]
        d = torch.sqrt(torch.clamp(d2, min=1e-24))
        u = d / radius
        base = 1.0 - u * u * u
        w = torch.clamp(base, min=0.0) * sel
        coef = torch.where(sel & (base > 0.0) & (d2 > 1e-24),
                           -3.0 * u * u / (radius * d), 0.0)
        a = (c[3] + c[4] * cx + c[5] * cy + c[6] * cz) * coef
        nn = (sel & (d2 > 0.0)).float()
        grads = [a * dx + w * c[4] + nn * (c[7] + 2.0 * c[10] * dx),
                 a * dy + w * c[5] + nn * (c[8] + 2.0 * c[11] * dy),
                 a * dz + w * c[6] + nn * (c[9] + 2.0 * c[12] * dz)]
        per_slot = torch.stack([v.sum(dim=1) for v in grads], -1)
        d_points.index_add_(0, idx[rc].reshape(-1), per_slot.reshape(-1, 3))
    return d_points[:n_points]


def _check_cuda_args(q_rep, tx, ty, tz, gcell, dims, group_size):
    dev = q_rep.device
    ng, t = gcell.shape[0], group_size
    d0, d1, d2 = dims
    for name, a in (("q_rep", q_rep), ("tx", tx), ("ty", ty), ("tz", tz)):
        check_tensor(name, a, dev)
    check_tensor("gcell", gcell, dev, torch.int32)
    if q_rep.shape != (ng * t, 3):
        raise ValueError(f"q_rep {tuple(q_rep.shape)} != ({ng * t}, 3)")
    for a in (tx, ty, tz):
        if a.shape != (d0 * d1 * d2 + 1, tx.shape[1]):
            raise ValueError(f"table {tuple(a.shape)} != "
                             f"({d0 * d1 * d2 + 1}, {tx.shape[1]})")


def ball_sums_cuda(q_rep, tx, ty, tz, gcell, dims, radius: float, k: int,
                   group_size: int) -> torch.Tensor:
    """K3: one block per group, the 27 rows staged once in shared memory,
    the live slots walked in turn; ranks from a warp ballot."""
    _check_cuda_args(q_rep, tx, ty, tz, gcell, dims, group_size)
    ng, t = gcell.shape[0], group_size
    d0, d1, d2 = dims
    out = torch.empty((ng * t, N_SUMS), dtype=torch.float32,
                      device=q_rep.device)
    if ng:
        plan = walk_plan(tx.shape[1], 3, t, N_SUMS)
        KERNEL(q_rep.data_ptr(), tx.data_ptr(), ty.data_ptr(), tz.data_ptr(),
               gcell.data_ptr(), out.data_ptr(), ng, t, d0, d1, d2,
               tx.shape[1], float(np.float32(radius * radius)), float(radius),
               int(k), THREADS, *plan)
    return out


def ball_sums_bwd_cuda(q_rep, cot_rep, tx, ty, tz, table_idx, gcell, dims,
                       radius: float, k: int, group_size: int,
                       n_points: int) -> torch.Tensor:
    """K4: one block per group on K3's staged walk; the slots with a
    cotangent walk to their k-th selected neighbour, the group's gradient
    is summed per candidate in shared memory, then added into d_points by
    one f32 atomic per candidate and axis."""
    _check_cuda_args(q_rep, tx, ty, tz, gcell, dims, group_size)
    dev = q_rep.device
    check_tensor("cot_rep", cot_rep, dev)
    check_tensor("table_idx", table_idx, dev, torch.int32)
    ng, t = gcell.shape[0], group_size
    if cot_rep.shape != (ng * t, N_SUMS) or table_idx.shape != tx.shape:
        raise ValueError(f"cot_rep {tuple(cot_rep.shape)} or table_idx "
                         f"{tuple(table_idx.shape)} disagree with the tables")
    d0, d1, d2 = dims
    d_points = torch.zeros((n_points, 3), dtype=torch.float32, device=dev)
    if ng:
        BWD_KERNEL(q_rep.data_ptr(), cot_rep.data_ptr(), tx.data_ptr(),
                   ty.data_ptr(), tz.data_ptr(), table_idx.data_ptr(),
                   gcell.data_ptr(), d_points.data_ptr(), ng, t, d0, d1, d2,
                   tx.shape[1], float(np.float32(radius * radius)),
                   float(radius), int(k), BWD_THREADS,
                   *bwd_walk_plan(tx.shape[1], t))
    return d_points


class BallFeatureSums(torch.autograd.Function):
    """The sums with their backward with respect to the particles: K3/K4
    for CUDA tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, queries, points, radius, k, lower, upper, max_per_cell,
                capacity_frac, group_size):
        n_q = queries.shape[0]
        capacity = -(-int(n_q * capacity_frac) // 256) * 256
        grouping = group_queries(queries, points, radius, lower, upper,
                                 capacity, group_size)
        capacity = grouping.capacity
        grid, tx, ty, tz = build_tables(points, lower, upper, radius,
                                        max_per_cell)
        q_pad = torch.cat([queries[grouping.order[:capacity]],
                           torch.full_like(queries[:1], SENTINEL)], dim=0)
        q_rep = q_pad[grouping.rep_idx].contiguous()
        fwd = ball_sums_cuda if q_rep.is_cuda else ball_sums_plain
        sums_rep = fwd(q_rep, tx, ty, tz, grouping.gcell, grid.dims, radius,
                       k, grouping.group_size)

        slot_of_sorted = packed_slots(grouping.rep_idx, capacity)
        r = grouping.inv_rank
        kept = r < capacity
        sums = sums_rep[slot_of_sorted[torch.clamp(r, max=capacity - 1)]]
        sums = torch.where(kept[:, None], sums, 0.0)
        overflow = grid.overflow | grouping.cull_overflow

        ctx.save_for_backward(q_rep, tx, ty, tz,
                              grid.table_idx.to(torch.int32), grouping.gcell,
                              grouping.order, grouping.rep_idx)
        ctx.static = (grid.dims, radius, k, grouping.group_size, capacity,
                      points.shape[0])
        ctx.mark_non_differentiable(overflow)
        return sums, overflow

    @staticmethod
    def backward(ctx, g_sums, _g_overflow):
        q_rep, tx, ty, tz, table_idx, gcell, order, rep_idx = ctx.saved_tensors
        dims, radius, k, t, capacity, n_points = ctx.static
        # the forward's final gather, reversed: slot s holds the original
        # query order[rep_idx[s]]; padded slots and culled queries get zero
        src = order[torch.clamp(rep_idx, max=capacity - 1)]
        cot_rep = torch.where((rep_idx < capacity)[:, None], g_sums[src], 0.0)
        bwd = ball_sums_bwd_cuda if q_rep.is_cuda else ball_sums_bwd_plain
        d_points = bwd(q_rep, cot_rep.contiguous(), tx, ty, tz, table_idx,
                       gcell, dims, radius, k, t, n_points)
        return None, d_points, None, None, None, None, None, None, None


def ball_feature_sums(queries, points, radius: float, k: int, lower, upper,
                      max_per_cell: int = 128, capacity_frac: float = 0.625,
                      group_size: int = 32):
    """Per-query sums (Q, N_SUMS) in the original query order, and the
    overflow flag (a table cell held more than max_per_cell particles, or
    more queries than the cull capacity lay inside the particle AABB).
    Culled queries have all-zero sums. Differentiable with respect to
    `points`; the queries are detached."""
    return BallFeatureSums.apply(queries.detach(), points, radius, k,
                                 tuple(lower), tuple(upper), max_per_cell,
                                 capacity_frac, group_size)


def assemble_features(sums, flat_xyz, radius: float, k: int):
    """(density, smoothed_pos, var, num_nn, count) from the sums, with the
    reference's origin-padding term: each of the k - n_sel empty slots
    adds w0 = max(1 - (|q|/r)^3, 0) to the density."""
    count = sums[:, 0]
    n_sel, nn_count, w_sum = sums[:, 1], sums[:, 2], sums[:, 3]
    wx, v, v2 = sums[:, 4:7], sums[:, 7:10], sums[:, 10:13]
    num_nn = torch.clamp(count, max=float(k))[:, None]
    q_norm = torch.sqrt(torch.clamp(torch.sum(flat_xyz ** 2, dim=-1), min=1e-24))
    u = q_norm / radius
    w0 = torch.clamp(1.0 - u * u * u, min=0.0)
    density = (w_sum + (float(k) - n_sel) * w0)[:, None]
    smoothed_pos = wx / (density + 1e-12)
    num_nn_k = num_nn + 1e-12
    vec_mean = v / num_nn_k
    var = (v2 - 2.0 * vec_mean * v + nn_count[:, None] * vec_mean ** 2) / num_nn_k
    return density, smoothed_pos, var, num_nn, count
