"""Fused compact ball query: K7 (`csrc/fused_query.cu`
`nf_ball_query_compact`) and its plain version (port of
neurofluid_tpu/ops/fused_query.py).

Fixed-K neighbour lists for consumers that do not care about the order of
a neighbourhood (the continuous convolutions sum over it, the loss weight
reads the true count). Queries are culled, sorted by cell and packed into
one-cell groups (`ball_features.group_queries`); each packed slot walks
the 27 table rows around its cell in order o -> (o//9 - 1, (o//3)%3 - 1,
o%3 - 1) and keeps the first k particles with d^2 <= r^2 (inclusive; and
d^2 > 0 with `exclude_self`), rows in order, table slots in order. Whenever
count <= k the selected set is that of any other first-k rule. `count` is
always the true, uncapped number of in-radius particles.

No gradient: the ids are discrete and the emitted coordinates are detached
copies. Consumers gather from the point table (`segment_ops`) for
differentiable quantities.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from neurofluid_torch.cuda import Kernel, check_tensor
from neurofluid_torch.ops import ball_features as bf
from neurofluid_torch.ops.neighbor_search import (
    CellGrid, NeighborList, recompute_sq_dists,
)

GROUP_SIZE = 8  # queries per group: a rest-density cell holds ~11 queries
THREADS = 128  # K7's block: 4 warps take a group's live slots in turn

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("fused_query.cu", "nf_ball_query_compact",
                [_P] * 11 + [_I] * 6 + [_F, _I, _I] + [_I] * 3)


def ball_query_compact_plain(q_rep, tx, ty, tz, ti, gcell, dims,
                             radius: float, k: int, group_size: int,
                             exclude_self: bool, emit_xyz: bool,
                             chunk_groups: int = 256):
    """Plain PyTorch twin of K7. q_rep (NG * T, 3) packed queries; tx/ty/tz
    (cells + 1, cap) coordinates with empty slots at the sentinel; ti the
    slots' original ids (int32). Returns (idx (NG * T, k) int32, -1 at
    unfilled slots; count (NG * T,) int32; then x, y, z (NG * T, k), 0 at
    unfilled slots, when emit_xyz).

    The 27 rows of a group laid side by side are its candidates in
    selection order, so one cumulative count of the in-radius test along
    them is each candidate's output slot + 1, and its last entry the true
    count."""
    ng, t = gcell.shape[0], group_size
    rows = bf.neighbor_rows(gcell, dims)
    qg = q_rep.reshape(ng, t, 3)
    r2 = float(np.float32(radius * radius))
    outs = []
    for g0 in range(0, ng, chunk_groups):
        qc, rc = qg[g0:g0 + chunk_groups], rows[g0:g0 + chunk_groups]
        g = qc.shape[0]
        cx, cy, cz = (a[rc].reshape(g, 1, -1) for a in (tx, ty, tz))
        dx = cx - qc[:, :, 0, None]
        dy = cy - qc[:, :, 1, None]
        dz = cz - qc[:, :, 2, None]
        d2 = dx * dx + dy * dy + dz * dz
        # empty table slots sit at the sentinel; so do padded query slots,
        # which are far from every real particle
        within = (cx < 0.5 * bf.SENTINEL) & (d2 <= r2)
        if exclude_self:
            within = within & (d2 > 0.0)
        rank = torch.cumsum(within.to(torch.int32), dim=-1)
        # unselected candidates all land in a spare slot k, dropped below
        slot = torch.where(within & (rank <= k), rank - 1, k).long()
        payloads = [ti[rc].reshape(g, 1, -1)]
        fills = [-1]
        if emit_xyz:
            payloads += [cx, cy, cz]
            fills += [0.0] * 3
        chunk = [rank[..., -1].to(torch.int32)]
        for val, fill in zip(payloads, fills):
            out = val.new_full((g, t, k + 1), fill)
            out.scatter_(-1, slot, val.expand(g, t, -1))
            chunk.append(out[..., :k])
        outs.append(chunk)
    count, *lists = (torch.cat(parts).reshape(ng * t, *parts[0].shape[2:])
                     for parts in zip(*outs))
    return (lists[0], count, *lists[1:])


def ball_query_compact_cuda(q_rep, tx, ty, tz, ti, gcell, dims,
                            radius: float, k: int, group_size: int,
                            exclude_self: bool, emit_xyz: bool):
    """K7: one block per group, the 27 rows' occupied prefixes and ids
    staged once in shared memory, the live slots walked in turn; each
    in-radius lane stores its own id at the slot its ballot rank gives it.
    Same results as the plain version."""
    dev = q_rep.device
    ng, t = gcell.shape[0], group_size
    d0, d1, d2 = dims
    for name, a in (("q_rep", q_rep), ("tx", tx), ("ty", ty), ("tz", tz)):
        check_tensor(name, a, dev)
    check_tensor("ti", ti, dev, torch.int32)
    check_tensor("gcell", gcell, dev, torch.int32)
    if q_rep.shape != (ng * t, 3):
        raise ValueError(f"q_rep {tuple(q_rep.shape)} != ({ng * t}, 3)")
    for a in (tx, ty, tz, ti):
        if a.shape != (d0 * d1 * d2 + 1, tx.shape[1]):
            raise ValueError(f"table {tuple(a.shape)} != "
                             f"({d0 * d1 * d2 + 1}, {tx.shape[1]})")
    idx = torch.empty((ng * t, k), dtype=torch.int32, device=dev)
    count = torch.empty((ng * t,), dtype=torch.int32, device=dev)
    xyz = [torch.empty((ng * t, k), dtype=torch.float32, device=dev)
           for _ in range(3 if emit_xyz else 0)]
    if ng and k:
        plan = bf.walk_plan(tx.shape[1], 4, t, 0)
        KERNEL(q_rep.data_ptr(), tx.data_ptr(), ty.data_ptr(), tz.data_ptr(),
               ti.data_ptr(), gcell.data_ptr(), idx.data_ptr(),
               count.data_ptr(), *(a.data_ptr() for a in xyz),
               *([0] * (3 - len(xyz))), ng, t, d0, d1, d2, tx.shape[1],
               float(np.float32(radius * radius)), int(k), int(exclude_self),
               THREADS, *plan)
    return (idx, count, *xyz)


def ball_query_compact(queries: torch.Tensor, grid: CellGrid, radius: float,
                       k: int, exclude_self: bool = False,
                       group_size: int = GROUP_SIZE,
                       max_occupied_cells: int = 4096,
                       emit_xyz: bool = False):
    """Compact fixed-K neighbour lists of `grid.points` around `queries`.

    The grid's cells must have the radius for their edge; their geometry
    (`grid.origin`, `grid.dims`) is the grid's own. Returns (NeighborList,
    overflow) in the original query order; overflow is True when a grid
    cell held more points than its cap or the grouping ran out of groups,
    in both cases some neighbourhood was not computed in full. With
    `emit_xyz` the list carries the selected coordinates (detached).
    `max_occupied_cells` bounds the groups the packed layout allots to
    partly filled cells (`group_queries(max_groups=...)`): the fluid
    occupies about a tenth of the transition grid's cells. K7 for CUDA
    tensors, the plain version for CPU tensors."""
    q_det = queries.detach()
    n_q, dev = q_det.shape[0], q_det.device
    if grid.cell_size != float(radius):
        raise ValueError(f"grid cell size {grid.cell_size} != radius "
                         f"{radius}: the walk covers 27 cells of the radius")
    dims = grid.dims
    num_cells = dims[0] * dims[1] * dims[2]
    max_groups = (n_q // int(group_size)
                  + min(num_cells, int(max_occupied_cells)) + 2)
    grouping = bf.group_queries_on(q_det, grid.points, radius, grid.origin,
                                   dims, capacity=n_q, group_size=group_size,
                                   max_groups=max_groups)
    capacity, t = grouping.capacity, grouping.group_size

    empty = grid.table_idx < 0
    tx, ty, tz = (torch.where(empty, bf.SENTINEL, c).contiguous()
                  for c in (grid.table_x, grid.table_y, grid.table_z))
    ti = grid.table_idx.to(torch.int32)
    q_pad = torch.cat([q_det[grouping.order[:capacity]],
                       torch.full_like(q_det[:1], bf.SENTINEL)])
    q_rep = q_pad[grouping.rep_idx].contiguous()

    fn = ball_query_compact_cuda if q_rep.is_cuda else ball_query_compact_plain
    idx_rep, count_rep, *xyz_rep = fn(q_rep, tx, ty, tz, ti, grouping.gcell,
                                      dims, radius, k, t, exclude_self,
                                      emit_xyz)

    # packed slots -> original query order. A query that no slot holds (the
    # grouping ran out of groups, flagged) reads the spare empty slot.
    n_slots = grouping.rep_idx.shape[0]
    slot_of_sorted = torch.full((capacity + 1,), n_slots, dtype=torch.long,
                                device=dev)
    slot_of_sorted[grouping.rep_idx] = torch.arange(n_slots, device=dev)
    kept = grouping.inv_rank < capacity
    slot = torch.where(
        kept, slot_of_sorted[torch.clamp(grouping.inv_rank, max=capacity - 1)],
        n_slots)

    def unpack(a, fill):
        return torch.cat([a, a.new_full((1,) + a.shape[1:], fill)])[slot]

    count = unpack(count_rep, 0)
    mask = torch.arange(k, device=dev)[None, :] \
        < torch.clamp(count, max=k)[:, None]
    idx = unpack(idx_rep, -1)
    if emit_xyz:
        xyz = tuple(unpack(a, 0.0) for a in xyz_rep)
        sq = sum(torch.where(mask, c - q_det[:, ax, None], 0.0) ** 2
                 for ax, c in enumerate(xyz))
    else:
        xyz = None
        sq = recompute_sq_dists(queries, grid.points, idx, mask)
    return (NeighborList(idx, sq, mask, count, xyz),
            grid.overflow | grouping.cull_overflow)
