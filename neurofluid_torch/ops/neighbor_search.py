"""Fixed-radius neighbour search with fixed-K lists (port of
neurofluid_tpu/ops/neighbor_search.py): the dense per-cell particle tables,
the neighbour list, and the plain searches over them, tiled brute force
(`radius_search_brute`), the 27-cell grid (`radius_search_grid`), the grid
behind an AABB cull (`radius_search_grid_culled`) and pytorch3d's ball
query (`ball_query`).

Both searches return, per query, up to k in-radius points and the TRUE
(uncapped) count. With `order="nearest"` the k nearest are kept, with
`order="index"` the k of lowest point index. The selection reproduces
`lax.top_k`'s order, ties included: a stable descending sort of the score,
so that of two equal scores the candidate at the lower position comes
first (`torch.topk` promises no order among ties on the card). The search
is discrete and runs detached; only the squared distances carry a
gradient, recomputed from the selected ids (`recompute_sq_dists`).

`selection` takes 'sort' and 'approx', and both are the exact selection:
the JAX package's 'approx' is the TPU's PartialReduce top-k
(`lax.approx_max_k`, recall ~0.95 there), which is exact on every other
backend; a GPU has no such op, so the name is an alias here.

Queries run in chunks of `query_chunk`. The rows of a chunk are
independent, so the last chunk is simply shorter (the JAX package pads it
to the chunk's static shape and drops the padded rows).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from neurofluid_torch.cuda import device_constant
from neurofluid_torch.ops import segment_ops
from neurofluid_torch.utils.profiling import sync_span


def cell_dims(lower, upper, cell_size: float) -> tuple:
    return tuple(
        int(max(1, math.ceil((float(u) - float(l)) / cell_size)))
        for l, u in zip(lower, upper)
    )


def cell_ids(points: torch.Tensor, lower, dims: tuple,
             cell_size: float) -> torch.Tensor:
    """(N,) z-fastest cell id of each point; points outside the box clamp
    to border cells."""
    lo = device_constant(tuple(float(v) for v in lower), points.dtype,
                         points.device)
    hi = device_constant(tuple(int(d) - 1 for d in dims), torch.int64,
                         points.device)
    cell = torch.floor((points - lo) / cell_size).long()
    cell = torch.minimum(torch.clamp(cell, min=0), hi)
    return (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]


class NeighborList(NamedTuple):
    """Fixed-K padded neighbourhoods.

    idx: (Q, K) int32 point indices, -1 where no neighbour; sq_dists: (Q, K)
    squared distances, 0 where no neighbour, differentiable with respect to
    the points and the queries; mask: (Q, K) bool; count: (Q,) int32 true
    number of in-radius neighbours (may exceed K); xyz: optionally the
    selected neighbours' coordinates as three detached (Q, K) tensors
    (arbitrary finite values at masked slots)."""

    idx: torch.Tensor
    sq_dists: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    xyz: tuple | None = None


class CellGrid(NamedTuple):
    """table_x/y/z: (num_cells + 1, cap) coordinates, 0 at empty slots;
    table_idx: (num_cells + 1, cap) original point index, -1 at empty;
    row num_cells is the all-empty sentinel row. overflow: () bool, some
    cell held more than `cap` points (the tail was dropped). points: the
    (N, 3) points the tables were built from, not detached. origin: the
    box's lower corner; cell_size: the cells' edge."""

    table_x: torch.Tensor
    table_y: torch.Tensor
    table_z: torch.Tensor
    table_idx: torch.Tensor
    dims: tuple
    cap: int
    overflow: torch.Tensor
    points: torch.Tensor
    origin: tuple
    cell_size: float


def build_cell_grid(points: torch.Tensor, lower, upper, cell_size: float,
                    max_per_cell: int = 64,
                    valid: torch.Tensor | None = None) -> CellGrid:
    """Sort points by cell and fill `max_per_cell` slots per cell.

    The sort is stable, so a cell's slots hold its points in ascending
    original index; the renderer's first-K selection depends on that
    order. `valid` (N,) bool, optional: points marked False stay out of
    the tables (the sharded ParticleNet's empty halo slots, whose sentinel
    coordinates would otherwise fill a border cell)."""
    dims = cell_dims(lower, upper, cell_size)
    num_cells = dims[0] * dims[1] * dims[2]
    pts = points.detach()
    n, cap, dev = pts.shape[0], max_per_cell, pts.device
    cid = cell_ids(pts, lower, dims, cell_size)
    if valid is not None:  # invalid points sort past every real cell
        cid = torch.where(valid.detach(), cid, num_cells)
    sorted_id, order = torch.sort(cid, stable=True)
    starts = torch.searchsorted(
        sorted_id, torch.arange(num_cells + 1, device=dev))
    overflow = torch.max(starts[1:] - starts[:-1]) > cap
    src = starts[:-1, None] + torch.arange(cap, device=dev)[None, :]
    valid = src < starts[1:, None]  # (num_cells, cap)
    src = torch.clamp(src, 0, n - 1).reshape(-1)
    rows = pts[order][src].reshape(num_cells, cap, 3)
    ids = torch.where(valid, order[src].reshape(num_cells, cap), -1)

    def densify(coord):
        t = torch.where(valid, coord, 0.0)
        return torch.cat([t, torch.zeros_like(t[:1])], dim=0)

    return CellGrid(
        table_x=densify(rows[..., 0]), table_y=densify(rows[..., 1]),
        table_z=densify(rows[..., 2]),
        table_idx=torch.cat([ids, torch.full_like(ids[:1], -1)], dim=0),
        dims=dims, cap=cap, overflow=overflow, points=points,
        origin=tuple(float(x) for x in lower), cell_size=float(cell_size),
    )


def recompute_sq_dists(queries, points, idx, mask, xyz=None):
    """Squared distances of the selected pairs, differentiable with respect
    to `points` and `queries` (the search itself is discrete); 0 at masked
    slots. With `xyz` (the search's selected coordinates) the forward
    gather is skipped (`segment_ops.gather3_values`)."""
    if xyz is not None:
        nb = segment_ops.gather3_values(
            points, idx, *xyz, segment_ops.AdjointPlan(idx, points.shape[0]))
    else:
        nb = segment_ops.take_rows(points, idx).unbind(-1)
    sq = sum((nb[ax] - queries[:, ax, None]) ** 2 for ax in range(3))
    return torch.where(mask, sq, 0.0)


def gather_neighbor_positions(points: torch.Tensor,
                              neighbors: NeighborList) -> torch.Tensor:
    """(Q, K, 3) neighbour coordinates, exactly 0 at padded slots (the
    renderer's smoothing feature inherits pytorch3d's `masked_gather`
    zeros)."""
    nb = segment_ops.take_rows(points, neighbors.idx)
    return torch.where(neighbors.mask[..., None], nb, 0.0)


def _sq_radius(radius: float) -> float:
    """radius^2 rounded as f32 arithmetic rounds it."""
    r = torch.tensor(radius, dtype=torch.float32)
    return float(r * r)


def _select_from_candidates(d2, cand_idx, within, k: int, order: str,
                            selection: str = "sort", cand_xyz=None):
    """Up to k in-radius candidates per query row, as `lax.top_k` orders
    them. d2, within, cand_idx (C, M) (cand_idx the candidates' point ids).
    Returns idx (C, k) int32 (-1 pad), mask (C, k) and, with `cand_xyz`
    (three (C, M) tensors), the selected coordinates (three (C, k),
    arbitrary finite values at invalid slots), else None. The squared
    distances are recomputed from idx (`recompute_sq_dists`)."""
    if selection not in ("sort", "approx"):  # both exact (module doc)
        raise ValueError(f"unknown selection: {selection}")
    m = d2.shape[-1]
    if m < k:  # fewer candidates than slots: pad the candidate axis
        pad = k - m

        def grow(a, fill):
            return torch.cat([a, a.new_full((a.shape[0], pad), fill)], -1)

        d2, within = grow(d2, 0.0), grow(within, False)
        cand_idx = grow(cand_idx, torch.iinfo(torch.int32).max - 1)
        if cand_xyz is not None:
            cand_xyz = tuple(grow(c, 0.0) for c in cand_xyz)
    if order == "index":
        # f32 scores as in the JAX package; point ids < 2^24 are exact
        score = torch.where(within, -cand_idx.to(torch.float32), -math.inf)
    elif order == "nearest":
        score = torch.where(within, -d2.to(torch.float32), -math.inf)
    else:
        raise ValueError(f"unknown order: {order}")
    # lax.top_k: descending, equal scores by ascending position
    top, pos = torch.sort(score, dim=-1, descending=True, stable=True)
    top, pos = top[:, :k], pos[:, :k]
    valid = torch.isfinite(top)
    if order == "index":
        idx = torch.where(valid, (-top).to(torch.int32), -1)
    else:
        idx = torch.where(valid, torch.gather(cand_idx, -1, pos), -1)
    sel_xyz = None
    if cand_xyz is not None:
        sel_xyz = tuple(torch.gather(c, -1, pos) for c in cand_xyz)
    return idx.to(torch.int32), valid, sel_xyz


def _within(d2, r2: float, inclusive: bool, exclude_self: bool):
    within = (d2 <= r2) if inclusive else (d2 < r2)
    if exclude_self:  # coincident points: d^2 is exactly 0 for them
        within = within & (d2 > 0.0)
    return within


def _brute_chunk(q, points, r2, k, order, inclusive, exclude_self,
                 selection, emit_xyz):
    # coordinate-wise (q - p)^2: exactly 0 for coincident points, which
    # exclude_self depends on (the |q|^2 + |p|^2 - 2 q.p form is not)
    d2 = torch.zeros((q.shape[0], points.shape[0]), dtype=q.dtype,
                     device=q.device)
    for ax in range(3):
        diff = q[:, ax, None] - points[None, :, ax]
        d2 = d2 + diff * diff
    within = _within(d2, r2, inclusive, exclude_self)
    count = within.sum(-1, dtype=torch.int32)
    cand_idx = torch.arange(points.shape[0], dtype=torch.int32,
                            device=q.device).expand(d2.shape)
    cand_xyz = (tuple(points[None, :, ax].expand(d2.shape) for ax in range(3))
                if emit_xyz else None)
    idx, mask, xyz = _select_from_candidates(
        d2, cand_idx, within, k, order, selection, cand_xyz)
    return idx, mask, count, xyz


def _grid_chunk(q, grid: CellGrid, radius, r2, k, order, inclusive,
                exclude_self, selection, emit_xyz):
    dims, cap, dev = grid.dims, grid.cap, q.device
    reach = max(1, int(math.ceil(radius / grid.cell_size)))
    num_cells = dims[0] * dims[1] * dims[2]
    # each copy of a host constant to the device waits for the stream
    with sync_span("sync.grid_origin", dev):
        origin = torch.tensor(grid.origin, dtype=q.dtype, device=dev)
    cell = torch.floor((q - origin) / grid.cell_size).long()
    span = torch.arange(-reach, reach + 1, device=dev)
    offsets = torch.stack(torch.meshgrid(span, span, span, indexing="ij"),
                          dim=-1).reshape(-1, 3)  # (O, 3), x slowest
    ncell = cell[:, None, :] + offsets[None]  # (C, O, 3)
    with sync_span("sync.grid_dims", dev):
        dims_t = torch.tensor(dims, device=dev)
    in_grid = ((ncell >= 0) & (ncell < dims_t)).all(-1)
    ncell_id = (ncell[..., 0] * dims[1] + ncell[..., 1]) * dims[2] \
        + ncell[..., 2]
    # out-of-grid lookups read the all-empty sentinel row
    ncell_id = torch.where(in_grid, ncell_id, num_cells)
    c, m = q.shape[0], offsets.shape[0] * cap
    cand_idx = grid.table_idx[ncell_id].reshape(c, m)
    d2 = torch.zeros((c, m), dtype=q.dtype, device=dev)
    cand_xyz = []
    for ax, table in enumerate((grid.table_x, grid.table_y, grid.table_z)):
        coord = table[ncell_id].reshape(c, m)
        diff = coord - q[:, ax, None]
        d2 = d2 + diff * diff
        cand_xyz.append(coord)
    within = _within(d2, r2, inclusive, exclude_self) & (cand_idx >= 0)
    count = within.sum(-1, dtype=torch.int32)
    idx, mask, xyz = _select_from_candidates(
        d2, cand_idx, within, k, order, selection,
        tuple(cand_xyz) if emit_xyz else None)
    return idx, mask, count, xyz


def _chunked(chunk_fn, queries: torch.Tensor, query_chunk: int):
    """chunk_fn over row chunks of the detached queries, concatenated:
    (idx, mask, count, xyz or None)."""
    q = queries.detach()
    chunk = max(1, min(int(query_chunk), q.shape[0]))
    parts = [chunk_fn(q[i:i + chunk])
             for i in range(0, max(q.shape[0], 1), chunk)]
    idx, mask, count = (torch.cat([p[j] for p in parts]) for j in range(3))
    xyz = None
    if parts[0][3] is not None:
        xyz = tuple(torch.cat([p[3][ax] for p in parts]) for ax in range(3))
    return idx, mask, count, xyz


def radius_search_brute(queries: torch.Tensor, points: torch.Tensor,
                        radius: float, k: int, order: str = "nearest",
                        inclusive: bool = True, exclude_self: bool = False,
                        query_chunk: int = 4096, selection: str = "sort",
                        emit_xyz: bool = False) -> NeighborList:
    """Exact fixed-radius search by tiled brute force: queries (Q, 3)
    against every one of points (N, 3), each chunk of queries one (C, N)
    distance matrix and one selection. `inclusive`: d^2 <= r^2, else
    d^2 < r^2; `exclude_self`: points at distance 0 are no neighbours."""
    p_det = points.detach()
    r2 = _sq_radius(radius)
    idx, mask, count, xyz = _chunked(
        lambda q: _brute_chunk(q, p_det, r2, k, order, inclusive,
                               exclude_self, selection, emit_xyz),
        queries, query_chunk)
    sq = recompute_sq_dists(queries, points, idx, mask, xyz=xyz)
    return NeighborList(idx, sq, mask, count, xyz)


def radius_search_grid(queries: torch.Tensor, grid: CellGrid, radius: float,
                       k: int, order: str = "nearest", inclusive: bool = True,
                       exclude_self: bool = False, query_chunk: int = 4096,
                       selection: str = "sort", emit_xyz: bool = False):
    """Fixed-radius search against a prebuilt `CellGrid`: each query's
    candidates are the table rows of the (2 reach + 1)^3 cells around its
    own (reach = ceil(radius / cell_size); 27 cells when the cell is the
    radius), in cell order, then slot order. Returns (NeighborList,
    grid.overflow): when a cell held more than its cap the tail was dropped
    from the tables, and a neighbourhood may miss points."""
    r2 = _sq_radius(radius)
    idx, mask, count, xyz = _chunked(
        lambda q: _grid_chunk(q, grid, radius, r2, k, order, inclusive,
                              exclude_self, selection, emit_xyz),
        queries, query_chunk)
    # the tables hold original point ids
    sq = recompute_sq_dists(queries, grid.points, idx, mask, xyz=xyz)
    return NeighborList(idx, sq, mask, count, xyz), grid.overflow


def radius_search_grid_culled(queries: torch.Tensor, grid: CellGrid,
                              radius: float, k: int, capacity: int,
                              order: str = "nearest", inclusive: bool = True,
                              exclude_self: bool = False,
                              query_chunk: int = 4096,
                              selection: str = "sort",
                              emit_xyz: bool = False):
    """`radius_search_grid` over the queries inside the points' AABB
    inflated by `radius` only: the others provably have no neighbour.

    The queries are partitioned stably, inside first; the first `capacity`
    of them are searched and the results go back by the inverse
    permutation; a query outside, or inside beyond `capacity`, gets the
    empty result (count 0, ids -1). Identical to the uncapped search
    whenever at most `capacity` queries are inside; otherwise the returned
    flag is raised (with the grid's own overflow flag OR'ed in)."""
    q = queries.shape[0]
    capacity = int(min(max(capacity, 1), q))
    q_det, p_det = queries.detach(), grid.points.detach()
    lo = p_det.min(dim=0).values - radius
    hi = p_det.max(dim=0).values + radius
    inside = torch.all((q_det >= lo) & (q_det <= hi), dim=-1)  # (Q,)
    cull_overflow = inside.sum() > capacity
    # stable partition by f32 keys, inside first, as the JAX package's
    # argsort; equal keys keep their order, so the slots stay in place
    part = torch.argsort(torch.where(inside, 0.0, 1.0), stable=True)
    r2 = _sq_radius(radius)
    idx_c, mask_c, count_c, xyz_c = _chunked(
        lambda qc: _grid_chunk(qc, grid, radius, r2, k, order, inclusive,
                               exclude_self, selection, emit_xyz),
        q_det[part[:capacity]], query_chunk)
    rank = torch.empty_like(part)
    rank[part] = torch.arange(q, device=part.device)
    in_compact = (rank < capacity) & inside
    safe_rank = torch.clamp(rank, max=capacity - 1)
    idx = torch.where(in_compact[:, None], idx_c[safe_rank], -1)
    mask = in_compact[:, None] & mask_c[safe_rank]
    count = torch.where(in_compact, count_c[safe_rank], 0)
    xyz = None
    if xyz_c is not None:
        xyz = tuple(torch.where(in_compact[:, None], c[safe_rank], 0.0)
                    for c in xyz_c)
    sq = recompute_sq_dists(queries, grid.points, idx, mask, xyz=xyz)
    return (NeighborList(idx, sq, mask, count, xyz),
            grid.overflow | cull_overflow)


def radius_search(queries: torch.Tensor, points: torch.Tensor, radius: float,
                  k: int, order: str = "nearest", inclusive: bool = True,
                  exclude_self: bool = False,
                  query_chunk: int = 4096) -> NeighborList:
    """The default search: `radius_search_brute`."""
    return radius_search_brute(queries, points, radius, k, order=order,
                               inclusive=inclusive, exclude_self=exclude_self,
                               query_chunk=query_chunk)


def ball_query(queries: torch.Tensor, points: torch.Tensor, radius: float,
               k: int, query_chunk: int = 4096) -> NeighborList:
    """pytorch3d's ball query (reference models/renderer.py:112-122): the
    first k points by index at d^2 < r^2 (strict), squared distances, ids
    -1 and distances 0 at padded slots; by brute force."""
    return radius_search_brute(queries, points, radius, k, order="index",
                               inclusive=False, exclude_self=False,
                               query_chunk=query_chunk)
