"""Dense per-cell particle tables and the fixed-K neighbour list (port of
neurofluid_tpu/ops/neighbor_search.py `build_cell_grid`, `NeighborList` and
`_recompute_sq_dists`)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from neurofluid_torch.ops import segment_ops


def cell_dims(lower, upper, cell_size: float) -> tuple:
    return tuple(
        int(max(1, math.ceil((float(u) - float(l)) / cell_size)))
        for l, u in zip(lower, upper)
    )


def cell_ids(points: torch.Tensor, lower, dims: tuple,
             cell_size: float) -> torch.Tensor:
    """(N,) z-fastest cell id of each point; points outside the box clamp
    to border cells."""
    lo = torch.as_tensor(lower, dtype=points.dtype, device=points.device)
    hi = torch.as_tensor(dims, device=points.device) - 1
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
    (N, 3) points the tables were built from, not detached."""

    table_x: torch.Tensor
    table_y: torch.Tensor
    table_z: torch.Tensor
    table_idx: torch.Tensor
    dims: tuple
    cap: int
    overflow: torch.Tensor
    points: torch.Tensor


def build_cell_grid(points: torch.Tensor, lower, upper, cell_size: float,
                    max_per_cell: int = 64) -> CellGrid:
    """Sort points by cell and fill `max_per_cell` slots per cell.

    The sort is stable, so a cell's slots hold its points in ascending
    original index; the renderer's first-K selection depends on that
    order."""
    dims = cell_dims(lower, upper, cell_size)
    num_cells = dims[0] * dims[1] * dims[2]
    pts = points.detach()
    n, cap, dev = pts.shape[0], max_per_cell, pts.device
    sorted_id, order = torch.sort(cell_ids(pts, lower, dims, cell_size),
                                  stable=True)
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
