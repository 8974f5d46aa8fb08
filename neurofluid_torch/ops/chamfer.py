"""Chamfer distance between point sets (port of
neurofluid_tpu/ops/chamfer.py).

The replacement for pytorch3d's `chamfer_distance` used by the reference
trainers (reference trainer/basetrainer.py:14, 129-134): the symmetric sum
of mean squared nearest-neighbour distances. For the particle counts in
play (~1e4) a chunked |x|^2 + |y|^2 - 2 x.y^T matrix needs no spatial
structure. The product is `torch.matmul`: the JAX package computes it
outside any Pallas kernel too.
"""

from __future__ import annotations

import torch


def _min_sq_dists(x: torch.Tensor, y: torch.Tensor,
                  chunk: int = 4096) -> torch.Tensor:
    """min_j ||x_i - y_j||^2 for each i, over query chunks of x."""
    y_sq = torch.sum(y ** 2, dim=-1)
    chunk = max(1, min(int(chunk), x.shape[0]))
    out = []
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk]
        d2 = (torch.sum(xc ** 2, dim=-1, keepdim=True) + y_sq[None, :]
              - 2.0 * xc @ y.T)
        out.append(torch.clamp(d2, min=0.0).min(dim=-1).values)
    return torch.cat(out) if out else x.new_zeros((0,))


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     chunk: int = 4096) -> torch.Tensor:
    """Symmetric chamfer distance, mean_i min_j d2 + mean_j min_i d2:
    pytorch3d.loss.chamfer_distance's defaults (squared distances, mean
    over points, the two directions summed)."""
    return (torch.mean(_min_sq_dists(x, y, chunk))
            + torch.mean(_min_sq_dists(y, x, chunk)))


def nearest_neighbor_dists(x: torch.Tensor, y: torch.Tensor,
                           chunk: int = 4096) -> torch.Tensor:
    """Euclidean distance from each x to its nearest y (the device-side
    replacement of the reference's cKDTree, utils/point_eval.py:11-14)."""
    return torch.sqrt(_min_sq_dists(x, y, chunk))
