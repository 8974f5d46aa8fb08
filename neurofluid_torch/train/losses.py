"""Loss functions of the training stages (port of
neurofluid_tpu/train/losses.py).

- RGB MSE and PSNR;
- the neighbour-weighted particle distance, importance exp(-n / 40) and
  dist^0.5;
- the mean-teacher EMA of two state_dicts;
- boundary L1 against the positions clipped to the z-up container
  x, y in +-(1 - r), z in [-1 + r, 2.4552 - r]. Inside the box the
  difference is exactly 0 and abs'(0) = 0, so those particles get no
  gradient, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PARTICLE_RADIUS = 0.025


class BoxBounds(NamedTuple):
    lower: torch.Tensor  # (3,)
    upper: torch.Tensor  # (3,)


def default_box_bounds(particle_radius: float = PARTICLE_RADIUS,
                       device="cpu") -> BoxBounds:
    """The reference's container."""
    r = particle_radius
    return BoxBounds(
        torch.tensor([-1.0 + r, -1.0 + r, -1.0 + r], device=device),
        torch.tensor([1.0 - r, 1.0 - r, 2.4552 - r], device=device))


def clip_to_box(pos: torch.Tensor, bounds: BoxBounds) -> torch.Tensor:
    return torch.clamp(pos, bounds.lower.to(pos), bounds.upper.to(pos))


def boundary_loss(pos: torch.Tensor, bounds: BoxBounds) -> torch.Tensor:
    """Mean L1 distance to the clipped position."""
    return torch.mean(torch.abs(pos - clip_to_box(pos, bounds)))


def weighted_mse_loss(pred_pos, gt_pos, num_fluid_neighbors,
                      gamma: float = 0.5, neighbor_scale: float = 1.0 / 40.0):
    """Importance-weighted particle distance."""
    importance = torch.exp(-neighbor_scale * num_fluid_neighbors)
    dist = torch.sqrt(torch.sum((pred_pos - gt_pos) ** 2, dim=-1) + 1e-12)
    return torch.mean(importance * dist ** gamma)


def ema_update(teacher: dict, student: dict, global_step,
               factor: float = 0.99) -> dict:
    """Mean-teacher EMA of two state_dicts (reference
    trainer/basetrainer.py:164-168): the true average until the exponential
    one is the better estimate, f = min(1 - 1 / (step + 1), factor)."""
    f = min(1.0 - 1.0 / (float(global_step) + 1.0), factor)
    return {k: t * f + student[k] * (1.0 - f) for k, t in teacher.items()}


def img_mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 log10(mse) for [0, 1] images."""
    return -10.0 * torch.log(mse) / torch.log(torch.tensor(10.0))
