"""The transition model alone: its autoregressive rollout and its 2-step
train step (port of neurofluid_tpu/train/transition.py `make_rollout_fn`
and the `train_step` of `TransitionTrainer.build_steps`)."""

from __future__ import annotations

import torch

from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.train import losses
from neurofluid_torch.train.e2e import (
    clip_grads_, global_norm, grads_or_zeros,
)


def make_rollout_fn(net: ParticleNet):
    """(pos, vel, box, box_normals, n_steps) -> (traj (F, N, 3), diag),
    where diag is the OR over steps of the search-health flags. The box is
    static, so its plan (or, on the `fused` backend, its cell grid) is built
    once for the whole rollout."""

    def rollout(pos, vel, box, box_normals, n_steps: int):
        box_plan = net.make_box_plan(box)
        flags = {k: torch.zeros((), dtype=torch.bool, device=pos.device)
                 for k in ("grid_overflow", "cap_exceeded")}
        traj = []
        for _ in range(n_steps):
            pos, vel, _, diag = net(pos, vel, box, box_normals,
                                    box_plan=box_plan)
            flags = {k: flags[k] | diag[k] for k in flags}
            traj.append(pos)
        return torch.stack(traj), flags

    return rollout


def make_transition_train_step(net: ParticleNet,
                               optimizer: torch.optim.Optimizer,
                               bounds: losses.BoxBounds,
                               grad_clip_value: float = 0.0):
    """Build the transition-only train step over `net.parameters()`.

    The step takes (pos0, vel0, pos1, pos2, box, box_normals,
    box_plan=None): two chained transition steps from (pos0, vel0) with the
    gradient flowing through both, against the ground-truth positions pos1
    and pos2:

        loss = 0.5 wmse(pred1, pos1) + 0.5 wmse(pred2, pos2)
               + boundary(pred1) + boundary(pred2)

    with the neighbour-weighted distance and the boundary L1 of `losses`;
    one backward pass, the gradients clipped by their global norm when
    `grad_clip_value > 0` (as optax's `clip_by_global_norm`), one optimizer
    update. `box_plan` is `net.make_box_plan(box)`, built here when absent.
    Returns (loss, aux), aux holding loss1, loss2, bloss1, bloss2,
    search_overflow, search_cap_exceeded and the pre-clip grad_norm."""
    params = list(net.parameters())

    def train_step(pos0, vel0, pos1, pos2, box, box_normals, box_plan=None):
        optimizer.zero_grad(set_to_none=True)
        if box_plan is None:
            box_plan = net.make_box_plan(box)
        pred1, v1, nn1, diag1 = net(pos0, vel0, box, box_normals,
                                    box_plan=box_plan)
        pred2, _, nn2, diag2 = net(pred1, v1, box, box_normals,
                                   box_plan=box_plan)
        l1 = losses.weighted_mse_loss(pred1, pos1, nn1)
        l2 = losses.weighted_mse_loss(pred2, pos2, nn2)
        b1 = losses.boundary_loss(pred1, bounds)
        b2 = losses.boundary_loss(pred2, bounds)
        loss = 0.5 * l1 + 0.5 * l2 + b1 + b2
        loss.backward()

        grads = grads_or_zeros(params)
        gnorm = global_norm(grads)
        if grad_clip_value:
            clip_grads_(params, grads, gnorm, torch.as_tensor(
                grad_clip_value, dtype=gnorm.dtype, device=gnorm.device))
        optimizer.step()
        aux = {
            "loss1": l1.detach(), "loss2": l2.detach(),
            "bloss1": b1.detach(), "bloss2": b2.detach(),
            "search_overflow": diag1["grid_overflow"] | diag2["grid_overflow"],
            "search_cap_exceeded": (diag1["cap_exceeded"]
                                    | diag2["cap_exceeded"]),
            "grad_norm": gnorm,
        }
        return loss.detach(), aux

    return train_step
