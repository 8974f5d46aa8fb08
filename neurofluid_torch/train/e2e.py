"""The end-to-end train step (port of neurofluid_tpu/train/e2e.py
`make_e2e_train_step`).

One step, deterministic (no random pixels, jitter or sigma noise inside):
1. one transition step from the detached state (truncated BPTT of length 1);
2. a coarse + fine render of every view at t+1 from the predicted particles;
3. loss = sum over views of MSE(rgb0) + MSE(rgb1), plus
   bd_weight * boundary_L1(pred_pos);
4. one backward pass through both models (the image gradient reaches the
   transition model through the renderer's particle gradient, K4 on the
   card), then one Adam update of each.

`grad_clip_value > 0` clips each model's gradients by their global norm as
optax's `clip_by_global_norm` does (g / ||g|| * c where ||g|| >= c; no
epsilon in the norm) and adds the per-parameter gradient-norm histograms
before and after the clip. The renderer-protection anchor of the JAX step
(`with_anchor`) is not part of this port yet.
"""

from __future__ import annotations

import torch

from neurofluid_torch.train import losses


def grads_or_zeros(params):
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_grads_(params, grads, norm: torch.Tensor, clip: torch.Tensor):
    """Set each `p.grad` to its gradient clipped by the global norm `norm`
    as optax's `clip_by_global_norm` does: unchanged below `clip`, else
    g / norm * clip."""
    keep = norm < clip
    for p, g in zip(params, grads):
        p.grad = torch.where(keep, g, g / norm * clip)


def leaf_norms(tensors) -> torch.Tensor:
    """Per-parameter L2 norms as one vector (the histogram payload)."""
    return torch.stack([torch.linalg.norm(t.reshape(-1)) for t in tensors])


def make_e2e_train_step(transition, renderer, opt_r, opt_t, bounds,
                        bd_weight: float, grad_clip_value: float = 0.0):
    """Build the train step.

    transition: ParticleNet; renderer: RenderNet; opt_r / opt_t: optimizers
    over `renderer.parameters()` / `transition.parameters()` (Adam at 3e-4 /
    1e-5 in the reference; `schedules` gives their `LambdaLR` factors, for
    the caller to step); bounds: `losses.BoxBounds`.

    The step takes (pos, vel, box, box_normals, ro_v (V, 3), rays_v
    (V, R, 6), rgbs_v (V, R, 3), box_plan=None) and returns (loss,
    next_pos, next_vel, aux), next_* detached. aux holds rgbloss_0,
    rgbloss_1, mse0_views, mse1_views, boundary_loss, search_overflow,
    search_cap_exceeded, num_nn_0 (V, R * S0, 1), num_nn_1, and the
    pre-clip grad_norm_renderer and grad_norm_transition; with clipping also
    grad_hist_{renderer,transition}_{before,after}, in `parameters()` order.
    """
    params_r = list(renderer.parameters())
    params_t = list(transition.parameters())

    def train_step(pos, vel, box, nrm, ro_v, rays_v, rgbs_v, box_plan=None):
        opt_r.zero_grad(set_to_none=True)
        opt_t.zero_grad(set_to_none=True)
        pred_pos, pred_vel, _, diag = transition(
            pos.detach(), vel.detach(), box, nrm, box_plan=box_plan)
        outs = [renderer(pred_pos, ro, rays) for ro, rays in zip(ro_v, rays_v)]
        rgb0 = torch.stack([o["rgb0"] for o in outs])
        rgb1 = torch.stack([o["rgb1"] for o in outs])
        mse0 = torch.mean((rgb0 - rgbs_v) ** 2, dim=(1, 2))
        mse1 = torch.mean((rgb1 - rgbs_v) ** 2, dim=(1, 2))
        bd = losses.boundary_loss(pred_pos, bounds)
        loss = torch.sum(mse0 + mse1) + bd_weight * bd
        loss.backward()

        g_r, g_t = grads_or_zeros(params_r), grads_or_zeros(params_t)
        gn_r, gn_t = global_norm(g_r), global_norm(g_t)
        overflow = diag["grid_overflow"]
        for o in outs:
            overflow = overflow | o["overflow"]
        aux = {
            "rgbloss_0": torch.sum(mse0).detach(),
            "rgbloss_1": torch.sum(mse1).detach(),
            "mse0_views": mse0.detach(), "mse1_views": mse1.detach(),
            "boundary_loss": bd.detach(),
            "search_overflow": overflow,
            "search_cap_exceeded": diag["cap_exceeded"],
            "num_nn_0": torch.stack([o["num_nn_0"] for o in outs]).detach(),
            "num_nn_1": torch.stack([o["num_nn_1"] for o in outs]).detach(),
            "grad_norm_renderer": gn_r, "grad_norm_transition": gn_t,
        }
        if grad_clip_value:
            clip = torch.as_tensor(grad_clip_value, dtype=gn_r.dtype,
                                   device=gn_r.device)
            for name, params, grads, gn in (("renderer", params_r, g_r, gn_r),
                                            ("transition", params_t, g_t,
                                             gn_t)):
                before = leaf_norms(grads)
                aux[f"grad_hist_{name}_before"] = before
                aux[f"grad_hist_{name}_after"] = before * torch.minimum(
                    torch.ones_like(clip), clip / (gn + 1e-16))
                clip_grads_(params, grads, gn, clip)
        opt_r.step()
        opt_t.step()
        return loss.detach(), pred_pos.detach(), pred_vel.detach(), aux

    return train_step
