"""Plain reference of NeuroFluid's end-to-end training loop
(`train_e2e.py`) beyond one step: a chain of train steps that carries its
own particle state from frame to frame, the published learning-rate
schedules, and the Pred2GT distance the trainer logs.

- `follow_carried` runs the first steps of the loop from given parameters
  and a starting state: each step's loss from the state the previous step
  left (detached, as the published loop truncates the gradient at one
  step), Adam (`reference.train`'s, no clipping) at each step's learning
  rate;
- `published_lr`: the stage's step schedules as the reference trainer
  builds them, a base rate halved at each milestone the update count has
  passed (renderer 10k / 75k / 150k, transition 10k / 30k / 50k / 100k /
  300k updates);
- `published_draw`: the pixels the published loop draws a view once past
  its centre crop, N distinct pixels uniform over the whole image
  (`np.random.choice(H * W, N, replace=False)`), from a numpy generator's
  state;
- `scene_batch`: a step's rays and targets from a written scene: a
  pinhole camera in Blender's convention (focal 0.5 W / tan(0.5
  camera_angle_x), the ray through pixel (row j, column i) along
  ((i - W/2) / focal, -(j - H/2) / focal, -1) in the camera's frame, turned
  by the pose and made unit), the target the image's colour there over
  255, all in float64;
- `pred2gt_mm`: the mean over the ground-truth particles of the distance
  to the nearest predicted particle, in millimetres, in float64 (the
  reference's `utils/point_eval.py` takes it from a k-d tree; here every
  pair in blocks, on the device the positions are on).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nfbench.reference.train import _adam

RENDERER_MILESTONES = (10_000, 75_000, 150_000)
TRANSITION_MILESTONES = (10_000, 30_000, 50_000, 100_000, 300_000)
GAMMA = 0.5


def published_lr(base: float, milestones, update: int) -> float:
    """The learning rate of update `update` (from 0): `base` times GAMMA
    for each milestone below the update count."""
    return base * GAMMA ** sum(update > m for m in milestones)


def follow_carried(step_loss, params: dict, lr_at, n_steps: int, state):
    """step_loss(p, t, state) -> (loss, next state) for step t (from 0) of
    the loop; lr_at(name, t) the learning rate of a leaf at step t.
    Returns (losses [float], first gradients {name: tensor}, changes
    {name: tensor}, the state after the last step)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    names = list(p)
    losses, first = [], None
    for t in range(n_steps):
        loss, nxt = step_loss(p, t, state)
        grads = torch.autograd.grad(loss, [p[k] for k in names],
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        state = tuple(s.detach() for s in nxt)
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in names:
                p[k].add_(_adam(grads[k], m[k], v2[k], t + 1, lr_at(k, t)))
        del loss, grads
    changes = {k: (p[k].detach() - params[k]) for k in names}
    return losses, first, changes, state


def published_draw(rng_state: dict, n_pixels: int, n_rays: int,
                   n_views: int) -> list:
    """[(n_rays,) flat pixel indices] of n_views views, drawn in turn from
    a numpy generator set to `rng_state`."""
    rng = np.random.Generator(getattr(np.random, rng_state["bit_generator"])())
    rng.bit_generator.state = rng_state
    return [torch.as_tensor(rng.choice(n_pixels, size=n_rays, replace=False))
            for _ in range(n_views)]


def scene_batch(poses: list, camera_angle_x: float, images: list,
                pixels: list, rnd=None) -> tuple:
    """(ro_v (V, 3), rays_v (V, R, 6) [origin, unit direction], rgbs_v
    (V, R, 3)) in float64 of V views: poses[v] the camera-to-world (3, 4),
    images[v] the target (H, W, 3|4) uint8 (RGBA blended onto white),
    pixels[v] (R,) flat indices row x W + column. `rnd`, a rounding of
    float32 operands, rounds the pose and the camera-frame directions
    before the product (in float32), as a unit of that precision would."""
    ro_v, rays_v, rgbs_v = [], [], []
    for c2w, image, idx in zip(poses, images, pixels):
        h, w = image.shape[:2]
        focal = 0.5 * w / math.tan(0.5 * camera_angle_x)
        idx = idx.long().cpu()
        row, col = (idx // w).double(), (idx % w).double()
        d = torch.stack([(col - w / 2) / focal, -(row - h / 2) / focal,
                         -torch.ones_like(col)], dim=-1)
        c2w = c2w.double()
        if rnd is not None:
            c2w, d = rnd(c2w.float()), rnd(d.float())
        d = (d @ c2w[:, :3].T).double()
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = c2w[:, 3].double()
        ro_v.append(o)
        rays_v.append(torch.cat([o.expand(d.shape), d], dim=-1))
        rgb = image.reshape(h * w, -1)[idx].double() / 255.0
        if rgb.shape[-1] == 4:
            rgb = rgb[:, :3] * rgb[:, 3:] + (1.0 - rgb[:, 3:])
        rgbs_v.append(rgb)
    return torch.stack(ro_v), torch.stack(rays_v), torch.stack(rgbs_v)


def pred2gt_mm(pred: torch.Tensor, gt: torch.Tensor,
               block: int = 512) -> float:
    """mean_i min_j |gt_i - pred_j| x 1000 in float64, the ground truth in
    blocks of `block` rows against every predicted particle."""
    p, g = pred.detach().double(), gt.detach().double()
    total = 0.0
    for i in range(0, g.shape[0], block):
        d2 = ((g[i:i + block, None, :] - p[None, :, :]) ** 2).sum(-1)
        total += float(torch.sqrt(d2.min(dim=1).values).sum())
    return 1e3 * total / g.shape[0]
