"""Plain training loop of the reference: Adam (Kingma and Ba, 2015) with
bias correction, eps added to the corrected root, no gradient clipping.

`follow` runs the first steps of a loss from given parameters and returns
what a program's training is compared on: each step's loss, the first
gradient of each leaf, and each leaf's change after the last step.
`step_from` takes one step from given parameters and Adam moments (a
program's state in its window) and returns the step's loss, gradient and
change.
"""

from __future__ import annotations

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def follow(loss_fn, params: dict, lrs: dict, n_steps: int):
    """loss_fn(p, step) -> loss over the leaves `p` (name -> tensor); lrs:
    name -> learning rate. Returns (losses [float], first gradients
    {name: tensor}, changes {name: tensor})."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    names = list(p)
    losses, first = [], None
    for t in range(1, n_steps + 1):
        loss = loss_fn(p, t - 1)
        grads = torch.autograd.grad(loss, [p[k] for k in names],
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in names:
                p[k].add_(_adam(grads[k], m[k], v2[k], t, lrs[k]))
        del loss, grads
    changes = {k: (p[k].detach() - params[k]) for k in names}
    return losses, first, changes


def _adam(g, m, v, t: int, lr: float):
    """Updates the moments m, v in place with the gradient g at step t
    (from 1) and returns the parameter's change."""
    b1, b2 = BETAS
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    root = torch.sqrt(v / (1.0 - b2 ** t)) + EPS
    return -lr * (m / (1.0 - b1 ** t)) / root


def step_from(loss_fn, params: dict, m: dict, v: dict, steps: dict,
              lrs: dict):
    """One step of loss_fn(p) from the leaves `params` with Adam's moments
    `m`, `v` after `steps` steps (name -> count). Returns (loss, gradients
    {name: tensor}, changes {name: tensor}); the inputs are not changed."""
    p = {k: t.detach().clone().requires_grad_(True) for k, t in params.items()}
    names = list(p)
    loss = loss_fn(p)
    grads = torch.autograd.grad(loss, [p[k] for k in names],
                                allow_unused=True)
    grads = {k: torch.zeros_like(p[k]) if g is None else g.detach()
             for k, g in zip(names, grads)}
    with torch.no_grad():
        # the change as the leaf's own precision holds it: (p + d) - p
        changes = {k: (params[k] + _adam(grads[k], m[k].clone(),
                                         v[k].clone(),
                                         int(round(float(steps[k]))) + 1,
                                         lrs[k])) - params[k]
                   for k in names}
    return float(loss.detach()), grads, changes
