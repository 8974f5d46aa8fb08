"""Faults planted in the program underneath a run, for the readings that
set the upper end of a limit and for the tests that see `correct` come
out false: each patches the port's own function while the context is
open.

- unchanged: Adam's update runs (its moments as usual) and the weights
  are put back, so the state the step returns is the state it got;
- half: the loss is taken over half of the batch, the mean over the rest
  (the transition step's particles, a render step's rays);
- altered: every frame's fine colour is moved by 0.01 where it is made.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}: expected one of {FAULTS}")
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        init, step = torch.optim.Adam.__init__, torch.optim.Adam.step

        def remember(self, *a, **k):
            init(self, *a, **k)
            self.nfbench_start = {p: p.detach().clone()
                                  for g in self.param_groups
                                  for p in g["params"]}

        def no_update(self, closure=None):
            step(self, closure)
            with torch.no_grad():
                for p, start in self.nfbench_start.items():
                    p.copy_(start)

        patch(torch.optim.Adam, "__init__", remember)
        patch(torch.optim.Adam, "step", no_update)
    elif name == "half":
        from neurofluid_torch.train import e2e, losses, warmup

        full_loss, full_views = losses.weighted_mse_loss, warmup.render_views

        def half_loss(pred, gt, n, *a, **k):
            m = pred.shape[0] // 2
            return full_loss(pred[:m], gt[:m], n[:m], *a, **k)

        def half_views(renderer, particles, ro_v, rays_v, rgbs_v):
            m = rays_v.shape[1] // 2
            return full_views(renderer, particles, ro_v,
                              rays_v[:, :m].contiguous(),
                              rgbs_v[:, :m].contiguous())

        patch(losses, "weighted_mse_loss", half_loss)
        patch(warmup, "render_views", half_views)
        patch(e2e, "render_views", half_views)
    else:
        from neurofluid_torch.models.render_net import RenderNet

        forward = RenderNet.forward

        def altered(self, *a, **k):
            out = forward(self, *a, **k)
            out["rgb1"] = out["rgb1"] + 0.01
            return out

        patch(RenderNet, "forward", altered)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
