"""warmup_train: `train/warmup.py` `make_warmup_train_step` (the views'
rays rendered from one frame's particles, one backward, one Adam update
at the warm-up stage's rate) on one frame, a pool of view sets in
turn."""

from __future__ import annotations

import torch

from nfbench import inputs
from nfbench.cells import RenderTrainCell


class Entry(RenderTrainCell):
    program_state = ("renderer", "optimizer", "step_fn")

    def build(self) -> None:
        from neurofluid_torch.train.warmup import make_warmup_train_step

        cfg, dev = self.config, self.device
        self.frames = inputs.fluid_frames(cfg["scene"], cfg["particle_net"],
                                          1, self.seed, dev)
        self.particles = self.frames[0][0]
        self.weights = self.build_renderer()
        self.optimizer = torch.optim.Adam(self.renderer.parameters(),
                                          lr=cfg["optimizer"]["warmup_lr"])
        self.step_fn = make_warmup_train_step(self.renderer, self.optimizer)

    def named_parameters(self):
        return self.renderer.named_parameters()

    def optimizer_of(self, name):
        return self.optimizer

    def learning_rates(self) -> dict:
        lr = self.config["optimizer"]["warmup_lr"]
        return {k: lr for k in self.weights}

    def program_step(self, i: int):
        loss, (_, _, overflow) = self.step_fn(self.particles,
                                              *self.batches[i % self.pool])
        return loss, overflow | ~torch.isfinite(loss)

    def reference_loss(self, p, t, precision):
        return self.render_loss(p, self.particles, self.batches[t],
                                precision)

    def work(self) -> dict:
        r_ops, r_bytes = self.render_work(False)
        return {"render_ops": 0.0, "render_bytes": r_bytes,
                "model_ops": r_ops}
