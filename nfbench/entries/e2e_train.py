"""e2e_train: `train/e2e.py` `make_e2e_train_step` (a ParticleNet step
from the detached state, a coarse + fine render of the views' rays, the
RGB and boundary losses, one backward, two Adam updates) over a pool of
(frame, views) in turn."""

from __future__ import annotations

import torch

from nfbench import inputs, work
from nfbench.cells import RenderTrainCell, particle_net, ref_model
from nfbench.reference import particle_net as ref_pn


class Entry(RenderTrainCell):
    program_state = ("net", "renderer", "opt_r", "opt_t", "step_fn",
                     "box_plan")

    def build(self) -> None:
        from neurofluid_torch.train import losses
        from neurofluid_torch.train.e2e import make_e2e_train_step

        cfg, dev = self.config, self.device
        pn, opt = cfg["particle_net"], cfg["optimizer"]
        self.weights = inputs.draw_weights(inputs.particle_net_specs(pn),
                                           self.seed, "particle_net", dev)
        self.frames = inputs.fluid_frames(cfg["scene"], pn, self.pool,
                                          self.seed, dev)
        self.box, self.box_normals = inputs.container(cfg["scene"], dev)
        self.net = particle_net(pn, dev)
        self.net.load_state_dict(self.weights)
        self.weights.update(self.build_renderer())
        self.opt_r = torch.optim.Adam(self.renderer.parameters(),
                                      lr=opt["renderer_lr"])
        self.opt_t = torch.optim.Adam(self.net.parameters(),
                                      lr=opt["transition_lr"])
        self.step_fn = make_e2e_train_step(
            self.net, self.renderer, self.opt_r, self.opt_t,
            losses.default_box_bounds(pn["particle_radius"], dev),
            opt["boundary_weight"], 0.0)
        self.box_plan = self.net.make_box_plan(self.box)
        self.transition_names = {k for k, _ in self.net.named_parameters()}

    def named_parameters(self):
        yield from self.net.named_parameters()
        yield from self.renderer.named_parameters()

    def groups(self) -> dict:
        """The renderer's leaves and the transition model's apart: the
        transition model's gradient reaches it through the render as a
        nearly cancelling sum, which f32 rounding sets to a few percent
        (PERF.md, e2e-train's readings against a float64 reference)."""
        return {"renderer": [k for k in self.weights
                             if k not in self.transition_names],
                "transition": sorted(self.transition_names)}

    def optimizer_of(self, name):
        return self.opt_t if name in self.transition_names else self.opt_r

    def learning_rates(self) -> dict:
        opt = self.config["optimizer"]
        return {k: opt["transition_lr"] if k in self.transition_names
                else opt["renderer_lr"] for k in self.weights}

    def program_step(self, i: int):
        pos, vel, *_ = self.frames[i % self.pool]
        loss, _, _, aux = self.step_fn(pos, vel, self.box, self.box_normals,
                                       *self.batches[i % self.pool],
                                       self.box_plan)
        bad = (aux["search_overflow"] | aux["search_cap_exceeded"]
               | ~torch.isfinite(loss))
        return loss, bad

    def reference_loss(self, p, t, precision):
        pn = self.config["particle_net"]
        pos, vel, *_ = self.frames[t]
        pred, _, _ = ref_pn.step(
            p, pos, vel, self.box, self.box_normals, ref_model(pn),
            ref_pn.Precision(precision["conv"], precision["dense"]))
        loss = self.render_loss(p, pred, self.batches[t], precision)
        bounds = ref_pn.box_bounds(pn["particle_radius"], pos.device)
        return loss + self.config["optimizer"]["boundary_weight"] \
            * ref_pn.boundary_loss(pred, bounds)

    def work(self) -> dict:
        pn = self.config["particle_net"]
        n, nb = self.frames[0][0].shape[0], self.box.shape[0]
        ff, fb = self.pair_counts()
        conv_ops, conv_bytes = work.conv_work(pn, n, nb, ff, fb, True)
        r_ops, r_bytes = self.render_work(True)
        return {"conv_ops": conv_ops, "conv_bytes": conv_bytes,
                "render_ops": 0.0, "render_bytes": r_bytes,
                "model_ops": conv_ops + work.dense_ops(pn, n, True) + r_ops}
