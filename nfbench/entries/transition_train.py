"""transition_train: `train/transition.py` `make_transition_train_step`
(two chained ParticleNet steps, the weighted-distance and boundary losses,
one backward, Adam) over a pool of seeded frames, in turn."""

from __future__ import annotations

import torch

from nfbench import inputs, work
from nfbench.cells import TrainCell, particle_net, ref_model
from nfbench.reference import particle_net as ref_pn


class Entry(TrainCell):
    program_state = ("net", "optimizer", "step_fn")

    def build(self) -> None:
        from neurofluid_torch.train import losses
        from neurofluid_torch.train.transition import (
            make_transition_train_step)

        cfg, dev = self.config, self.device
        pn = cfg["particle_net"]
        self.weights = inputs.draw_weights(inputs.particle_net_specs(pn),
                                           self.seed, "particle_net", dev)
        self.frames = inputs.fluid_frames(cfg["scene"], pn, self.pool,
                                          self.seed, dev)
        self.box, self.box_normals = inputs.container(cfg["scene"], dev)
        self.net = particle_net(pn, dev)
        self.net.load_state_dict(self.weights)
        self.optimizer = torch.optim.Adam(
            self.net.parameters(), lr=cfg["optimizer"]["transition_lr"])
        self.step_fn = make_transition_train_step(
            self.net, self.optimizer,
            losses.default_box_bounds(pn["particle_radius"], dev), 0.0)

    def named_parameters(self):
        return self.net.named_parameters()

    def optimizer_of(self, name):
        return self.optimizer

    def learning_rates(self) -> dict:
        lr = self.config["optimizer"]["transition_lr"]
        return {k: lr for k in self.weights}

    def program_step(self, i: int):
        loss, aux = self.step_fn(*self.frames[i % self.pool], self.box,
                                 self.box_normals)
        bad = (aux["search_overflow"] | aux["search_cap_exceeded"]
               | ~torch.isfinite(loss))
        return loss, bad

    def reference_loss(self, p, t, precision):
        return ref_pn.transition_loss(
            p, self.frames[t], self.box, self.box_normals,
            ref_model(self.config["particle_net"]),
            ref_pn.Precision(precision["conv"], precision["dense"]))

    def work(self) -> dict:
        pn = self.config["particle_net"]
        n, nb = self.frames[0][0].shape[0], self.box.shape[0]
        ff, fb = self.pair_counts()
        conv_ops, conv_bytes = work.conv_work(pn, n, nb, ff, fb, True)
        return {"conv_ops": 2 * conv_ops, "conv_bytes": 2 * conv_bytes,
                "model_ops": 2 * (conv_ops + work.dense_ops(pn, n, True))}
