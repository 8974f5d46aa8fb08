"""eval_frame: whole frames through the trainers' chunked renderer
(`TrainerBase.make_chunk_renderer`, no gradient) over a pool of (frame,
camera), in turn. Its numbers: rgb0_gap and rgb1_gap, the largest
absolute gap of a coarse and a fine pixel channel, over a sample of each
rendered frame's rays drawn from the seed."""

from __future__ import annotations

import torch

from nfbench import inputs, work
from nfbench.cells import ref_render_cfg, render_net
from nfbench.reference import render_net as ref_rn


class Entry:
    unit = "frame"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.pool = int(traffic["pool"])
        self.attempted = self.failed = 0
        self.kept = []

    def setup(self) -> None:
        from neurofluid_torch.train.trainer_base import TrainerBase

        cfg, dev = self.config, self.device
        rn = cfg["render_net"]
        self.renderer = render_net(rn, dev)
        self.weights = inputs.draw_weights(inputs.render_net_specs(rn),
                                           self.seed, "render_net", dev)
        self.renderer.load_state_dict(self.weights)
        self.frames = inputs.fluid_frames(cfg["scene"], cfg["particle_net"],
                                          self.pool, self.seed, dev)
        poses = inputs.cameras(cfg["camera"], self.pool, self.seed, dev)
        self.views = [(c2w[:, 3].contiguous(),
                       inputs.pixel_rays(cfg["camera"], c2w)) for c2w in poses]
        n_rays = self.views[0][1].shape[0]
        gen = inputs.generator(self.seed, "checked_rays", dev)
        k = int(self.traffic["checked_rays_per_frame"])
        self.sample = [torch.randperm(n_rays, generator=gen, device=dev)[:k]
                       for _ in range(self.pool)]
        # the trainers' chunked renderer reads nothing of the trainer
        self.render_full = TrainerBase.make_chunk_renderer(
            None, self.renderer, chunk=int(cfg["eval_chunk"]))
        for i in range(int(self.traffic["warm_frames"])):
            self.frame(i, keep=False)

    def frame(self, i: int, keep: bool = True) -> bool:
        j = i % self.pool
        ro, rays = self.views[j]
        out = self.render_full(self.frames[j][0], ro, rays)
        s = self.sample[j]
        bad = out["overflow"].any() | ~torch.isfinite(out["rgb1"]).all()
        if keep:
            self.kept.append((j, out["rgb0"][s], out["rgb1"][s]))
        return bool(bad)

    def run_unit(self, i: int, share: float) -> bool:
        bad = self.frame(i)
        self.attempted += 1
        self.failed += int(bad)
        return bad

    def settled(self) -> bool:
        return True

    def release(self) -> None:
        self.renderer = self.render_full = None

    def _reference(self, precision: dict):
        rcfg = ref_render_cfg(self.config["render_net"])
        out = []
        with torch.no_grad():
            for j, _, _ in self.kept:
                ro, rays = self.views[j]
                out.append(ref_rn.render(self.weights, self.frames[j][0], ro,
                                         rays[self.sample[j]], rcfg,
                                         precision["dense"]))
        return out

    @staticmethod
    def _gaps(got, want) -> dict:
        return {"rgb0_gap": max(float((a - b).abs().max())
                                for (a, _), (b, _) in zip(got, want)),
                "rgb1_gap": max(float((a - b).abs().max())
                                for (_, a), (_, b) in zip(got, want))}

    def numbers(self) -> dict:
        return self._gaps([(a, b) for _, a, b in self.kept],
                          self._reference(self.config["precision"]))

    def control_numbers(self) -> dict:
        return self._gaps(self._reference(self.config["control"]),
                          self._reference(self.config["precision"]))

    def work(self) -> dict:
        rn = self.config["render_net"]
        in_xyz, in_dir = inputs.nerf_in_channels()
        rays = self.views[0][1].shape[0]
        n = self.frames[0][0].shape[0]
        return {"render_ops": 0.0,
                "render_bytes": work.render_kernel_bytes(rn, rays, n, False,
                                                         False),
                "model_ops": work.render_ops(rn, in_xyz, in_dir, rays, False)}
