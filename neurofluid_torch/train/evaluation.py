"""Evaluation drivers, the "serve" analogs (port of
neurofluid_tpu/train/evaluation.py).

- `E2EEvaluator`: counterpart of reference eval_e2e.py:26-160 — load a joint
  checkpoint, autoregressively roll the transition model over the full test
  sequence, report per-frame Pred2GT (trained-50 / rollout-10 windows in the
  reference's print format), dump pred/GT obj clouds, render every frame on
  the test views.
- `TransitionEvaluator`: counterpart of reference eval_transmodel.py — the
  particle-only rollout evaluation, including the clipped-positions variant
  metrics (strict box clip before scoring).
- `RendererEvaluator`: counterpart of reference eval_renderer.py — render a
  GT-particle sequence from a fixed camera with a warmup checkpoint.

Each builds its ParticleNet with the JAX evaluators' settings: the
constructor's defaults there, which means search backend 'auto' (this
package's constructor defaults to 'fused_cconv', so it is passed). Rollouts
and renders run under `torch.no_grad()`, on the card unless the evaluator
is built with `device="cpu"`.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from neurofluid_torch.cuda import resolve_device
from neurofluid_torch.data import io as data_io
from neurofluid_torch.data.blender import BlenderDataset
from neurofluid_torch.data.particles import ParticleDataset
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.ops import ray_ops
from neurofluid_torch.train import checkpoint as ckpt
from neurofluid_torch.train import losses
from neurofluid_torch.train.trainer_base import TrainerBase, host
from neurofluid_torch.train.transition import make_rollout_fn
from neurofluid_torch.train.warmup import build_renderer
from neurofluid_torch.utils.logging import to8b
from neurofluid_torch.utils.metrics import FluidErrors, psnr as psnr_np

# the JAX evaluators' ParticleNet() search backend (its default)
EVAL_SEARCH_BACKEND = "auto"


def print_pred2gt_report(dists):
    """The reference's eval report format (reference eval_e2e.py:122-130)."""
    dists = [d for d in dists if d is not None]
    print("----------------- trained 50 steps ------------------------")
    print("Pred2GT:", np.mean(dists[0:49]) if len(dists) > 49 else np.mean(dists))
    print("Pred2GT-10:", np.mean(dists[:10]))
    if len(dists) > 48:
        print("Pred2GT-end:", dists[48])
    print("\n----------------- rollout 10 steps ------------------------")
    print("Pred2GT:", np.mean(dists[-10:]))
    print("Pred2GT-end:", dists[-1])


def _save_png(image_hwc, path):
    from PIL import Image

    Image.fromarray(to8b(image_hwc)).save(path)


class E2EEvaluator(TrainerBase):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.test_views = list(cfg.test.views)
        self.test_dataset = BlenderDataset(
            cfg.test.path, data_type=cfg.data_type,
            img_wh=(int(cfg.TEST.imgW), int(cfg.TEST.imgH)),
            img_scale=float(cfg.TEST.scale),
            start_index=int(cfg.test.start_index),
            end_index=int(cfg.test.end_index),
            view_names=self.test_views, split="test",
        )
        gravity = tuple(float(g) for g in cfg.get("gravity", (0.0, -9.81, 0.0)))
        gen = torch.Generator().manual_seed(0)
        self.transition = ParticleNet(gravity=gravity,
                                      search_backend=EVAL_SEARCH_BACKEND,
                                      device=self.device, generator=gen)
        self.renderer = build_renderer(cfg, self.device, gen)
        if cfg.get("resume_from"):
            loaded, _ = ckpt.restore_checkpoint(cfg.resume_from)
            self.renderer.load_state_dict(loaded["renderer"])
            self.transition.load_state_dict(ckpt.transition_state(
                loaded["transition"]))

        self.rollout = make_rollout_fn(self.transition)
        self.render_full = self.make_chunk_renderer(
            self.renderer, chunk=self.eval_chunk_size())

    def eval(self, render: bool = True):
        d0 = self.test_dataset[0]
        n_steps = len(self.test_dataset)
        with torch.no_grad():
            traj, _ = self.rollout(
                *(self.to_device(d0[k]) for k in (
                    "particles_pos", "particles_vel", "box", "box_normals")),
                n_steps)
        traj_np = host(traj)
        fluid_errors = FluidErrors()
        dists = []
        os.makedirs(osp.join(self.particlepath, "Pred"), exist_ok=True)
        os.makedirs(osp.join(self.particlepath, "GT"), exist_ok=True)
        h = int(self.cfg.TEST.imgH // self.cfg.TEST.scale)
        w = int(self.cfg.TEST.imgW // self.cfg.TEST.scale)
        psnrs = []
        for t in range(n_steps):
            data = self.test_dataset[t]
            gt = data["particles_pos_1"]
            dists.append(fluid_errors.cal_errors(traj_np[t], gt, t + 1))
            with open(osp.join(self.particlepath, f"Pred/{t + 1}.obj"), "w") as fp:
                data_io.write_obj_pointcloud(traj_np[t], fp, color=[255, 0, 0])
            with open(osp.join(self.particlepath, f"GT/{t + 1}.obj"), "w") as fp:
                data_io.write_obj_pointcloud(gt, fp, color=[3, 168, 158])
            if not render:
                continue
            for v, name in enumerate(self.test_views):
                out = self.render_full(traj[t], self.to_device(
                    data["cw_1"][v][:, 3]), data["rays_1"][v])
                gt_rgb = data["rgb_1"][v]
                psnrs.append(psnr_np(host(out["rgb1"]), gt_rgb))
                for pass_name, key in (("coarse", "rgb0"), ("fine", "rgb1")):
                    pdir = osp.join(self.imgpath, pass_name, name)
                    os.makedirs(osp.join(pdir, "Pred"), exist_ok=True)
                    os.makedirs(osp.join(pdir, "GT"), exist_ok=True)
                    _save_png(host(out[key]).reshape(h, w, 3),
                              osp.join(pdir, "Pred", f"{t + 1:05d}.png"))
                    _save_png(gt_rgb.reshape(h, w, 3),
                              osp.join(pdir, "GT", f"{t + 1:05d}.png"))
        fluid_errors.save(osp.join(self.exppath, "pred2gt.json"))
        print_pred2gt_report(dists)
        if psnrs:
            print("mean fine PSNR:", float(np.mean(psnrs)))
        return dists, psnrs


class TransitionEvaluator:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.exppath = osp.join(cfg.expdir, cfg.expname)
        self.particlepath = osp.join(self.exppath, "particles")
        os.makedirs(self.particlepath, exist_ok=True)
        gravity = tuple(float(g) for g in cfg.TEST.gravity)
        self.net = ParticleNet(gravity=gravity,
                               search_backend=EVAL_SEARCH_BACKEND,
                               device=self.device,
                               generator=torch.Generator().manual_seed(0))
        self.dataset = ParticleDataset(
            cfg.TEST.datapath, data_type=cfg.TEST.datatype,
            start=int(cfg.TEST.start_index), end=int(cfg.TEST.end_index),
            random_rot=False, window=2,
        )
        if cfg.get("resume_from"):
            loaded, _ = ckpt.restore_checkpoint(cfg.resume_from)
            self.net.load_state_dict(ckpt.transition_state(
                loaded["transition"]))
        self.rollout = make_rollout_fn(self.net)
        self.bounds = losses.default_box_bounds()

    def eval(self, save_obj: bool | None = None):
        save_obj = (bool(self.cfg.TEST.get("save_obj", True))
                    if save_obj is None else save_obj)
        d0 = self.dataset[0]
        # every window of the dataset, as the JAX evaluator rolls out
        n_steps = len(self.dataset)
        with torch.no_grad():
            traj, _ = self.rollout(
                *(torch.as_tensor(d0[k], device=self.device) for k in (
                    "particles_pos_0", "particles_vel_0", "box",
                    "box_normals")),
                n_steps)
        traj = host(traj)
        errors, clipped_errors = FluidErrors(), FluidErrors()
        dists, clipped_dists = [], []
        lower = host(self.bounds.lower)
        upper = host(self.bounds.upper)
        for t in range(n_steps):
            gt = self.dataset[t]["particles_pos_1"]
            dists.append(errors.cal_errors(traj[t], gt, t + 1))
            clipped = np.clip(traj[t], lower, upper)
            clipped_dists.append(clipped_errors.cal_errors(clipped, gt, t + 1))
            if save_obj:
                os.makedirs(osp.join(self.particlepath, "eval"), exist_ok=True)
                with open(
                    osp.join(self.particlepath, "eval", f"pred_{t + 1}.obj"), "w"
                ) as fp:
                    data_io.write_obj_pointcloud(traj[t], fp, color=[255, 0, 0])
        errors.save(osp.join(self.exppath, "pred2gt.json"))
        clipped_errors.save(osp.join(self.exppath, "pred2gt_clipped.json"))
        print("unclipped:")
        print_pred2gt_report(dists)
        print("\nclipped to box:")
        print_pred2gt_report(clipped_dists)
        return dists, clipped_dists


class RendererEvaluator(TrainerBase):
    """Render a GT-particle sequence from a fixed camera
    (reference eval_renderer.py:63-160)."""

    def __init__(self, cfg, camera_c2w=None, device="cuda"):
        super().__init__(cfg, device)
        self.renderer = build_renderer(cfg, self.device,
                                       torch.Generator().manual_seed(0))
        self.test_views = list(cfg.test.views)
        self.dataset = BlenderDataset(
            cfg.test.path, data_type=cfg.data_type,
            img_wh=(int(cfg.TEST.imgW), int(cfg.TEST.imgH)),
            img_scale=float(cfg.TEST.scale),
            start_index=int(cfg.test.start_index),
            end_index=int(cfg.test.end_index),
            view_names=self.test_views, split="test",
        )
        self.c2w = (np.asarray(camera_c2w, np.float32)
                    if camera_c2w is not None else self.dataset[0]["cw"][0])
        if cfg.get("resume_from"):
            loaded, _ = ckpt.restore_checkpoint(cfg.resume_from)
            self.renderer.load_state_dict(loaded["renderer"])
        self.render_full = self.make_chunk_renderer(
            self.renderer, chunk=self.eval_chunk_size())

    def eval(self, max_frames: int = 53):
        h = int(self.cfg.TEST.imgH // self.cfg.TEST.scale)
        w = int(self.cfg.TEST.imgW // self.cfg.TEST.scale)
        focal = 0.5 * w / np.tan(0.5 * float(self.cfg.TEST.camera_angle_x))
        c2w = self.to_device(self.c2w)
        dirs = ray_ops.get_ray_directions(h, w, focal, device=self.device)
        rays = ray_ops.make_ray_bundle(dirs, c2w).reshape(-1, 6)
        ro = c2w[:, 3]
        outdir = osp.join(self.exppath, "render_GT")
        os.makedirs(outdir, exist_ok=True)
        for t in range(min(len(self.dataset) + 1, max_frames)):
            particles = self.to_device(self.dataset.particles_pos[t])
            out = self.render_full(particles, ro, rays)
            for pass_name, key in (("coarse", "rgb0"), ("fine", "rgb1")):
                _save_png(host(out[key]).reshape(h, w, 3),
                          osp.join(outdir, f"{pass_name}_pred_{t}.png"))
        return outdir
