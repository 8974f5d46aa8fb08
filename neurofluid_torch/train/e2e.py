"""End-to-end stage: joint transition-model + renderer training (port of
neurofluid_tpu/train/e2e.py).

Behavioral contract from the reference e2e trainer
(reference trainer/trainer_e2e.py:28-371):
- per frame (sequential within an epoch): one transition step from the
  previous frame's *detached* state (TBPTT-1, reference :189-199), render the
  dynamic view(s) at frame t+1 on `ray_chunk` random pixels, loss =
  sum_views [MSE(rgb0) + MSE(rgb1)] + boundary_weight * boundary_L1(pred_pos)
  (reference :202-261),
- separate Adam optimizers: renderer lr 3e-4, transition lr 1e-5, with the
  piecewise-halving schedules of schedules.py (reference :71-141),
- periodic eval: autoregressive rollout over the test sequence (state NOT
  detached, no grads), pred2gt per frame, obj dumps, rendering frames
  {0, 20, 30} on the test views with PSNR (reference :305-371),
- checkpoints {step, renderer, transition, optimizers} (reference :152-158);
  resume restores model weights but NOT optimizer state (reference :145-149).

The step (`make_e2e_train_step`) is deterministic: no random pixels, jitter
or sigma noise inside. The image gradient reaches the transition model
through the renderer's particle gradient (K4 on the card).
`grad_clip_value > 0` clips each model's gradients by their global norm as
optax's `clip_by_global_norm` does (g / ||g|| * c where ||g|| >= c; no
epsilon in the norm) and adds the per-parameter gradient-norm histograms
before and after the clip.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from neurofluid_torch.data.blender import BlenderDataset
from neurofluid_torch.models.init import flax_init_state
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.train import checkpoint as ckpt
from neurofluid_torch.train import losses, schedules
from neurofluid_torch.train.trainer_base import TrainerBase, host
from neurofluid_torch.train.transition import (
    clip_grads_, global_norm, grads_or_zeros, make_rollout_fn, rollout_errors,
)
from neurofluid_torch.train.warmup import (
    build_renderer, load_renderer, render_views,
)
from neurofluid_torch.utils.metrics import FluidErrors, psnr as psnr_np
from neurofluid_torch.utils.profiling import span, sync_span


def leaf_norms(tensors) -> torch.Tensor:
    """Per-parameter L2 norms as one vector (the histogram payload)."""
    return torch.stack([torch.linalg.norm(t.reshape(-1)) for t in tensors])


def make_e2e_train_step(transition, renderer, opt_r, opt_t, bounds,
                        bd_weight: float, grad_clip_value: float = 0.0,
                        with_anchor: bool = False, anchor_weight: float = 1.0):
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

    `with_anchor=True` adds the JAX package's renderer-protection term
    (absent from the reference): the step takes four more arguments,
    (anchor_pos (N0, 3), anchor_ro_v (A, 3), anchor_rays_v (A, R', 6),
    anchor_rgbs_v (A, R', 3)), renders the detached frame-0 GT particles on
    the warm-up views and adds anchor_weight * (MSE0 + MSE1), each MSE over
    all anchor views and rays; its overflow flag joins `search_overflow`.
    It carries no gradient to the transition model.
    """
    params_r = list(renderer.parameters())
    params_t = list(transition.parameters())

    def train_step(pos, vel, box, nrm, ro_v, rays_v, rgbs_v, box_plan=None,
                   anchor_pos=None, anchor_ro_v=None, anchor_rays_v=None,
                   anchor_rgbs_v=None):
        with span("step.e2e"):
            opt_r.zero_grad(set_to_none=True)
            opt_t.zero_grad(set_to_none=True)
            pred_pos, pred_vel, _, diag = transition(
                pos.detach(), vel.detach(), box, nrm, box_plan=box_plan)
            outs, se0, se1, overflow = render_views(renderer, pred_pos, ro_v,
                                                    rays_v, rgbs_v)
            mse0, mse1 = se0.mean(dim=(1, 2)), se1.mean(dim=(1, 2))
            bd = losses.boundary_loss(pred_pos, bounds)
            loss = torch.sum(mse0 + mse1) + bd_weight * bd
            if with_anchor:
                _, ase0, ase1, anchor_overflow = render_views(
                    renderer, anchor_pos.detach(), anchor_ro_v, anchor_rays_v,
                    anchor_rgbs_v)
                loss = loss + anchor_weight * (ase0.mean() + ase1.mean())
                overflow = overflow | anchor_overflow
            with span("backward"):
                loss.backward()

            with span("optimizer"):
                g_r, g_t = grads_or_zeros(params_r), grads_or_zeros(params_t)
                gn_r, gn_t = global_norm(g_r), global_norm(g_t)
                aux = {
                    "rgbloss_0": torch.sum(mse0).detach(),
                    "rgbloss_1": torch.sum(mse1).detach(),
                    "mse0_views": mse0.detach(), "mse1_views": mse1.detach(),
                    "boundary_loss": bd.detach(),
                    "search_overflow": diag["grid_overflow"] | overflow,
                    "search_cap_exceeded": diag["cap_exceeded"],
                    "num_nn_0": torch.stack(
                        [o["num_nn_0"] for o in outs]).detach(),
                    "num_nn_1": torch.stack(
                        [o["num_nn_1"] for o in outs]).detach(),
                    "grad_norm_renderer": gn_r, "grad_norm_transition": gn_t,
                }
                if grad_clip_value:
                    clip = torch.as_tensor(grad_clip_value, dtype=gn_r.dtype,
                                           device=gn_r.device)
                    for name, params, grads, gn in (
                            ("renderer", params_r, g_r, gn_r),
                            ("transition", params_t, g_t, gn_t)):
                        before = leaf_norms(grads)
                        aux[f"grad_hist_{name}_before"] = before
                        aux[f"grad_hist_{name}_after"] = before * \
                            torch.minimum(torch.ones_like(clip),
                                          clip / (gn + 1e-16))
                        clip_grads_(params, grads, gn, clip)
                opt_r.step()
                opt_t.step()
            return loss.detach(), pred_pos.detach(), pred_vel.detach(), aux

    return train_step


class E2ETrainer(TrainerBase):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.build_data()
        self.build_model()
        self.build_optimizer()
        self.build_steps()
        self.start_step = 0
        self.eval_count = 0
        if cfg.get("resume_from"):
            self.resume(cfg.resume_from)
        # the loop's state: the step counter, the Pred2GT record of the
        # epoch and the carried particles (set at a sequence's start)
        self.global_step = self.start_step
        self.fluid_errors = FluidErrors()
        self.state_pos = self.state_vel = None

    # ------------------------------------------------------------------

    def build_data(self):
        cfg = self.cfg
        self.train_views = list(cfg.train.views.dynamic)
        self.test_views = list(cfg.test.views)
        self.dataset = BlenderDataset(
            cfg.train.path, data_type=cfg.data_type,
            img_wh=(int(cfg.TRAIN.imgW), int(cfg.TRAIN.imgH)),
            img_scale=float(cfg.TRAIN.scale),
            start_index=int(cfg.train.start_index),
            end_index=int(cfg.train.end_index),
            view_names=self.train_views, split="train",
        )
        self.test_dataset = BlenderDataset(
            cfg.test.path, data_type=cfg.data_type,
            img_wh=(int(cfg.TEST.imgW), int(cfg.TEST.imgH)),
            img_scale=float(cfg.TEST.scale),
            start_index=int(cfg.test.start_index),
            end_index=int(cfg.test.end_index),
            view_names=self.test_views, split="test",
        )
        # renderer-protection anchor: frame-0 GT particles + warmup views
        # (see make_e2e_train_step's with_anchor)
        anchor_cfg = cfg.TRAIN.get("anchor", {})
        self.anchor_enabled = bool(anchor_cfg.get("enabled", False))
        self.anchor_weight = float(anchor_cfg.get("weight", 1.0))
        self.anchor_data = None
        if self.anchor_enabled:
            n_views = int(anchor_cfg.get("n_views", 2))
            ds = BlenderDataset(
                cfg.train.path, data_type=cfg.data_type,
                img_wh=(int(cfg.TRAIN.imgW), int(cfg.TRAIN.imgH)),
                img_scale=float(cfg.TRAIN.scale),
                start_index=int(cfg.train.start_index),
                end_index=int(cfg.train.start_index) + 2,
                view_names=list(cfg.train.views.warmup)[:n_views],
                split="train",
            )
            d0 = ds[0]
            self.anchor_data = {
                "pos": self.to_device(d0["particles_pos"]),
                "ro_v": self.to_device(d0["cw"][:, :, 3]),
                "rays": d0["rays"],  # per view, the full image
                "rgb": d0["rgb"],
            }
            self.anchor_rays = int(anchor_cfg.get("rays", 1024))

    def build_model(self):
        cfg = self.cfg
        gravity = tuple(float(g) for g in cfg.get("gravity", (0.0, -9.81, 0.0)))
        t = cfg.TRAIN
        self.transition = ParticleNet(
            gravity=gravity,
            search_backend=t.get("search_backend", "auto"),
            fluid_neighbor_k=int(t.get("fluid_neighbor_k", 64)),
            obstacle_neighbor_k=int(t.get("obstacle_neighbor_k", 48)),
            grid_max_per_cell=int(t.get("grid_max_per_cell", 32)),
            query_chunk=int(t.get("query_chunk", 4096)),
            conv_precision=t.get("conv_precision", "highest"),
            fused_group_size=int(t.get("fused_group_size", 16)),
            fused_slab_cap=int(t.get("fused_slab_cap", 256)),
            fused_cell_scale=float(t.get("fused_cell_scale", 1.0)),
            device=self.device,
        )
        # JAX's key order: the transition model's draw, then the renderer's
        self.transition.load_state_dict(
            flax_init_state(self.transition, self.next_key()))
        self.renderer = build_renderer(cfg, self.device, key=self.next_key())

        # the static boundary's search structure: built once per scene and
        # passed to every step; the per-step check below fails loudly if
        # the dataset's box ever differs from the one it was built from
        box = self.dataset[0]["box"]
        self.box_plan = self.transition.make_box_plan(self.to_device(box))
        self._box_plan_src = np.asarray(box)

        if t.get("pretrained_transition_model"):
            loaded, _ = ckpt.restore_checkpoint(t.pretrained_transition_model)
            self.transition.load_state_dict(ckpt.transition_state(
                loaded["transition"]))
        if t.get("pretrained_renderer"):
            load_renderer(self.renderer, cfg, t.pretrained_renderer)

    def build_optimizer(self):
        lr = self.cfg.TRAIN.LR
        use_sched = bool(lr.get("use_scheduler", True))
        r_lr = float(lr.get("renderer_lr", 3e-4))
        t_lr = float(lr.get("trans_lr", 1e-5))
        # seperate_render_transition=False is the reference's single-optimizer
        # mode (reference trainer_e2e.py:71-86): one Adam with per-group base
        # LRs and the RENDERER piecewise schedule applied to both groups.
        # Adam's state is per parameter, so two Adams on the same schedule
        # shape are that one optimizer.
        separate = bool(self.cfg.TRAIN.get("seperate_render_transition", True))
        if use_sched:
            self.sched_r = schedules.e2e_renderer_schedule(r_lr)
            self.sched_t = (schedules.e2e_transition_schedule(t_lr) if separate
                            else schedules.e2e_renderer_schedule(t_lr))
        else:
            self.sched_r = lambda step: r_lr
            self.sched_t = lambda step: t_lr
        self.opt_r = torch.optim.Adam(self.renderer.parameters(), lr=r_lr)
        self.opt_t = torch.optim.Adam(self.transition.parameters(), lr=t_lr)
        self.lr_scheds = [
            torch.optim.lr_scheduler.LambdaLR(opt, schedules.lr_lambda(s, l))
            for opt, s, l in ((self.opt_r, self.sched_r, r_lr),
                              (self.opt_t, self.sched_t, t_lr))]

    def build_steps(self):
        self.train_step = make_e2e_train_step(
            self.transition, self.renderer, self.opt_r, self.opt_t,
            self.box_bounds, float(self.cfg.TRAIN.loss_weight.boundary_loss),
            grad_clip_value=float(self.cfg.TRAIN.get("grad_clip_value", 0)),
            with_anchor=self.anchor_enabled, anchor_weight=self.anchor_weight,
        )
        self.rollout = make_rollout_fn(self.transition)
        self.render_full = self.make_chunk_renderer(
            self.renderer, chunk=self.eval_chunk_size())

    # ------------------------------------------------------------------

    def resume(self, path):
        """Model weights of the latest checkpoint under `path`, not the
        optimizers' state (the reference's e2e resume); training continues
        at the step after the saved one, which was saved after its
        increment, so one step index is skipped as in the reference."""
        loaded, _ = ckpt.restore_checkpoint(path)
        self.renderer.load_state_dict(loaded["renderer"])
        self.transition.load_state_dict(ckpt.transition_state(
            loaded["transition"]))
        self.start_step = int(loaded["step"]) + 1

    def save_checkpoint(self, step):
        ckpt.save_checkpoint(
            self.modelpath, step,
            {"step": step,
             "renderer": self.renderer.state_dict(),
             "transition": self.transition.state_dict(),
             "opt_r_state": self.opt_r.state_dict(),
             "opt_t_state": self.opt_t.state_dict()},
        )

    # ------------------------------------------------------------------

    def train(self, n_epochs: int | None = None,
              eval_during_training: bool = True):
        """`train_iteration` over every frame of the sequence, `n_epochs`
        times (cfg.TRAIN.epochs), from the start step; returns the last
        loss."""
        n_epochs = int(n_epochs if n_epochs is not None
                       else self.cfg.TRAIN.epochs)
        self.global_step = self.start_step
        last_loss = None
        for _epoch in range(n_epochs):
            self.fluid_errors = FluidErrors()
            for data_idx in range(len(self.dataset)):
                last_loss, _ = self.train_iteration(data_idx,
                                                    eval_during_training)
        return float(last_loss) if last_loss is not None else None

    def train_iteration(self, data_idx: int,
                        eval_during_training: bool = True):
        """One step of the loop on frame `data_idx` of the sequence: the
        frame's arrays, a pixel draw per view (the center crop until
        precrop_iters), the copies to the device, the box check, the
        train step from the carried state (reset to the frame's particles
        at the sequence's start, reference :192-193), the schedules' step,
        the log every log_interval steps; then the eval and checkpoint
        every save_interval steps. Returns (loss, aux) of the step."""
        cfg = self.cfg
        h = int(cfg.TRAIN.imgH // cfg.TRAIN.scale)
        w = int(cfg.TRAIN.imgW // cfg.TRAIN.scale)
        ray_chunk = int(cfg.RENDERER.ray.ray_chunk)
        precrop = int(cfg.TRAIN.get("precrop_iters", 500))
        log_interval = int(cfg.TRAIN.get("log_interval", 10))
        save_interval = int(cfg.TRAIN.get("save_interval", 500))
        step = self.global_step

        with span("step.e2e"):
            with span("loop.data"):
                data = self.dataset[data_idx]
                if data_idx == 0:
                    self.state_pos = self._copy(data["particles_pos"])
                    self.state_vel = self._copy(data["particles_vel"])
                idx = [self.sample_pixel_indices(h, w, step, ray_chunk,
                                                 precrop)
                       for _ in self.train_views]
                rays_v = self._copy([data["rays_1"][v][i]
                                     for v, i in enumerate(idx)])
                rgbs_v = self._copy([data["rgb_1"][v][i]
                                     for v, i in enumerate(idx)])
                ro_v = self._copy(data["cw_1"][:, :, 3])

                if self.box_plan is not None and not np.array_equal(
                        np.asarray(data["box"]), self._box_plan_src):
                    raise ValueError(
                        "per-frame box differs from the box the static plan "
                        "was built from; rebuild the box plan per scene"
                    )

                anchor = ()
                if self.anchor_enabled:
                    a = self.anchor_data
                    # the anchor samples with precrop 0, as the JAX trainer
                    # does (its own quirk: the warm-up's crop is not reused)
                    a_idx = [self.sample_pixel_indices(h, w, step,
                                                       self.anchor_rays, 0)
                             for _ in a["rays"]]
                    anchor = (
                        a["pos"], a["ro_v"],
                        self._copy([a["rays"][v][i]
                                    for v, i in enumerate(a_idx)]),
                        self._copy([a["rgb"][v][i]
                                    for v, i in enumerate(a_idx)]),
                    )
                box = self._copy(data["box"])
                box_normals = self._copy(data["box_normals"])
            loss, self.state_pos, self.state_vel, aux = self.train_step(
                self.state_pos, self.state_vel, box, box_normals, ro_v,
                rays_v, rgbs_v, self.box_plan, *anchor,
            )
            for s in self.lr_scheds:
                s.step()

            if (step + 1) % log_interval == 0:
                with span("loop.log"):
                    self.log_step(step, data_idx, data, loss, aux)
            self.global_step = step + 1
        if eval_during_training and self.global_step % save_interval == 0:
            self.eval(self.global_step)
            self.save_checkpoint(self.global_step)
        return loss, aux

    def _copy(self, x) -> torch.Tensor:
        """`to_device` of a host array: a copy from pageable memory, which
        waits for the card's queue."""
        with sync_span("sync.data", self.device):
            return self.to_device(x)

    def log_step(self, step, data_idx, data, loss, aux):
        """The overflow check, the scalars and histograms and the Pred2GT
        of the carried state of one logged step (reference
        trainer_e2e.py:247-302). Each read of a device value waits for the
        card (`sync.log`)."""
        def read(x) -> np.ndarray:
            with span("sync.log"):
                return host(x)

        self.check_search_overflow(aux["search_overflow"], step, "e2e-train")
        self.logger.scalar("train/loss", float(read(loss)), step)
        for k in ("rgbloss_0", "rgbloss_1", "boundary_loss",
                  "grad_norm_renderer", "grad_norm_transition",
                  "search_cap_exceeded"):
            self.logger.scalar(f"train/{k}", float(read(aux[k])), step)
        # per-view scalars + neighbor-count histograms
        mse0, mse1 = read(aux["mse0_views"]), read(aux["mse1_views"])
        for v, name in enumerate(self.train_views):
            self.logger.scalar(f"{name}/rgbloss_0", float(mse0[v]), step)
            self.logger.scalar(f"{name}/rgbloss", float(mse0[v] + mse1[v]),
                               step)
            self.logger.histogram(f"{name}/num_neighbors_0",
                                  read(aux["num_nn_0"][v]), step)
            self.logger.histogram(f"{name}/num_neighbors_1",
                                  read(aux["num_nn_1"][v]), step)
        # grad-norm histograms before/after the clip
        if "grad_hist_renderer_before" in aux:
            for tag in ("grad_hist_renderer_before", "grad_hist_renderer_after",
                        "grad_hist_transition_before",
                        "grad_hist_transition_after"):
                self.logger.histogram(f"train/{tag}", read(aux[tag]), step)
        self.logger.scalar("train/lr_renderer", float(self.sched_r(step)), step)
        self.logger.scalar("train/lr_transition", float(self.sched_t(step)),
                           step)
        pred = read(self.state_pos)
        with span("loop.pred2gt"):
            d = self.fluid_errors.cal_errors(pred, data["particles_pos_1"],
                                             data_idx + 1)
        if d is not None:
            self.logger.scalar("train/pred2gt_distance", d, step)

    # ------------------------------------------------------------------

    def eval(self, step_idx, render_frames=(0, 20, 30), save_obj: bool = True):
        """Rollout eval + sparse frame rendering (reference :305-371)."""
        d0 = self.test_dataset[0]
        n_steps = len(self.test_dataset)
        with torch.no_grad():
            traj, rollout_diag = self.rollout(
                *(self.to_device(d0[k]) for k in (
                    "particles_pos", "particles_vel", "box", "box_normals")),
                n_steps)
        self.last_rollout_overflow = self.check_search_overflow(
            rollout_diag["grid_overflow"], step_idx, "e2e-eval-rollout",
            fatal=False,
        )
        _, dists = rollout_errors(
            host(traj),
            [self.test_dataset[t]["particles_pos_1"] for t in range(n_steps)],
            osp.join(self.particlepath, str(step_idx)) if save_obj else None)
        avg = float(np.mean(dists))
        self.logger.scalar("eval/avg_pred2gt_distance", avg, step_idx)

        h = int(self.cfg.TEST.imgH // self.cfg.TEST.scale)
        w = int(self.cfg.TEST.imgW // self.cfg.TEST.scale)
        psnrs = {}
        for t in render_frames:
            if t >= n_steps:
                continue
            data = self.test_dataset[t]
            for v, name in enumerate(self.test_views):
                out = self.render_full(traj[t], self.to_device(
                    data["cw_1"][v][:, 3]), data["rays_1"][v])
                gt = data["rgb_1"][v]
                rgb0, rgb1 = host(out["rgb0"]), host(out["rgb1"])
                p0, p1 = psnr_np(rgb0, gt), psnr_np(rgb1, gt)
                self.logger.scalar(f"{name}/psnr_{t}_0", p0, step_idx)
                self.logger.scalar(f"{name}/psnr_{t}_1", p1, step_idx)
                self.visualize_image(rgb0, gt, h, w, step_idx,
                                     f"coarse_{t}_{name}")
                self.visualize_image(rgb1, gt, h, w, step_idx,
                                     f"fine_{t}_{name}")
                psnrs[f"{name}_{t}"] = (p0, p1)
        return avg, psnrs
