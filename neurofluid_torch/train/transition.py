"""Transition-model stage: train ParticleNet on particle sequences alone
(port of neurofluid_tpu/train/transition.py).

Behavioral contract from the reference transition trainer
(reference trainer/trainer_transmodel.py:23-262):
- data: windowed (window=3) particle samples with random z-rotation
  augmentation, shuffled, batch size 1 (reference :118-124),
- 2-step rollout loss with gradients through both steps:
  0.5 * wmse(pred1, pos1) + 0.5 * wmse(pred2, pos2)
  + boundary(pred1) + boundary(pred2) (reference :179-189),
- Adam, optional global-norm grad clip (reference :159-160, 196-200),
- eval: full-sequence autoregressive rollout from frame 0, per-frame
  pred2gt distance + obj dumps (reference :224-262).

On the JAX trainers' default search backend, 'auto', the step's backward
runs K8 (the segment sum) on the card.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from neurofluid_torch.data import io as data_io
from neurofluid_torch.data.particles import ParticleDataset
from neurofluid_torch.models.init import flax_init_state
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.train import checkpoint as ckpt
from neurofluid_torch.train import losses
from neurofluid_torch.train.trainer_base import TrainerBase, host
from neurofluid_torch.utils.metrics import FluidErrors
from neurofluid_torch.utils.profiling import span


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


def build_particle_net(cfg, device="cuda",
                       generator: torch.Generator | None = None,
                       key=None) -> ParticleNet:
    """The transition stage's ParticleNet from cfg.TRAIN, with the JAX
    trainer's defaults: search backend 'auto', fused_slab_cap 256. Its
    weights are flax's draw under the JAX `key` when one is given, else
    drawn from `generator`."""
    t = cfg.TRAIN
    extra = {}
    # Rotation-safe grid bounds: ParticleDataset's random z-rotation swings
    # the square container's corners (|xy| = 0.975*sqrt(2) ~ 1.38) past the
    # default grid cover (+-1.05); trainers that rotate widen the grid.
    if t.get("grid_lower"):
        extra["grid_lower"] = tuple(float(x) for x in t.grid_lower)
    if t.get("grid_upper"):
        extra["grid_upper"] = tuple(float(x) for x in t.grid_upper)
    net = ParticleNet(
        gravity=tuple(float(x) for x in t.get("gravity", (0.0, -9.81, 0.0))),
        particle_radius=float(t.get("particle_radius", 0.025)),
        search_backend=t.get("search_backend", "auto"),
        **extra,
        fluid_neighbor_k=int(t.get("fluid_neighbor_k", 64)),
        obstacle_neighbor_k=int(t.get("obstacle_neighbor_k", 48)),
        grid_max_per_cell=int(t.get("grid_max_per_cell", 32)),
        query_chunk=int(t.get("query_chunk", 4096)),
        conv_precision=t.get("conv_precision", "highest"),
        fused_group_size=int(t.get("fused_group_size", 16)),
        fused_slab_cap=int(t.get("fused_slab_cap", 256)),
        fused_cell_scale=float(t.get("fused_cell_scale", 1.0)),
        device=device, generator=generator,
    )
    if key is not None:
        net.load_state_dict(flax_init_state(net, key))
    return net


def make_rollout_fn(net: ParticleNet):
    """(pos, vel, box, box_normals, n_steps) -> (traj (F, N, 3), diag),
    where diag is the OR over steps of the search-health flags. The box is
    static, so its plan (or, on the `fused` backend, its cell grid) is built
    once for the whole rollout."""

    def rollout(pos, vel, box, box_normals, n_steps: int):
        box_plan = net.make_box_plan(box)
        flags = {k: torch.zeros((), dtype=torch.bool, device=pos.device)
                 for k in ("grid_overflow", "cap_exceeded")}
        traj = []
        for _ in range(n_steps):
            pos, vel, _, diag = net(pos, vel, box, box_normals,
                                    box_plan=box_plan)
            flags = {k: flags[k] | diag[k] for k in flags}
            traj.append(pos)
        return torch.stack(traj), flags

    return rollout


def make_transition_train_step(net: ParticleNet,
                               optimizer: torch.optim.Optimizer,
                               bounds: losses.BoxBounds,
                               grad_clip_value: float = 0.0):
    """Build the transition-only train step over `net.parameters()`.

    The step takes (pos0, vel0, pos1, pos2, box, box_normals,
    box_plan=None): two chained transition steps from (pos0, vel0) with the
    gradient flowing through both, against the ground-truth positions pos1
    and pos2:

        loss = 0.5 wmse(pred1, pos1) + 0.5 wmse(pred2, pos2)
               + boundary(pred1) + boundary(pred2)

    with the neighbour-weighted distance and the boundary L1 of `losses`;
    one backward pass, the gradients clipped by their global norm when
    `grad_clip_value > 0` (as optax's `clip_by_global_norm`), one optimizer
    update. `box_plan` is `net.make_box_plan(box)`, built here when absent.
    Returns (loss, aux), aux holding loss1, loss2, bloss1, bloss2,
    search_overflow, search_cap_exceeded and the pre-clip grad_norm."""
    params = list(net.parameters())

    def train_step(pos0, vel0, pos1, pos2, box, box_normals, box_plan=None):
        with span("step.transition"):
            optimizer.zero_grad(set_to_none=True)
            if box_plan is None:
                box_plan = net.make_box_plan(box)
            pred1, v1, nn1, diag1 = net(pos0, vel0, box, box_normals,
                                        box_plan=box_plan)
            pred2, _, nn2, diag2 = net(pred1, v1, box, box_normals,
                                       box_plan=box_plan)
            l1 = losses.weighted_mse_loss(pred1, pos1, nn1)
            l2 = losses.weighted_mse_loss(pred2, pos2, nn2)
            b1 = losses.boundary_loss(pred1, bounds)
            b2 = losses.boundary_loss(pred2, bounds)
            loss = 0.5 * l1 + 0.5 * l2 + b1 + b2
            with span("backward"):
                loss.backward()

            with span("optimizer"):
                grads = grads_or_zeros(params)
                gnorm = global_norm(grads)
                if grad_clip_value:
                    clip_grads_(params, grads, gnorm, torch.as_tensor(
                        grad_clip_value, dtype=gnorm.dtype,
                        device=gnorm.device))
                optimizer.step()
            aux = {
                "loss1": l1.detach(), "loss2": l2.detach(),
                "bloss1": b1.detach(), "bloss2": b2.detach(),
                "search_overflow": (diag1["grid_overflow"]
                                    | diag2["grid_overflow"]),
                "search_cap_exceeded": (diag1["cap_exceeded"]
                                        | diag2["cap_exceeded"]),
                "grad_norm": gnorm,
            }
            return loss.detach(), aux

    return train_step


def rollout_errors(traj, gt_frames, outdir=None):
    """FluidErrors of a rollout against the ground-truth frames, in frames
    1.. (traj[t] is frame t + 1), with the pred / GT obj clouds written to
    `outdir` when given. Returns (errors, per-frame Pred2GT)."""
    fluid_errors = FluidErrors()
    dists = []
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
    for t, gt in enumerate(gt_frames):
        dists.append(fluid_errors.cal_errors(traj[t], gt, t + 1))
        if outdir is not None:
            with open(osp.join(outdir, f"pred_{t + 1}.obj"), "w") as fp:
                data_io.write_obj_pointcloud(traj[t], fp, color=[255, 0, 0])
            with open(osp.join(outdir, f"gt_{t + 1}.obj"), "w") as fp:
                data_io.write_obj_pointcloud(gt, fp, color=[3, 168, 158])
    return fluid_errors, dists


class TransitionTrainer(TrainerBase):
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

    def build_data(self):
        cfg = self.cfg
        self.dataset = ParticleDataset(
            cfg.TRAIN.datapath.train,
            data_type=cfg.TRAIN.datapath.train_datatype,
            start=int(cfg.TRAIN.start_index), end=int(cfg.TRAIN.end_index),
            random_rot=True, window=3, seed=int(cfg.TRAIN.seed),
        )
        self.test_dataset = ParticleDataset(
            cfg.TRAIN.datapath.eval, data_type=cfg.TRAIN.datapath.eval_datatype,
            start=int(cfg.TRAIN.start_index), end=int(cfg.TRAIN.end_index),
            random_rot=False, window=3,
        )

    def build_model(self):
        self.net = build_particle_net(self.cfg, self.device,
                                      key=self.next_key())
        # the JAX trainer reads sample 0 to initialise its weights, which
        # draws one augmentation angle: draw it too, so that every later
        # sample is rotated as there
        self.dataset[0]
        if self.cfg.TRAIN.get("pretrained"):
            loaded, _ = ckpt.restore_checkpoint(self.cfg.TRAIN.pretrained)
            self.net.load_state_dict(ckpt.transition_state(
                loaded["transition"]))

    def build_optimizer(self):
        self.optimizer = torch.optim.Adam(self.net.parameters(),
                                          lr=float(self.cfg.TRAIN.lr))

    def build_steps(self):
        self.train_step = make_transition_train_step(
            self.net, self.optimizer, self.box_bounds,
            float(self.cfg.TRAIN.get("grad_clip_value", 0)))
        self.rollout = make_rollout_fn(self.net)

    def resume(self, path):
        """Weights and optimizer state of the latest checkpoint under
        `path`; training continues at the saved step (saved after its
        increment)."""
        restored, _ = ckpt.restore_checkpoint(path)
        self.net.load_state_dict(ckpt.transition_state(restored["transition"]))
        self.optimizer.load_state_dict(restored["opt_state"])
        self.start_step = int(restored["step"])

    def save_checkpoint(self, step):
        ckpt.save_checkpoint(
            self.modelpath, step,
            {"step": step, "transition": self.net.state_dict(),
             "opt_state": self.optimizer.state_dict()},
        )

    def train(self, n_epochs: int | None = None):
        cfg = self.cfg
        n_epochs = int(n_epochs if n_epochs is not None else cfg.TRAIN.N_iters)
        log_interval = int(cfg.TRAIN.get("log_interval", 10))
        save_interval = int(cfg.TRAIN.get("save_interval", 10))
        global_step = self.start_step
        order = np.arange(len(self.dataset))
        last_loss = None
        for epoch in range(n_epochs):
            self.np_rng.shuffle(order)
            for i in order:
                d = self.dataset[int(i)]
                loss, aux = self.train_step(
                    *(self.to_device(d[k]) for k in (
                        "particles_pos_0", "particles_vel_0",
                        "particles_pos_1", "particles_pos_2", "box",
                        "box_normals")))
                last_loss = loss
                if (global_step + 1) % log_interval == 0:
                    self.check_search_overflow(
                        aux.pop("search_overflow"), global_step, "transition"
                    )
                    self.logger.scalar("loss", float(loss), global_step)
                    for k, v in aux.items():
                        self.logger.scalar(k, float(v), global_step)
                global_step += 1
            # checkpoint every epoch: a fail-loudly overflow or preemption
            # mid-stage must not lose the completed epochs
            self.save_checkpoint(global_step)
            if (epoch + 1) % save_interval == 0:
                self.eval(global_step)
        return float(last_loss) if last_loss is not None else None

    def eval(self, step_idx, save_obj: bool = True):
        self.eval_count += 1
        d0 = self.test_dataset[0]
        # roll out ONE physical sequence (reference eval_transmodel.py:101-154
        # evaluates a single sim): with 'blender_all' the same frames appear
        # once per view dir, and a rollout across the seam is nonphysical
        n_steps = (self.test_dataset.sequence_lengths[0]
                   if self.test_dataset.sequence_lengths
                   else len(self.test_dataset))
        with torch.no_grad():
            traj, rollout_diag = self.rollout(
                *(self.to_device(d0[k]) for k in (
                    "particles_pos_0", "particles_vel_0", "box",
                    "box_normals")),
                n_steps)
        self.last_rollout_overflow = self.check_search_overflow(
            rollout_diag["grid_overflow"], step_idx, "transition-eval-rollout",
            fatal=False,
        )
        fluid_errors, dists = rollout_errors(
            host(traj),
            [self.test_dataset[t]["particles_pos_1"] for t in range(n_steps)],
            osp.join(self.particlepath, str(step_idx)) if save_obj else None)
        for t, d in enumerate(dists):
            self.logger.scalar(
                "pred2gt_distance", d, self.eval_count * n_steps + t + 1
            )
        avg = float(np.mean(dists))
        self.logger.scalar("avg_pred2gt_distance", avg, step_idx)
        fluid_errors.save(osp.join(self.exppath, f"errors_{step_idx}.json"))
        return avg
