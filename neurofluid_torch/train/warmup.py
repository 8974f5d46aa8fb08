"""Warm-up stage: train the renderer alone on frame-0 GT particles (port of
neurofluid_tpu/train/warmup.py).

Behavioral contract from the reference warm-up trainer
(reference trainer/trainer_renderer.py:22-175):
- data: frame 0 of the training split across the warmup views (data_idx = 0
  every step, reference :81-82),
- per step: per view, sample `ray_chunk` random pixels (pre-crop aware),
  render coarse+fine with GT particles, sum per-view MSE(rgb0) + MSE(rgb1)
  (reference :102-143),
- Adam with continuous exponential LR decay gamma^(step / decay_epochs)
  (reference :55-58),
- periodic eval: render the full test view for frame 0, PSNR, image dumps
  (reference :146-175), checkpoint {step, renderer, optimizer} (:68-72).

On the card the dense render runs K3 and K5 and its backward K6 (the list
render: K5 and K6); the particles are constants here, so K4 and K8 (the
gradients into them) do not run.
"""

from __future__ import annotations

import torch

from neurofluid_torch.data.blender import BlenderDataset
from neurofluid_torch.models.init import flax_init_state
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train import checkpoint as ckpt
from neurofluid_torch.train import schedules
from neurofluid_torch.train.trainer_base import TrainerBase, host
from neurofluid_torch.utils.metrics import psnr as psnr_np
from neurofluid_torch.utils.profiling import span

def build_renderer(cfg, device="cuda",
                   generator: torch.Generator | None = None,
                   key=None) -> RenderNet:
    """The RenderNet of cfg.RENDERER, every key read as the JAX package's
    `build_renderer` reads it, with its defaults: the encoding switches,
    `bf16` (bf16 products in the NeRF MLPs), and `NN_search.mode` ('dense'
    or 'list'), `backend` and `selection` (which only the list path
    reads). Its weights are flax's draw under the JAX `key` when one is
    given, else drawn from `generator`."""
    r = cfg.RENDERER
    model = RenderNet(
        near=float(cfg.near),
        far=float(cfg.far),
        n_samples=int(r.ray.N_samples),
        n_importance=int(r.ray.N_importance),
        particle_radius=float(r.NN_search.particle_radius),
        search_radius_scale=float(r.NN_search.search_radius_scale),
        num_neighbors=int(r.NN_search.N_neighbor),
        use_mask=bool(r.use_mask),
        encode_density=bool(r.encoding.density),
        encode_var=bool(r.encoding.var),
        encode_smoothed_pos=bool(r.encoding.smoothed_pos),
        encode_smoothed_dir=bool(r.encoding.smoothed_dir),
        exclude_ray=bool(r.encoding.exclude_ray),
        same_smooth_factor=bool(r.encoding.get("same_smooth_factor", False)),
        compute_dtype=torch.bfloat16 if r.get("bf16", False) else torch.float32,
        search_backend=r.NN_search.get("backend", "auto"),
        search_selection=r.NN_search.get("selection", "approx"),
        search_mode=r.NN_search.get("mode", "dense"),
        device=device, generator=generator,
    )
    if key is not None:
        model.load_state_dict(flax_init_state(model, key))
    return model


def load_renderer(renderer: RenderNet, cfg, path: str) -> None:
    """Load the latest renderer checkpoint under `path` into `renderer`,
    only its `sigma` / `xyz_encoding` parameters with TRAIN.partial_load."""
    loaded, _ = ckpt.restore_checkpoint(path)
    renderer.load_state_dict(ckpt.merge_renderer_params(
        renderer.state_dict(), loaded["renderer"],
        partial_load=bool(cfg.TRAIN.get("partial_load", False))))


def render_views(renderer: RenderNet, particles, ro_v, rays_v, rgbs_v):
    """Render each view (ro_v (V, 3), rays_v (V, R, 6)) from `particles`:
    (the outputs per view, the squared errors of rgb0 and rgb1 against
    rgbs_v (V, R, 3), whether any search overflowed)."""
    outs = [renderer(particles, ro, rays) for ro, rays in zip(ro_v, rays_v)]
    rgb0 = torch.stack([o["rgb0"] for o in outs])
    rgb1 = torch.stack([o["rgb1"] for o in outs])
    overflow = torch.stack([o["overflow"] for o in outs]).any()
    return outs, (rgb0 - rgbs_v) ** 2, (rgb1 - rgbs_v) ** 2, overflow


def make_warmup_train_step(renderer: RenderNet,
                           optimizer: torch.optim.Optimizer):
    """The renderer-only step: (particles (N, 3), ro_v (V, 3), rays_v
    (V, R, 6), rgbs_v (V, R, 3)) -> (loss, (mse0 (V,), mse1 (V,),
    overflow)). Renders every view from the particles, loss = sum over views
    of MSE(rgb0) + MSE(rgb1) (reference trainer_renderer.py:127-133), one
    backward, one optimizer update; the caller steps the LR schedule."""

    def train_step(particles, ro_v, rays_v, rgbs_v):
        with span("step.warmup"):
            optimizer.zero_grad(set_to_none=True)
            _, se0, se1, overflow = render_views(renderer, particles, ro_v,
                                                 rays_v, rgbs_v)
            mse0, mse1 = se0.mean(dim=(1, 2)), se1.mean(dim=(1, 2))
            loss = torch.sum(mse0 + mse1)
            with span("backward"):
                loss.backward()
            with span("optimizer"):
                optimizer.step()
            return loss.detach(), (mse0.detach(), mse1.detach(), overflow)

    return train_step


class WarmupTrainer(TrainerBase):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.build_data()
        self.build_model()
        self.build_optimizer()
        self.build_steps()
        self.start_step = 0
        if cfg.get("resume_from"):
            self.resume(cfg.resume_from)

    # ------------------------------------------------------------------

    def build_data(self):
        cfg = self.cfg
        self.train_views = list(cfg.train.views.warmup)
        self.test_views = list(cfg.test.views)
        wh = (int(cfg.TRAIN.imgW), int(cfg.TRAIN.imgH))
        self.dataset = BlenderDataset(
            cfg.train.path, data_type=cfg.data_type, img_wh=wh,
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

    def build_model(self):
        self.model = build_renderer(self.cfg, self.device,
                                    key=self.next_key())
        if self.cfg.TRAIN.get("pretrained_renderer"):
            load_renderer(self.model, self.cfg,
                          self.cfg.TRAIN.pretrained_renderer)

    def build_optimizer(self):
        lr_cfg = self.cfg.TRAIN.LR
        lr = float(lr_cfg.lr)
        if lr_cfg.get("use_scheduler", True):
            self.schedule = schedules.exponential_decay(
                lr, int(lr_cfg.decay_epochs), gamma=0.1)
        else:
            self.schedule = lambda step: lr
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)
        # stepped after every update: the schedule is read at the update
        # count, as optax reads it, and the count travels in checkpoints
        self.lr_sched = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, schedules.lr_lambda(self.schedule, lr))

    def build_steps(self):
        self.train_step = make_warmup_train_step(self.model, self.optimizer)
        self.render_full = self.make_chunk_renderer(
            self.model, chunk=self.eval_chunk_size())

    # ------------------------------------------------------------------

    def resume(self, path):
        """Weights, optimizer and schedule state of the latest checkpoint
        under `path`; training continues at the step after the saved one
        (the reference's offset)."""
        restored, _ = ckpt.restore_checkpoint(path)
        self.model.load_state_dict(restored["renderer"])
        self.optimizer.load_state_dict(restored["opt_state"])
        self.lr_sched.load_state_dict(restored["lr_state"])
        self.start_step = int(restored["step"]) + 1

    def save_checkpoint(self, step):
        ckpt.save_checkpoint(
            self.modelpath, step,
            {"step": step, "renderer": self.model.state_dict(),
             "opt_state": self.optimizer.state_dict(),
             "lr_state": self.lr_sched.state_dict()},
        )

    # ------------------------------------------------------------------

    def train(self, n_iters: int | None = None):
        cfg = self.cfg
        n_iters = int(n_iters if n_iters is not None else cfg.TRAIN.N_iters)
        h = int(cfg.TRAIN.imgH // cfg.TRAIN.scale)
        w = int(cfg.TRAIN.imgW // cfg.TRAIN.scale)
        ray_chunk = int(cfg.RENDERER.ray.ray_chunk)
        precrop = int(cfg.TRAIN.get("precrop_iters", 500))
        data = self.dataset[0]  # frame 0 only (reference :81-82)
        particles = self.to_device(data["particles_pos"])
        ro_v = self.to_device(data["cw"][:, :, 3])

        log_interval = int(cfg.TRAIN.get("log_interval", 10))
        save_interval = int(cfg.TRAIN.get("save_interval", 500))

        last_loss = None
        for step in range(self.start_step, n_iters):
            idx = [self.sample_pixel_indices(h, w, step, ray_chunk, precrop)
                   for _ in self.train_views]
            rays_v = self.to_device([data["rays"][v][i]
                                     for v, i in enumerate(idx)])
            rgbs_v = self.to_device([data["rgb"][v][i]
                                     for v, i in enumerate(idx)])

            loss, (mse0, mse1, overflow) = self.train_step(
                particles, ro_v, rays_v, rgbs_v)
            self.lr_sched.step()
            last_loss = loss

            if (step + 1) % log_interval == 0:
                self.check_search_overflow(overflow, step, "warmup-render")
                self.logger.scalar("train/loss", float(loss), step)
                self.logger.scalar("train/lr", float(self.schedule(step)),
                                   step)
                mse0, mse1 = host(mse0), host(mse1)
                for v, name in enumerate(self.train_views):
                    self.logger.scalar(f"{name}/rgbloss_0", float(mse0[v]),
                                       step)
                    self.logger.scalar(f"{name}/rgbloss",
                                       float(mse0[v] + mse1[v]), step)
            if (step + 1) % save_interval == 0:
                self.eval(step)
                self.save_checkpoint(step)
        return float(last_loss) if last_loss is not None else None

    # ------------------------------------------------------------------

    def eval(self, step):
        cfg = self.cfg
        h = int(cfg.TEST.imgH // cfg.TEST.scale)
        w = int(cfg.TEST.imgW // cfg.TEST.scale)
        data = self.test_dataset[0]
        particles = self.to_device(data["particles_pos"])
        results = {}
        for v, name in enumerate(self.test_views):
            ro = self.to_device(data["cw"][v][:, 3])
            out = self.render_full(particles, ro, data["rays"][v])
            gt = data["rgb"][v]
            rgb0, rgb1 = host(out["rgb0"]), host(out["rgb1"])
            p0, p1 = psnr_np(rgb0, gt), psnr_np(rgb1, gt)
            self.logger.scalar(f"{name}/psnr_0", p0, step)
            self.logger.scalar(f"{name}/psnr_1", p1, step)
            self.visualize_image(rgb0, gt, h, w, step, f"coarse_0_{name}")
            self.visualize_image(rgb1, gt, h, w, step, f"fine_0_{name}")
            results[name] = {"psnr_0": p0, "psnr_1": p1}
        return results
