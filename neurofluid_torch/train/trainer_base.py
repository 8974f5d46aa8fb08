"""Shared trainer infrastructure (port of
neurofluid_tpu/train/trainer_base.py).

Plays the role of the reference `BaseTrainer` (reference
trainer/basetrainer.py:17-341): experiment directory layout
(<expdir>/<expname>/{models,images,particles}), metric logging, seeding,
boundary-loss constants, pixel sampling with pre-crop, chunked full-image
rendering, and visualization dumps.

Randomness is explicit: a `numpy.random.Generator` from TRAIN.seed for
the host (pixel choices, shuffles), drawn in the JAX trainers' order, and
JAX's `PRNGKey(TRAIN.seed)` for weight initialisation, split as the JAX
trainers split it and drawn by `utils.jax_random` on the host, so that a
seeded trainer starts from the JAX trainer's weights. Trainers run on the
card unless built with `device="cpu"`.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from neurofluid_torch.cuda import resolve_device
from neurofluid_torch.train import losses
from neurofluid_torch.utils import jax_random
from neurofluid_torch.utils.logging import MetricsLogger, to8b
from neurofluid_torch.utils.profiling import span


class TrainerBase:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.exppath = osp.join(cfg.expdir, cfg.expname)
        self.imgpath = osp.join(self.exppath, "images")
        self.particlepath = osp.join(self.exppath, "particles")
        self.modelpath = osp.join(self.exppath, "models")
        for d in (self.modelpath, self.imgpath, self.particlepath):
            os.makedirs(d, exist_ok=True)
        self.logger = MetricsLogger(self.exppath)

        seed = int(cfg.TRAIN.seed)
        self.np_rng = np.random.default_rng(seed)
        self.key = jax_random.prng_key(seed)

        self.box_bounds = losses.default_box_bounds(device=self.device)

    def next_key(self) -> np.ndarray:
        """A fresh JAX key: `key, sub = jax.random.split(key)`."""
        self.key, sub = jax_random.split(self.key)
        return sub

    def to_device(self, x) -> torch.Tensor:
        """A host array (numpy) as a float32 tensor on the trainer's
        device."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # ------------------------------------------------------------------
    # search-health policy
    # ------------------------------------------------------------------

    def check_search_overflow(self, flag, step, context: str,
                              fatal: bool = True):
        """Enforce the neighbor-search overflow policy.

        `flag` is the boolean emitted by the models' search diagnostics
        (read on the host here): a grid cell exceeded its cap (tail
        candidates dropped), or a cull capacity was exceeded. The policy is
        fail-loudly: raise (default) or warn when cfg
        TRAIN.on_search_overflow == 'warn'.

        `fatal=False` is for EVAL rollouts: a weakly-trained model may
        legitimately diverge during a long autoregressive rollout; the
        overflow is LOGGED and recorded, never silent, but evaluating a
        bad model must not stop a run whose metric reports the divergence
        anyway. Returns True when overflow was present.
        """
        with span("sync.overflow"):
            overflow = bool(flag)
        if not overflow:
            return False
        msg = (
            f"neighbor-search overflow at step {step} ({context}): a cell "
            "grid bucket or fixed-K neighborhood exceeded its static cap, so "
            "near neighbors were dropped and the physics/features are "
            "corrupted. Increase grid_max_per_cell / fluid_neighbor_k (or "
            "the relevant cap) and restart."
        )
        policy = str(self.cfg.TRAIN.get("on_search_overflow", "raise"))
        if policy == "warn" or not fatal:
            print(f"WARNING: {msg}")
            self.logger.scalar(f"overflow/{context}", 1.0, step)
        else:
            raise RuntimeError(msg)
        return True

    def eval_chunk_size(self) -> int:
        """Ray-chunk size for full-image eval renders: RENDERER.ray.
        eval_ray_chunk when set, else the larger of the training chunk
        (RENDERER.ray.ray_chunk) and 2,048, the JAX package's default."""
        ray = self.cfg.RENDERER.ray
        return int(ray.get("eval_ray_chunk", max(int(ray.ray_chunk), 2048)))

    # ------------------------------------------------------------------
    # pixel sampling (reference basetrainer.py:171-193 + trainer loops)
    # ------------------------------------------------------------------

    def sample_pixel_indices(self, height, width, global_step, n_rays,
                             precrop_iters):
        """Flat pixel indices; center crop for the first `precrop_iters`
        steps."""
        if global_step > precrop_iters:
            candidates = np.arange(height * width)
        else:
            dh = int(height // 2 * 0.5)
            dw = int(width // 2 * 0.5)
            rows = np.arange(height // 2 - dh, height // 2 + dh)
            cols = np.arange(width // 2 - dw, width // 2 + dw)
            candidates = (rows[:, None] * width + cols[None, :]).reshape(-1)
        sel = self.np_rng.choice(candidates.shape[0], size=n_rays,
                                 replace=False)
        return candidates[sel]

    # ------------------------------------------------------------------
    # chunked full-image rendering for eval
    # ------------------------------------------------------------------

    def make_chunk_renderer(self, model, chunk=1024):
        """render_full(particles, ro, rays_flat) -> dict of outputs over all
        rays: the rays in blocks of `chunk`, one render each under
        `torch.no_grad()`, the last block padded to `chunk` by repeating
        its last real ray (never zeros: a zero-direction ray is
        degenerate, and its PDF normalisation could emit NaNs and trip the
        per-block diagnostics). Per-ray and per-sample outputs are
        concatenated and trimmed to the real rays; scalar diagnostics (the
        search overflow flag) are stacked, one entry per block. The
        particles' search grid (`model._shared_grid`: the list path's on
        the grid backend, else none) is built once for all blocks, as the
        JAX package's scan does. Reads nothing from `self`."""

        def trim(flat, k, n, n_chunks):
            # outputs are either per-ray (dim0 = n_chunks * chunk) or
            # per-sample (dim0 = n_chunks * chunk * S); anything else breaks
            # the model's output contract: fail loudly, never pass through
            total = n_chunks * chunk
            if flat.shape[0] % total != 0:
                raise ValueError(
                    f"render output '{k}' has leading dim {flat.shape[0]}, "
                    f"not a multiple of rays {total}: per-ray/per-sample "
                    "output contract violated"
                )
            return flat[: n * (flat.shape[0] // total)]

        def render_full(particles, ro, rays_flat):
            with span("frame"):
                dev = particles.device
                rays_flat = torch.as_tensor(rays_flat, dtype=torch.float32,
                                            device=dev)
                n = rays_flat.shape[0]
                n_chunks = -(-n // chunk)
                outs = []
                with torch.no_grad():
                    grid = model._shared_grid(particles)
                    for i in range(n_chunks):
                        part = rays_flat[i * chunk:(i + 1) * chunk]
                        pad = chunk - part.shape[0]
                        if pad:
                            part = torch.cat([part, part[-1:].expand(pad, 6)])
                        outs.append(model(particles, ro, part, grid=grid))
                merged = {}
                for k in outs[0]:
                    if outs[0][k].ndim == 0:
                        merged[k] = torch.stack([o[k] for o in outs])
                        continue
                    cat = torch.cat([o[k] for o in outs])
                    merged[k] = trim(cat, k, n, n_chunks)
                return merged

        return render_full

    # ------------------------------------------------------------------
    # visualization (reference basetrainer.py:312-333)
    # ------------------------------------------------------------------

    def visualize_image(self, pred_rgbs, gt_rgbs, height, width, step,
                        prefix, mask=None):
        pred = np.asarray(pred_rgbs).reshape(height, width, 3)
        gt = np.asarray(gt_rgbs).reshape(height, width, 3)
        self.logger.image(f"{prefix}/pred_vs_gt",
                          np.concatenate([gt, pred], 1), step)
        from PIL import Image

        Image.fromarray(to8b(gt)).save(
            osp.join(self.imgpath, f"{prefix}_{step:05d}.png")
        )
        Image.fromarray(to8b(pred)).save(
            osp.join(self.imgpath, f"{prefix}_{step:05d}_pred.png")
        )
        if mask is not None:
            m = np.asarray(mask).reshape(height, width)
            Image.fromarray(to8b(m)).save(
                osp.join(self.imgpath, f"{prefix}_{step:05d}_mask.png")
            )


def host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
