"""e2e_trainer_loop: `train/e2e.py` `E2ETrainer` as `train_e2e.py` builds
it (`stage_config('end2end')` with the watercube block of
`configs/dataset.yaml`), over a seeded Blender-layout scene written to
TMPDIR, one `E2ETrainer.train_iteration` a unit: the frame's arrays, the
pixel draw, the copies to the card, a ParticleNet step on 'auto' from the
carried state (reset at the sequence's start), the coarse + fine render,
one backward, two Adams, the schedules' step and, every `log_interval`
steps, the trainer's log with its host Pred2GT. No eval or checkpoint.

Besides the training cells' numbers (`nfbench/cells.py`), against the
reference carrying its own state from the sequence's first frame at the
published schedule's rates:
- ray_gap: the largest difference between a ray origin, a ray direction
  or a target colour that the trainer handed its train step (the start's
  steps and the window step) and the one the reference builds in float64
  from the written scene (the camera's pose and `camera_angle_x`, the
  next frame's image) at its own draw of the published loop's pixels
  (from the trainer's generator as it stood before the step). It holds
  the data path: `BlenderDataset`, the rays, the pixel draw and the
  pairing of ray and target. The reference's steps then take the
  trainer's batch: its rays differ from the scene's by float32's
  rounding alone, and a ray moved by that rounding can change the
  render's discrete choices (a neighbour set, a sample's bin), which
  would blur every other gap;
- state_gap: the largest distance between a particle of the program's
  carried state after the start's steps and the reference's, over the
  rest spacing;
- pred2gt_gap: |the Pred2GT the trainer logged at the window's first
  logged step - the float64 mean of `reference.trainer_loop.pred2gt_mm`
  over the same positions| over the latter. It checks the host's
  nearest-neighbour code alone: both sides read the program's positions.
"""

from __future__ import annotations

import shutil
import tempfile

import torch

from nfbench import inputs, work
from nfbench.cells import RenderTrainCell, ref_model
from nfbench.reference import particle_net as ref_pn
from nfbench.reference.precision import rounding
from nfbench.reference.train import step_from
from nfbench.reference.trainer_loop import (
    RENDERER_MILESTONES, TRANSITION_MILESTONES, follow_carried, pred2gt_mm,
    published_draw, published_lr, scene_batch,
)

TRAIN_VIEW, TEST_VIEW = "view_1", "view_5"


def sequence(config: dict, seed: int) -> tuple:
    """(positions (F, N, 3), velocities (F, N, 3)) of the scene's F frames:
    the seeded jittered block and its velocities at frame 0, the ballistic
    fall from them at frame t plus seeded noise."""
    pn, scene = config["particle_net"], config["scene"]
    pos0, vel0, *_ = inputs.fluid_frames(scene, pn, 1, seed, "cpu")[0]
    n_frames = int(config["end_index"])
    noise = torch.randn((n_frames, *pos0.shape),
                        generator=inputs.generator(seed, "sequence", "cpu"))
    g = torch.tensor(pn["gravity"])
    pos, vel = [pos0], [vel0]
    for t in range(1, n_frames):
        s = t * pn["timestep"]
        pos.append(pos0 + vel0 * s + 0.5 * g * s * s
                   + scene["target_noise"] * noise[t])
        vel.append(vel0 + g * s)
    return torch.stack(pos).numpy(), torch.stack(vel).numpy()


def write_scene(root: str, config: dict, seed: int) -> dict:
    """Write the seeded scene in Blender layout (`TRAIN_VIEW` for training,
    `TEST_VIEW` for the test split the trainer loads) with images of
    colours uniform over the 8-bit range; returns what was written:
    positions, velocities (F, N, 3), box, box_normals, cameras {view: c2w
    (3, 4)}, images {view: (F, H, W, 3) uint8}, camera_angle_x."""
    from neurofluid_torch.data.synthetic import write_blender_scene

    camera = config["camera"]
    positions, velocities = sequence(config, seed)
    box, box_normals = (t.numpy() for t in inputs.container(config["scene"],
                                                            "cpu"))
    poses = inputs.cameras(camera, 2, seed, "cpu")
    cams = {TRAIN_VIEW: poses[0].numpy(), TEST_VIEW: poses[1].numpy()}
    size, n_frames = camera["image"], positions.shape[0]
    pixels = torch.randint(0, 256, (len(cams), n_frames, size, size, 3),
                           dtype=torch.uint8,
                           generator=inputs.generator(seed, "images", "cpu"))
    images = dict(zip(cams, pixels.numpy()))
    write_blender_scene(root, positions, velocities, box, box_normals, cams,
                        images, test_views=(TEST_VIEW,),
                        camera_angle_x=camera["camera_angle_x"])
    return {"positions": positions, "velocities": velocities, "box": box,
            "box_normals": box_normals, "cameras": cams, "images": images,
            "camera_angle_x": camera["camera_angle_x"]}


def trainer_config(config: dict, traffic: dict, seed: int, scene: str,
                   expdir: str):
    """The stage's configuration as `train_e2e.py --dataset watercube`
    assembles it, the dataset's paths pointed at the written scene, its
    sequence cut to the configuration's `end_index`, the host's seed drawn
    from the run's, and the sizes the configuration and the traffic state
    (the published stage's own: `check_settings` holds the rest)."""
    from neurofluid_torch.utils.config import stage_config, validate_keys

    cfg = stage_config("end2end", ["--expdir", expdir, "--expname",
                                   "e2e-trainer-loop", "--dataset",
                                   "watercube"]).clone()
    size, rn = config["camera"]["image"], config["render_net"]
    cfg.merge({"train": {"path": scene, "end_index": config["end_index"]},
               "test": {"path": scene},
               "TRAIN": {"log_interval": int(traffic["log_interval"]),
                         "seed": inputs.sub_seed(seed, "trainer") % 2 ** 31,
                         "imgW": size, "imgH": size},
               "TEST": {"imgW": size, "imgH": size},
               "RENDERER": {"ray": {
                   "ray_chunk": int(traffic["rays_per_view"]),
                   "N_samples": rn["n_samples"],
                   "N_importance": rn["n_importance"]}}})
    validate_keys(cfg, "end2end")
    return cfg.freeze()


def _same(a, b) -> bool:
    as_list = lambda v: list(v) if isinstance(v, tuple) else v  # noqa: E731
    return as_list(a) == as_list(b)


def check_settings(trainer, config: dict, traffic: dict) -> None:
    """The trainer builds what the configuration and the traffic state, or
    this raises. The NeRFs' widths are held by loading the weights."""
    pn, rn, opt = (config[k] for k in ("particle_net", "render_net",
                                       "optimizer"))
    t, lr = trainer.cfg.TRAIN, trainer.cfg.TRAIN.LR
    built = trainer.transition.init_kwargs
    found = {f"particle_net.{k}": (built[k], v) for k, v in pn.items()}
    found.update({f"render_net.{k}": (getattr(trainer.renderer, k), v)
                  for k, v in rn.items() if hasattr(trainer.renderer, k)})
    found.update({
        "render_net.search_radius": (
            trainer.renderer.search_radius,
            rn["search_radius_scale"] * rn["particle_radius"]),
        "optimizer.renderer_lr": (float(lr.renderer_lr), opt["renderer_lr"]),
        "optimizer.transition_lr": (float(lr.trans_lr), opt["transition_lr"]),
        "optimizer.use_scheduler": (bool(lr.use_scheduler),
                                    opt["use_scheduler"]),
        "optimizer.grad_clip_value": (float(t.grad_clip_value),
                                      opt["grad_clip_value"]),
        "optimizer.boundary_weight": (float(t.loss_weight.boundary_loss),
                                      opt["boundary_weight"]),
        "anchor": (trainer.anchor_enabled, False),
        "views": (trainer.train_views, [TRAIN_VIEW] * int(traffic["views"])),
        "rays_per_view": (int(trainer.cfg.RENDERER.ray.ray_chunk),
                          int(traffic["rays_per_view"])),
        "image": (int(t.imgW), config["camera"]["image"]),
    })
    differ = {k: v for k, v in found.items() if not _same(*v)}
    if differ:
        raise ValueError(f"the trainer differs from the configuration: "
                         f"{differ} (built, stated)")


def build_trainer(config: dict, traffic: dict, seed: int, scene: str,
                  expdir: str, device):
    """The cell's trainer on the scene written at `scene`: built as
    `train_e2e.py` builds it, held to the configuration, the seeded
    weights loaded over its own and its step past the centre crop, as a
    resumed job's. Returns (trainer, weights {name: tensor}, the
    transition model's leaf names)."""
    from neurofluid_torch.train.e2e import E2ETrainer

    trainer = E2ETrainer(trainer_config(config, traffic, seed, scene, expdir),
                         device=device)
    check_settings(trainer, config, traffic)
    weights = inputs.draw_weights(
        inputs.particle_net_specs(config["particle_net"]), seed,
        "particle_net", device)
    trainer.transition.load_state_dict(weights)
    rw = inputs.draw_weights(inputs.render_net_specs(config["render_net"]),
                             seed, "render_net", device)
    trainer.renderer.load_state_dict(rw)
    names = set(weights)
    weights.update(rw)
    start = int(trainer.cfg.TRAIN.precrop_iters) + 1
    trainer.start_step = trainer.global_step = start
    return trainer, weights, names


class Entry(RenderTrainCell):
    program_state = ("trainer",)

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from neurofluid_torch.train.e2e import E2ETrainer

        if not hasattr(E2ETrainer, "train_iteration"):
            raise RuntimeError("this program's E2ETrainer has no "
                               "train_iteration: the cell drives the "
                               "trainer's own iteration")
        # a unit is a step of the sequence: 7 steps from 8 frames
        super().__init__(config, dict(traffic, pool=config["end_index"] - 1),
                         seed, device)
        self.pred2gt = None

    # -- program side
    def build(self) -> None:
        import scipy.spatial  # noqa: F401  (the log's k-d tree, imported here)

        cfg, dev = self.config, self.device
        self.tmp = tempfile.mkdtemp(prefix="nfbench-e2e-trainer-loop-")
        scene = f"{self.tmp}/scene"
        self.scene = write_scene(scene, cfg, self.seed)
        self.trainer, self.weights, self.transition_names = build_trainer(
            cfg, self.traffic, self.seed, scene, f"{self.tmp}/exps", dev)
        if len(self.trainer.dataset) != self.pool:
            raise ValueError(f"the sequence has {len(self.trainer.dataset)} "
                             f"steps, not {self.pool}")

        to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self.positions = to(self.scene["positions"])
        self.frames = [(self.positions[t], to(self.scene["velocities"][t]))
                       for t in range(self.pool)]
        self.box = to(self.scene["box"])
        self.box_normals = to(self.scene["box_normals"])
        # what the iteration hands its train step, observed, not changed
        step_fn, self.calls = self.trainer.train_step, []

        def observed(*args):
            self.calls.append(args[:7])
            del self.calls[:-1]
            return step_fn(*args)

        self.trainer.train_step = observed
        self.inputs, self.draws = [], []

    def named_parameters(self):
        yield from self.trainer.transition.named_parameters()
        yield from self.trainer.renderer.named_parameters()

    def groups(self) -> dict:
        """The renderer's leaves and the transition model's apart, as in
        e2e-train: the transition model's gradient is a nearly cancelling
        sum through the render."""
        return {"renderer": [k for k in self.weights
                             if k not in self.transition_names],
                "transition": sorted(self.transition_names)}

    def optimizer_of(self, name):
        return (self.trainer.opt_t if name in self.transition_names
                else self.trainer.opt_r)

    def lr_at(self, name: str, update: int) -> float:
        opt = self.config["optimizer"]
        if name in self.transition_names:
            return published_lr(opt["transition_lr"], TRANSITION_MILESTONES,
                                update)
        return published_lr(opt["renderer_lr"], RENDERER_MILESTONES, update)

    def learning_rates(self, update: int) -> dict:
        return {k: self.lr_at(k, update) for k in self.weights}

    def program_step(self, i: int):
        tr = self.trainer
        data_idx = i % self.pool
        logged = (tr.global_step + 1) % int(self.traffic["log_interval"]) == 0
        self.last_draw = (data_idx, tr.np_rng.bit_generator.state)
        loss, aux = tr.train_iteration(data_idx, eval_during_training=False)
        if i < self.checked:
            self.inputs.append(self.calls[-1])
            self.draws.append(self.last_draw)
            if i == self.checked - 1:
                self.state_after_start = tr.state_pos
        elif logged and self.pred2gt is None:
            self.pred2gt = {
                "logged": tr.fluid_errors.errors[data_idx + 1]["gt2pred_mean"],
                "pred": tr.state_pos, "gt": self.positions[data_idx + 1]}
        bad = (aux["search_overflow"] | aux["search_cap_exceeded"]
               | ~torch.isfinite(loss))
        return loss, bad

    def run_unit(self, i: int, share: float) -> bool:
        kept = self.kept
        bad = super().run_unit(i, share)
        if kept is None and self.kept is not None:
            self.kept["inputs"] = self.calls[-1]
            self.kept["draw"] = self.last_draw
            self.kept["update"] = self.checked + i
        return bad

    def settled(self) -> bool:
        return super().settled() and self.pred2gt is not None

    def release(self) -> None:
        super().release()
        self.calls = None
        shutil.rmtree(self.tmp, ignore_errors=True)

    # -- reference side
    def batch(self, draw: tuple, rnd=None) -> tuple:
        """(ro_v, rays_v, rgbs_v) in float64 of a step, from the written
        scene at the published loop's pixels: `draw` = (the step's frame,
        the trainer's generator state before it); the target is the next
        frame's image. `rnd` rounds the pose and the camera's directions,
        as a product of that precision would."""
        data_idx, state = draw
        views = [TRAIN_VIEW] * int(self.traffic["views"])
        size = self.config["camera"]["image"]
        pixels = published_draw(state, size * size,
                                int(self.traffic["rays_per_view"]),
                                len(views))
        return scene_batch(
            [torch.as_tensor(self.scene["cameras"][v]) for v in views],
            self.scene["camera_angle_x"],
            [torch.as_tensor(self.scene["images"][v][data_idx + 1])
             for v in views], pixels, rnd)

    def step_loss(self, p, inputs: tuple, precision):
        """The loss of one step from the state `inputs` holds first, and
        the next state: the ParticleNet step, the render of the step's
        rays against its targets, the boundary loss."""
        pn = self.config["particle_net"]
        pos, vel, _, _, ro_v, rays_v, rgbs_v = inputs
        pred, pred_vel, _ = ref_pn.step(
            p, pos, vel, self.box, self.box_normals, ref_model(pn),
            ref_pn.Precision(precision["conv"], precision["dense"]))
        loss = self.render_loss(p, pred, (ro_v, rays_v, rgbs_v), precision)
        bounds = ref_pn.box_bounds(pn["particle_radius"], pos.device)
        loss = loss + self.config["optimizer"]["boundary_weight"] \
            * ref_pn.boundary_loss(pred, bounds)
        return loss, (pred, pred_vel)

    def _chain(self, precision: dict):
        """The start's steps followed by the reference from the seeded
        weights and the sequence's first frame, carrying its own state;
        the rays and targets are the trainer's, which `ray_gap` holds to
        the written scene's."""
        def step(p, t, state):
            return self.step_loss(p, (*state, *self.inputs[t][2:]),
                                  precision)

        return self._once(("chain", str(precision)), lambda: follow_carried(
            step, self.weights, self.lr_at, self.checked, self.frames[0]))

    def follow_reference(self, precision: dict):
        return self._chain(precision)[:3]

    def window_reference(self, precision: dict):
        k = self.kept

        def make():
            loss, grads, changes = step_from(
                lambda p: self.step_loss(p, k["inputs"], precision)[0],
                *k["before"], self.learning_rates(k["update"]))
            return [loss], grads, changes

        return self._once(("window", str(precision)), make)

    def _ray_gap(self, rnd=None) -> float:
        """The largest |ray origin, ray direction or target colour - the
        written scene's in float64| over the start's steps and the window
        step: of the trainer's batch (rnd None), or of the scene's own
        rounded by `rnd`."""
        steps = list(zip(self.inputs, self.draws))
        if self.kept is not None:
            steps.append((self.kept["inputs"], self.kept["draw"]))
        gap = 0.0
        for args, draw in steps:
            want = self.batch(draw)
            got = args[4:7] if rnd is None else self.batch(draw, rnd)
            gap = max([gap] + [float((g.detach().cpu().double() - w).abs()
                                     .max()) for g, w in zip(got, want)])
        return gap

    def _state_gap(self, got, want) -> float:
        d = torch.linalg.norm((got - want).double(), dim=-1)
        return float(d.max()) / self.config["scene"]["spacing"]

    def _pred2gt_gap(self, got: float) -> float:
        want = pred2gt_mm(self.pred2gt["pred"], self.pred2gt["gt"])
        return abs(got - want) / want

    def numbers(self) -> dict:
        out = super().numbers()
        prec = self.config["precision"]
        out["ray_gap"] = self._ray_gap()
        out["state_gap"] = self._state_gap(self.state_after_start,
                                           self._chain(prec)[3][0])
        out["pred2gt_gap"] = self._pred2gt_gap(self.pred2gt["logged"])
        return out

    def control_numbers(self) -> dict:
        out = super().control_numbers()
        prec, low = self.config["precision"], self.config["control"]
        out["ray_gap"] = self._ray_gap(rounding(low["dense"]))
        out["state_gap"] = self._state_gap(self._chain(low)[3][0],
                                           self._chain(prec)[3][0])
        rnd = rounding(low["dense"])
        out["pred2gt_gap"] = self._pred2gt_gap(pred2gt_mm(
            rnd(self.pred2gt["pred"]), rnd(self.pred2gt["gt"])))
        return out

    def work(self) -> dict:
        pn = self.config["particle_net"]
        n, nb = self.frames[0][0].shape[0], self.box.shape[0]
        ff, fb = self.pair_counts()
        conv_ops, conv_bytes = work.conv_work(pn, n, nb, ff, fb, True)
        r_ops, r_bytes = self.render_work(True)
        return {"conv_ops": conv_ops, "conv_bytes": conv_bytes,
                "render_ops": 0.0, "render_bytes": r_bytes,
                "model_ops": conv_ops + work.dense_ops(pn, n, True) + r_ops}
