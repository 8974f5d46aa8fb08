"""What the cells' entries share. An entry is the file
`nfbench/entries/<entry>.py` that a traffic mix names by its `entry`; its
class `Entry` builds the program's object for the window from the
configuration and the seed, drives its first steps in set-up, runs one
unit (a train step or a frame) at a time for the window, and afterwards
compares what the program produced with the plain reference.

A training cell compares two stretches of the one object it builds:

- the start: set-up's first `checked_steps` steps, through the window's
  own call on pool entries that all differ, against the reference
  followed from the seeded weights;
- a window step: the unit that starts once a share of the window drawn
  from the seed (`WINDOW_SHARE`) has passed. Its weights and Adam moments
  are copied before it and its weights and gradients after it; the
  reference takes one Adam step from that copy. That follows the
  program's own state, which the start's check covers from the seed.

Its numbers, each over leaves:
- loss_gap: the largest |loss - reference| / |reference| of the start's
  steps;
- grad_gap: the largest gap between the norm of a leaf's first gradient
  as the optimizer got it (Adam's first moment after one step over
  1 - beta1) and the reference's, over the larger of the reference leaf's
  norm and the median leaf's;
- grad_gap_median: the median leaf's gap of the same;
- change_gap: the worst leaf's gap of each leaf's change after the
  start's steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (those move under Adam by round-off
  alone);
- window_loss_gap, window_grad_gap, window_grad_gap_median,
  window_change_gap: the same of the window step (the gradient read from
  the leaves' `.grad`, as Adam read it; the change over that one step).
A cell with `groups()` takes the gaps of each group of leaves apart
(`grad_gap.renderer`, ...). A run compares the numbers its cell's limits
file names (`nfbench/limits/<cell>.json`).
"""

from __future__ import annotations

import statistics

import torch

from nfbench import inputs, work
from nfbench.reference import particle_net as ref_pn
from nfbench.reference import render_net as ref_rn
from nfbench.reference.train import follow, step_from

BETA1 = 0.9
QUIET_LEAF = 1e-3  # a leaf's reference gradient below this x the median's
TINY = 1e-30  # a floor under the denominators, for all-zero references
WINDOW_SHARE = (0.5, 0.9)  # the window step starts within this share

# configuration keys that set the benchmark's draw, not the module
NOT_MODULE_KEYS = {"sigma_bias"}


def _module_kwargs(section: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in section.items() if k not in NOT_MODULE_KEYS}


def particle_net(pn: dict, device):
    """The program's ParticleNet with the configuration's settings."""
    from neurofluid_torch.models.particle_net import ParticleNet

    return ParticleNet(**_module_kwargs(pn), device=device)


def render_net(rn: dict, device):
    """The program's RenderNet with the configuration's settings."""
    from neurofluid_torch.models.render_net import RenderNet

    return RenderNet(**_module_kwargs(rn), device=device)


def ref_model(pn: dict) -> dict:
    return {k: pn[k] for k in ("timestep", "radius_scale", "particle_radius",
                               "gravity", "correction_scale",
                               "layer_channels")}


def ref_render_cfg(rn: dict) -> dict:
    """The settings `reference.render_net` renders with; it renders
    NeuroFluid's published encodings on the dense search
    (`render_net.PUBLISHED`) and refuses any other."""
    other = {k: rn[k] for k, v in ref_rn.PUBLISHED.items() if rn[k] != v}
    if other:
        raise ValueError(f"the reference renders NeuroFluid's published "
                         f"settings only, not {other}")
    out = {k: rn[k] for k in ("near", "far", "n_samples", "n_importance",
                              "num_neighbors", "grid_lower", "grid_upper")}
    out["search_radius"] = rn["search_radius_scale"] * rn["particle_radius"]
    return out


def _norm(t) -> float:
    return float(torch.linalg.norm(t.reshape(-1).double()))


def _leaf_gaps(got: dict, want: dict, names: list) -> dict:
    """{leaf: the gap of the norms over the larger of the leaf's and the
    median leaf's reference norm} over `names`."""
    norms = {k: _norm(want[k]) for k in names}
    med = statistics.median(norms.values())
    return {k: abs(_norm(got[k]) - norms[k]) / max(norms[k], med, TINY)
            for k in names}


def training_gaps(losses, grads, changes, ref, groups: dict) -> tuple:
    """({loss_gap, grad_gap[.group], grad_gap_median[.group],
    change_gap[.group]}, the worst leaf of each worst-leaf number) of
    (losses, first gradients, changes) against the reference's. `groups`
    maps a suffix to the leaves it compares ('' for all)."""
    r_losses, r_grads, r_changes = ref
    out = {"loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(losses, r_losses))}
    worst = {}
    for suffix, names in groups.items():
        tag = f".{suffix}" if suffix else ""
        gn = {k: _norm(r_grads[k]) for k in names}
        med = statistics.median(gn.values())
        kept = [k for k in names if gn[k] >= QUIET_LEAF * med]
        for key, gaps in ((f"grad_gap{tag}", _leaf_gaps(grads, r_grads,
                                                         names)),
                          (f"change_gap{tag}", _leaf_gaps(changes, r_changes,
                                                           kept))):
            worst[key] = max(gaps, key=gaps.get)
            out[key] = gaps[worst[key]]
            if key.startswith("grad"):
                out[f"grad_gap_median{tag}"] = statistics.median(
                    gaps.values())
    return out, worst


def _prefixed(gaps: tuple) -> tuple:
    out, worst = gaps
    return ({f"window_{k}": v for k, v in out.items()},
            {f"window_{k}": v for k, v in worst.items()})


class TrainCell:
    """What the training entries share: the start's steps and the window
    step, the readings taken from the optimizers, the comparison. An entry
    gives build(), named_parameters(), optimizer_of(name),
    learning_rates(), program_step(i) -> (loss, bad flag), reference_loss
    (leaves, pool index, precision) and work(), and names the attributes
    that hold the program's state in `program_state`."""

    unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.checked = int(traffic["checked_steps"])
        self.pool = int(traffic["pool"])
        self.attempted = self.failed = 0
        u = torch.rand((), generator=inputs.generator(seed, "window_step",
                                                      "cpu"))
        lo, hi = WINDOW_SHARE
        self.pick = lo + (hi - lo) * float(u)
        self.kept = None

    # -- program side
    def setup(self) -> None:
        self.build()
        self.params = dict(self.named_parameters())
        differ = set(self.weights) ^ set(self.params)
        if differ:
            raise ValueError(f"weights and parameters differ: {differ}")
        self.losses = []
        for i in range(self.checked):
            loss, bad = self.program_step(i)
            self.losses.append(float(loss))
            self.count(bad)
            if i == 0:
                self.first_grads = {
                    k: self.optimizer_of(k).state[p]["exp_avg"] / (1.0 - BETA1)
                    for k, p in self.params.items()}
        with torch.no_grad():
            self.changes = {k: p.detach() - self.weights[k]
                            for k, p in self.params.items()}

    def count(self, bad) -> bool:
        bad = bool(bad)
        self.attempted += 1
        self.failed += int(bad)
        return bad

    def _moments(self) -> tuple:
        """Copies of (leaves, Adam's first and second moments, its step
        counts), queued on the stream: no synchronisation."""
        p0, m0, v0, s0 = {}, {}, {}, {}
        for k, p in self.params.items():
            state = self.optimizer_of(k).state[p]
            p0[k] = p.detach().clone()
            m0[k] = state["exp_avg"].clone()
            v0[k] = state["exp_avg_sq"].clone()
            s0[k] = state["step"].clone()
        return p0, m0, v0, s0

    def run_unit(self, i: int, share: float) -> bool:
        """Step `i` of the window, begun at `share` of it."""
        keep = self.kept is None and share >= self.pick
        before = self._moments() if keep else None
        t = (self.checked + i) % self.pool
        loss, bad = self.program_step(self.checked + i)
        if keep:
            with torch.no_grad():
                self.kept = {
                    "t": t, "loss": loss.detach().clone(), "before": before,
                    "grads": {k: torch.zeros_like(p) if p.grad is None
                              else p.grad.clone()
                              for k, p in self.params.items()},
                    "changes": {k: p.detach() - before[0][k]
                                for k, p in self.params.items()}}
        return self.count(bad)

    def settled(self) -> bool:
        """Whether the window step was taken (the window runs on until
        it is)."""
        return self.kept is not None

    def release(self) -> None:
        for name in self.program_state:
            setattr(self, name, None)
        self.params = None

    # -- reference side
    def _once(self, key: tuple, make):
        """make(), computed once per key (numbers and control_numbers
        share the reference at the stated precision)."""
        memo = self.__dict__.setdefault("_memo", {})
        if key not in memo:
            memo[key] = make()
        return memo[key]

    def follow_reference(self, precision: dict):
        return self._once(("start", str(precision)), lambda: follow(
            lambda p, t: self.reference_loss(p, t, precision),
            self.weights, self.learning_rates(), self.checked))

    def window_reference(self, precision: dict):
        k = self.kept

        def make():
            loss, grads, changes = step_from(
                lambda p: self.reference_loss(p, k["t"], precision),
                *k["before"], self.learning_rates())
            return [loss], grads, changes

        return self._once(("window", str(precision)), make)

    def groups(self) -> dict:
        return {"": list(self.weights)}

    def numbers(self) -> dict:
        prec = self.config["precision"]
        out, self.worst = training_gaps(self.losses, self.first_grads,
                                        self.changes,
                                        self.follow_reference(prec),
                                        self.groups())
        k = self.kept
        w_out, w_worst = _prefixed(training_gaps(
            [float(k["loss"])], k["grads"], k["changes"],
            self.window_reference(prec), self.groups()))
        out.update(w_out)
        self.worst.update(w_worst)
        return out

    def control_numbers(self) -> dict:
        prec, low = self.config["precision"], self.config["control"]
        out = training_gaps(*self.follow_reference(low),
                            self.follow_reference(prec), self.groups())[0]
        out.update(_prefixed(training_gaps(
            *self.window_reference(low), self.window_reference(prec),
            self.groups()))[0])
        return out

    def pair_counts(self) -> tuple:
        """Mean in-radius (fluid, box) pairs of a ParticleNet step over the
        pool, at the integrated positions of its first step."""
        pn = self.config["particle_net"]
        radius = 3.0 * pn["radius_scale"] * pn["particle_radius"]
        g = torch.tensor(pn["gravity"], device=self.device)
        ff = fb = 0
        for pos, vel, *_ in self.frames:
            v2 = vel + g * pn["timestep"]
            x2 = pos + (vel + v2) / 2.0 * pn["timestep"]
            ff += ref_pn.radius_pairs(x2, x2, radius, True).qi.numel()
            fb += ref_pn.radius_pairs(x2, self.box, radius, False).qi.numel()
        return ff / len(self.frames), fb / len(self.frames)


class RenderTrainCell(TrainCell):
    """What the renderer's two training entries share."""

    def build_renderer(self):
        cfg, dev = self.config, self.device
        rn = cfg["render_net"]
        self.renderer = render_net(rn, dev)
        w = inputs.draw_weights(inputs.render_net_specs(rn), self.seed,
                                "render_net", dev)
        self.renderer.load_state_dict(w)
        self.batches = inputs.ray_batches(
            cfg["camera"], self.pool, int(self.traffic["views"]),
            int(self.traffic["rays_per_view"]), self.seed, dev)
        return w

    def render_loss(self, p, particles, batch, precision):
        rcfg = ref_render_cfg(self.config["render_net"])
        ro_v, rays_v, rgb_v = batch
        loss = 0.0
        for ro, rays, rgb in zip(ro_v, rays_v, rgb_v):
            rgb0, rgb1 = ref_rn.render(p, particles, ro, rays, rcfg,
                                       precision["dense"])
            loss = loss + torch.mean((rgb0 - rgb) ** 2) \
                + torch.mean((rgb1 - rgb) ** 2)
        return loss

    def render_work(self, particle_grad: bool) -> tuple:
        rn = self.config["render_net"]
        in_xyz, in_dir = inputs.nerf_in_channels()
        rays = int(self.traffic["views"]) * int(self.traffic["rays_per_view"])
        n = self.frames[0][0].shape[0]
        return (work.render_ops(rn, in_xyz, in_dir, rays, True),
                work.render_kernel_bytes(rn, rays, n, particle_grad, True))
