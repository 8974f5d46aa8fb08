"""Port parity, the reference-protocol run: `neurofluid_torch.cli.
full_protocol_run` and `reval_e2e_rollout` against the JAX package's
tools/full_protocol_run.py and tools/reval_e2e_rollout.py.

Both runners are driven with recorders in place of what they orchestrate
(the stage trainers, the data writers, FluidErrors, PSNR / SSIM and the
rollout), so that no model is built: the same knobs must give the same
stage configs (paths apart), the same calls in the same order, the same
resume decisions and the same record. The JAX tools write their record
beside their module's parent directory, so the tests point the modules'
`__file__` into tmp_path; the repo's PROTOCOL_R5.json is never written.
The retry is held against JAX's with a rollout whose overflow flag is
forced, and the port's clone against the original net on a real rollout.
"""

import importlib
import json
import os
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.data import synthetic as jsynthetic
from neurofluid_tpu.models.particle_net import ParticleNet as JParticleNet
from neurofluid_tpu.train import e2e as je2e
from neurofluid_tpu.train import transition as jtransition
from neurofluid_tpu.train import warmup as jwarmup
from neurofluid_tpu.utils import metrics as jmetrics
from neurofluid_torch.cli import full_protocol_run as fpr
from neurofluid_torch.cli import reval_e2e_rollout as reval
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.train import transition as trans_mod

TOOLS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools")
# the knobs both runners are driven with (small, so that every loop of the
# orchestration runs several times): stride 7 renders frames on both sides
# of the trained / rollout split
KNOBS = dict(N_SIMS=3, WARMUP_ITERS=11, TRANS_EPOCHS=2, E2E_EPOCHS=1,
             E2E_RLR=2e-4, RENDER_STRIDE=7, SEARCH="fused_cconv",
             CONV_PREC="default", ANCHOR="1", FUSED_SLAB=320)
# the JAX module's constant of each knob
JAX_NAMES = dict(N_SIMS="N_SIMS", WARMUP_ITERS="WARMUP_ITERS",
                 TRANS_EPOCHS="TRANS_EPOCHS", E2E_EPOCHS="E2E_EPOCHS",
                 E2E_RLR="E2E_RENDERER_LR", RENDER_STRIDE="RENDER_STRIDE",
                 SEARCH="SEARCH_BACKEND", CONV_PREC="CONV_PREC",
                 ANCHOR="ANCHOR", FUSED_SLAB="FUSED_SLAB")
N_TEST, IMG, WINDOWS = 60, 400, 5  # test samples, image side, windows/sim
CAPS = dict(fluid_neighbor_k=128, obstacle_neighbor_k=64,
            grid_max_per_cell=64, fused_slab_cap=320)


def _import_tool(name):
    """A module of tools/, importable by its own name as the tools import
    each other; the JAX compilation cache setting their import makes is
    put back."""
    before = jax.config.jax_compilation_cache_dir
    sys.path.insert(0, TOOLS)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(TOOLS)
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture(scope="module")
def jfpr():
    return _import_tool("full_protocol_run")


@pytest.fixture(scope="module")
def jreval(jfpr):
    return _import_tool("reval_e2e_rollout")


# ---------------------------------------------------------------- recorders

def _plain(x, paths):
    """`x` (configs, call arguments) as plain data with each path root
    replaced by its name."""
    if hasattr(x, "to_dict"):
        x = x.to_dict()
    if isinstance(x, dict):
        return {k: _plain(v, paths) for k, v in x.items() if k != "log"}
    if isinstance(x, (list, tuple)):
        return [_plain(v, paths) for v in x]
    if isinstance(x, str):
        for name, path in paths.items():
            x = x.replace(path, name)
    return x


class World:
    """Recorders for one run of either runner: every call appended to
    `calls` (configs and arguments as plain data, paths by name), every
    return fixed by the call's position, so that two runners that make the
    same calls write the same record."""

    def __init__(self, root, pretrain):
        self.calls = []
        self.paths = {"ROOT": root, "PRETRAIN": pretrain}
        self.n_psnr = 0
        rays = np.zeros((IMG * IMG, 6), np.float32)
        rgb = np.zeros((IMG * IMG, 3), np.float32)
        box = np.zeros((4, 3), np.float32)
        world = self

        def record(*call):
            world.calls.append(_plain(call, world.paths))

        def models(cfg):
            path = osp.join(cfg.expdir, cfg.expname, "models")
            os.makedirs(path, exist_ok=True)
            return path

        def latest(path):
            return max(int(f) for f in os.listdir(path))

        def save(path, step):
            open(osp.join(path, str(step)), "w").close()

        class Frames:
            """A dataset of `n` samples; sample t's particles hold t."""

            def __init__(self, n):
                self.n = n

            def __len__(self):
                return self.n

            def __getitem__(self, t):
                pos = np.full((2, 3), t, np.float32)
                return dict(particles_pos=pos, particles_vel=pos,
                            box=box, box_normals=box, particles_pos_1=pos,
                            cw_1=np.zeros((1, 3, 4), np.float32),
                            rays_1=[rays], rgb_1=[rgb])

        class Warmup:
            def __init__(self, cfg, **kw):
                record("WarmupTrainer", cfg)
                self.modelpath = models(cfg)
                self.start = latest(cfg.resume_from) + 1 if cfg.resume_from \
                    else 0

            def train(self, n_iters):
                record("warmup.train", n_iters)
                return 0.5 if self.start < n_iters else None

            def save_checkpoint(self, step):
                record("warmup.save_checkpoint", step)
                save(self.modelpath, step)

            def eval(self, step):
                record("warmup.eval", step)
                return {"view_5": {"psnr_0": 28.5, "psnr_1": 32.25}}

        class Transition:
            def __init__(self, cfg, **kw):
                record("TransitionTrainer", cfg)
                self.modelpath = models(cfg)
                self.dataset = Frames(WINDOWS)
                self.start_step = 0

            def resume(self, path):
                record("transition.resume", path)
                self.start_step = latest(path)

            def train(self, n_epochs):
                record("transition.train", n_epochs)
                self.start_step += n_epochs * len(self.dataset)
                save(self.modelpath, self.start_step)
                return 0.0625

        class E2E:
            def __init__(self, cfg, **kw):
                record("E2ETrainer", cfg)
                self.modelpath = models(cfg)
                self.test_dataset = Frames(N_TEST)
                self.transition = self.params_t = self.params_r = None
                self.start_step = 0

            def to_device(self, x):
                return x

            def train(self, n_epochs, eval_during_training):
                record("e2e.train", n_epochs, eval_during_training)
                return 0.125

            def save_checkpoint(self, step):
                record("e2e.save_checkpoint", step)
                save(self.modelpath, step)

            def resume(self, path):
                record("e2e.resume", path)
                self.start_step = latest(path) + 1

            def render_full(self, *args):
                # (params, particles, ro, rays) in JAX, the port's without
                # params: the particles are third from the end
                record("render_full", int(np.asarray(args[-3])[0, 0]) - 1000)
                return {"rgb1": torch.zeros(IMG * IMG, 3)}

        class Errors:
            def cal_errors(self, pred, gt, t):
                record("cal_errors", int(np.asarray(pred)[0, 0]) - 1000,
                       int(np.asarray(gt)[0, 0]), t)
                return 1.5 * t + 0.25 * (t % 7)

        def rollout(*args):
            # (net, params, pos, vel, box, nrm, n_steps, log) in JAX, the
            # port's without params
            n_steps = args[-2]
            record("rollout_with_retry", int(np.asarray(args[-6])[0, 0]),
                   n_steps)
            traj = 1000 + np.broadcast_to(
                np.arange(n_steps, dtype=np.float32)[:, None, None],
                (n_steps, 2, 3))
            return traj, False, dict(CAPS)

        def image_metric(kind):
            def fn(img, gt):
                record(kind, img.shape, gt.shape)
                world.n_psnr += 1
                return 20.0 + 0.5 * world.n_psnr
            return fn

        def writer(kind, last):
            def fn(root, **kw):
                record(kind, root, kw)
                os.makedirs(osp.join(root, last(kw)), exist_ok=True)
            return fn

        self.fakes = dict(
            WarmupTrainer=Warmup, TransitionTrainer=Transition,
            E2ETrainer=E2E, FluidErrors=Errors, rollout_with_retry=rollout,
            psnr=image_metric("psnr"), ssim=image_metric("ssim"),
            generate_blender_scene=writer("generate_blender_scene",
                                          lambda kw: "."),
            generate_pbf_raw_dataset=writer(
                "generate_pbf_raw_dataset",
                lambda kw: f"sim_{kw['n_sims'] - 1:04d}"))


def _run_jax(monkeypatch, jfpr, tmp_path, knobs, name="jax"):
    """JAX's main() under the recorders of a new World; its record read
    back from tmp_path/<name>/PROTOCOL_R5.json."""
    root, pretrain = str(tmp_path / name / "root"), str(tmp_path / "pre_j")
    world = World(root, pretrain)
    f = world.fakes
    for mod, names in ((jsynthetic, ("generate_blender_scene",
                                     "generate_pbf_raw_dataset")),
                       (jwarmup, ("WarmupTrainer",)),
                       (jtransition, ("TransitionTrainer",)),
                       (je2e, ("E2ETrainer",)),
                       (jmetrics, ("FluidErrors", "psnr", "ssim")),
                       (jfpr, ("rollout_with_retry",))):
        for n in names:
            monkeypatch.setattr(mod, n, f[n])
    monkeypatch.setattr(jfpr, "__file__",
                        str(tmp_path / name / "tools" / "fpr.py"))
    monkeypatch.setattr(jfpr, "ROOT", root)
    monkeypatch.setattr(jfpr, "SCENE", osp.join(root, "scene"))
    monkeypatch.setattr(jfpr, "PRETRAIN", pretrain)
    for k, v in knobs.items():
        const = JAX_NAMES[k]
        # the JAX module's own parse of the environment's string
        value = v == "1" if k == "ANCHOR" else type(getattr(jfpr, const))(v)
        monkeypatch.setattr(jfpr, const, value)
    jfpr.main()
    with open(tmp_path / name / "PROTOCOL_R5.json") as fh:
        return world, json.load(fh)


def _run_torch(monkeypatch, tmp_path, knobs, name="torch"):
    """The port's main() under the recorders of a new World; its record
    read back."""
    root, pretrain = str(tmp_path / name / "root"), str(tmp_path / "pre_t")
    world = World(root, pretrain)
    f = world.fakes
    for n in ("generate_blender_scene", "generate_pbf_raw_dataset",
              "WarmupTrainer", "TransitionTrainer", "E2ETrainer",
              "FluidErrors", "rollout_with_retry"):
        monkeypatch.setattr(fpr, n, f[n])
    monkeypatch.setattr(fpr, "psnr_np", f["psnr"])
    monkeypatch.setattr(fpr, "ssim_np", f["ssim"])
    monkeypatch.setenv("PROTO_ROOT", root)
    monkeypatch.setenv("PROTO_PRETRAIN", pretrain)
    for k, v in knobs.items():
        monkeypatch.setenv(f"PROTO_{k}", str(v))
    record = tmp_path / name / "PROTOCOL_TORCH.json"
    fpr.main(device="cpu", record=record)
    with open(record) as fh:
        return world, json.load(fh)


def _without_walls(record):
    return {k: ({kk: vv for kk, vv in v.items() if kk != "wall_s"}
                if isinstance(v, dict) else v)
            for k, v in record.items()
            if k not in ("config", "device", "total_wall_s")}


# ----------------------------------------------------------------- windows

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("as_list", [False, True])
def test_windows_match_jax(jfpr, seed, as_list):
    d = np.random.default_rng(seed).uniform(0.0, 120.0, 60)
    if as_list:
        d = [float(x) for x in d]
    assert fpr.reference_pred2gt_windows(d) == \
        jfpr.reference_pred2gt_windows(d)


def test_stage_dicts_match_jax(jfpr):
    assert fpr.renderer_cfg() == jfpr.renderer_cfg()
    assert fpr.scene_cfg(jfpr.SCENE) == jfpr.scene_cfg()


def test_knob_defaults_match_jax(jfpr, monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(f"PROTO_{k}", raising=False)
    got = fpr.knobs()
    assert {k: got[k] for k in ("n_sims", "warmup_iters", "trans_epochs",
                                "e2e_epochs", "e2e_renderer_lr",
                                "render_stride", "search", "conv_prec",
                                "anchor", "fused_slab")} == dict(
        n_sims=16, warmup_iters=2000, trans_epochs=6, e2e_epochs=2,
        e2e_renderer_lr=3e-4, render_stride=1, search="fused_cconv",
        conv_prec="default", anchor=True, fused_slab=320)
    for k, v in (("n_sims", "N_SIMS"), ("fused_slab", "FUSED_SLAB"),
                 ("search", "SEARCH_BACKEND"), ("conv_prec", "CONV_PREC")):
        assert got[k] == getattr(jfpr, v)


# ------------------------------------------------------------ orchestration

def test_orchestration_matches_jax(jfpr, monkeypatch, tmp_path):
    committed = osp.join(osp.dirname(TOOLS), "PROTOCOL_R5.json")
    with open(committed, "rb") as fh:
        before = fh.read()
    jw, jrec = _run_jax(monkeypatch, jfpr, tmp_path, KNOBS)
    tw, trec = _run_torch(monkeypatch, tmp_path, KNOBS)
    # the same calls in the same order: the three stage configs, the train
    # arguments, the checkpoint and eval steps, the rollouts' n_steps, the
    # frames rendered and every metric's inputs
    assert tw.calls == jw.calls
    kinds = [c[0] for c in tw.calls]
    assert [k for k in kinds if k in ("WarmupTrainer", "TransitionTrainer",
                                      "E2ETrainer")] == [
        "WarmupTrainer", "TransitionTrainer", "E2ETrainer"]
    assert [c for c in tw.calls if c[0] == "rollout_with_retry"] == [
        ["rollout_with_retry", 0, N_TEST]] * 2
    assert [c[1] for c in tw.calls if c[0] == "render_full"] == list(
        range(0, N_TEST, KNOBS["RENDER_STRIDE"]))
    with open(committed, "rb") as fh:
        assert fh.read() == before

    # the record: JAX's keys and the port's device; every value from the
    # recorders equal; the config as JAX's but the LPIPS note (the port's
    # module) and what the port adds
    assert set(trec) == set(jrec) | {"device"}
    assert _without_walls(trec) == _without_walls(jrec)
    extra = set(trec["config"]) - set(jrec["config"])
    assert extra == {"products", "n_frames", "n_side", "init",
                     "init_caveat"}
    assert {k: v for k, v in trec["config"].items()
            if k not in extra | {"lpips"}} == {
        k: v for k, v in jrec["config"].items() if k != "lpips"}
    assert "neurofluid_torch/utils/lpips.py" in trec["config"]["lpips"]
    assert trec["device"]["name"] == "cpu"
    assert set(trec["device"]["stages"]) == {
        "data", "warmup", "transition", "e2e_setup", "pretrained_rollout",
        "e2e", "rollout", "renders"}


def test_resume_matches_jax(jfpr, monkeypatch, tmp_path):
    """A second run on the same root: the warm-up resumed (its train
    returns None), the transition fully trained (no train call), the
    scene and the pretraining set not written again; with one more
    epoch asked, only that epoch trains. The same in both runners."""
    more = dict(KNOBS, TRANS_EPOCHS=KNOBS["TRANS_EPOCHS"] + 1)
    for knobs, trained in ((KNOBS, []), (more, [1])):
        runs = []
        for run in (_run_jax, _run_torch):
            args = (monkeypatch, jfpr) if run is _run_jax else (monkeypatch,)
            run(*args, tmp_path, KNOBS)
            world, rec = run(*args, tmp_path, knobs)
            runs.append((world.calls, _without_walls(rec)))
            assert [c[1] for c in world.calls
                    if c[0] == "transition.train"] == trained
            assert not any(c[0].startswith("generate") for c in world.calls)
            assert rec["warmup"]["final_loss"] is None
            assert (rec["transition"]["final_loss"] is None) == (not trained)
            wcfg = next(c[1] for c in world.calls if c[0] == "WarmupTrainer")
            assert wcfg["resume_from"] == "ROOT/exps/warmup/models"
        assert runs[0] == runs[1]


@pytest.mark.parametrize("run", ["jax", "torch"])
def test_legacy_transition_checkpoint_refused(jfpr, monkeypatch, tmp_path,
                                              run):
    """A transition checkpoint whose step is not a multiple of the
    dataset's length raises SystemExit before any training."""
    models = tmp_path / run / "root" / "exps" / "transition" / "models"
    models.mkdir(parents=True)
    (models / str(WINDOWS * 5 + 3)).touch()
    with pytest.raises(SystemExit, match="legacy transition checkpoint"):
        if run == "jax":
            _run_jax(monkeypatch, jfpr, tmp_path, KNOBS, name=run)
        else:
            _run_torch(monkeypatch, tmp_path, KNOBS, name=run)


# -------------------------------------------------------------------- retry

def _torch_rollouts(monkeypatch, n_overflows):
    """The port's rollout_with_retry over a rollout whose flag is on for
    its first `n_overflows` calls: (attempts' caps and weights, result)."""
    attempts = []

    def fake(net):
        def rollout(pos, vel, box, nrm, n_steps):
            attempts.append(({c: getattr(net, c) for c in CAPS},
                             {k: v.clone() for k, v in
                              net.state_dict().items()}, net.init_kwargs))
            over = torch.tensor(len(attempts) <= n_overflows)
            return (torch.zeros(n_steps, pos.shape[0], 3),
                    {"grid_overflow": over, "cap_exceeded": over})
        return rollout

    monkeypatch.setattr(trans_mod, "make_rollout_fn", fake)
    net = ParticleNet(search_backend="fused_cconv", device="cpu",
                      generator=torch.Generator().manual_seed(0), **CAPS)
    z = torch.zeros(5, 3)
    out = fpr.rollout_with_retry(net, z, z, z, z, 4, lambda m: None)
    return net, attempts, out


def _jax_rollouts(monkeypatch, jfpr, n_overflows):
    attempts = []

    def fake(net, with_diag=False):
        assert with_diag

        def rollout(params, pos, vel, box, nrm, n_steps):
            attempts.append({c: getattr(net, c) for c in CAPS})
            over = jnp.asarray(len(attempts) <= n_overflows)
            return jnp.zeros((n_steps, pos.shape[0], 3)), {
                "grid_overflow": over}
        return rollout

    monkeypatch.setattr(jtransition, "make_rollout_fn", fake)
    net = JParticleNet(search_backend="fused_cconv", **CAPS)
    z = jnp.zeros((5, 3))
    out = jfpr.rollout_with_retry(net, None, z, z, z, z, 4, lambda m: None)
    return attempts, out


@pytest.mark.parametrize("n_overflows", [0, 1, 3])
def test_retry_matches_jax(jfpr, monkeypatch, n_overflows):
    """Each overflowing attempt doubles the four caps; at most 3 attempts,
    the last one's caps and flag reported; the weights and every other
    constructor argument carried."""
    net, attempts, (traj, over, caps) = _torch_rollouts(monkeypatch,
                                                       n_overflows)
    j_attempts, (j_traj, j_over, j_caps) = _jax_rollouts(monkeypatch, jfpr,
                                                         n_overflows)
    assert [a[0] for a in attempts] == j_attempts
    assert len(attempts) == min(n_overflows + 1, 3)
    assert [a[0]["fused_slab_cap"] for a in attempts] == [
        320 * 2 ** i for i in range(len(attempts))]
    assert (over, caps) == (j_over, j_caps)
    assert over == (n_overflows >= 3)
    assert isinstance(traj, np.ndarray) and traj.shape == j_traj.shape
    want = net.state_dict()
    for _, state, kwargs in attempts:
        assert state.keys() == want.keys()
        assert all(torch.equal(state[k], want[k]) for k in want)
        assert {k: v for k, v in kwargs.items() if k not in CAPS} == {
            k: v for k, v in net.init_kwargs.items() if k not in CAPS}


def test_clone_rolls_out_the_same():
    """A clone with the caps doubled holds the same weights, so its
    rollout (uncapped on `fused_cconv`) is the original's, bitwise."""
    gen = np.random.default_rng(3)
    pos = torch.from_numpy(gen.uniform(-0.3, 0.3, (96, 3)).astype(np.float32))
    vel = torch.from_numpy(gen.normal(0, 0.1, (96, 3)).astype(np.float32))
    box = torch.from_numpy(gen.uniform(-1, 1, (40, 3)).astype(np.float32))
    nrm = torch.nn.functional.normalize(box, dim=-1)
    net = ParticleNet(search_backend="fused_cconv", device="cpu",
                      gravity=(0.0, 0.0, -9.81),
                      generator=torch.Generator().manual_seed(1), **CAPS)
    twin = net.clone(**{c: 2 * v for c, v in CAPS.items()})
    assert twin.fused_slab_cap == 640 and twin.gravity == net.gravity
    with torch.no_grad():
        a, _ = trans_mod.make_rollout_fn(net)(pos, vel, box, nrm, 3)
        b, _ = trans_mod.make_rollout_fn(twin)(pos, vel, box, nrm, 3)
    assert torch.equal(a, b)


# ------------------------------------------------------------ re-evaluation

def test_reval_replaces_only_pred2gt_mm(jfpr, jreval, monkeypatch, tmp_path):
    """The port's re-evaluation over the recorders against JAX's: the same
    e2e config (its expname and epochs apart from the stage's), checkpoint
    resumed, rollout and windows; in its record only `pred2gt_mm` changes,
    with the note."""
    old = {"config": {"img": IMG}, "warmup": {"psnr_fine": 30.0},
           "pred2gt_mm": {"trained_pred2gt": -1.0}, "device": {"name": "x"}}
    rows, calls = {}, {}
    for run in ("jax", "torch"):
        root = str(tmp_path / run / "root")
        world = World(root, str(tmp_path / "pre"))
        e2e_models = osp.join(root, "exps", "e2e", "models")
        os.makedirs(e2e_models)
        open(osp.join(e2e_models, "100"), "w").close()
        path = tmp_path / run / ("PROTOCOL_R5.json" if run == "jax"
                                 else "PROTOCOL_TORCH.json")
        path.write_text(json.dumps(old))
        f = world.fakes
        if run == "jax":
            monkeypatch.setattr(jfpr, "ROOT", root)
            monkeypatch.setattr(jfpr, "SCENE", osp.join(root, "scene"))
            monkeypatch.setattr(jfpr, "rollout_with_retry",
                                f["rollout_with_retry"])
            monkeypatch.setattr(jreval, "E2ETrainer", f["E2ETrainer"])
            monkeypatch.setattr(jreval, "FluidErrors", f["FluidErrors"])
            monkeypatch.setattr(jreval, "__file__",
                                str(tmp_path / run / "tools" / "r.py"))
            jreval.main()
        else:
            monkeypatch.setenv("PROTO_ROOT", root)
            for k, v in KNOBS.items():
                monkeypatch.delenv(f"PROTO_{k}", raising=False)
            for n in ("rollout_with_retry", "FluidErrors"):
                monkeypatch.setattr(fpr, n, f[n])
            monkeypatch.setattr(reval, "E2ETrainer", f["E2ETrainer"])
            reval.main(device="cpu", record=path)
        new = json.loads(path.read_text())
        assert {k: v for k, v in new.items() if k != "pred2gt_mm"} == {
            k: v for k, v in old.items() if k != "pred2gt_mm"}
        rows[run], calls[run] = new["pred2gt_mm"], world.calls
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][1] == ["e2e.resume", "ROOT/exps/e2e/models"]
    assert rows["torch"].pop("note") == \
        "re-evaluated from the saved e2e checkpoint"
    rows["jax"].pop("note")
    assert rows["torch"] == rows["jax"]
    assert rows["torch"]["caps_used"] == CAPS
