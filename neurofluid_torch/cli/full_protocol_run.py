"""The reference-protocol run on the port (counterpart of
tools/full_protocol_run.py), on the card.

    python -m neurofluid_torch.cli.full_protocol_run

The same experiment as the JAX package's runner, built from the port's
trainers: a synthetic 61-frame PBF scene (13,824 particles, 400 x 400
images; `data.synthetic.generate_blender_scene`), then
1. warm-up: the renderer alone on frame 0 over four views
   (`WarmupTrainer`), its fine PSNR on the test view;
2. transition: ParticleNet over `PROTO_N_SIMS` randomised PBF simulations
   in the raw layout (`data.synthetic.generate_pbf_raw_dataset`,
   `TransitionTrainer`), one checkpoint per epoch;
3. the pretrained rollout: 60 autoregressive steps from frame 0 with the
   transition weights alone, Pred2GT in the reference's windows
   (`reference_pred2gt_windows`);
4. e2e: both models jointly over the 50 training frames with the frame-0
   renderer anchor (`E2ETrainer`), then the same rollout again;
5. every test frame rendered from that rollout, PSNR and SSIM against the
   ground truth (LPIPS needs VGG weights, which the repo does not hold).

Budget knobs, read from the environment when `main` runs (the JAX
runner's names and defaults): PROTO_ROOT (scene, checkpoints and logs),
PROTO_PRETRAIN (the pretraining set; both packages write the same files
from the same seed), PROTO_N_SIMS 16, PROTO_WARMUP_ITERS 2000,
PROTO_TRANS_EPOCHS 6, PROTO_E2E_EPOCHS 2, PROTO_E2E_RLR 3e-4,
PROTO_RENDER_STRIDE 1, PROTO_SEARCH fused_cconv, PROTO_CONV_PREC default,
PROTO_ANCHOR 1, PROTO_FUSED_SLAB 320.

Stages resume: a second run on the same root reuses the scene and the
pretraining set, resumes the warm-up from its checkpoints and the
transition from its per-epoch checkpoints (training only the epochs
left), and reruns the e2e stage and the evaluations. The record goes to
PROTOCOL_TORCH.json at the repo root after every stage, with the keys of
the JAX runner's record and `device`: the card's name and power limit,
and per stage its wall time, kernel launches and peak device memory.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from neurofluid_torch.data.synthetic import (
    generate_blender_scene, generate_pbf_raw_dataset,
)
from neurofluid_torch.ops import ball_features, composite, fused_cconv
from neurofluid_torch.ops import fused_query, segment_ops
from neurofluid_torch.ops.cconv import conv_bf16
from neurofluid_torch.train import transition as trans_mod
from neurofluid_torch.train.e2e import E2ETrainer
from neurofluid_torch.train.transition import TransitionTrainer
from neurofluid_torch.train.warmup import WarmupTrainer
from neurofluid_torch.utils.config import ConfigNode
from neurofluid_torch.utils.metrics import FluidErrors
from neurofluid_torch.utils.metrics import psnr as psnr_np, ssim as ssim_np

RECORD = Path(__file__).resolve().parents[2] / "PROTOCOL_TORCH.json"
# the kernels' launch counters, read per stage; K1d and K2d are K1 and K2
# at conv_precision 'default' (their bf16 instantiations)
KERNELS = {"K1": fused_cconv.KERNEL, "K2": fused_cconv.BWD_KERNEL,
           "K1d": fused_cconv.BF16_KERNELS["K1"],
           "K2d": fused_cconv.BF16_KERNELS["K2"],
           "K3": ball_features.KERNEL, "K4": ball_features.BWD_KERNEL,
           "K5": composite.KERNEL, "K6": composite.BWD_KERNEL,
           "K7": fused_query.KERNEL, "K8": segment_ops.KERNEL}
# the trainers' initial weights (TRAIN.seed 10): JAX's own draw, computed
# by utils.jax_random
INIT = "JAX seed-10 draw (threefry2x32, flax keys), jax 0.9.0 semantics"
INIT_CAVEAT = ("PROTOCOL_R5.json does not name the JAX it ran on; a JAX "
               "before the partitionable threefry default (0.5.0) drew "
               "other initial weights there")
# the four static caps a retried rollout doubles
CAPS = ("fluid_neighbor_k", "obstacle_neighbor_k", "grid_max_per_cell",
        "fused_slab_cap")


def products_note(conv_prec: str) -> str:
    """What the run's arithmetic was, for its record."""
    dense = ("the dense layers and the renderer f32 (TF32 off for torch "
             "products)")
    if conv_bf16(conv_prec):
        return ("conv_precision 'default': every conv contraction on bf16-"
                "rounded operands with f32 sums, forward and backward (K1d/"
                "K2d, the bf16 instantiations of K1/K2, and one bf16 wgmma "
                "pass in their products; the list conv's bf16_product), as "
                "JAX's DEFAULT on the TPU; " + dense)
    return (f"conv_precision {conv_prec!r}: f32 class (f32 SIMT, 3xTF32 "
            f"tensor-core products in K1/K2, f32 list-conv products); "
            + dense)


def knobs() -> dict:
    """The PROTO_* budget knobs from the environment, with the JAX
    runner's defaults (the roots under the temporary directory)."""
    env = os.environ.get
    tmp = tempfile.gettempdir()
    root = env("PROTO_ROOT", osp.join(tmp, "protocol_torch"))
    return dict(
        root=root, scene=osp.join(root, "scene"),
        pretrain=env("PROTO_PRETRAIN", osp.join(tmp, "pbf_pretrain")),
        n_sims=int(env("PROTO_N_SIMS", 16)),
        warmup_iters=int(env("PROTO_WARMUP_ITERS", 2000)),
        trans_epochs=int(env("PROTO_TRANS_EPOCHS", 6)),
        e2e_epochs=int(env("PROTO_E2E_EPOCHS", 2)),
        e2e_renderer_lr=float(env("PROTO_E2E_RLR", 3e-4)),
        render_stride=int(env("PROTO_RENDER_STRIDE", 1)),
        search=env("PROTO_SEARCH", "fused_cconv"),
        conv_prec=env("PROTO_CONV_PREC", "default"),
        anchor=env("PROTO_ANCHOR", "1") == "1",
        fused_slab=int(env("PROTO_FUSED_SLAB", 320)),
    )


def scene_cfg(scene, n_frames=61):
    return dict(
        data_type="splishsplash", near=9.0, far=13.0,
        gravity=[0.0, 0.0, -9.81],
        train=dict(start_index=0, end_index=50, path=scene,
                   views=dict(warmup=["view_1", "view_2", "view_3", "view_4"],
                              dynamic=["view_1"])),
        test=dict(start_index=0, end_index=n_frames, path=scene,
                  views=["view_5"]),
    )


def renderer_cfg():
    return dict(
        ray=dict(ray_chunk=1024, N_importance=128, N_samples=64,
                 eval_ray_chunk=2048),
        NN_search=dict(fix_radius=True, particle_radius=0.025,
                       search_radius_scale=9.0, N_neighbor=20,
                       backend="grid", selection="approx", mode="dense"),
        encoding=dict(density=True, var=True, smoothed_pos=True,
                      smoothed_dir=True, exclude_ray=True,
                      same_smooth_factor=False),
        use_mask=True,
    )


def e2e_cfg(k, scene, img, n_frames, expname, pretrained_renderer,
            pretrained_transition_model, epochs):
    """The e2e stage's config (also the re-evaluation's)."""
    return ConfigNode(dict(
        expdir=osp.join(k["root"], "exps"), expname=expname, resume_from="",
        TRAIN=dict(seed=10, epochs=epochs, precrop_iters=0,
                   save_interval=10**7, log_interval=100,
                   # clip as the reference e2e does (its update step clips
                   # both parameter sets)
                   imgW=img, imgH=img, scale=1.0, grad_clip_value=1.0,
                   LR=dict(trans_lr=1e-5, renderer_lr=k["e2e_renderer_lr"],
                           use_scheduler=True),
                   loss_weight=dict(boundary_loss=1.0),
                   fluid_neighbor_k=128, obstacle_neighbor_k=64,
                   grid_max_per_cell=64, conv_precision=k["conv_prec"],
                   fused_slab_cap=k["fused_slab"],
                   anchor=dict(enabled=k["anchor"], weight=1.0, rays=1024,
                               n_views=2),
                   pretrained_renderer=pretrained_renderer,
                   pretrained_transition_model=pretrained_transition_model,
                   partial_load=False, search_backend=k["search"]),
        TEST=dict(imgW=img, imgH=img, scale=1.0, start_index=0,
                  end_index=n_frames),
        RENDERER=renderer_cfg(),
        **scene_cfg(scene, n_frames),
    ))


def rollout_with_retry(net, pos, vel, box, nrm, n_steps, log):
    """Autoregressive rollout; on a search overflow, again with the caps
    doubled.

    The caps (fluid_neighbor_k / obstacle_neighbor_k / grid_max_per_cell
    on the list backends, fused_slab_cap) can truncate neighbourhoods when
    a rollout compresses or diverges the fluid; the rollout's
    `grid_overflow` flag says so. A committed number must be computed on
    whole neighbourhoods, so an overflowing rollout is run again by a new
    ParticleNet with the four caps doubled and the same weights, up to
    three attempts in all. Returns (traj (n_steps, N, 3) on the host,
    overflow flag of the last attempt, the caps it used)."""
    for attempt in range(3):
        with torch.no_grad():
            traj, flags = trans_mod.make_rollout_fn(net)(pos, vel, box, nrm,
                                                         n_steps)
        traj = traj.cpu().numpy()
        over = bool(flags["grid_overflow"])
        caps = {c: getattr(net, c) for c in CAPS}
        if not over:
            return traj, False, caps
        log(f"rollout overflow at caps {caps} (attempt {attempt + 1}); "
            "retrying with doubled caps")
        net = net.clone(**{c: 2 * v for c, v in caps.items()})
    return traj, True, caps


def reference_pred2gt_windows(dists):
    """The reference's report windows (its eval_e2e.py:122-130)."""
    d = np.asarray(dists, np.float64)
    return {
        "trained_pred2gt": float(np.mean(d[0:49])),
        "trained_pred2gt_10": float(np.mean(d[:10])),
        "trained_pred2gt_end": float(d[48]),
        "rollout_pred2gt": float(np.mean(d[-10:])),
        "rollout_pred2gt_end": float(d[-1]),
        "windows": "reference eval_e2e.py:122-130 conventions",
    }


def eval_row(et, net, n_steps, log):
    """(the Pred2GT row of `net`'s rollout over et's test frames, the
    rollout on the host)."""
    d0 = et.test_dataset[0]
    traj, over, caps = rollout_with_retry(
        net, *(et.to_device(d0[k]) for k in (
            "particles_pos", "particles_vel", "box", "box_normals")),
        n_steps, log)
    fe = FluidErrors()
    dists = [fe.cal_errors(traj[t], et.test_dataset[t]["particles_pos_1"],
                           t + 1) for t in range(n_steps)]
    row = reference_pred2gt_windows(dists)
    row["rollout_overflow"] = over
    row["caps_used"] = caps
    return row, traj


def device_info(device) -> dict:
    """The card's name and power limit as nvidia-smi reads them (the CPU:
    its name only)."""
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


class Stages:
    """Per stage: wall seconds, kernel launches and peak device memory,
    into `record` under its name."""

    def __init__(self, device, record: dict):
        self.cuda = torch.device(device).type == "cuda"
        self.record = record

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.before = {k: kern.launches for k, kern in KERNELS.items()}
        self.t0 = time.time()

    def stop(self, name):
        self._sync()
        launched = {k: kern.launches - self.before[k]
                    for k, kern in KERNELS.items()}
        self.record[name] = {
            "wall_s": time.time() - self.t0,
            "launches": {k: n for k, n in launched.items() if n},
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if self.cuda else None),
        }
        self.start()


def main(n_frames=61, n_side=24, img=400, pretrain_frames=50,
         device="cuda", record=None):
    """The protocol run over the PROTO_* knobs; the scene's shape is the
    JAX runner's unless a caller cuts it. Writes the record to `record`
    (PROTOCOL_TORCH.json at the repo root by default)."""
    k = knobs()
    root, scene, pretrain = k["root"], k["scene"], k["pretrain"]
    t_start = time.time()
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(f"[{time.time()-t_start:.0f}s] {msg}", flush=True)

    out_json = str(record or RECORD)
    results = {"config": {
        "warmup_iters": k["warmup_iters"], "trans_epochs": k["trans_epochs"],
        "pretrain_sims": k["n_sims"], "pretrain_frames": pretrain_frames,
        "e2e_epochs": k["e2e_epochs"], "img": img, "sim": "pbf",
        "n_samples": 64, "n_importance": 128, "ray_chunk": 1024,
        "e2e_renderer_lr": k["e2e_renderer_lr"], "e2e_grad_clip": 1.0,
        "render_stride": k["render_stride"], "search_backend": k["search"],
        "conv_precision": k["conv_prec"], "anchor": k["anchor"],
        "fused_slab_cap": k["fused_slab"],
        "lpips": "blocked: no VGG16 weights in the repo and none obtainable "
                 "offline (neurofluid_torch/utils/lpips.py reads a "
                 "user-supplied .npz)",
        "products": products_note(k["conv_prec"]),
        "n_frames": n_frames, "n_side": n_side,
        "init": INIT,
        "init_caveat": INIT_CAVEAT,
    }}
    stages = {}
    results["device"] = dict(device_info(device), stages=stages)
    meter = Stages(device, stages)

    def flush_results():
        # the record after every stage: a crash in a later stage keeps the
        # earlier stages' numbers
        with open(out_json, "w") as f:
            json.dump(results, f, indent=2)

    meter.start()
    if not osp.isdir(scene):
        os.makedirs(root, exist_ok=True)
        generate_blender_scene(
            scene, n_frames=n_frames, n_side=n_side, img_wh=(img, img),
            train_views=("view_1", "view_2", "view_3", "view_4"),
            test_views=("view_5",), method="pbf",
        )
    log("render scene ready")
    if not osp.isdir(osp.join(pretrain, f"sim_{k['n_sims'] - 1:04d}")):
        generate_pbf_raw_dataset(
            pretrain, n_sims=k["n_sims"], n_frames=pretrain_frames,
            n_side=n_side, seed=42, log=log,
        )
    log("pretrain set ready")
    meter.stop("data")

    # ---------------------------------------------------------------- warmup
    wm_models = osp.join(root, "exps", "warmup", "models")
    wm_resume = wm_models if (
        osp.isdir(wm_models) and os.listdir(wm_models)
    ) else ""
    if wm_resume:
        log(f"resuming warmup from {wm_resume}")
    cfg = ConfigNode(dict(
        expdir=osp.join(root, "exps"), expname="warmup",
        resume_from=wm_resume,
        TRAIN=dict(seed=10, N_iters=k["warmup_iters"], precrop_iters=500,
                   save_interval=10**7, log_interval=100,
                   imgW=img, imgH=img, scale=1.0,
                   LR=dict(lr=5e-4, use_scheduler=True, decay_epochs=10000),
                   pretrained_renderer="", partial_load=False),
        TEST=dict(imgW=img, imgH=img, scale=1.0, start_index=0,
                  end_index=n_frames),
        RENDERER=renderer_cfg(),
        **scene_cfg(scene, n_frames),
    ))
    wt = WarmupTrainer(cfg, device=device)
    loss = wt.train(n_iters=k["warmup_iters"])  # None when fully resumed
    wt.save_checkpoint(k["warmup_iters"])
    res = wt.eval(k["warmup_iters"])
    results["warmup"] = {
        "final_loss": None if loss is None else float(loss),
        "psnr_coarse": float(res["view_5"]["psnr_0"]),
        "psnr_fine": float(res["view_5"]["psnr_1"]),
        "wall_s": time.time() - t_start,
    }
    meter.stop("warmup")
    log(f"warmup: {results['warmup']}")
    flush_results()

    # ------------------------------------------------------------ transition
    # multi-scene pretraining over the randomised PBF set (raw layout); the
    # reference's counterpart trains ~50k iterations over 270 DFSPH sims
    cfg = ConfigNode(dict(
        expdir=osp.join(root, "exps"), expname="transition", resume_from="",
        TRAIN=dict(seed=10, N_iters=1, save_interval=10**7, log_interval=50,
                   lr=1e-4, grad_clip_value=1.0, start_index=0,
                   end_index=pretrain_frames,
                   particle_radius=0.025, gravity=[0.0, 0.0, -9.81],
                   # generous caps: early-training rollouts compress the
                   # fluid well past rest density (the reference's search
                   # is uncapped)
                   fluid_neighbor_k=128, obstacle_neighbor_k=64,
                   grid_max_per_cell=64,
                   # a grid cover safe under rotation: the z-rotation
                   # augmentation swings the container's corners to
                   # |xy| ~ 1.38, past the default +-1.05
                   grid_lower=[-1.45, -1.45, -1.05],
                   grid_upper=[1.45, 1.45, 2.55],
                   pretrained="", search_backend=k["search"],
                   conv_precision=k["conv_prec"],
                   fused_slab_cap=k["fused_slab"],
                   datapath=dict(train=pretrain, train_datatype="raw",
                                 eval=scene, eval_datatype="blender_all")),
    ))
    tt = TransitionTrainer(cfg, device=device)
    tr_models = osp.join(root, "exps", "transition", "models")
    done_epochs = 0
    if osp.isdir(tr_models) and os.listdir(tr_models):
        tt.resume(tr_models)
        # per-epoch checkpoints carry step = epochs done * len(dataset); a
        # step that is not a multiple of it comes from another convention,
        # and an epoch count derived from it would retrain or skip epochs
        if tt.start_step % max(len(tt.dataset), 1):
            raise SystemExit(
                f"legacy transition checkpoint in {tr_models}: step "
                f"{tt.start_step} is not a multiple of the dataset length "
                f"{len(tt.dataset)} — use a fresh PROTO_ROOT (or delete the "
                f"stage dir) instead of resuming it"
            )
        done_epochs = tt.start_step // max(len(tt.dataset), 1)
        log(f"resumed transition from {tr_models} "
            f"(step {tt.start_step} = {done_epochs} epochs)")
    if done_epochs < k["trans_epochs"]:
        tloss = tt.train(n_epochs=k["trans_epochs"] - done_epochs)
    else:
        tloss = None  # fully trained, no training this run
    results["transition"] = {
        "final_loss": None if tloss is None else float(tloss),
        "train_windows": len(tt.dataset),
        "wall_s": time.time() - t_start,
    }
    meter.stop("transition")
    log(f"transition: {results['transition']}")
    flush_results()

    # ------------------------------------------------------------------- e2e
    et = E2ETrainer(e2e_cfg(k, scene, img, n_frames, "e2e", wt.modelpath,
                            tt.modelpath, k["e2e_epochs"]), device=device)
    n_steps = len(et.test_dataset)
    meter.stop("e2e_setup")

    def eval_rollout(tag):
        row, traj = eval_row(et, et.transition, n_steps, log)
        results[tag] = row
        log(f"{tag}: {row}")
        flush_results()
        return traj

    # ablation row 1: the pretrained transition model, before any e2e
    # update (the same evaluation as the post-e2e row)
    eval_rollout("pred2gt_mm_pretrained")
    meter.stop("pretrained_rollout")

    eloss = et.train(n_epochs=k["e2e_epochs"], eval_during_training=False)
    et.save_checkpoint(k["e2e_epochs"] * 50)
    results["e2e"] = {"final_loss": float(eloss),
                      "wall_s": time.time() - t_start}
    meter.stop("e2e")
    log(f"e2e: {results['e2e']}")
    flush_results()

    # ablation row 2, and the rollout the images are rendered from
    traj = eval_rollout("pred2gt_mm")
    meter.stop("rollout")

    # ------------------------------------------------- full-coverage renders
    # the reference renders every test frame; a stride above 1 is a
    # labelled subsample
    frames = list(range(0, n_steps, k["render_stride"]))
    metrics = {"trained": [], "rollout": []}
    for t in frames:
        data = et.test_dataset[t]
        out = et.render_full(et.to_device(traj[t]),
                             et.to_device(data["cw_1"][0][:, 3]),
                             data["rays_1"][0])
        gt = data["rgb_1"][0].reshape(img, img, 3)
        rgb = out["rgb1"].cpu().numpy().reshape(img, img, 3)
        rec = {
            "frame": t,
            "psnr": float(psnr_np(rgb, gt)),
            "ssim": float(ssim_np(rgb, gt)),
        }
        metrics["trained" if t < 50 else "rollout"].append(rec)
        log(f"frame {t}: {rec}")
        if t % 10 == 0:
            results["image_metrics"] = metrics
            flush_results()
    meter.stop("renders")
    results["image_metrics"] = metrics
    results["image_metrics_summary"] = {
        "frames_rendered": len(frames),
        "trained_frames": len(metrics["trained"]),
        "rollout_frames": len(metrics["rollout"]),
        "trained_psnr_mean": float(np.mean([m["psnr"] for m in metrics["trained"]])),
        "trained_ssim_mean": float(np.mean([m["ssim"] for m in metrics["trained"]])),
        "rollout_psnr_mean": float(np.mean([m["psnr"] for m in metrics["rollout"]])),
        "rollout_ssim_mean": float(np.mean([m["ssim"] for m in metrics["rollout"]])),
    }
    results["total_wall_s"] = time.time() - t_start
    flush_results()
    print(json.dumps(results["image_metrics_summary"]), flush=True)
    print("PROTOCOL RUN COMPLETE", flush=True)
    return results


if __name__ == "__main__":
    main()
