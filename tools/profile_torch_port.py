"""Kernel-design probes of the PyTorch port on one GPU, and a trace of its
stage trainers' loops. A step's or a frame's time and its device-time
breakdown come from the benchmark: `python3 -m nfbench.run --workload
<cell> --seed <n> --seconds 20 --trace 1`.

Usage: python tools/profile_torch_port.py --walk-phases [--precision default]
                                          [--root DIR]
       python tools/profile_torch_port.py --conv-steps [--root DIR]
       python tools/profile_torch_port.py --ball-walk-sweep
       python tools/profile_torch_port.py --trainers [--rows 20]

The probes build the bench-point scene and seeded models as chip_smoke.py
does and time kernels at the calls they record there by CUDA events
(`event_ms`, median of 10). Each needs a CUDA device; the kernels build at
first use.

With --trainers it traces the port's stage trainers at the shipped
configs' widths on chip_smoke.py's trainers scene (13,824 particles,
400 x 400 views; `chip_smoke.write_trainer_scene`, `trainer_config`, logging
every step, no eval, no checkpoint but the transition trainer's one per
epoch) with torch.profiler (CPU + CUDA activities): TRAIN_TRACES single
iterations of the warm-up trainer's loop (4 views; the one with the median
wall time is reported), one full-frame eval render, then one epoch each of
the transition trainer (20 iterations) and of the e2e trainer (5 frames),
each after a warm-up epoch. For each pass it prints the wall time, the
summed device time of its kernels, the device idle share (1 - device time
/ wall time, the trainers' host work included) and the `--rows` kernels
with the most device time, each by its own name.

With --walk-phases it times K1 (CUDA events, median of 10) at the five
calls of one ParticleNet step with parts of the forward walk taken out,
in patched temporary copies of csrc/fused_cconv.cu: what a part costs is the
time that goes with it. The patched kernels compute wrong results; only
their time is read, and the package's own build is not touched. With
--precision default it times K1d, the same calls at conv_precision
'default', with the parts of its own walk taken out (`walk_patches`: the
bf16 walk where the source has one, else the shared walk's bf16
instantiation). --root imports the package and chip_smoke.py from another
checkout (for example a `git archive` of the parent under the git-ignored
build/), so that two trees are timed by one script in one call.

With --conv-steps it times K1 and K1d (conv_precision 'highest'
and 'default') at the calls of one ParticleNet step, and K2 and K2d at the
calls of one transition train step on `fused_cconv` (CUDA events, median of
10), per call and per step; --root as above.

With --ball-walk-sweep it times K3 at the two calls of one render,
K7 at the two calls of one ParticleNet step on `search_backend='fused'` and
K4 at the two calls of one e2e train step's backward (CUDA events, median
of 10): as built; on the leading live groups alone (a probe of what the
dead groups' blocks cost); with a register budget (__launch_bounds__) or
the walk's step unrolled, in patched temporary copies of the source as
--walk-phases builds them; for each block size; with one stage forced (the
27 rows at their full width); and with the two-stage ring forced at
several stage sizes (the launch plan is chosen in Python,
`ball_features.walk_plan`, `bwd_walk_plan` and the THREADS constants: no
rebuild).
"""

import argparse
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# warm-up trainer iterations traced, each on its own; the median-wall one
# is reported
TRAIN_TRACES = 3


def event_ms(torch, fn, reps=10):
    """Median CUDA-event time of fn() after one warm-up call. A spin kernel
    runs ahead of each timed call so the launch is queued before the start
    event fires and host overhead stays out of the interval."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def traced(torch, fn):
    """(wall ms, profiler) of fn() under torch.profiler, synchronised."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, prof


def report(name, wall_ms, prof, rows):
    # a user annotation on the device timeline (Adam's optimizer-step range)
    # spans kernels that are counted on their own
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"{name}: wall {wall_ms:.2f} ms, device {device_ms:.2f} ms, idle "
          f"share {1 - device_ms / wall_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:rows]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:110]}")


# parts of the forward walk and the source edit that takes each out
WALK_PATCHES = {
    "the ball -> cube map of phase 1 (its square roots, divisions and "
    "arctangent)": [
        ("    ball_to_cube(ox, oy, oz, d2n, ux, uy, uz);",
         "    ux = ox, uy = oy, uz = oz;")],
    "phase 2 (the tap accumulation)": [
        ("for (unsigned m = qmask[q]; m != 0; m &= m - 1) {",
         "for (unsigned m = 0; m != 0; m &= m - 1) {")],
    "phases 1 and 2 (no pair is in radius: the tile loads, the barriers, "
    "the rows or the fold, and the products remain)": [
        ("  if (!live) return false;\n  float ox, oy, oz, d2n;",
         "  if (true) return false;\n  float ox, oy, oz, d2n;")],
}


class patched_source:
    """Within the block, `source` of csrc/ builds from a temporary copy of
    csrc/ with `edits` (old, new) applied; its cached library and its
    kernels' handles are dropped on the way in and out."""

    def __init__(self, source, edits, kernels):
        self.source, self.edits, self.kernels = source, edits, kernels

    def _reset(self):
        from neurofluid_torch import cuda as nf_cuda
        nf_cuda._libs.pop(self.source, None)
        for k in self.kernels:
            k._fn = None

    def __enter__(self):
        from neurofluid_torch import cuda as nf_cuda
        self.real = nf_cuda.CSRC
        self.tmp = tempfile.mkdtemp(prefix="nf_probe_")
        for f in self.real.iterdir():
            shutil.copy(f, self.tmp)
        path = os.path.join(self.tmp, self.source)
        text = open(path).read()
        for old, new in self.edits:
            if old not in text:
                raise RuntimeError(f"{self.source} no longer holds {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        nf_cuda.CSRC = type(self.real)(self.tmp)
        self._reset()

    def __exit__(self, *exc):
        from neurofluid_torch import cuda as nf_cuda
        nf_cuda.CSRC = self.real
        self._reset()
        shutil.rmtree(self.tmp)


# the same parts of the bf16 walk (`walk_fwd_bf16_kernel`; phase 1 is
# `pair_geometry_bf16`, which K2d's walk shares)
WALK_PATCHES_BF16 = {
    "the ball -> cube map of phase 1 (its square roots, divisions and "
    "arctangent)": [
        ("      ball_to_cube(ox, oy, oz, d2n, ux, uy, uz);",
         "      ux = ox, uy = oy, uz = oz;")],
    "phase 2 (the tap-feature contraction on the tensor cores)": [
        ("        for (int k0 = 0; k0 < n; k0 += 16) {",
         "        for (int k0 = 0; k0 < 0; k0 += 16) {")],
    "the in-walk fold's product (conv0, conv3: its staging and sums "
    "remain)": [
        ("          for (int k0 = 16 * warp; k0 < kpad; k0 += 16 * kBf16Warps) {",
         "          for (int k0 = 16 * warp; k0 < 0; k0 += 16 * kBf16Warps) {")],
    "phases 1 and 2 (no pair is in radius: the tile loads, the barriers, "
    "the rows or the fold, and the products remain)": [
        ("  if (live) {\n    float ox, oy, oz, d2n;",
         "  if (false) {\n    float ox, oy, oz, d2n;")],
}


def conv_steps(torch, k1_calls, k2_calls):
    from neurofluid_torch.ops import fused_cconv as fc

    for name, fn, calls, n_args, per in (
            ("K1", fc.fused_cconv_cuda, k1_calls, 8, "ParticleNet step"),
            ("K2", fc.fused_cconv_bwd_cuda, k2_calls, 10,
             "transition train step")):
        for prec, kid in (("highest", name), ("default", name + "d")):
            ms = []
            for i, a in enumerate(calls):
                args = a[:n_args] + (prec,)
                with torch.no_grad():
                    ms.append(event_ms(torch, lambda: fn(*args)))
                cin, cout = a[0].shape[-2:]
                needs = ("" if name == "K1" else " needs (dW, dq, dc, dfeats) "
                         + "".join(str(int(x)) for x in a[9]))
                print(f"{kid} call {i}: Cin {cin} Cout {cout}{needs} ms "
                      f"{ms[-1]:.4f}", flush=True)
            print(f"{kid} per {per}: {sum(ms):.4f} ms ({len(ms)} calls)",
                  flush=True)


def walk_patches(precision):
    """(source, patch set) of the walk that K1 runs at `precision`: K1d's
    own in a tree that has it, else the shared walk's bf16 instantiation."""
    from neurofluid_torch import cuda as nf_cuda
    if precision == "default" and (nf_cuda.CSRC
                                   / "fused_cconv_bf16.cu").exists():
        return "fused_cconv_bf16.cu", WALK_PATCHES_BF16
    return "fused_cconv.cu", WALK_PATCHES


def walk_phases(torch, calls, precision="highest"):
    from neurofluid_torch.ops import fused_cconv as fc

    name_k = "K1d" if precision == "default" else "K1"
    calls = [a[:8] + (precision,) for a in calls]
    kernels = [fc.KERNEL, *getattr(fc, "BF16_KERNELS", {}).values()]

    def times():
        out = []
        with torch.no_grad():
            for a in calls:
                out.append(event_ms(torch, lambda: fc.fused_cconv_cuda(*a)))
        return out

    def show(name, ms, base=None):
        gone = "" if base is None else (
            "; goes with it: " + ", ".join(
                f"{b - m:.4f}" for b, m in zip(base, ms))
            + f" (sum {sum(base) - sum(ms):.4f})")
        print(f"{name_k} without {name}: " if base else f"{name_k} {name}: ",
              end="")
        print(", ".join(f"{m:.4f}" for m in ms) + f" ms (sum {sum(ms):.4f})"
              + gone, flush=True)

    shapes = ", ".join(f"Cin {a[0].shape[-2]} Cout {a[0].shape[-1]}"
                       for a in calls)
    print(f"{name_k} at the calls of one ParticleNet step: {shapes}")
    base = times()
    show("as built", base)
    source, patches = walk_patches(precision)
    for name, edits in patches.items():
        with patched_source(source, edits, kernels):
            show(name, times(), base)


# block sizes of the staged walk (a plan may ask for at most 256 threads),
# two-stage ring stages (bytes of staged arrays) forced in place of the
# one-stage plan, and register budgets (__launch_bounds__ added: blocks of
# 256 threads per SM)
SWEEP_THREADS = (64, 128, 256)
SWEEP_RING_BYTES = (4 * 1024, 8 * 1024, 16 * 1024, 32 * 1024)
SWEEP_MIN_BLOCKS = (3, 4, 6, 8)
# the walk's 32-candidate step of K3 and K7, and of K4 (which stops at k)
WALK_STEP = "      for (int base = 0; base < n; base += 32) {"
K4_WALK_STEP = "      for (int base = 0; base < n && off < k; base += 32) {"


def source_variants(head, step):
    """(what, edits) of the patched builds the sweep times: `head` opens
    the kernel, `step` is its walk's step."""
    out = {f"__launch_bounds__(256, {b})":
           [(head, head.replace("void ", f"void __launch_bounds__(256, {b}) "))]
           for b in SWEEP_MIN_BLOCKS}
    out["the walk's step unrolled x2"] = [(step, "#pragma unroll 2\n" + step)]
    return out


def live_groups_only(args, gi, n_slot_args=1):
    """The same call on its leading live groups alone (`group_queries` puts
    every group of the sentinel cell after them), `gi` the place of gcell
    in the arguments, the first `n_slot_args` of them per packed slot: a
    timing probe of what the dead groups' blocks cost. The dead groups'
    outputs are then not written."""
    gcell, dims, t = args[gi], args[gi + 1], args[gi + 4]
    live = gcell.long() < dims[0] * dims[1] * dims[2]
    n = int(live.sum())
    if not bool(live[:n].all()):
        raise RuntimeError("the live groups do not lead the packed layout")
    return (*(a[: n * t] for a in args[:n_slot_args]),
            *args[n_slot_args:gi], gcell[:n], *args[gi + 1:])


def ball_walk_sweep(torch, k3_calls, k7_calls, k4_calls):
    from neurofluid_torch.ops import ball_features as bf
    from neurofluid_torch.ops import fused_query as fq

    def show(name, fn, calls, what):
        with torch.no_grad():
            ms = [event_ms(torch, lambda: fn(*a)) for a in calls]
        print(f"{name} {what}: " + ", ".join(f"{m:.4f}" for m in ms)
              + f" ms (sum {sum(ms):.4f})", flush=True)

    saved = {(m, a): getattr(m, a) for m, a in (
        (bf, "THREADS"), (fq, "THREADS"), (bf, "BWD_THREADS"),
        (bf, "WHOLE_STAGE_BYTES"), (bf, "RING_STAGE_BYTES"),
        (bf, "BWD_RING_STAGE_BYTES"))}
    # name, wrapper, calls, source, kernel head, walk step, handles to
    # drop on a rebuild, place of gcell, per-slot arguments, and the module
    # attributes of its block size and its ring's stage bytes
    sweeps = (
        ("K3", bf.ball_sums_cuda, k3_calls, "ball_features.cu",
         "__global__ void ball_sums_kernel(", WALK_STEP,
         [bf.KERNEL, bf.BWD_KERNEL], 4, 1, (bf, "THREADS"),
         "RING_STAGE_BYTES"),
        ("K7", fq.ball_query_compact_cuda, k7_calls, "fused_query.cu",
         "__global__ void ball_query_compact_kernel(", WALK_STEP, [fq.KERNEL],
         5, 1, (fq, "THREADS"), "RING_STAGE_BYTES"),
        ("K4", bf.ball_sums_bwd_cuda, k4_calls, "ball_features.cu",
         "__global__ void ball_sums_bwd_kernel(", K4_WALK_STEP,
         [bf.KERNEL, bf.BWD_KERNEL], 6, 2, (bf, "BWD_THREADS"),
         "BWD_RING_STAGE_BYTES"))
    try:
        for (name, fn, calls, source, head, step, kernels, gi, n_slot,
             (mod, threads_attr), ring_attr) in sweeps:
            built = getattr(mod, threads_attr)
            show(name, fn, calls, f"{built} threads, as built")
            show(name, fn, [live_groups_only(a, gi, n_slot) for a in calls],
                 f"{built} threads, the live groups alone (probe)")
            for what, edits in source_variants(head, step).items():
                with patched_source(source, edits, kernels):
                    show(name, fn, calls, f"{built} threads, {what}")
            for threads in SWEEP_THREADS:
                setattr(mod, threads_attr, threads)
                show(name, fn, calls, f"{threads} threads, plan as built")
            setattr(mod, threads_attr, built)
            bf.WHOLE_STAGE_BYTES = bf.SMEM_LIMIT
            show(name, fn, calls, f"{built} threads, one stage forced")
            for ring in SWEEP_RING_BYTES:
                bf.WHOLE_STAGE_BYTES = 0
                setattr(bf, ring_attr, ring)
                show(name, fn, calls, f"{built} threads, two stages of "
                     f"{ring} B")
            for (m, a), v in saved.items():
                setattr(m, a, v)
    finally:
        for (m, a), v in saved.items():
            setattr(m, a, v)


def record(torch, mod, attr, fn, grad=False):
    """The argument tuples of every call of mod.attr while fn() runs (with
    autograd off unless `grad`)."""
    calls, wrapper = [], getattr(mod, attr)
    setattr(mod, attr, lambda *a: calls.append(a) or wrapper(*a))
    try:
        with torch.set_grad_enabled(grad):
            fn()
    finally:
        setattr(mod, attr, wrapper)
    return calls


def trainers_profile(torch, chip_smoke, rows):
    """The --trainers passes (see the module docstring)."""
    from neurofluid_torch.train.e2e import E2ETrainer
    from neurofluid_torch.train.transition import TransitionTrainer
    from neurofluid_torch.train.warmup import WarmupTrainer

    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="profile_trainers_", dir=build)
    try:
        root, ds_yaml = chip_smoke.write_trainer_scene(tmp)
        quiet = dict(save_interval=10 ** 9, log_interval=1)

        def config(stage, over):
            return chip_smoke.trainer_config(tmp, ds_yaml, stage, stage, over)

        w_tr = WarmupTrainer(config("warmup", {"TRAIN": quiet}))
        w_tr.train(n_iters=1)  # warm-up

        def warmup_iteration(i):
            w_tr.start_step = i
            w_tr.train(n_iters=i + 1)

        runs = [traced(torch, lambda: warmup_iteration(i))
                for i in range(1, 1 + TRAIN_TRACES)]
        walls = sorted(w for w, _ in runs)
        print("warm-up trainer iteration traced walls (ms): "
              + ", ".join(f"{w:.2f}" for w in walls))
        wall, prof = next(r for r in runs if r[0] == walls[len(walls) // 2])
        report(f"warm-up trainer iteration ({len(w_tr.train_views)} views x "
               f"{w_tr.cfg.RENDERER.ray.ray_chunk} rays), the median traced "
               "one", wall, prof, rows)
        data = w_tr.test_dataset[0]
        args = (w_tr.to_device(data["particles_pos"]),
                w_tr.to_device(data["cw"][0][:, 3]), data["rays"][0])
        wall, prof = traced(torch, lambda: w_tr.render_full(*args))
        report(f"full-frame eval render ({len(data['rays'][0])} rays in "
               f"chunks of {w_tr.eval_chunk_size()})", wall, prof, rows)
        del w_tr

        t_tr = TransitionTrainer(config("transmodel", {"TRAIN": dict(
            quiet, datapath=dict(train=root, eval=root))}))
        t_tr.train(n_epochs=1)  # warm-up
        wall, prof = traced(torch, lambda: t_tr.train(n_epochs=1))
        report(f"transition trainer epoch ({len(t_tr.dataset)} iterations, "
               f"search {t_tr.net.search_backend})", wall, prof, rows)
        del t_tr

        e_tr = E2ETrainer(config("end2end", {"TRAIN": quiet}))
        e_tr.train(n_epochs=1, eval_during_training=False)  # warm-up
        wall, prof = traced(torch, lambda: e_tr.train(
            n_epochs=1, eval_during_training=False))
        report(f"e2e trainer epoch ({len(e_tr.dataset)} iterations, search "
               f"{e_tr.transition.search_backend})", wall, prof, rows)
    finally:
        shutil.rmtree(tmp)


def main():
    import torch

    parser = argparse.ArgumentParser()
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--walk-phases", action="store_true",
                      help="time K1 with parts of its walk taken out")
    mode.add_argument("--ball-walk-sweep", action="store_true",
                      help="time K3, K7 and K4 across staged-walk plans")
    mode.add_argument("--trainers", action="store_true",
                      help="trace the stage trainers' loops")
    mode.add_argument("--conv-steps", action="store_true",
                      help="time K1/K1d and K2/K2d at a step's calls")
    parser.add_argument("--rows", type=int, default=20,
                        help="--trainers: the kernels listed per pass")
    parser.add_argument("--precision", default="highest",
                        choices=("highest", "default"),
                        help="--walk-phases: the conv precision timed")
    parser.add_argument("--root", default=None,
                        help="import the package and chip_smoke.py from "
                             "this checkout")
    args = parser.parse_args()
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    if args.trainers:
        trainers_profile(torch, chip_smoke, args.rows)
        print(f"card: {torch.cuda.get_device_name(0)}")
        return 0
    from neurofluid_torch import scene
    from neurofluid_torch.models import ParticleNet, RenderNet
    from neurofluid_torch.train import losses
    from neurofluid_torch.train.e2e import make_e2e_train_step
    from neurofluid_torch.train.transition import (
        make_rollout_fn, make_transition_train_step,
    )

    dev = torch.device("cuda")
    pos, vel, box, nrm, ro_v, rays_v, rgbs_v = (
        torch.from_numpy(a).to(dev) for a in scene.build_problem())
    ro, rays = ro_v[0], rays_v[0]
    gen = torch.Generator().manual_seed(0)
    net = ParticleNet(**scene.particle_net_kwargs(), device=dev, generator=gen)
    ren = RenderNet(device=dev, generator=gen)
    with torch.no_grad():
        for nerf in (ren.nerf_coarse, ren.nerf_fine):
            nerf.sigma.bias.fill_(chip_smoke.SIGMA_BIAS)
    rollout = make_rollout_fn(net)

    if args.conv_steps:
        from neurofluid_torch.ops import fused_cconv as fc
        print(f"root: {os.path.dirname(os.path.dirname(fc.__file__))}")
        k1_calls = record(torch, fc, "fused_cconv_cuda",
                          lambda: rollout(pos, vel, box, nrm, 1))
        t_step = make_transition_train_step(
            net, torch.optim.Adam(net.parameters(),
                                  lr=chip_smoke.LR_TRANSITION_ONLY),
            losses.default_box_bounds(device=dev), chip_smoke.TRANSITION_CLIP)
        plan = net.make_box_plan(box)
        k2_calls = record(torch, fc, "fused_cconv_bwd_cuda",
                          lambda: t_step(pos, vel, pos + 0.001, pos + 0.002,
                                         box, nrm, box_plan=plan), grad=True)
        conv_steps(torch, k1_calls, k2_calls)
        print(f"card: {torch.cuda.get_device_name(0)}")
        return 0
    if args.walk_phases:
        from neurofluid_torch.ops import fused_cconv as fc
        calls = record(torch, fc, "fused_cconv_cuda",
                       lambda: rollout(pos, vel, box, nrm, 1))
        print(f"root: {os.path.dirname(os.path.dirname(fc.__file__))}")
        walk_phases(torch, calls, args.precision)
        print(f"card: {torch.cuda.get_device_name(0)}")
        return 0
    from neurofluid_torch.ops import ball_features as bf
    from neurofluid_torch.ops import fused_query as fq
    with torch.no_grad():
        traj, _ = rollout(pos, vel, box, nrm, 1)
    k3_calls = record(torch, bf, "ball_sums_cuda",
                      lambda: ren(traj[-1], ro, rays))
    l_net = ParticleNet(**scene.particle_net_kwargs(),
                        search_backend="fused", device=dev,
                        generator=torch.Generator().manual_seed(1))
    l_plan = l_net.make_box_plan(box)
    k7_calls = record(torch, fq, "ball_query_compact_cuda",
                      lambda: l_net(pos, vel, box, nrm, box_plan=l_plan))
    step = make_e2e_train_step(
        net, ren, torch.optim.Adam(ren.parameters(),
                                   lr=chip_smoke.LR_RENDERER),
        torch.optim.Adam(net.parameters(), lr=chip_smoke.LR_TRANSITION),
        losses.default_box_bounds(device=dev), chip_smoke.BD_WEIGHT)
    box_plan = net.make_box_plan(box)
    k4_calls = record(
        torch, bf, "ball_sums_bwd_cuda",
        lambda: step(pos, vel, box, nrm, ro_v, rays_v, rgbs_v,
                     box_plan=box_plan), grad=True)
    ball_walk_sweep(torch, k3_calls, k7_calls, k4_calls)
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0

if __name__ == "__main__":
    sys.exit(main())
