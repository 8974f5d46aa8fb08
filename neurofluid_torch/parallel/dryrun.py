"""Multi-rank dry run on the CPU (port of neurofluid_tpu/parallel/dryrun.py):
the sharded paths of `parallel.sharding` over a gloo world of n ranks on
tiny shapes, each against the port's replicated step.

    python -m neurofluid_torch.parallel.dryrun 4

Each `run_*` launches its own ranks (`launch`: `torch.multiprocessing`
spawn, a `file://` store in a temporary directory, one thread a rank),
runs a `*_stage` function on every rank, and returns rank 0's result
beside the replicated step's, which it computes in the calling process
from the same seeded weights. A stage function runs inside a world that
is already up, so the same stage runs on a world of one over NCCL on the
card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.parallel.collectives import all_gather_rows
from neurofluid_torch.parallel.mesh import init_world, make_mesh
from neurofluid_torch.parallel.sharding import (
    make_halo_particle_step, make_sharded_e2e_step,
    make_sharded_particle_step, make_spmd_e2e_step, particle_rows,
    shard_ray_batch, spmd_ray_sharding,
)
from neurofluid_torch.train import losses
from neurofluid_torch.train.e2e import make_e2e_train_step

# the tiny models of the JAX dry run; the renderer's grid hugs the tiny
# problem (the default container grid makes the plain ball sums cost ~2 s a
# render call on the CPU, whatever the ray count)
TINY_TRANSITION = dict(fluid_neighbor_k=16, obstacle_neighbor_k=8)
TINY_RENDERER = dict(near=1.0, far=3.0, n_samples=4, n_importance=4,
                     nerf_depth=2, nerf_width=32, num_neighbors=4,
                     grid_lower=(-0.6, -0.6, -0.6),
                     grid_upper=(0.6, 0.6, 0.6))
LR_RENDERER, LR_TRANSITION = 1e-3, 1e-4
# the lattice stage's net (JAX `run_halo_lattice_step`): grid bounds cover
# its 2.4-wide x-extent
LATTICE_NET = dict(search_backend="grid", halo_axis=0, fluid_neighbor_k=64,
                   obstacle_neighbor_k=16, grid_max_per_cell=32,
                   grid_lower=(-1.35, -0.8, -0.8), grid_upper=(1.35, 0.8, 0.8))


def _tiny_problem(n_ranks: int, seed: int = 0):
    """JAX's `_tiny_problem`: (pos, vel, box, nrm, ro (V, 3), rays
    (V, R, 6), rgbs (V, R, 3)) as float32 numpy, particles and rays
    divisible by the rank count."""
    rng = np.random.default_rng(seed)
    n_particles = 64 * max(1, n_ranks)
    n_rays = 16 * max(1, n_ranks)
    n_views = 2
    pos = rng.uniform(-0.3, 0.3, size=(n_particles, 3)).astype(np.float32)
    vel = rng.normal(size=(n_particles, 3)).astype(np.float32) * 0.05
    box = rng.uniform(-0.6, 0.6, size=(48, 3)).astype(np.float32)
    nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (48, 1))
    ro = np.tile(np.asarray([0, 0, 2.0], np.float32), (n_views, 1))
    d = rng.normal(size=(n_views, n_rays, 3)).astype(np.float32)
    d[..., 2] -= 2.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(ro[:, None, :], d.shape)
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rgbs = rng.uniform(size=(n_views, n_rays, 3)).astype(np.float32)
    return pos, vel, box, nrm, ro, rays, rgbs


def build_tiny_models(search_backend: str = "brute",
                      kernel_size: tuple = (4, 4, 4), shard_group=None,
                      device="cpu"):
    """(ParticleNet, RenderNet) of the dry run, seeded weights (the same
    on every rank and in the replicated step)."""
    transition = ParticleNet(search_backend=search_backend,
                             kernel_size=kernel_size, shard_group=shard_group,
                             device=device,
                             generator=torch.Generator().manual_seed(0),
                             **TINY_TRANSITION)
    renderer = RenderNet(search_backend=search_backend, device=device,
                         generator=torch.Generator().manual_seed(1),
                         **TINY_RENDERER)
    return transition, renderer


def _optimizers(transition, renderer):
    return (torch.optim.Adam(renderer.parameters(), lr=LR_RENDERER),
            torch.optim.Adam(transition.parameters(), lr=LR_TRANSITION))


def tensors_of(arrays, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def replicas_equal(mesh, models, optimizers) -> bool:
    """Every rank's parameters and optimizer states bitwise equal to rank
    0's (all-gathered over the mesh's world)."""
    flat = [p.detach().reshape(-1) for m in models for p in m.parameters()]
    dev = flat[0].device
    for opt in optimizers:
        for state in opt.state.values():  # Adam keeps `step` on the CPU
            flat += [v.detach().reshape(-1).float().to(dev) for _, v in
                     sorted(state.items()) if torch.is_tensor(v)]
    mine = torch.cat(flat).view(torch.int32)
    every = all_gather_rows(mine[None], mesh.world)
    return bool((every == every[:1]).all())


def flag_on_ranks(flag: torch.Tensor, group) -> list:
    """The () bool `flag` of every rank of the group, in group-rank order."""
    every = all_gather_rows(flag.detach().reshape(1).to(torch.int32), group)
    return [bool(v) for v in every.cpu()]


# ---- stages: run on every rank of an initialised world


def particle_stage(arrays, net_kw: dict, device="cpu") -> dict:
    """The particle-sharded transition step (halo exchange when net_kw
    has halo_size > 0) on a 1-D 'particles' mesh; the outputs gathered,
    the diag flags as rank 0 and as every rank sees them."""
    mesh = make_mesh(axis_names=("particles",), device=device)
    group = mesh.group("particles")
    net = ParticleNet(shard_group=group, device=mesh.device,
                      generator=torch.Generator().manual_seed(0), **net_kw)
    make = (make_halo_particle_step if net_kw.get("halo_size", 0) > 0
            else make_sharded_particle_step)
    step = make(net, mesh)
    rows = particle_rows(mesh)
    pos, vel, box, nrm = tensors_of(arrays, mesh.device)
    with torch.no_grad():
        p, _, nn_, diag = step(rows.local(pos), rows.local(vel), box, nrm,
                               box_plan=net.make_box_plan(box))
        return {"pos": all_gather_rows(p, group).cpu(),
                "nn": all_gather_rows(nn_, group).cpu(),
                "diag": {k: bool(v) for k, v in diag.items()},
                "diag_ranks": {k: flag_on_ranks(v, group)
                               for k, v in diag.items()}}


def e2e_stage(arrays, steps: int, device="cpu") -> dict:
    """`steps` ray-sharded e2e steps on a 1-D 'rays' mesh, the state
    carried; per step the loss and grad norms, the last next_pos, and
    whether the replicas agree bitwise after the updates."""
    mesh = make_mesh(axis_names=("rays",), device=device)
    transition, renderer = build_tiny_models(device=mesh.device)
    opt_r, opt_t = _optimizers(transition, renderer)
    step = make_sharded_e2e_step(transition, renderer, opt_r, opt_t,
                                 losses.default_box_bounds(device=mesh.device),
                                 1.0, mesh)
    pos, vel, box, nrm, ro, rays, rgbs = tensors_of(arrays, mesh.device)
    rays, rgbs = shard_ray_batch(rays, mesh), shard_ray_batch(rgbs, mesh)
    out = _run_steps(step, steps, pos, vel, box, nrm, ro, rays, rgbs)
    out["states_equal"] = replicas_equal(mesh, (renderer, transition),
                                         (opt_r, opt_t))
    return out


def composed_stage(arrays, shape: tuple, kernel_size: tuple = (2, 2, 2),
                   search_backend: str = "brute", device="cpu") -> dict:
    """One composed e2e step on the ('particles', 'rays') mesh of `shape`:
    loss, grad norms, the gathered next_pos, replicas bitwise equal."""
    mesh = make_mesh(shape, ("particles", "rays"), device=device)
    group = mesh.group("particles")
    transition, renderer = build_tiny_models(search_backend, kernel_size,
                                             shard_group=group,
                                             device=mesh.device)
    opt_r, opt_t = _optimizers(transition, renderer)
    step = make_spmd_e2e_step(transition, renderer, opt_r, opt_t,
                              losses.default_box_bounds(device=mesh.device),
                              1.0, mesh)
    pos, vel, box, nrm, ro, rays, rgbs = tensors_of(arrays, mesh.device)
    rows, ray_block = particle_rows(mesh), spmd_ray_sharding(mesh)
    out = _run_steps(step, 1, rows.local(pos), rows.local(vel), box, nrm, ro,
                     ray_block.local(rays), ray_block.local(rgbs),
                     box_plan=transition.make_box_plan(box))
    out["next_pos"] = all_gather_rows(out["next_pos"].to(mesh.device),
                                      group).cpu()
    out["states_equal"] = replicas_equal(mesh, (renderer, transition),
                                         (opt_r, opt_t))
    return out


def _run_steps(step, steps, pos, vel, box, nrm, ro, rays, rgbs,
               box_plan=None) -> dict:
    out = {"loss": [], "grad_norm_r": [], "grad_norm_t": [], "overflow": []}
    for _ in range(steps):
        loss, pos, vel, aux = step(pos, vel, box, nrm, ro, rays, rgbs,
                                   box_plan=box_plan)
        out["loss"].append(float(loss))
        out["grad_norm_r"].append(float(aux["grad_norm_renderer"]))
        out["grad_norm_t"].append(float(aux["grad_norm_transition"]))
        out["overflow"].append(bool(aux["search_overflow"]))
    out["next_pos"] = pos.cpu()
    return out


# ---- the replicated steps, in the calling process


def replicated_particle_step(arrays, net_kw: dict) -> dict:
    kw = {k: v for k, v in net_kw.items() if k not in ("halo_size",)}
    net = ParticleNet(device="cpu", generator=torch.Generator().manual_seed(0),
                      **kw)
    pos, vel, box, nrm = tensors_of(arrays, "cpu")
    with torch.no_grad():
        p, _, nn_, diag = net(pos, vel, box, nrm,
                              box_plan=net.make_box_plan(box))
    return {"pos": p, "nn": nn_, "diag": {k: bool(v) for k, v in diag.items()}}


def replicated_e2e_steps(arrays, steps: int = 1,
                         kernel_size: tuple = (4, 4, 4),
                         search_backend: str = "brute") -> dict:
    """The port's replicated `make_e2e_train_step` from the dry run's
    weights: per step loss and grad norms, the last next_pos."""
    transition, renderer = build_tiny_models(search_backend, kernel_size)
    opt_r, opt_t = _optimizers(transition, renderer)
    step = make_e2e_train_step(transition, renderer, opt_r, opt_t,
                               losses.default_box_bounds(), 1.0)
    pos, vel, box, nrm, ro, rays, rgbs = tensors_of(arrays, "cpu")
    return _run_steps(step, steps, pos, vel, box, nrm, ro, rays, rgbs,
                      box_plan=transition.make_box_plan(box))


# ---- launching ranks


def _worker(rank, n_ranks, tmp, fn, args):
    torch.set_num_threads(1)
    init_world(rank, n_ranks, f"file://{os.path.join(tmp, 'store')}", "cpu")
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, *args):
    """fn(*args) on n_ranks spawned CPU ranks of one gloo world; rank 0's
    result."""
    with tempfile.TemporaryDirectory(prefix="nf_dryrun_") as tmp:
        mp.start_processes(_worker, args=(n_ranks, tmp, fn, args),
                           nprocs=n_ranks, join=True, start_method="spawn")
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=True)


# ---- the JAX dry run's steps


def run_particle_sharded_step(n_ranks: int, seed: int = 0):
    """(ref_pos, sh_pos, ref_nn, sh_nn): the all-gather particle step at
    n_ranks against the replicated step."""
    arrays = _tiny_problem(n_ranks, seed)[:4]
    net_kw = dict(search_backend="brute", **TINY_TRANSITION)
    sh = launch(particle_stage, n_ranks, arrays, net_kw)
    ref = replicated_particle_step(arrays, net_kw)
    return ref["pos"], sh["pos"], ref["nn"], sh["nn"]


def halo_problem(n_ranks: int, seed: int = 0, n_per_rank: int = 64):
    """(arrays, grid bounds) of the halo check: particles sorted along x
    and spread so that each rank's slab is wider than the radius, and grid
    bounds that cover them (JAX `run_halo_particle_step`)."""
    rng = np.random.default_rng(seed)
    n = n_per_rank * max(1, n_ranks)
    pos = rng.uniform(-0.3, 0.3, size=(n, 3)).astype(np.float32)
    pos[:, 0] *= max(1.0, 0.55 * n_ranks)
    pos = pos[np.argsort(pos[:, 0])]  # the slab contract
    vel = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    box = rng.uniform(-0.6, 0.6, size=(48, 3)).astype(np.float32)
    nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (48, 1))
    span = float(np.abs(pos[:, 0]).max()) + 0.2
    return (pos, vel, box, nrm), dict(grid_lower=(-span, -1.05, -1.05),
                                      grid_upper=(span, 1.05, 2.55))


def run_halo_particle_step(n_ranks: int, seed: int = 0, halo_size: int = 32,
                           search_backend: str = "brute",
                           n_per_rank: int = 64):
    """(ref_pos, sh_pos, ref_nn, sh_nn, diag): the halo step on
    `halo_problem` against the replicated step; diag as every rank sees
    it ({flag: [per rank]})."""
    arrays, bounds = halo_problem(n_ranks, seed, n_per_rank)
    net_kw = dict(search_backend=search_backend, halo_axis=0,
                  halo_size=halo_size, **bounds, **TINY_TRANSITION)
    sh = launch(particle_stage, n_ranks, arrays, net_kw)
    ref = replicated_particle_step(arrays, net_kw)
    return ref["pos"], sh["pos"], ref["nn"], sh["nn"], sh["diag_ranks"]


def lattice_problem(n_ranks: int, dims=(48, 24, 12), jitter: float = 0.004,
                    seed: int = 0):
    """The 13,824-particle jittered lattice at the rest spacing 0.05,
    sorted along x (JAX `run_halo_lattice_step`)."""
    rng = np.random.default_rng(seed)
    spacing = 0.05
    gx = (np.arange(dims[0], dtype=np.float32) - dims[0] / 2 + 0.5) * spacing
    gy = (np.arange(dims[1], dtype=np.float32) - dims[1] / 2 + 0.5) * spacing
    gz = (np.arange(dims[2], dtype=np.float32) + 0.5) * spacing
    x, y, z = np.meshgrid(gx, gy, gz, indexing="ij")
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    pos = (pos + rng.normal(scale=jitter, size=pos.shape)).astype(np.float32)
    pad = (-len(pos)) % n_ranks
    if pad:
        pos = np.concatenate([pos, pos[:pad] + 0.001])
    pos = pos[np.argsort(pos[:, 0])]
    vel = (rng.normal(size=pos.shape) * 0.05).astype(np.float32)
    box = rng.uniform(-0.6, 0.6, size=(128, 3)).astype(np.float32)
    nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (128, 1))
    return pos, vel, box, nrm


def run_halo_lattice_step(n_ranks: int, dims=(48, 24, 12),
                          halo_size: int = 1024, jitter: float = 0.004,
                          seed: int = 0):
    """The halo step at the reference's density and scale on
    `lattice_problem`, on the grid backend with its halo-slot mask; as
    `run_halo_particle_step`."""
    arrays = lattice_problem(n_ranks, dims, jitter, seed)
    net_kw = dict(halo_size=halo_size, **LATTICE_NET)
    sh = launch(particle_stage, n_ranks, arrays, net_kw)
    ref = replicated_particle_step(arrays, net_kw)
    return ref["pos"], sh["pos"], ref["nn"], sh["nn"], sh["diag_ranks"]


def run_e2e_step(n_ranks: int, steps: int = 1, seed: int = 0):
    """(sharded, replicated): `steps` ray-sharded e2e steps at n_ranks and
    the replicated steps, each {loss, grad_norm_r, grad_norm_t (lists),
    next_pos, ...}."""
    arrays = _tiny_problem(n_ranks, seed)
    return (launch(e2e_stage, n_ranks, arrays, steps),
            replicated_e2e_steps(arrays, steps))


def run_composed_step(n_ranks: int, seed: int = 0):
    """(composed, replicated): the composed e2e step on a 2 x (n_ranks //
    2) ('particles', 'rays') mesh, 2 x 2 from 4 ranks on as in JAX, with
    (2, 2, 2) taps, against the replicated step."""
    if n_ranks % 2:
        raise ValueError("the composed mesh needs an even rank count")
    shape = (2, 2 if n_ranks >= 4 else n_ranks // 2)
    arrays = _tiny_problem(n_ranks, seed)
    comp = launch(composed_stage, shape[0] * shape[1], arrays, shape)
    return comp, replicated_e2e_steps(arrays, 1, kernel_size=(2, 2, 2))


def check_composed(comp: dict, repl: dict) -> None:
    """JAX's tolerances: loss rtol 1e-5, grad norms rtol 2e-3, next
    positions 1e-5; the replicas bitwise equal after the update."""
    assert comp["states_equal"], "replicas differ after the update"
    np.testing.assert_allclose(comp["loss"], repl["loss"], rtol=1e-5)
    np.testing.assert_allclose(comp["grad_norm_r"], repl["grad_norm_r"],
                               rtol=2e-3)
    np.testing.assert_allclose(comp["grad_norm_t"], repl["grad_norm_t"],
                               rtol=2e-3)
    np.testing.assert_allclose(comp["next_pos"], repl["next_pos"], atol=1e-5)


def dryrun_multichip(n_ranks: int) -> None:
    """JAX's six checks at n_ranks CPU ranks: the all-gather particle step,
    the halo step on brute and on grid, the 13,824-particle lattice, and
    the composed e2e step (finite, then equal to the replicated step)."""
    t0 = time.time()

    def mark(msg):
        print(f"[dryrun +{time.time() - t0:6.1f}s] {msg}", flush=True)

    mark(f"start: {n_ranks} ranks, gloo on the CPU")
    ref_pos, sh_pos, ref_nn, sh_nn = run_particle_sharded_step(n_ranks)
    np.testing.assert_array_equal(ref_nn, sh_nn)
    np.testing.assert_allclose(ref_pos, sh_pos, atol=1e-5)
    mark(f"1/6 particle-sharded step matches replicated "
         f"(max diff {float((ref_pos - sh_pos).abs().max()):.2e})")

    for i, backend in enumerate(("brute", "grid")):
        h_ref, h_sh, h_rnn, h_snn, h_diag = run_halo_particle_step(
            n_ranks, search_backend=backend)
        assert not any(h_diag["grid_overflow"]), (backend, h_diag)
        np.testing.assert_array_equal(h_rnn, h_snn)
        np.testing.assert_allclose(h_ref, h_sh, atol=1e-5)
        mark(f"{2 + i}/6 halo-exchange step ({backend}) matches replicated "
             f"(max diff {float((h_ref - h_sh).abs().max()):.2e})")

    l_ref, l_sh, l_rnn, l_snn, l_diag = run_halo_lattice_step(n_ranks)
    assert not any(l_diag["grid_overflow"]), l_diag
    np.testing.assert_array_equal(l_rnn, l_snn)
    np.testing.assert_allclose(l_ref, l_sh, atol=1e-4)
    mark(f"4/6 13.8k-particle lattice grid halo matches "
         f"(max diff {float((l_ref - l_sh).abs().max()):.2e})")

    comp, repl = run_composed_step(n_ranks)
    assert np.isfinite(comp["loss"]).all(), comp
    assert bool(torch.isfinite(comp["next_pos"]).all())
    mark(f"5/6 composed e2e train step (rays x particles + optimizers) ran: "
         f"loss={comp['loss'][0]:.6f}")
    check_composed(comp, repl)
    mark(f"6/6 composed step matches the replicated step (loss "
         f"{comp['loss'][0]:.6f} vs {repl['loss'][0]:.6f}); parameters and "
         f"Adam states bitwise equal on every rank")
    print(f"dryrun_multichip({n_ranks}): all six checks passed in "
          f"{time.time() - t0:.1f}s")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
