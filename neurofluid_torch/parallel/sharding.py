"""Multi-rank sharded paths over `torch.distributed` (port of
neurofluid_tpu/parallel/sharding.py, same names).

Each rank runs one process and holds its own block of every sharded array;
the parameters, both models' Adam states and the box are replicated. JAX
states the layout as shardings of one global program (jit's
`in_shardings`, `shard_map`'s specs); here `Sharding.local` cuts a rank's
block out of a global array, and the steps take and return local blocks.

1. Ray sharding (`make_sharded_e2e_step`, `make_sharded_render_fn`): the
   ray batch is split over the 'rays' axis; the transition step runs
   replicated (on any backend, `fused_cconv` included).
2. Particle sharding (`make_sharded_particle_step`,
   `make_halo_particle_step`): each rank owns a block of the particles,
   and the net's `shard_group` extends each layer's inputs by all-gather
   or by the slab halo exchange.
3. Both composed (`make_spmd_e2e_step`, `make_composed_e2e_step`): the
   transition sharded over 'particles', its predicted positions
   all-gathered for the renderer, the rays owned once over both axes.

The e2e steps follow JAX's ownership accounting
(neurofluid_tpu/parallel/sharding.py `make_spmd_e2e_step`): every term of
the local loss is owned by exactly one rank (each rgb term over the global
ray count; the boundary term, replicated across the ray axis, pre-divided
by that axis's size), so the loss and both models' gradients, summed over
the whole world outside autograd, are the global ones, and the two Adam
updates are the same on every rank. GSPMD versus `shard_map` is a JAX
compile choice, so `make_composed_e2e_step` and `make_spmd_e2e_step` are
one implementation here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from neurofluid_torch.parallel.collectives import all_gather_rows, any_over
from neurofluid_torch.parallel.mesh import Mesh
from neurofluid_torch.train.transition import global_norm, grads_or_zeros
from neurofluid_torch.train.warmup import render_views


class Sharding(NamedTuple):
    """Dimension `dim` of an array split over the mesh axes `axes` (jointly,
    the first slowest), or replicated when `dim` is None."""

    mesh: Mesh
    dim: int | None
    axes: tuple = ()

    def blocks(self) -> tuple:
        """(number of blocks, this rank's block)."""
        n, i = 1, 0
        for ax in self.axes:
            size = self.mesh.size(ax)
            n, i = n * size, i * size + self.mesh.index(ax)
        return n, i

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global `x`."""
        if self.dim is None:
            return x
        n, i = self.blocks()
        size = x.shape[self.dim]
        if size % n:
            raise ValueError(f"dimension {self.dim} of size {size} does not "
                             f"split into {n} blocks")
        return x.narrow(self.dim, i * (size // n), size // n)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def ray_sharding(mesh: Mesh, axis_name: str = "rays") -> Sharding:
    """(V, R, ...) ray batches split along R."""
    return Sharding(mesh, 1, (axis_name,))


def shard_ray_batch(x: torch.Tensor, mesh: Mesh,
                    axis_name: str = "rays") -> torch.Tensor:
    """This rank's block of a (V, R, ...) ray batch, on its device."""
    return ray_sharding(mesh, axis_name).local(x).to(mesh.device)


def make_sharded_render_fn(renderer, mesh: Mesh, axis_name: str = "rays"):
    """render(particles, ro, rays (R, 6)) -> the renderer's result dict for
    all R rays, on every rank: each rank renders its block of the rays;
    the per-ray outputs are all-gathered and `overflow` is ORed."""
    group = mesh.group(axis_name)
    block = Sharding(mesh, 0, (axis_name,))

    def render(particles, ro, rays):
        out = renderer(particles, ro, block.local(rays))
        return {k: any_over(v, group) if v.dim() == 0
                else all_gather_rows(v, group) for k, v in out.items()}

    return render


def _owned_once_step(transition, renderer, opt_r, opt_t, bounds, bd_weight,
                     mesh: Mesh, ray_axis: str, particle_axis: str | None):
    """The e2e train step on this rank's rays (and particles, with
    `particle_axis`); see the module docstring for the accounting.

    step(pos, vel, box, nrm, ro_v (V, 3), rays_v (V, R_local, 6), rgbs_v
    (V, R_local, 3), box_plan=None) -> (loss, next_pos, next_vel, aux), the
    loss global, next_* this rank's rows, detached. aux: rgbloss_0,
    rgbloss_1, boundary_loss (global), search_overflow and
    search_cap_exceeded (ORed over the world), grad_norm_renderer and
    grad_norm_transition (of the global gradients)."""
    params = list(renderer.parameters()) + list(transition.parameters())
    n_r = len(list(renderer.parameters()))
    world = mesh.world
    world_size = dist.get_world_size(world)
    rr = mesh.size(ray_axis)
    pgroup = None if particle_axis is None else mesh.group(particle_axis)
    pp = 1 if particle_axis is None else mesh.size(particle_axis)

    def train_step(pos, vel, box, nrm, ro_v, rays_v, rgbs_v, box_plan=None):
        opt_r.zero_grad(set_to_none=True)
        opt_t.zero_grad(set_to_none=True)
        pred_pos, pred_vel, _, diag = transition(
            pos.detach(), vel.detach(), box, nrm, box_plan=box_plan)
        full_pos = (pred_pos if pgroup is None
                    else all_gather_rows(pred_pos, pgroup))
        _, se0, se1, overflow = render_views(renderer, full_pos, ro_v, rays_v,
                                             rgbs_v)
        denom = rays_v.shape[1] * world_size * se0.shape[-1]
        rgb0, rgb1 = se0.sum() / denom, se1.sum() / denom
        clipped = torch.clamp(pred_pos, bounds.lower.to(pred_pos),
                              bounds.upper.to(pred_pos))
        bd = torch.abs(pred_pos - clipped).sum() / (
            3.0 * pos.shape[0] * pp * rr)
        loss = rgb0 + rgb1 + bd_weight * bd
        loss.backward()

        # one all-reduce of the loss terms and every gradient, outside
        # autograd: the sums of the owned-once terms are the global ones
        grads = grads_or_zeros(params)
        flat = torch.cat([torch.stack([loss, rgb0, rgb1, bd]).detach()]
                         + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=world)
        head, off = flat[:4], 4
        for p in params:  # views of the one reduced buffer
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        g_r = [p.grad for p in params[:n_r]]
        g_t = [p.grad for p in params[n_r:]]
        aux = {
            "rgbloss_0": head[1], "rgbloss_1": head[2],
            "boundary_loss": head[3],
            "search_overflow": any_over(diag["grid_overflow"] | overflow,
                                        world),
            "search_cap_exceeded": any_over(diag["cap_exceeded"], world),
            "grad_norm_renderer": global_norm(g_r),
            "grad_norm_transition": global_norm(g_t),
        }
        opt_r.step()
        opt_t.step()
        return head[0], pred_pos.detach(), pred_vel.detach(), aux

    return train_step


def make_sharded_e2e_step(transition, renderer, opt_r, opt_t, bounds,
                          bd_weight: float, mesh: Mesh,
                          axis_name: str = "rays"):
    """The e2e train step (`train.e2e.make_e2e_train_step`'s loss and
    updates) with the ray batch split over `axis_name`: the step takes
    this rank's rays (`shard_ray_batch`) and the whole, replicated
    particle state; it returns the global loss and the (replicated) next
    state. Each view's MSE is this rank's squared errors over the global
    ray count, so the world's sum is the global mean."""
    return _owned_once_step(transition, renderer, opt_r, opt_t, bounds,
                            bd_weight, mesh, axis_name, None)


class ShardMapTransition(nn.Module):
    """The sharded ParticleNet as the e2e steps call it (JAX's
    `ShardMapTransition`): its forward runs the wrapped net on this rank's
    particles and ORs the health flags over the particle group, so every
    rank sees every rank's overflow. `box_plan` is passed on to the net,
    never dropped."""

    def __init__(self, net, mesh: Mesh, axis_name: str = "particles"):
        super().__init__()
        if net.shard_group is not mesh.group(axis_name):
            raise ValueError(f"net.shard_group is not the mesh's "
                             f"{axis_name!r} group")
        self.net = net
        self.mesh = mesh
        self.axis_name = axis_name

    @property
    def search_backend(self):
        return self.net.search_backend

    def make_box_plan(self, box):
        return self.net.make_box_plan(box)

    def forward(self, pos, vel, box, box_feats, feats=None, box_plan=None):
        p, v, nn_, diag = self.net(pos, vel, box, box_feats, feats=feats,
                                   box_plan=box_plan)
        group = self.mesh.group(self.axis_name)
        return p, v, nn_, {k: any_over(f, group) for k, f in diag.items()}


def make_spmd_e2e_step(transition, renderer, opt_r, opt_t, bounds,
                       bd_weight: float, mesh: Mesh, ray_axis: str = "rays",
                       particle_axis: str = "particles"):
    """The composed e2e train step on the ('particles', 'rays') mesh.

    `transition`: a ParticleNet built with shard_group =
    mesh.group(particle_axis) (JAX takes a factory of it, and its params
    apart; a torch module carries its parameters), `opt_t` over its
    parameters. The step takes this rank's particle rows (the rows split
    over `particle_axis`, replicated over `ray_axis`) and its rays (split
    over both axes, `Sharding(mesh, 1, (particle_axis, ray_axis))`, each
    ray owned by one rank); the renderer renders them against the
    all-gathered predicted particles. Returns as `make_sharded_e2e_step`,
    next_* this rank's particle rows."""
    shim = ShardMapTransition(transition, mesh, particle_axis)
    return _owned_once_step(shim, renderer, opt_r, opt_t, bounds, bd_weight,
                            mesh, ray_axis, particle_axis)


make_composed_e2e_step = make_spmd_e2e_step


def make_sharded_particle_step(net, mesh: Mesh, axis_name: str = "particles"):
    """The particle-sharded transition step: step(pos, vel, box, nrm,
    box_plan=None) on this rank's particle rows -> (pos', vel', num_nn,
    diag), the first three this rank's rows, the diag flags ORed over the
    group. `net` is a ParticleNet built with shard_group =
    mesh.group(axis_name) (all-gather or halo)."""
    shim = ShardMapTransition(net, mesh, axis_name)

    def step(pos, vel, box, nrm, box_plan=None):
        return shim(pos, vel, box, nrm, box_plan=box_plan)

    return step


def make_halo_particle_step(net, mesh: Mesh, axis_name: str = "particles"):
    """`make_sharded_particle_step` for a net with halo_size > 0: the
    particles must be sorted by the net's `halo_axis` coordinate before
    they are split. `grid_overflow` includes the halo's insufficiency and
    must be checked by the caller."""
    if net.halo_size <= 0:
        raise ValueError("make_halo_particle_step needs halo_size > 0")
    return make_sharded_particle_step(net, mesh, axis_name)


def particle_rows(mesh: Mesh, axis_name: str = "particles") -> Sharding:
    """(N, ...) particle arrays split along N over `axis_name`."""
    return Sharding(mesh, 0, (axis_name,))


def spmd_ray_sharding(mesh: Mesh, particle_axis: str = "particles",
                      ray_axis: str = "rays") -> Sharding:
    """(V, R, ...) ray batches of the composed step, split along R over
    both axes."""
    return Sharding(mesh, 1, (particle_axis, ray_axis))

