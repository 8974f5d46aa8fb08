"""Rank-side functions of tests/test_torch_parallel.py, run by
`neurofluid_torch.parallel.dryrun.launch` on spawned gloo ranks. They live
apart from the test file so that a rank imports torch and the port only,
not JAX."""

import torch
import torch.distributed as dist

from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.ops.neighbor_search import build_cell_grid
from neurofluid_torch.parallel import collectives as col
from neurofluid_torch.parallel.dryrun import (
    TINY_TRANSITION, build_tiny_models, flag_on_ranks, tensors_of,
)
from neurofluid_torch.parallel.mesh import make_mesh
from neurofluid_torch.parallel.sharding import (
    make_sharded_particle_step, make_sharded_render_fn, particle_rows,
)


class _ReplicatedIn(torch.autograd.Function):
    """Identity on a tensor every rank holds alike; its backward sums the
    ranks' gradients, so a function of it is one function of one input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _StackedOut(torch.autograd.Function):
    """Every rank's (R, ...) output stacked, the same on every rank; its
    backward hands each rank its own block of the (equal) cotangents."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(y) for _ in range(ctx.n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n)[ctx.rank].clone(), None


def collectives_stage(rows: int = 3) -> dict:
    """all_gather_rows, shift (+-1, +-2) and any_over on this world: the
    forwards against the single-process concatenation and shift of every
    rank's input, the backwards by gradcheck in float64 of the global
    function (input replicated, outputs stacked); errors, gradcheck verdicts
    and flags per check."""
    mesh = make_mesh(axis_names=("particles",), device="cpu")
    group = mesh.group("particles")
    n, me = dist.get_world_size(group), dist.get_rank(group)
    gen = torch.Generator().manual_seed(0)
    full = torch.randn((n * rows, 2), generator=gen, dtype=torch.float64)
    block = full.chunk(n)
    out = {}
    got = col.all_gather_rows(block[me], group)
    out["all_gather_err"] = float((got - full).abs().max())
    for s in (1, -1, 2, -2):
        want = block[me + s] if 0 <= me + s < n else torch.zeros_like(block[0])
        out[f"shift{s}_err"] = float((col.shift(block[me], s, group)
                                      - want).abs().max())
    flag = torch.tensor(me == n - 1)
    out["any_over"] = bool(col.any_over(flag, group))
    out["any_over_none"] = bool(col.any_over(torch.tensor(False), group))

    def global_fn(op):
        def fn(x):
            local = _ReplicatedIn.apply(x, group).chunk(n)[me]
            return _StackedOut.apply(op(local), group)
        return fn

    x = full.clone().requires_grad_(True)
    out["gradcheck_all_gather"] = torch.autograd.gradcheck(
        global_fn(lambda t: col.all_gather_rows(t, group)), (x,))
    for s in (1, -1, 2):
        out[f"gradcheck_shift{s}"] = torch.autograd.gradcheck(
            global_fn(lambda t, s=s: col.shift(t, s, group)), (x,))
    return out


def box_plan_stage(arrays) -> dict:
    """The sharded particle step with and without a box grid whose cells
    hold one particle (the tiny box overflows it): grid_overflow on every
    rank says whether the step used the grid it was passed."""
    mesh = make_mesh(axis_names=("particles",), device="cpu")
    group = mesh.group("particles")
    net = ParticleNet(shard_group=group, device="cpu", search_backend="brute",
                      generator=torch.Generator().manual_seed(0),
                      **TINY_TRANSITION)
    step = make_sharded_particle_step(net, mesh)
    rows = particle_rows(mesh)
    pos, vel, box, nrm = tensors_of(arrays, "cpu")
    tiny_grid = build_cell_grid(box, net.grid_lower, net.grid_upper,
                                net.radius, max_per_cell=1)
    flags = {}
    with torch.no_grad():
        for name, plan in (("none", None), ("tiny_grid", tiny_grid)):
            *_, diag = step(rows.local(pos), rows.local(vel), box, nrm,
                            box_plan=plan)
            flags[name] = flag_on_ranks(diag["grid_overflow"], group)
    return flags



def render_stage(arrays) -> dict:
    """`make_sharded_render_fn` over a 1-D 'rays' mesh: every rank's
    result for all rays."""
    mesh = make_mesh(axis_names=("rays",), device="cpu")
    _, renderer = build_tiny_models()
    pos, ro, rays = tensors_of(arrays, "cpu")
    with torch.no_grad():
        out = make_sharded_render_fn(renderer, mesh)(pos, ro, rays)
    return {k: v.cpu() for k, v in out.items()}
