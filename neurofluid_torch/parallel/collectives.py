"""The collectives of the sharded paths, written as autograd functions over
`torch.distributed` (the JAX package has them as `lax` primitives inside
`shard_map`). Each runs on gloo (CPU tensors) and on NCCL (CUDA tensors),
and on a group of one it still makes its call (NCCL moves nothing then).

- `all_gather_rows(x, group)`: `lax.all_gather(x, axis, axis=0,
  tiled=True)`, the group's row blocks concatenated in group-rank order.
  Its backward is the transpose JAX uses, `psum_scatter`: the cotangent
  summed over the group, this rank's rows of the sum.
- `shift(x, s, group)`: `lax.ppermute` as the halo exchange uses it
  (neurofluid_tpu/models/particle_net.py `_halo_plan.from_shift`): the
  value of x on group rank + s, zeros where that rank does not exist. Its
  backward is `shift(g, -s)`.
- `any_over(flag, group)`: the `psum(flag) > 0` of the health flags, on
  booleans, outside autograd.

They are written here and not taken from `torch.distributed.nn`, whose
all-gather backward changes form with the backend: here each gradient is
counted once, where the docstrings say.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_gather_single(out, x, group):
    # all_gather_into_tensor was renamed all_gather_single in torch 2.13
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_single(out, x, group):
    fn = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    fn(out, x, group=group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single(out, x, group)
        return out

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        n = dist.get_world_size(group)
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        _reduce_scatter_single(out, g, group)
        return out, None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n * R, ...) from each rank's (R, ...), in group-rank order; every
    rank must pass the same shape."""
    return _AllGatherRows.apply(x, group)


def _shift(x: torch.Tensor, s: int, group) -> torch.Tensor:
    n, me = dist.get_world_size(group), dist.get_rank(group)
    out = torch.zeros_like(x)
    x = x.contiguous()
    ops = []
    if 0 <= me + s < n:  # receive from group rank me + s
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, me + s), group))
    if 0 <= me - s < n:  # ... which sends to me - s
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, me - s), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, group):
        ctx.s, ctx.group = s, group
        return _shift(x, s, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.s, ctx.group), None, None


def shift(x: torch.Tensor, s: int, group) -> torch.Tensor:
    """x as group rank (own + s) holds it; zeros where that rank does not
    exist. Every rank of the group must call it with the same s and shape."""
    return _Shift.apply(x, int(s), group)


def any_over(flag: torch.Tensor, group) -> torch.Tensor:
    """() bool: `flag` set on any rank of the group."""
    x = flag.detach().to(torch.int32).reshape(1).clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x[0] > 0
