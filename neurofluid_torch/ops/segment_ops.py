"""Neighbour gathers and their adjoint, the segment sum: K8
(`csrc/segment_sum.cu` `nf_segment_sum_accumulate`) and its plain version
(port of neurofluid_tpu/ops/segment_ops.py).

`take_rows` / `take_rows_planned` gather table rows at a neighbour list's
ids; their backward sums the cotangent rows back into the table,

    d_table[s] = sum of g[i] over the slots i with idx[i] == s,

which is K8 for CUDA tensors and `segment_sum_plain` for CPU tensors. All
gathers from one neighbour list share one `AdjointPlan`: the ids with every
padding slot (-1) and out-of-range id sent to a trash segment, and, sorted
once at the first backward that needs it, the slots grouped by id.

A padding slot gathers a zero row and gets no gradient, so callers hand the
list's ids over as they are (-1 included) and need not mask the gathered
rows again. (The JAX callers clamp such ids to row 0 and zero the rows
afterwards; the cotangent of those rows is then exactly zero, so the
table's gradient is the same.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from neurofluid_torch.cuda import Kernel, check_tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("segment_sum.cu", "nf_segment_sum_accumulate",
                [_P] * 4 + [_I] * 2)


class AdjointPlan:
    """The shared backward plan of the gathers at `idx` into an (n, ...)
    table (the JAX package's `adjoint_plan`).

    ids: (M,) int32, `idx` flattened with ids < 0 or >= n replaced by the
    trash id n. order: (M,) int32, the slots sorted by id, stably (natural
    order inside an id); starts: (n + 1,) int32, the first position in
    `order` of each id, starts[n] opening the trash segment. The sort runs
    at the first use of `order` or `starts`, so a forward pass that is never
    differentiated does not pay for it."""

    def __init__(self, idx: torch.Tensor, n: int):
        ids = idx.detach().reshape(-1)
        self.ids = torch.where((ids < 0) | (ids >= n), n, ids).to(torch.int32)
        self.n = int(n)

    @functools.cached_property
    def _sorted(self):
        ids_sorted, order = torch.sort(self.ids, stable=True)
        starts = torch.searchsorted(
            ids_sorted, torch.arange(self.n + 1, dtype=torch.int32,
                                     device=self.ids.device))
        return order.to(torch.int32), starts.to(torch.int32)

    @property
    def order(self) -> torch.Tensor:
        return self._sorted[0]

    @property
    def starts(self) -> torch.Tensor:
        return self._sorted[1]


def segment_sum_plain(vals: torch.Tensor, plan: AdjointPlan) -> torch.Tensor:
    """Plain PyTorch twin of K8: (M, C) rows added into an (n + 1, C) table
    in natural order at `plan.ids`, the trash row dropped. Returns (n, C)."""
    out = vals.new_zeros((plan.n + 1, vals.shape[1]))
    return out.index_add_(0, plan.ids, vals)[: plan.n]


def segment_sum_cuda(vals: torch.Tensor, plan: AdjointPlan) -> torch.Tensor:
    """K8: one warp per table row sums that row's slots in the plan's
    order; deterministic, no atomics. vals (M, C) f32 -> (n, C)."""
    dev = vals.device
    check_tensor("vals", vals, dev)
    if vals.ndim != 2 or vals.shape[0] != plan.ids.shape[0]:
        raise ValueError(f"vals {tuple(vals.shape)} against a plan of "
                         f"{plan.ids.shape[0]} slots")
    check_tensor("plan.order", plan.order, dev, torch.int32)
    check_tensor("plan.starts", plan.starts, dev, torch.int32)
    n, c = plan.n, vals.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if n and c:
        KERNEL(vals.data_ptr(), plan.order.data_ptr(),
               plan.starts.data_ptr(), out.data_ptr(), n, c)
    return out


def segment_sum_accumulate(vals: torch.Tensor,
                           plan: AdjointPlan) -> torch.Tensor:
    """sum_i vals[i] into out[plan.ids[i]], the trash segment dropped: K8
    for a CUDA tensor, the plain version for a CPU tensor."""
    fn = segment_sum_cuda if vals.is_cuda else segment_sum_plain
    return fn(vals, plan)


def segment_sum_sorted(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """The same reduction by sort, cumulative sum and differences at the
    segment boundaries. values (M,) or (M, C); ids outside [0, num_segments)
    are dropped. A plain function kept for the module's completeness: the
    TPU build uses it because scatters are slow there, nothing here does."""
    squeeze = values.ndim == 1
    vals = values[:, None] if squeeze else values
    ids = segment_ids.reshape(-1)
    ids = torch.where((ids < 0) | (ids >= num_segments), num_segments, ids)
    ids_sorted, order = torch.sort(ids, stable=True)
    csum = torch.cumsum(vals[order].float(), dim=0)
    csum = torch.cat([csum.new_zeros((1, vals.shape[1])), csum])
    starts = torch.searchsorted(
        ids_sorted, torch.arange(num_segments + 1, dtype=ids.dtype,
                                 device=ids.device))
    out = (csum[starts[1:]] - csum[starts[:-1]]).to(values.dtype)
    return out[:, 0] if squeeze else out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, plan, shape):
        ctx.plan = plan
        padded = torch.cat([table, table.new_zeros((1,) + table.shape[1:])])
        return padded.index_select(0, plan.ids).reshape(*shape, *table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        flat = g.reshape(ctx.plan.ids.shape[0], -1).contiguous()
        d_table = segment_sum_accumulate(flat, ctx.plan)
        return d_table.reshape(ctx.plan.n, *g.shape[-1:]), None, None


def take_rows_planned(table: torch.Tensor, idx: torch.Tensor,
                      plan: AdjointPlan) -> torch.Tensor:
    """table (N, C) gathered at idx (...) -> (..., C); zero rows where idx
    is -1 or out of range. `plan` must be `AdjointPlan(idx, N)`; the
    backward is the segment sum over it."""
    if plan.n != table.shape[0] or plan.ids.shape[0] != idx.numel():
        raise ValueError("the plan was built for another table or index")
    return _TakeRows.apply(table, plan, tuple(idx.shape))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`take_rows_planned` with a plan of its own."""
    return take_rows_planned(table, idx, AdjointPlan(idx, table.shape[0]))


class _Gather3Values(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, vx, vy, vz, plan):
        ctx.plan = plan
        return vx.clone(), vy.clone(), vz.clone()

    @staticmethod
    def backward(ctx, gx, gy, gz):
        cots = torch.stack([g.reshape(-1) for g in (gx, gy, gz)], dim=-1)
        return segment_sum_accumulate(cots.contiguous(), ctx.plan), \
            None, None, None, None


def gather3_values(table, idx, vx, vy, vz, plan: AdjointPlan):
    """(table[:, 0][idx], table[:, 1][idx], table[:, 2][idx]) without the
    gather: the search already holds the selected coordinates (vx, vy, vz),
    so they are returned as they are and only the backward, the segment sum
    of the three cotangents into `table` (N, 3), remains. The caller
    guarantees (vx, vy, vz) == table[idx].T wherever a cotangent can be
    nonzero, and plan == AdjointPlan(idx, N)."""
    if plan.n != table.shape[0] or plan.ids.shape[0] != idx.numel():
        raise ValueError("the plan was built for another table or index")
    return _Gather3Values.apply(table, vx, vy, vz, plan)
