"""The model path without host syncs: the cell ids, K3's grouping, its
compaction map and sums, and the gravity step, each bitwise against the
formula that copied its constants to the device and counted the live
slots on the host (`torch.nonzero` and a boolean mask index), written out
here as the oracle."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.ops import ball_features as bf
from neurofluid_torch.ops import neighbor_search as ns

LOWER = (-0.7, -0.7, -0.7)
UPPER = (0.7, 0.7, 0.7)
R = 0.225


def host_cell_ids(points, lower, dims, cell_size):
    lo = torch.as_tensor(lower, dtype=points.dtype, device=points.device)
    hi = torch.as_tensor(dims, device=points.device) - 1
    cell = torch.floor((points - lo) / cell_size).long()
    cell = torch.minimum(torch.clamp(cell, min=0), hi)
    return (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]


class Grouping(NamedTuple):
    order: torch.Tensor
    inv_rank: torch.Tensor
    gcell: torch.Tensor
    rep_idx: torch.Tensor
    capacity: int
    n_groups: int
    group_size: int
    cull_overflow: torch.Tensor


def host_group_queries_on(queries, points, radius, lower, dims, capacity,
                          group_size=32, max_groups=None):
    q, p = queries.detach(), points.detach()
    n_q, t, dev = q.shape[0], int(group_size), q.device
    capacity = int(min(max(capacity, t), n_q))
    num_cells = dims[0] * dims[1] * dims[2]
    lo = p.min(dim=0).values - radius
    hi = p.max(dim=0).values + radius
    inside = torch.all((q >= lo) & (q <= hi), dim=-1)
    cull_overflow = inside.sum() > capacity
    key = torch.where(inside, host_cell_ids(q, lower, dims, radius),
                      num_cells)
    key_sorted, order = torch.sort(key, stable=True)
    inv_rank = torch.empty_like(order)
    inv_rank[order] = torch.arange(n_q, device=dev)
    qcell = key_sorted[:capacity]
    cells = torch.arange(num_cells + 1, device=dev)
    starts_cell = torch.searchsorted(qcell, cells)
    end = starts_cell.new_tensor([capacity])
    counts = torch.diff(starts_cell, append=end)
    gbase = torch.cat([counts.new_zeros(1), torch.cumsum(-(-counts // t), 0)])
    rank_in_cell = torch.arange(capacity, device=dev) - starts_cell[qcell]
    group_of_q = gbase[qcell] + rank_in_cell // t
    ng = capacity // t + num_cells + 2
    if max_groups is not None:
        ng = min(ng, max(int(max_groups), capacity // t + 2))
        cull_overflow = cull_overflow | (gbase[-1] > ng)
    gstart = torch.searchsorted(group_of_q, torch.arange(ng + 1, device=dev))
    gcount = torch.diff(gstart)
    first = torch.clamp(gstart[:-1], max=capacity - 1)
    gcell = torch.where(gcount > 0, qcell[first], num_cells).to(torch.int32)
    slot = torch.arange(t, device=dev)[None, :]
    rep_idx = torch.where(slot < gcount[:, None], gstart[:-1, None] + slot,
                          capacity).reshape(-1)
    return Grouping(order, inv_rank, gcell, rep_idx, capacity, ng, t,
                    cull_overflow)


def host_packed_slots(rep_idx, capacity):
    live = rep_idx < capacity
    slot_of_sorted = torch.zeros(capacity, dtype=torch.long,
                                 device=rep_idx.device)
    slots = torch.nonzero(live)[:, 0]
    packed = rep_idx[live]
    slot_of_sorted[packed] = slots
    return slot_of_sorted


def host_sums(queries, points, k, max_per_cell, capacity_frac):
    """`BallFeatureSums.forward` as it counted the live slots on the host:
    the sums, the overflow flag and the tensors saved for the backward."""
    n_q = queries.shape[0]
    capacity = -(-int(n_q * capacity_frac) // 256) * 256
    g = host_group_queries_on(queries, points, R, LOWER,
                              ns.cell_dims(LOWER, UPPER, R), capacity)
    capacity = g.capacity
    grid, tx, ty, tz = bf.build_tables(points, LOWER, UPPER, R, max_per_cell)
    q_pad = torch.cat([queries[g.order[:capacity]],
                       torch.full_like(queries[:1], bf.SENTINEL)], dim=0)
    q_rep = q_pad[g.rep_idx].contiguous()
    sums_rep = bf.ball_sums_plain(q_rep, tx, ty, tz, g.gcell, grid.dims, R,
                                  k, g.group_size)
    slot_of_sorted = host_packed_slots(g.rep_idx, capacity)
    r = g.inv_rank
    kept = r < capacity
    sums = sums_rep[slot_of_sorted[torch.clamp(r, max=capacity - 1)]]
    sums = torch.where(kept[:, None], sums, 0.0)
    saved = (q_rep, tx, ty, tz, grid.table_idx.to(torch.int32), g.gcell,
             g.order, g.rep_idx)
    return sums, grid.overflow | g.cull_overflow, saved


def _scene(n_pts, n_in, n_out, seed):
    """Particles in a ball of the box, `n_in` queries among them and
    `n_out` culled ones beyond their box plus the radius."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(n_pts, 3, generator=g) * 0.7 - 0.35
    q_in = torch.rand(n_in, 3, generator=g) * 0.9 - 0.45
    q_out = torch.rand(n_out, 3, generator=g) * 0.1 + 0.6
    q_out[::2] *= -1
    q = torch.cat([q_in, q_out])
    return pts, q[torch.randperm(q.shape[0], generator=g)]


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cell_ids_match_the_copied_constants(dtype):
    """Points outside the box on every side, on cell borders (in the
    points' dtype), at both corners and one ulp to either side."""
    cell = 0.1125
    dims = ns.cell_dims(LOWER, UPPER, cell)
    lo = torch.tensor(LOWER, dtype=dtype)
    k = torch.arange(-2, max(dims) + 3, dtype=dtype)[:, None]
    border = lo + k * cell
    g = torch.Generator().manual_seed(5)
    pts = torch.cat([
        border, torch.nextafter(border, border - 1),
        torch.nextafter(border, border + 1),
        torch.tensor([LOWER, UPPER], dtype=dtype),
        torch.rand(500, 3, generator=g, dtype=dtype) * 2.2 - 1.1,
    ])
    want = host_cell_ids(pts, LOWER, dims, cell)
    got = ns.cell_ids(pts, LOWER, dims, cell)
    _equal(got, want)
    assert (want == 0).any()
    assert int(want.max()) == dims[0] * dims[1] * dims[2] - 1
    # the upper corner lies in the last cell, clamped
    _equal(ns.cell_ids(torch.tensor([UPPER], dtype=dtype), LOWER, dims,
                       cell), want.new_tensor([int(want.max())]))


@pytest.mark.parametrize("max_groups", [None, 40, 10_000])
@pytest.mark.parametrize("n_in, capacity", [(300, 384), (250, 256),
                                            (420, 256)])
def test_grouping_matches_the_copied_capacity(n_in, capacity, max_groups):
    """Culled queries, a capacity nearly full (250 of 256) and one overrun
    (420 inside), with and without a cap on the groups."""
    pts, q = _scene(400, n_in, 700 - n_in, seed=n_in)
    dims = ns.cell_dims(LOWER, UPPER, R)
    want = host_group_queries_on(q, pts, R, LOWER, dims, capacity, 32,
                                 max_groups)
    got = bf.group_queries_on(q, pts, R, LOWER, dims, capacity, 32,
                              max_groups)
    for a, b in zip(got, want):
        if isinstance(b, torch.Tensor):
            _equal(a, b)
        else:
            assert a == b
    assert (want.rep_idx == want.capacity).any()  # padded slots
    if max_groups == 40:  # the cap cuts groups off
        assert bool(want.cull_overflow)


@pytest.mark.parametrize("max_groups", [None, 40])
def test_packed_slots_match_the_host_count(max_groups):
    pts, q = _scene(400, 250, 450, seed=9)
    g = bf.group_queries_on(q, pts, R, LOWER, ns.cell_dims(LOWER, UPPER, R),
                            256, 32, max_groups)
    want = host_packed_slots(g.rep_idx, g.capacity)
    _equal(bf.packed_slots(g.rep_idx, g.capacity), want)
    if max_groups is None:  # every kept query has its slot
        assert torch.equal(g.rep_idx[want], torch.arange(g.capacity))


@pytest.mark.parametrize("n_in, frac", [(300, 0.625), (250, 0.25),
                                        (420, 0.25), (700, 1.0)])
def test_ball_sums_match_the_host_compaction(n_in, frac):
    """K3's sums (its plain version), the overflow flag and the tensors
    saved for the backward: culled queries, a nearly full capacity, an
    overrun one (420 inside 256), and every query kept."""
    pts, q = _scene(400, n_in, 700 - n_in, seed=n_in + 1)
    pts.requires_grad_(True)
    want, want_over, want_saved = host_sums(q, pts.detach(), 6, 64, frac)
    got, over = bf.ball_feature_sums(q, pts, R, 6, LOWER, UPPER,
                                     max_per_cell=64, capacity_frac=frac)
    _equal(got.detach(), want)
    assert bool(over) == bool(want_over) == (n_in == 420)
    assert (want[:, 0] > 0).sum() > 100
    for a, b in zip(got.grad_fn.saved_tensors, want_saved):
        _equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gravity", [(0.0, -9.81, 0.0), (0.1, 0.0, -9.81)])
def test_gravity_step_matches_the_copied_gravity(dtype, gravity):
    net = ParticleNet(layer_channels=(8, 3), gravity=gravity, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    pos = torch.randn(64, 3, generator=g, dtype=dtype)
    vel = torch.randn(64, 3, generator=g, dtype=dtype)
    dt = net.timestep
    grav = torch.as_tensor(gravity, dtype=dtype)
    got_pos, got_vel = net.integrate_pos_vel(pos, vel)
    _equal(got_vel, vel + grav * dt)
    _equal(got_pos, pos + (vel + (vel + grav * dt)) / 2.0 * dt)
    assert "gravity" not in net.state_dict()
    assert net.init_kwargs["gravity"] == gravity
    np.testing.assert_array_equal(
        net.integrate_pos_vel(pos, vel)[0].numpy(), got_pos.numpy())
