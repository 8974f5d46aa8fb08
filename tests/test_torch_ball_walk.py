"""The host side of the staged ball walk of K3 and K7
(`neurofluid_torch/csrc/ball_walk.cuh`), on the CPU: the plan that sizes a
block's staging (`ball_features.walk_plan`, `walk_smem_bytes`), and the
kernels' batching of a group's flattened candidate list emulated in numpy.

A block copies the occupied prefixes of its group's 27 table rows, in
selection order, into one flattened list of `scan[27]` candidates, `stage`
at a time; a warp walks each batch 32 candidates per step and carries the
slot's running count from batch to batch. The emulation follows the
kernels' index arithmetic (`stage_batch`: the part of row o inside the
batch [lo, hi) lands at j - lo from table slot j - scan[o]) and its
selection (first k by ballot rank), and must give exactly the plain
versions' counts and ids for any stage size: flattening and batching do
not change the selection."""

import numpy as np
import pytest
import torch

from neurofluid_torch.ops import ball_features as bf
from neurofluid_torch.ops import fused_query as fq

# (arrays staged, per-slot state words, group size) of K3 and of K7
KERNELS = {"K3": (3, bf.N_SUMS, 32), "K7": (4, 0, fq.GROUP_SIZE)}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_walk_plan_fits_one_block_at_every_cap(kernel):
    n_arrays, state, t = KERNELS[kernel]
    for cap in range(1, 4097):
        stage, n_stages = bf.walk_plan(cap, n_arrays, t, state)
        smem = bf.walk_smem_bytes(stage, n_stages, n_arrays, t, state)
        assert smem + bf.GROUP_STATIC_BYTES <= bf.SMEM_LIMIT, cap
        assert n_stages in (1, 2) and stage >= 1
        if n_stages == 1:  # one batch holds every row at its full width
            assert stage >= 27 * cap, cap
        else:
            assert 27 * cap * 4 * n_arrays > bf.WHOLE_STAGE_BYTES, cap


def test_walk_plan_at_the_bench_point():
    """The render's cap 128 (K3) and the transition grid's cap 32 (K7) take
    one stage; cap 256 of K3 and cap 160 of K7 take the two-stage ring."""
    assert bf.walk_plan(128, 3, 32, bf.N_SUMS) == (27 * 128, 1)
    assert bf.walk_plan(32, 4, fq.GROUP_SIZE, 0) == (27 * 32, 1)
    assert bf.walk_plan(256, 3, 32, bf.N_SUMS)[1] == 2
    assert bf.walk_plan(160, 4, fq.GROUP_SIZE, 0)[1] == 2


def batches(extent, stage):
    """The (row, table slot) at each position of each batch, as
    `for_each_batch` and `stage_batch` place them."""
    scan = np.concatenate([[0], np.cumsum(extent)])
    total = int(scan[-1])
    out = []
    for lo in range(0, total, stage):
        hi = min(lo + stage, total)
        buf = [None] * (hi - lo)
        for o in range(27):  # warps take rows in any order
            for j in range(max(scan[o], lo), min(scan[o + 1], hi)):
                assert buf[j - lo] is None
                buf[j - lo] = (o, j - scan[o])
        assert None not in buf
        out.append(buf)
    return out


@pytest.mark.parametrize("stage", [1, 7, 32, 100, 27 * 40])
def test_batches_cover_every_row_in_order(stage):
    rng = np.random.default_rng(0)
    for _ in range(20):
        extent = rng.integers(0, 41, 27)
        extent[rng.uniform(size=27) < 0.2] = 0  # empty and out-of-grid rows
        flat = [p for buf in batches(extent, stage) for p in buf]
        assert flat == [(o, s) for o in range(27) for s in range(extent[o])]
        assert all(len(buf) <= stage for buf in batches(extent, stage))


def staged_select(q_rep, tx, ty, tz, gcell, dims, t, stage, within_fn, k):
    """Per packed slot: (true count, selected table positions in order),
    walking each live group's flattened list in batches of `stage`, the
    running count carried across batches. Distances in f32, in the plain
    versions' order."""
    q, tx_, ty_, tz_ = (a.numpy() for a in (q_rep, tx, ty, tz))
    cap = tx_.shape[1]
    rows = bf.neighbor_rows(gcell, dims).numpy()
    cells = dims[0] * dims[1] * dims[2]
    result = [(0, [])] * (len(gcell) * t)
    for g, c in enumerate(gcell.tolist()):
        if c >= cells:
            continue
        extent = (tx_[rows[g]] < 0.5 * bf.SENTINEL).sum(1)
        extent[rows[g] == cells] = 0
        for s in range(g * t, (g + 1) * t):
            if q[s, 0] >= 0.5 * bf.SENTINEL:
                continue  # a padded slot does not walk
            off, picked = 0, []
            for buf in batches(extent, stage):
                for o, j in buf:
                    at = rows[g, o] * cap + j
                    d = (tx_.flat[at] - q[s, 0], ty_.flat[at] - q[s, 1],
                         tz_.flat[at] - q[s, 2])
                    if within_fn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]):
                        off += 1  # the ballot rank of this candidate
                        if off <= k:
                            picked.append(at)
            result[s] = (off, picked)
    return result


def _packed(rng, n_pts, n_q, spread, radius, cap, t, exclude_self):
    lo, hi = (-0.6,) * 3, (0.6,) * 3
    pts = torch.tensor(rng.uniform(-spread, spread, (n_pts, 3)),
                       dtype=torch.float32)
    qs = pts if exclude_self else torch.tensor(
        rng.uniform(-0.5, 0.5, (n_q, 3)), dtype=torch.float32)
    grouping = bf.group_queries(qs, pts, radius, lo, hi, qs.shape[0], t)
    grid, tx, ty, tz = bf.build_tables(pts, lo, hi, radius, cap)
    q_pad = torch.cat([qs[grouping.order[:grouping.capacity]],
                       torch.full_like(qs[:1], bf.SENTINEL)])
    q_rep = q_pad[grouping.rep_idx].contiguous()
    return q_rep, grid, tx, ty, tz, grouping.gcell


@pytest.mark.parametrize("cap,stage", [(40, 27 * 40), (40, 33), (72, 100)])
def test_staged_walk_selects_as_k3_plain(cap, stage):
    """K3's selection: strict d^2 < r^2, the first k = 20 summed; the true
    and the selected counts of the emulated walk equal the plain
    version's count columns."""
    rng = np.random.default_rng(1)
    r, k, t = 0.225, 20, 32
    q_rep, grid, tx, ty, tz, gcell = _packed(rng, 700, 300, 0.3, r, cap, t,
                                             False)
    want = bf.ball_sums_plain(q_rep, tx, ty, tz, gcell, grid.dims, r, k, t)
    r2 = np.float32(r * r)
    got = staged_select(q_rep, tx, ty, tz, gcell, grid.dims, t, stage,
                        lambda d2: d2 < r2, k)
    assert int(want[:, 0].max()) > k  # truncation happens
    for s, (count, picked) in enumerate(got):
        assert count == int(want[s, 0]), s
        assert len(picked) == int(want[s, 1]), s


@pytest.mark.parametrize("cap,stage,exclude_self", [
    (32, 27 * 32, True), (32, 50, True), (40, 17, False)])
def test_staged_walk_selects_as_k7_plain(cap, stage, exclude_self):
    """K7's selection: inclusive d^2 <= r^2 (and d^2 > 0 with
    exclude_self); ids and true counts from the emulated walk equal the
    plain version's, k = 13 truncating the fuller lists."""
    rng = np.random.default_rng(2)
    r, k, t = 0.1125, 13, fq.GROUP_SIZE
    q_rep, grid, tx, ty, tz, gcell = _packed(rng, 500, 200, 0.2, r, cap, t,
                                             exclude_self)
    ti = grid.table_idx.to(torch.int32)
    idx, count = fq.ball_query_compact_plain(
        q_rep, tx, ty, tz, ti, gcell, grid.dims, r, k, t, exclude_self,
        False)
    r2 = np.float32(r * r)
    got = staged_select(
        q_rep, tx, ty, tz, gcell, grid.dims, t, stage,
        lambda d2: d2 <= r2 and not (exclude_self and d2 <= 0.0), k)
    flat_ids = ti.reshape(-1).numpy()
    assert int(count.max()) > k
    for s, (n, picked) in enumerate(got):
        assert n == int(count[s]), s
        ids = list(flat_ids[picked]) + [-1] * (k - len(picked))
        assert ids == idx[s].tolist(), s
