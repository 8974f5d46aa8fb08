"""The host side of the staged ball walk of K3, K4 and K7
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
not change the selection. K4's emulation adds its own steps (only slots
with a cotangent walk, each up to its k-th selected neighbour; the
gradient summed per staged candidate and flushed once per batch) and must
give the plain adjoint's particle gradient."""

import numpy as np
import pytest
import torch

from neurofluid_torch.ops import ball_features as bf
from neurofluid_torch.ops import fused_query as fq

# (arrays staged, per-slot state words, group size, accumulator arrays per
# staged candidate, a ring's stage bytes) of K3, K4 and K7
KERNELS = {"K3": (3, bf.N_SUMS, 32, 0, None),
           "K4": (bf.BWD_ARRAYS, bf.BWD_STATE_WORDS, 32, bf.BWD_ACC_ARRAYS,
                  bf.BWD_RING_STAGE_BYTES),
           "K7": (4, 0, fq.GROUP_SIZE, 0, None)}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_walk_plan_fits_one_block_at_every_cap(kernel):
    n_arrays, state, t, acc, ring = KERNELS[kernel]
    for cap in range(1, 4097):
        stage, n_stages = bf.walk_plan(cap, n_arrays, t, state, acc, ring)
        smem = bf.walk_smem_bytes(stage, n_stages, n_arrays, t, state, acc)
        assert smem + bf.GROUP_STATIC_BYTES <= bf.SMEM_LIMIT, cap
        assert n_stages in (1, 2) and stage >= 1
        if n_stages == 1:  # one batch holds every row at its full width
            assert stage >= 27 * cap, cap
        else:
            assert 27 * cap * 4 * (n_arrays + acc) > bf.WHOLE_STAGE_BYTES, cap


def test_walk_plan_at_the_bench_point():
    """The render's cap 128 (K3) and the transition grid's cap 32 (K7) take
    one stage; cap 256 of K3 and cap 160 of K7 take the two-stage ring. K4
    at cap 128 (seven arrays of 27 * 128) takes its own ring."""
    assert bf.walk_plan(128, 3, 32, bf.N_SUMS) == (27 * 128, 1)
    assert bf.walk_plan(32, 4, fq.GROUP_SIZE, 0) == (27 * 32, 1)
    assert bf.walk_plan(256, 3, 32, bf.N_SUMS)[1] == 2
    assert bf.walk_plan(160, 4, fq.GROUP_SIZE, 0)[1] == 2
    assert bf.bwd_walk_plan(128, 32) == (bf.BWD_RING_STAGE_BYTES // 16, 2)
    stage, n_stages = bf.bwd_walk_plan(64, 32)
    assert (stage, n_stages) == (27 * 64, 1)
    assert bf.walk_smem_bytes(stage, 1, 4, 32, 10, 3) == 4 * (
        27 * 64 * 7 + 32 * 15)


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
    pts = torch.tensor(rng.uniform(-spread, spread, (n_pts, 3)),
                       dtype=torch.float32)
    qs = pts if exclude_self else torch.tensor(
        rng.uniform(-0.5, 0.5, (n_q, 3)), dtype=torch.float32)
    return _packed_from(pts, qs, radius, cap, t)


def _packed_from(pts, qs, radius, cap, t):
    """The packed layout the walks take, every query kept: (q_rep, grid,
    tx, ty, tz, gcell)."""
    lo, hi = (-0.6,) * 3, (0.6,) * 3
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


def k4_staged(q_rep, cot_rep, tx, ty, tz, ti, gcell, dims, radius, k, t,
              stage, n_points):
    """K4's staged walk in float32 numpy: (d_points, work). Per live group
    only the slots whose query is live and whose cotangent columns 3-12
    are not all zero walk (a group with none stages nothing); each walks
    each batch 32 candidates per step, ranks from the running count carried
    across batches, and stops after the step in which its count reaches k;
    every selected pair's gradient is added into a per-candidate
    accumulator, flushed after each batch by one triple per candidate whose
    sum is not zero."""
    q, cot = q_rep.numpy(), cot_rep.numpy()
    tx_, ty_, tz_, ti_ = (a.numpy() for a in (tx, ty, tz, ti))
    cap = tx_.shape[1]
    rows = bf.neighbor_rows(gcell, dims).numpy()
    cells = dims[0] * dims[1] * dims[2]
    f32, r = np.float32, np.float32(radius)
    r2 = f32(radius * radius)
    d_points = np.zeros((n_points, 3), f32)
    work = dict(groups_staged=0, walked=0, skipped=0, steps=0, pairs=0,
                triples=0)
    for g, c in enumerate(gcell.tolist()):
        if c >= cells:
            continue
        slots = range(g * t, (g + 1) * t)
        live = [s for s in slots if q[s, 0] < 0.5 * bf.SENTINEL]
        walk = [s for s in live if np.any(cot[s, 3:] != 0.0)]
        work["skipped"] += len(live) - len(walk)
        if not walk:
            continue
        work["groups_staged"] += 1
        work["walked"] += len(walk)
        extent = (tx_[rows[g]] < 0.5 * bf.SENTINEL).sum(1)
        extent[rows[g] == cells] = 0
        count = dict.fromkeys(walk, 0)
        for buf in batches(extent, stage):
            at = np.array([rows[g, o] * cap + j for o, j in buf])
            cx, cy, cz = tx_.flat[at], ty_.flat[at], tz_.flat[at]
            acc = np.zeros((len(buf), 3), f32)
            for s in walk:
                for base in range(0, len(buf), 32):
                    if count[s] >= k:
                        break
                    work["steps"] += 1
                    j = np.arange(base, min(base + 32, len(buf)))
                    dx = cx[j] - q[s, 0]
                    dy = cy[j] - q[s, 1]
                    dz = cz[j] - q[s, 2]
                    d2 = dx * dx + dy * dy + dz * dz
                    within = d2 < r2
                    rank = count[s] + np.cumsum(within)
                    count[s] += int(within.sum())
                    sel = within & (rank <= k)
                    if not sel.any():
                        continue
                    work["pairs"] += int(sel.sum())
                    gc = cot[s, 3:]
                    dx, dy, dz, d2 = dx[sel], dy[sel], dz[sel], d2[sel]
                    rx, ry, rz = cx[j][sel], cy[j][sel], cz[j][sel]
                    d = np.sqrt(np.maximum(d2, f32(1e-24)))
                    u = d / r
                    base_w = f32(1.0) - u * u * u
                    w = np.maximum(base_w, f32(0.0))
                    coef = np.where((base_w > 0) & (d2 > f32(1e-24)),
                                    f32(-3.0) * u * u / (r * d), f32(0.0))
                    a = (gc[0] + gc[1] * rx + gc[2] * ry + gc[3] * rz) * coef
                    nn = d2 > 0
                    grad = np.stack([
                        a * dx + w * gc[1] + nn * (gc[4] + f32(2) * gc[7] * dx),
                        a * dy + w * gc[2] + nn * (gc[5] + f32(2) * gc[8] * dy),
                        a * dz + w * gc[3] + nn * (gc[6] + f32(2) * gc[9] * dz),
                    ], -1).astype(f32)
                    np.add.at(acc, j[sel], grad)
            flushed = np.any(acc != 0.0, axis=1)
            work["triples"] += int(flushed.sum())
            np.add.at(d_points, ti_.flat[at][flushed], acc[flushed])
    return d_points, work


def _clusters(rng, n, centers, spread):
    pts = centers[rng.integers(0, len(centers), n)]
    return np.clip(pts + rng.normal(size=(n, 3)) * spread, -0.55, 0.55)


# stage: the whole 27 rows at cap 40, or batches of 33 and 61 candidates
@pytest.mark.parametrize("stage", [27 * 40, 33, 61])
def test_k4_staged_walk_matches_plain_adjoint(stage):
    """Particles in two clusters and queries across the box: some live
    groups find no candidate in their 27 rows, some queries lie apart from
    every particle, a third of the queries carry a zero cotangent, and the
    fuller lists pass k = 20. The emulated K4 gives the plain adjoint's
    d_points within 1e-5 of its largest entry (sums in another order), and
    one flushed triple per group and distinct selected candidate."""
    rng = np.random.default_rng(9)
    r, k, t, cap = 0.225, 20, 32, 40
    centers = np.array([[-0.35, -0.35, -0.35], [0.3, 0.25, 0.3]])
    pts = torch.tensor(_clusters(rng, 600, centers, 0.06), dtype=torch.float32)
    qs = torch.tensor(rng.uniform(-0.55, 0.55, (400, 3)), dtype=torch.float32)
    qs[:4] = pts[:4]  # d == 0 pairs
    q_rep, grid, tx, ty, tz, gcell = _packed_from(pts, qs, r, cap, t)
    ti = grid.table_idx.to(torch.int32)
    cot = rng.normal(size=(q_rep.shape[0], bf.N_SUMS)).astype(np.float32)
    cot[q_rep[:, 0].numpy() > 5e8] = 0.0  # padded slots carry none
    cot[rng.uniform(size=len(cot)) < 0.33, 3:] = 0.0
    cot_rep = torch.from_numpy(cot)
    want = bf.ball_sums_bwd_plain(q_rep, cot_rep, tx, ty, tz, ti, gcell,
                                  grid.dims, r, k, t, len(pts)).numpy()
    got, work = k4_staged(q_rep, cot_rep, tx, ty, tz, ti, gcell, grid.dims,
                          r, k, t, stage, len(pts))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 1.0

    # the layout holds every case the kernel must survive
    cells = grid.dims[0] * grid.dims[1] * grid.dims[2]
    in_cell = gcell.numpy() < cells
    occupied = (tx < 0.5 * bf.SENTINEL).sum(1)
    extent = occupied[bf.neighbor_rows(gcell, grid.dims)].sum(1).numpy()
    assert (extent[in_cell] == 0).any()  # live groups with no candidate
    assert (~in_cell).any() and work["skipped"] > 0
    sums = bf.ball_sums_plain(q_rep, tx, ty, tz, gcell, grid.dims, r, k, t)
    walked = torch.from_numpy(np.any(cot[:, 3:] != 0, axis=1))
    assert float(sums[:, 0].max()) > k
    assert int(((sums[:, 0] == 0) & walked).sum()) > 0  # apart from all
    assert work["pairs"] == int((sums[:, 1] * walked).sum())

    # one triple per (group, selected candidate): the distinct candidates
    # that the group's walked slots select
    rows = bf.neighbor_rows(gcell, grid.dims)
    distinct = 0
    for g in np.flatnonzero(in_cell):
        qg = q_rep.reshape(-1, t, 3)[g:g + 1]
        rc = rows[g:g + 1]
        *_, sel = bf._select(qg, tx[rc][:, None], ty[rc][:, None],
                             tz[rc][:, None], float(np.float32(r * r)), k)
        sel = sel & walked.reshape(-1, t)[g][None, :, None, None]
        distinct += int(sel.any(1).sum())
    assert work["triples"] <= distinct < work["pairs"]
    assert work["triples"] >= distinct - 3  # a sum of exactly zero is rare
