"""Port parity: RenderNet's list path (`search_mode='list'`) and the searches
under it, `radius_search_grid_culled` and `ball_query`, against
neurofluid_tpu (same seeded numpy inputs, f32 on the CPU).

The searches' ids, masks, counts, squared distances and flags are held
equal. The list render runs at test_torch_render_options.py's small size
(8 rays, 16 + 16 samples, NeRF D=6 W=32) on 'brute' and on 'grid' (the
coarse pass behind the AABB cull), with selection 'approx' and 'sort'
(both exact in the port; JAX's `lax.approx_max_k` is exact on the CPU):
the forward within 1e-4 (depth 2e-4), the particles' gradient within 1e-4
of its largest entry, and that gradient reaches the segment sum (K8 on
the card) through `take_rows_planned`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.ops import neighbor_search as jns
from neurofluid_torch.ops import neighbor_search as tns
from neurofluid_torch.ops import segment_ops
from test_torch_render_options import assert_close, nets

LO, HI = (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)
RADIUS = 0.225


def _lists_equal(t, j):
    for name in ("idx", "mask", "count", "sq_dists"):
        np.testing.assert_array_equal(getattr(t, name).detach().numpy(),
                                      np.asarray(getattr(j, name)), name)
    assert t.idx.dtype == torch.int32 and t.count.dtype == torch.int32
    if j.xyz is not None:
        m = t.mask.numpy()
        for a, b in zip(t.xyz, j.xyz):
            np.testing.assert_array_equal(a.numpy()[m], np.asarray(b)[m])


def _culled_case(rng):
    """Points in a blob and queries around it: about a third of the
    queries lie inside the points' AABB (+ radius)."""
    pts = rng.uniform(-0.25, 0.25, (300, 3)).astype(np.float32)
    q = rng.uniform(-0.7, 0.7, (700, 3)).astype(np.float32)
    q[:5] = pts[:5]
    return pts, q


@pytest.mark.parametrize("capacity,want_flag", [(512, False), (120, True)])
@pytest.mark.parametrize("order,inclusive,emit_xyz", [
    ("index", False, False), ("nearest", True, True)])
def test_radius_search_grid_culled_matches_jax(capacity, want_flag, order,
                                               inclusive, emit_xyz):
    """Ids, masks, counts and squared distances slot by slot, and the flag;
    at capacity 120 more queries lie inside than are searched, the flag
    rises and the queries past the capacity come back empty, as in JAX."""
    pts, q = _culled_case(np.random.default_rng(3))
    kw = dict(capacity=capacity, order=order, inclusive=inclusive,
              query_chunk=128, emit_xyz=emit_xyz)
    tgrid = tns.build_cell_grid(torch.from_numpy(pts), LO, HI, RADIUS, 64)
    jgrid = jns.build_cell_grid(jnp.asarray(pts), LO, HI, RADIUS,
                                max_per_cell=64)
    t, t_flag = tns.radius_search_grid_culled(torch.from_numpy(q), tgrid,
                                              RADIUS, 20, **kw)
    j, j_flag = jns.radius_search_grid_culled(jnp.asarray(q), jgrid, RADIUS,
                                              20, **kw)
    _lists_equal(t, j)
    assert bool(t_flag) == bool(j_flag) == want_flag
    lo, hi = pts.min(0) - RADIUS, pts.max(0) + RADIUS
    n_inside = int(np.all((q >= lo) & (q <= hi), axis=-1).sum())
    assert 120 < n_inside < 512 and int(t.count.max()) > 20
    # with room for every inside query, the cull changes nothing
    if not want_flag:
        full, _ = tns.radius_search_grid(torch.from_numpy(q), tgrid, RADIUS,
                                         20, order=order, inclusive=inclusive)
        assert torch.equal(full.idx, t.idx) and torch.equal(full.count,
                                                            t.count)


def test_ball_query_matches_jax():
    """pytorch3d's ball query: the first 20 by index at d^2 < r^2."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.3, 0.3, (500, 3)).astype(np.float32)
    q = rng.uniform(-0.4, 0.4, (90, 3)).astype(np.float32)
    q[0] = pts[7] + np.asarray([RADIUS, 0.0, 0.0], np.float32)
    t = tns.ball_query(torch.from_numpy(q), torch.from_numpy(pts), RADIUS, 20,
                       query_chunk=32)
    j = jns.ball_query(jnp.asarray(q), jnp.asarray(pts), RADIUS, 20,
                       query_chunk=32)
    _lists_equal(t, j)
    sel = t.idx[t.mask].reshape(-1)
    assert int(t.count.max()) > 20 and bool((sel >= 0).all())
    # the first by index: each full row is ascending
    assert bool((t.idx[:, 1:] > t.idx[:, :-1])[t.mask[:, 1:]].all())


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(10)
    particles = rng.uniform(-0.3, 0.3, (400, 3)).astype(np.float32)
    ro = np.asarray([0.0, 0.05, 2.0], np.float32)
    o = np.tile(ro, (8, 1))
    d = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (8, 1))
    d[:, 0] += np.linspace(-0.12, 0.12, 8, dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return particles, ro, np.concatenate([o, d], -1).astype(np.float32)


def _weights(out):
    """Fixed random weights of the loss over rgb0 and rgb1."""
    rng = np.random.default_rng(5)
    return {k: rng.normal(size=np.shape(out[k])).astype(np.float32)
            for k in ("rgb0", "rgb1")}


@pytest.mark.parametrize("backend", ["brute", "grid"])
@pytest.mark.parametrize("selection", ["approx", "sort"])
def test_list_render_and_particle_gradient_match_jax(scene, monkeypatch,
                                                     backend, selection):
    particles, ro, rays = scene
    kw = dict(search_mode="list", search_backend=backend,
              search_selection=selection, query_chunk=64)
    jnet, params, tnet = nets(**kw)

    def run_j(p):
        return jnet.apply(params, p, jnp.asarray(ro), jnp.asarray(rays))

    out_j = run_j(jnp.asarray(particles))
    cot = _weights(out_j)

    def loss_j(p):
        out = run_j(p)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot)

    grad_j = np.asarray(jax.grad(loss_j)(jnp.asarray(particles)))

    sums = []
    plain = segment_ops.segment_sum_plain
    monkeypatch.setattr(segment_ops, "segment_sum_plain",
                        lambda v, plan: sums.append(v.shape) or plain(v, plan))
    p_t = torch.from_numpy(particles).requires_grad_(True)
    out_t = tnet(p_t, torch.from_numpy(ro), torch.from_numpy(rays))
    loss_t = sum((out_t[k] * torch.from_numpy(cot[k])).sum() for k in cot)
    loss_t.backward()
    assert_close({k: v.detach() for k, v in out_t.items()}, out_j)
    assert 0 < int(out_t["mask_0"].sum()) < 8 * 16
    top = np.abs(grad_j).max()
    assert top > 0
    np.testing.assert_allclose(p_t.grad.numpy(), grad_j, rtol=0,
                               atol=1e-4 * top)
    # one segment sum per pass: the adjoint of its (R * S * K, 3) gather
    assert sums == [(8 * 16 * 20, 3), (8 * 16 * 20, 3)]


@pytest.mark.parametrize("n_points,want", [(4095, False), (4096, True)])
def test_list_backend_auto_routes_as_jax(n_points, want):
    """'auto' builds the shared grid from 4,096 particles on, as JAX's
    `_shared_grid` does."""
    pts = np.random.default_rng(6).uniform(-0.4, 0.4, (n_points, 3)).astype(
        np.float32)
    jnet, _, tnet = nets(search_mode="list", search_backend="auto")
    got = tnet._shared_grid(torch.from_numpy(pts))
    assert (got is not None) == want
    assert (jnet._shared_grid(jnp.asarray(pts)) is not None) == want
    if want:
        jgrid = jnet.build_grid(jnp.asarray(pts))
        np.testing.assert_array_equal(got.table_idx.numpy(),
                                      np.asarray(jgrid.table_idx))


def test_list_render_takes_a_passed_grid(scene):
    """A grid passed to the call is the one searched (the chunked
    full-image render builds it once per frame); the dense path ignores
    it, as JAX's does."""
    args = [torch.from_numpy(a) for a in scene]
    _, _, tnet = nets(search_mode="list", search_backend="grid")
    grid = tnet.build_grid(args[0])
    with torch.no_grad():
        a = tnet(*args)
        b = tnet(*args, grid=grid)
        # a grid of other particles: the search reads it, not `particles`
        moved = tnet(*args, grid=tnet.build_grid(args[0] + 0.05))
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a["num_nn_0"], moved["num_nn_0"])
