"""Port parity: the plain neighbour searches (`radius_search_brute`,
`radius_search_grid`, `radius_search`, `gather_neighbor_positions`) against
neurofluid_tpu.ops.neighbor_search, and ParticleNet's search routing
(`'auto'`, `'grid'`, `'brute'`, and a passed grid) against the JAX model's
`_search`. Same numpy inputs through both packages, f32 on the CPU.

The selection must reproduce `lax.top_k`'s order, ties included, so ids,
masks and counts are held equal, slot by slot; the squared distances are
recomputed from the same ids in the same f32 order, so they are held equal
too. Search only: the train step on these backends is held in
tests/test_torch_transition_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.models import particle_net as jpn
from neurofluid_tpu.ops import neighbor_search as jns
from neurofluid_torch.models import particle_net as tpn
from neurofluid_torch.ops import neighbor_search as tns

LO, HI = (-0.6, -0.6, -0.6), (0.6, 0.6, 0.6)


def _cloud(rng, n_points=300, n_queries=123):
    """Uniform points, queries with five of them on points (d^2 = 0), one
    query with a point exactly at distance 0.25 along x (d^2 == r^2 in
    f32), and one at the origin with six points at 0.15 on the axes (an
    exact six-way tie) and others farther out."""
    pts = rng.uniform(-0.5, 0.5, (n_points, 3)).astype(np.float32)
    q = rng.uniform(-0.55, 0.55, (n_queries, 3)).astype(np.float32)
    q[:5] = pts[:5]
    q[5] = (0.125, -0.25, 0.0625)  # exact in f32, and so is the offset
    pts[10] = q[5] + np.asarray([0.25, 0.0, 0.0], np.float32)
    q[6] = 0.0
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    pts[20:26] = 0.15 * axes
    return pts, q


def _assert_lists_equal(t, j):
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    np.testing.assert_array_equal(t.sq_dists.detach().numpy(),
                                  np.asarray(j.sq_dists))
    assert t.idx.dtype == torch.int32 and t.count.dtype == torch.int32
    assert bool((t.idx[~t.mask] == -1).all())
    assert bool((t.sq_dists[~t.mask] == 0).all())


def _both(fn_t, fn_j, *arrays):
    return (fn_t(*(torch.from_numpy(a) for a in arrays)),
            fn_j(*(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("order", ["nearest", "index"])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_brute_matches_jax(order, inclusive, exclude_self):
    """Q = 123 in chunks of 50 (the last one short); k 16 with neighbourhoods
    above and below it."""
    pts, q = _cloud(np.random.default_rng(1))
    kw = dict(order=order, inclusive=inclusive, exclude_self=exclude_self,
              query_chunk=50)
    t, j = _both(lambda a, b: tns.radius_search_brute(a, b, 0.25, 16, **kw),
                 lambda a, b: jns.radius_search_brute(a, b, 0.25, 16, **kw),
                 q, pts)
    _assert_lists_equal(t, j)
    counts = t.count.numpy()
    assert counts.max() > 16 and (counts < 16).any()
    # the point at exactly r: counted only when inclusive
    other = tns.radius_search_brute(torch.from_numpy(q), torch.from_numpy(pts),
                                    0.25, 16, **dict(kw, inclusive=not inclusive))
    assert int(t.count[5] - other.count[5]) == (1 if inclusive else -1)
    # the five queries on points: themselves a neighbour unless excluded
    # (the nearest, and of the lowest ids)
    for i in range(5):
        assert (i in t.idx[i].tolist()) == (not exclude_self)


@pytest.mark.parametrize("order", ["nearest", "index"])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_grid_matches_jax(order, exclude_self):
    """The grid search against JAX's on the same tables: ids slot by slot
    (candidates in cell order, then slot order), overflow False; and the
    same sets as brute force wherever no neighbourhood passes k."""
    pts, q = _cloud(np.random.default_rng(2))
    gt = tns.build_cell_grid(torch.from_numpy(pts), LO, HI, 0.25, 32)
    gj = jns.build_cell_grid(jnp.asarray(pts), LO, HI, 0.25, 32)
    kw = dict(order=order, exclude_self=exclude_self, query_chunk=50)
    t, ov_t = tns.radius_search_grid(torch.from_numpy(q), gt, 0.25, 64, **kw)
    j, ov_j = jns.radius_search_grid(jnp.asarray(q), gj, 0.25, 64, **kw)
    _assert_lists_equal(t, j)
    assert bool(ov_t) == bool(ov_j) is False
    b = tns.radius_search_brute(torch.from_numpy(q), torch.from_numpy(pts),
                                0.25, 64, **kw)
    assert int(b.count.max()) <= 64
    np.testing.assert_array_equal(t.count.numpy(), b.count.numpy())
    for row_t, row_b in zip(t.idx.tolist(), b.idx.tolist()):
        assert sorted(row_t) == sorted(row_b)
    if order == "index":  # the first k by index: the same list as brute
        np.testing.assert_array_equal(t.idx.numpy(), b.idx.numpy())


@pytest.mark.parametrize("search", ["brute", "grid"])
@pytest.mark.parametrize("k", [4, 5])
def test_exact_tie_at_the_kth_slot(search, k):
    """Six points at exactly the same distance from the query at the
    origin: with k = 4 (or 5) the tie is cut at the k-th slot, and both
    packages keep the same ones, in the same slots (`lax.top_k`: the lower
    candidate position first)."""
    pts, q = _cloud(np.random.default_rng(3))
    far = np.linalg.norm(pts, axis=1) > 0.2
    far[20:26] = True
    pts = np.where(far[:, None], pts, 0.45).astype(np.float32)
    if search == "brute":
        t, j = _both(lambda a, b: tns.radius_search_brute(a, b, 0.2, k),
                     lambda a, b: jns.radius_search_brute(a, b, 0.2, k),
                     q, pts)
    else:
        gt = tns.build_cell_grid(torch.from_numpy(pts), LO, HI, 0.2, 64)
        gj = jns.build_cell_grid(jnp.asarray(pts), LO, HI, 0.2, 64)
        t, _ = tns.radius_search_grid(torch.from_numpy(q), gt, 0.2, k)
        j, _ = jns.radius_search_grid(jnp.asarray(q), gj, 0.2, k)
    _assert_lists_equal(t, j)
    assert int(t.count[6]) == 6
    assert set(t.idx[6].tolist()) < set(range(20, 26))
    d = t.sq_dists[6]
    assert bool((d == d[0]).all())  # an exact tie, not a near one


@pytest.mark.parametrize("search", ["brute", "grid"])
def test_k_above_the_candidates(search):
    """k larger than the candidate axis (8 points; 27 cells of 1 slot):
    the lists pad with -1 and 0, as JAX's."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.3, 0.3, (8, 3)).astype(np.float32)
    q = rng.uniform(-0.3, 0.3, (7, 3)).astype(np.float32)
    if search == "brute":
        t, j = _both(lambda a, b: tns.radius_search_brute(a, b, 0.5, 40),
                     lambda a, b: jns.radius_search_brute(a, b, 0.5, 40),
                     q, pts)
    else:
        gt = tns.build_cell_grid(torch.from_numpy(pts), LO, HI, 0.5, 1)
        gj = jns.build_cell_grid(jnp.asarray(pts), LO, HI, 0.5, 1)
        t, ov_t = tns.radius_search_grid(torch.from_numpy(q), gt, 0.5, 40)
        j, ov_j = jns.radius_search_grid(jnp.asarray(q), gj, 0.5, 40)
        assert bool(ov_t) == bool(ov_j) is True  # 8 points, 1 slot a cell
    _assert_lists_equal(t, j)
    assert t.idx.shape == (7, 40) and int(t.mask.sum(1).max()) <= 8


def test_grid_overflow_flag():
    """A cell over its cap: the tail is dropped from the tables, the flag
    is raised, and the lists are JAX's all the same."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0.0, 0.05, (40, 3)).astype(np.float32)
    q = pts[:6]
    gt = tns.build_cell_grid(torch.from_numpy(pts), (0, 0, 0), (1, 1, 1), 0.2,
                             4)
    gj = jns.build_cell_grid(jnp.asarray(pts), (0, 0, 0), (1, 1, 1), 0.2, 4)
    t, ov_t = tns.radius_search_grid(torch.from_numpy(q), gt, 0.2, 8)
    j, ov_j = jns.radius_search_grid(jnp.asarray(q), gj, 0.2, 8)
    assert bool(ov_t) and bool(ov_j)
    _assert_lists_equal(t, j)
    assert int(t.count.max()) <= 4  # only the kept tail was searched


@pytest.mark.parametrize("emit_xyz", [False, True])
def test_sq_dists_gradient_matches_jax(emit_xyz):
    """Only the squared distances carry a gradient, to the points and the
    queries; the same as JAX's recompute (f32 sums of <= 16 terms)."""
    pts, q = _cloud(np.random.default_rng(6), 120, 40)
    w = np.random.default_rng(7).normal(size=(40, 16)).astype(np.float32)
    gt = tns.build_cell_grid(torch.from_numpy(pts), LO, HI, 0.25, 32)
    pt = torch.from_numpy(pts).requires_grad_(True)
    qt = torch.from_numpy(q).requires_grad_(True)
    gt = gt._replace(points=pt)
    t, _ = tns.radius_search_grid(qt, gt, 0.25, 16, emit_xyz=emit_xyz)
    (t.sq_dists * torch.from_numpy(w)).sum().backward()

    def loss(p, qq):
        g = jns.build_cell_grid(p, LO, HI, 0.25, 32)
        r, _ = jns.radius_search_grid(qq, g, 0.25, 16, emit_xyz=emit_xyz)
        return (r.sq_dists * w).sum()

    dp, dq = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(q))
    assert (t.xyz is not None) == emit_xyz
    for got, want in ((pt.grad, dp), (qt.grad, dq)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_radius_search_and_gathered_positions():
    """`radius_search` is the brute search; gathered neighbour positions
    are the points at the ids and exactly 0 at padded slots."""
    pts, q = _cloud(np.random.default_rng(8))
    t, j = _both(lambda a, b: tns.radius_search(a, b, 0.2, 8),
                 lambda a, b: jns.radius_search(a, b, 0.2, 8), q, pts)
    _assert_lists_equal(t, j)
    got = tns.gather_neighbor_positions(torch.from_numpy(pts), t)
    want = jns.gather_neighbor_positions(jnp.asarray(pts), j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[~t.mask] == 0).all()) and bool((~t.mask).any())


def test_approximate_selection_is_refused():
    """selection='approx' is no longer refused: it is the exact selection,
    slot for slot the port's 'sort' and JAX's 'approx' (whose
    `lax.approx_max_k` is exact off the TPU), on both searches and in
    both orders; an unknown selection is refused."""
    pts, q = _cloud(np.random.default_rng(9))
    grid_t = tns.build_cell_grid(torch.from_numpy(pts), LO, HI, 0.25, 64)
    grid_j = jns.build_cell_grid(jnp.asarray(pts), LO, HI, 0.25,
                                 max_per_cell=64)
    for order in ("index", "nearest"):
        kw = dict(order=order, query_chunk=50)
        t, j = _both(
            lambda a, b: tns.radius_search_brute(a, b, 0.25, 8,
                                                 selection="approx", **kw),
            lambda a, b: jns.radius_search_brute(a, b, 0.25, 8,
                                                 selection="approx", **kw),
            q, pts)
        _assert_lists_equal(t, j)
        exact = tns.radius_search_brute(torch.from_numpy(q),
                                        torch.from_numpy(pts), 0.25, 8,
                                        selection="sort", **kw)
        assert torch.equal(exact.idx, t.idx)
        tg, _ = tns.radius_search_grid(torch.from_numpy(q), grid_t, 0.25, 8,
                                       selection="approx", **kw)
        jg, _ = jns.radius_search_grid(jnp.asarray(q), grid_j, 0.25, 8,
                                       selection="approx", **kw)
        _assert_lists_equal(tg, jg)
        assert int(t.count.max()) > 8
    with pytest.raises(ValueError, match="unknown selection"):
        tns.radius_search_brute(torch.from_numpy(q), torch.from_numpy(pts),
                                0.25, 8, selection="topk")


def _spy(monkeypatch, module, ran):
    """Record which of `module`'s two plain searches runs."""
    for name in ("radius_search_grid", "radius_search_brute"):
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            ran.append(_name.rsplit("_", 1)[1])
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("backend,n_points,pass_grid,want", [
    ("auto", 4095, False, "brute"), ("auto", 4096, False, "grid"),
    ("auto", 200, True, "grid"), ("brute", 200, True, "grid"),
    ("brute", 4096, False, "brute"), ("grid", 200, False, "grid")])
def test_search_routing_matches_jax(monkeypatch, backend, n_points,
                                    pass_grid, want):
    """'auto' takes the grid from 4,096 searched points on, and a passed
    grid sends any search to the grid (the quirk that, under 'auto', sends
    a small box to the grid and a small fluid to brute force): the same
    search runs in both packages' `_search`, with the same lists."""
    rng = np.random.default_rng(n_points)
    pts = rng.uniform(-0.5, 0.5, (n_points, 3)).astype(np.float32)
    q = pts[:12].copy()
    kw = dict(grid_lower=LO, grid_upper=HI, grid_max_per_cell=256)
    tnet = tpn.ParticleNet(device="cpu", search_backend=backend, **kw)
    jnet = jpn.ParticleNet(search_backend=backend, **kw)
    assert tnet.search_route(n_points, object() if pass_grid else None) \
        == want
    ran_t, ran_j = [], []
    _spy(monkeypatch, tns, ran_t)
    _spy(monkeypatch, jns, ran_j)
    grid_t = tnet.make_grid(torch.from_numpy(pts)) if pass_grid else None
    grid_j = jnet.make_grid(jnp.asarray(pts)) if pass_grid else None
    t, ov_t = tnet._search(torch.from_numpy(q), torch.from_numpy(pts), 16,
                           True, grid=grid_t)
    j, ov_j = jnet._search(jnp.asarray(q), jnp.asarray(pts), jnet.filter_extent
                           / 2.0, 16, True, grid=grid_j)
    assert ran_t == ran_j == [want]
    assert bool(ov_t) == bool(ov_j) is False
    _assert_lists_equal(t, j)


def test_box_plan_per_backend():
    """The box's search structure: a grid on the list backends that search
    by grid, none on 'brute' (the JAX trainers pass no grid there)."""
    box = torch.zeros((8, 3))
    for backend, kind in (("grid", tns.CellGrid), ("auto", tns.CellGrid),
                          ("fused", tns.CellGrid), ("brute", type(None))):
        net = tpn.ParticleNet(device="cpu", search_backend=backend)
        assert isinstance(net.make_box_plan(box), kind), backend
