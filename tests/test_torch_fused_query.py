"""Port parity: the compact ball query (`neurofluid_torch.ops.fused_query`,
K7's plain version on the CPU) against neurofluid_tpu.ops.fused_query, both
its Pallas kernel in interpret mode (asked for by name: on the CPU
backend="auto" picks "xla") and its XLA composition. The same clustered
clouds as tests/test_fused_query.py, from one numpy seed fed to both.

ids, masks, counts and the overflow flag are integers and must be equal;
the emitted coordinates are copies of table entries (atol 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.ops import fused_query as jfq
from neurofluid_tpu.ops import neighbor_search as jns
from neurofluid_torch.ops import ball_features as tbf
from neurofluid_torch.ops import fused_query as tfq
from neurofluid_torch.ops import neighbor_search as tns

LOWER = (-1.05, -1.05, -1.05)
UPPER = (1.05, 1.05, 1.05)
RADIUS = 0.1125


def _cloud(rng, n=600, spread=0.5):
    centers = rng.uniform(-spread, spread, (8, 3))
    pts = (centers[rng.integers(0, 8, n)]
           + rng.normal(size=(n, 3)) * 0.08).astype(np.float32)
    return np.clip(pts, -1.0, 1.0)


def _both(points, queries, k, cap=32, **kw):
    """(port NeighborList, overflow), (JAX pallas), (JAX xla) on one input."""
    tgrid = tns.build_cell_grid(torch.from_numpy(points), LOWER, UPPER,
                                RADIUS, cap)
    t = tfq.ball_query_compact(torch.from_numpy(queries), tgrid, RADIUS, k,
                               **kw)
    jgrid = jns.build_cell_grid(jnp.asarray(points), LOWER, UPPER, RADIUS,
                                max_per_cell=cap)
    js = [jfq.ball_query_compact(jnp.asarray(queries), jgrid, LOWER, UPPER,
                                 RADIUS, k, backend=b, **kw)
          for b in ("pallas", "xla")]
    return t, js


def _assert_lists_equal(t, j, emit_xyz):
    (tn, tov), (jn, jov) = t, j
    assert tn.idx.dtype == torch.int32 and tn.count.dtype == torch.int32
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(tn.mask.numpy(), np.asarray(jn.mask))
    np.testing.assert_array_equal(tn.count.numpy(), np.asarray(jn.count))
    assert bool(tov) == bool(jov)
    # f32 differences of the same operands, summed in the same order
    np.testing.assert_allclose(tn.sq_dists.numpy(), np.asarray(jn.sq_dists),
                               rtol=0, atol=1e-7)
    if emit_xyz:
        for a, b in zip(tn.xyz, jn.xyz):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=0)
    else:
        assert tn.xyz is None and jn.xyz is None


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("emit_xyz", [False, True])
def test_compact_query_matches_jax(rng, exclude_self, emit_xyz):
    points = _cloud(rng)
    queries = points if exclude_self else _cloud(rng, n=256)
    t, js = _both(points, queries, 48, exclude_self=exclude_self,
                  emit_xyz=emit_xyz)
    assert not bool(t[1])
    assert 0 < int(t[0].count.max())
    for j in js:
        _assert_lists_equal(t, j, emit_xyz)
    if exclude_self:  # no particle lists itself
        own = torch.arange(len(points), dtype=torch.int32)[:, None]
        assert not bool((t[0].idx == own).any())


def test_truncation_keeps_first_k_and_true_count(rng):
    """k = 4 at cap 128: most neighbourhoods overflow the list, the count
    stays the true one, and the kept ids are the first four in (cell
    offset, table slot) order, as in JAX."""
    points = _cloud(rng, n=400, spread=0.1)
    t, js = _both(points, points, 4, cap=128, exclude_self=True)
    for j in js:
        _assert_lists_equal(t, j, False)
    nb = t[0]
    assert int((nb.count > 4).sum()) > 100
    np.testing.assert_array_equal(nb.mask.sum(1).numpy(),
                                  np.minimum(nb.count.numpy(), 4))


def test_far_and_out_of_aabb_queries(rng):
    points = _cloud(rng)
    far = np.asarray([[50.0, 50.0, 50.0], [0.0, 0.0, 0.0],
                      [-1.04, -1.04, -1.04]], np.float32)
    t, js = _both(points, far, 16)
    for j in js:
        _assert_lists_equal(t, j, False)
    assert int(t[0].count[0]) == 0 and bool((t[0].idx[0] == -1).all())


def test_overflow_flags_match_jax(rng):
    """A cell fuller than its cap, and more groups than `max_occupied_cells`
    allows: both raise the flag, as in JAX."""
    points = _cloud(rng, n=400, spread=0.1)
    t, js = _both(points, points, 16, cap=8, exclude_self=True)
    assert bool(t[1]) and all(bool(j[1]) for j in js)
    np.testing.assert_array_equal(t[0].count.numpy(),
                                  np.asarray(js[0][0].count))
    spread_out = _cloud(rng, n=600, spread=0.9)
    t, js = _both(spread_out, spread_out, 16, exclude_self=True,
                  max_occupied_cells=8)
    assert bool(t[1]) and all(bool(j[1]) for j in js)


def test_group_queries_max_groups_matches_jax(rng):
    from neurofluid_tpu.ops import ball_features as jbf
    points = _cloud(rng)
    for max_groups in (None, 300, 40):
        tg = tbf.group_queries(torch.from_numpy(points),
                               torch.from_numpy(points), RADIUS, LOWER, UPPER,
                               capacity=600, group_size=8,
                               max_groups=max_groups)
        jg = jbf.group_queries(jnp.asarray(points), jnp.asarray(points),
                               RADIUS, LOWER, UPPER, capacity=600,
                               group_size=8, max_groups=max_groups)
        assert tg.n_groups == jg.n_groups
        np.testing.assert_array_equal(tg.gcell.numpy(), np.asarray(jg.gcell))
        np.testing.assert_array_equal(tg.rep_idx.numpy(),
                                      np.asarray(jg.rep_idx))
        np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
        assert bool(tg.cull_overflow) == bool(jg.cull_overflow)
    assert bool(tg.cull_overflow)  # 40 groups cannot hold 600 queries
