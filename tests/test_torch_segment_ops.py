"""Port parity: the segment sum (`neurofluid_torch.ops.segment_ops`, K8's
plain version on the CPU) and the gathers whose adjoint it is, against
neurofluid_tpu.ops.segment_ops with its Pallas accumulate kernel in
interpret mode, and against torch autograd of a plain index gather.

Tolerance: f32 sums of up to ~30 rows per segment in another order, held at
1e-5 of the largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.ops import segment_ops as jso
from neurofluid_torch.ops import segment_ops as tso


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,c,n,lo", [(5000, 96, 337, -1), (777, 8, 50, 0),
                                      (1000, 3, 64, -1), (1000, 4, 64, -1)])
def test_segment_sum_plain_matches_jax_accumulate(m, c, n, lo):
    """Also a ragged tail (m no multiple of the Pallas block) and trash ids
    (-1, sent to row n by both)."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(m, c)).astype(np.float32)
    idx = rng.integers(lo, n, size=(m,)).astype(np.int32)
    want = jso.segment_sum_accumulate(
        jnp.asarray(vals), jnp.asarray(np.where(idx < 0, n, idx)), n,
        block=256, streams=4)
    plan = tso.AdjointPlan(torch.from_numpy(idx), n)
    got = tso.segment_sum_accumulate(torch.from_numpy(vals), plan)
    assert got.shape == (n, c)
    _close(got.numpy(), want)
    # the plan K8 reads: the slots grouped by id, natural order inside
    order, starts = plan.order.numpy(), plan.starts.numpy()
    ids = plan.ids.numpy()
    assert (np.diff(ids[order]) >= 0).all()
    for s in (0, n // 2, n - 1):
        seg = order[starts[s]:starts[s + 1]]
        np.testing.assert_array_equal(seg, np.nonzero(ids == s)[0])
    _close(tso.segment_sum_sorted(torch.from_numpy(vals),
                                  torch.from_numpy(idx), n).numpy(),
           jso.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(idx), n))


def test_take_rows_planned_gradient_matches_jax_and_autograd(monkeypatch):
    monkeypatch.setenv("NF_SEGSUM_PALLAS", "1")
    rng = np.random.default_rng(2)
    n, c, q, k = 200, 32, 150, 12
    table = rng.normal(size=(n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(q, k)).astype(np.int32)
    idx[rng.uniform(size=idx.shape) < 0.25] = -1  # padding slots
    mask = idx >= 0
    ct = rng.normal(size=(q, k, c)).astype(np.float32)

    # JAX, as its callers do: ids clamped to row 0, the rows masked after
    safe = jnp.maximum(jnp.asarray(idx), 0)
    jplan = jso.adjoint_plan(safe, n)

    def jloss(t):
        rows = jso.take_rows_planned(t, safe, jplan.order, jplan.starts)
        return jnp.sum(jnp.where(jnp.asarray(mask)[..., None], rows, 0.0)
                       * jnp.asarray(ct))

    out_j = jnp.where(jnp.asarray(mask)[..., None],
                      jnp.asarray(table)[safe], 0.0)
    g_j = jax.grad(jloss)(jnp.asarray(table))

    t = torch.from_numpy(table).requires_grad_(True)
    tidx = torch.from_numpy(idx)
    out = tso.take_rows_planned(t, tidx, tso.AdjointPlan(tidx, n))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    g, = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), t)
    _close(g.numpy(), g_j)

    t2 = torch.from_numpy(table).requires_grad_(True)
    rows = t2[torch.from_numpy(np.maximum(idx, 0)).long()]
    rows = torch.where(torch.from_numpy(mask)[..., None], rows, 0.0)
    g2, = torch.autograd.grad((rows * torch.from_numpy(ct)).sum(), t2)
    _close(g.numpy(), g2.numpy())
    g3, = torch.autograd.grad(
        (tso.take_rows(t, tidx) * torch.from_numpy(ct)).sum(), t)
    np.testing.assert_array_equal(g3.numpy(), g.numpy())


def test_gather3_values_gradient_matches_jax():
    rng = np.random.default_rng(3)
    n, q, k = 120, 90, 10
    table = rng.normal(size=(n, 3)).astype(np.float32)
    idx = rng.integers(0, n, size=(q, k)).astype(np.int32)
    cts = [rng.normal(size=(q, k)).astype(np.float32) for _ in range(3)]
    vals = [table[idx, ax] for ax in range(3)]
    jplan = jso.adjoint_plan(jnp.asarray(idx), n)

    def jloss(t):
        out = jso.gather3_values(t, jnp.asarray(idx), *map(jnp.asarray, vals),
                                 jplan.order, jplan.starts)
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(out, cts))

    g_j = jax.grad(jloss)(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    tidx = torch.from_numpy(idx)
    out = tso.gather3_values(t, tidx, *map(torch.from_numpy, vals),
                             tso.AdjointPlan(tidx, n))
    for o, v in zip(out, vals):
        np.testing.assert_array_equal(o.detach().numpy(), v)
    g, = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cts)), t)
    _close(g.numpy(), g_j)


def test_plan_of_another_table_is_refused():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tso.take_rows_planned(torch.zeros(5, 3), idx, tso.AdjointPlan(idx, 6))
