"""Port parity, the multi-rank slice (`neurofluid_torch.parallel`): the
collectives and the JAX dry run's six checks on spawned gloo ranks on the
CPU, each against the port's replicated step (itself held to JAX's in
tests/test_torch_parallel_steps.py), the halo's overflow flag and the box
grid that a sharded step is passed.

Every multi-rank test launches its own world (`dryrun.launch`: spawned
processes, one thread each, a file store); the rank-side functions that
are not the dry run's own are in tests/torch_parallel_ranks.py. Tolerances
are the JAX dry run's (neurofluid_tpu/parallel/dryrun.py
`dryrun_multichip`): neighbour counts exact, positions 1e-5 (1e-4 on the
lattice), loss rtol 1e-5, gradient norms rtol 2e-3."""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from neurofluid_torch.parallel import dryrun


def _close_particles(ref_pos, sh_pos, ref_nn, sh_nn, atol=1e-5):
    np.testing.assert_array_equal(ref_nn.numpy(), sh_nn.numpy())
    np.testing.assert_allclose(sh_pos.numpy(), ref_pos.numpy(), rtol=0,
                               atol=atol)


def test_collectives_two_ranks():
    out = dryrun.launch(ranks.collectives_stage, 2)
    for key in ("all_gather_err", "shift1_err", "shift-1_err", "shift2_err",
                "shift-2_err"):
        assert out[key] == 0.0, (key, out[key])
    assert out["any_over"] and not out["any_over_none"]
    for key in ("gradcheck_all_gather", "gradcheck_shift1",
                "gradcheck_shift-1", "gradcheck_shift2"):
        assert out[key] is True, key


def test_particle_sharded_step_matches_replicated():
    _close_particles(*dryrun.run_particle_sharded_step(2))


@pytest.mark.parametrize("backend", ["brute", "grid"])
def test_halo_step_matches_replicated(backend):
    ref, sh, rnn, snn, diag = dryrun.run_halo_particle_step(
        4, search_backend=backend)
    assert diag["grid_overflow"] == [False] * 4, diag
    _close_particles(ref, sh, rnn, snn)


def test_halo_lattice_reference_scale():
    """13,824 particles at the rest spacing, 4 x-slabs, halo 1,024, grid
    backend with the halo-slot mask."""
    ref, sh, rnn, snn, diag = dryrun.run_halo_lattice_step(4)
    assert diag["grid_overflow"] == [False] * 4, diag
    _close_particles(ref, sh, rnn, snn, atol=1e-4)


def test_halo_insufficiency_is_flagged_on_every_rank():
    """A halo of 2 slots cannot hold a face's band: grid_overflow on every
    rank, never a silent drop (as tests/test_sharding.py)."""
    *_, diag = dryrun.run_halo_particle_step(4, halo_size=2)
    assert diag["grid_overflow"] == [True] * 4, diag


def test_box_plan_is_used_not_dropped():
    """A box grid passed to the sharded step is the one it searches: a grid
    whose cells hold one particle overflows, on every rank."""
    arrays = dryrun._tiny_problem(2)[:4]
    flags = dryrun.launch(ranks.box_plan_stage, 2, arrays)
    assert flags == {"none": [False, False], "tiny_grid": [True, True]}


@pytest.mark.parametrize("n_ranks", [2, 4], ids=["2x1", "2x2"])
def test_composed_step_matches_replicated(n_ranks):
    """The composed e2e step (transition sharded over 'particles', rays
    owned once over both axes, both Adam updates): loss, both gradient
    norms and next positions as the replicated step; every rank's
    parameters and Adam states bitwise equal after the update."""
    comp, repl = dryrun.run_composed_step(n_ranks)
    assert np.isfinite(comp["loss"]).all() and not comp["overflow"][0]
    dryrun.check_composed(comp, repl)


def test_sharded_render_matches_single_process():
    """`make_sharded_render_fn` at 2 ranks: every per-ray output of all the
    rays on every rank, as one process renders them."""
    pos, _, _, _, ro, rays, _ = dryrun._tiny_problem(2)
    arrays = (pos, ro[0], rays[0])
    got = dryrun.launch(ranks.render_stage, 2, arrays)
    _, renderer = dryrun.build_tiny_models()
    with torch.no_grad():
        want = renderer(*dryrun.tensors_of(arrays, "cpu"))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].float().numpy(),
                                   w.float().numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)
