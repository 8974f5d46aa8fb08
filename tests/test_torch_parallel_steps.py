"""Port parity, the multi-rank slice's steps: the ray-sharded e2e step at 2
gloo ranks over two steps against the single-process step, and that
replicated step (the one tests/test_torch_parallel.py holds every sharded
step to) against JAX's replicated step on the dry run's tiny models and
inputs, with (2, 2, 2) taps: the XLA:CPU compile cost is the tap matrices'
(neurofluid_tpu/parallel/dryrun.py `run_composed_step`). JAX's params come
from jitted inits (its NeRFs' own, so that no render runs at init)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurofluid_tpu.models.nerf import NeRF as JNeRF
from neurofluid_tpu.models.particle_net import ParticleNet as JParticleNet
from neurofluid_tpu.models.render_net import RenderNet as JRenderNet
from neurofluid_tpu.train import e2e as je2e
from neurofluid_tpu.train import losses as jlosses
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.parallel import dryrun
from neurofluid_torch.utils.params import (
    renderer_state_from_flax, transition_state_from_flax,
)

TAPS = (2, 2, 2)


def test_ray_sharded_e2e_two_steps_match_single_process():
    sh, ref = dryrun.run_e2e_step(2, steps=2)
    assert sh["states_equal"]
    np.testing.assert_allclose(sh["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(sh["grad_norm_r"], ref["grad_norm_r"],
                               rtol=2e-3)
    np.testing.assert_allclose(sh["grad_norm_t"], ref["grad_norm_t"],
                               rtol=2e-3)
    np.testing.assert_allclose(sh["next_pos"].numpy(), ref["next_pos"].numpy(),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def jax_replicated():
    """JAX's tiny models (brute force, (2, 2, 2) taps), their weights, the
    transition step's output and one jitted e2e step's."""
    pos, vel, box, nrm, ro, rays, rgbs = dryrun._tiny_problem(2)
    jnet = JParticleNet(search_backend="brute", kernel_size=TAPS,
                        **dryrun.TINY_TRANSITION)
    jren = JRenderNet(search_backend="brute", **dryrun.TINY_RENDERER)
    args = tuple(jnp.asarray(a) for a in (pos, vel, box, nrm))
    pt = jax.jit(jnet.init)(jax.random.PRNGKey(0), *args)
    nerf = JNeRF(depth=jren.nerf_depth, width=jren.nerf_width,
                 in_channels_xyz=jren.in_channels_xyz,
                 in_channels_dir=jren.in_channels_dir)
    x = jnp.zeros((1, jren.in_channels_xyz + jren.in_channels_dir))
    keys = jax.random.split(jax.random.PRNGKey(1))
    pr = {"params": {name: nerf.init(k, x)["params"]
                     for name, k in zip(("nerf_coarse", "nerf_fine"), keys)}}
    weights = jax.tree_util.tree_map(np.asarray, (pr, pt))
    t_pos, _, t_nn = jax.jit(jnet.apply)(pt, *args)
    opt_r, opt_t = optax.adam(dryrun.LR_RENDERER), optax.adam(
        dryrun.LR_TRANSITION)
    bounds = jlosses.default_box_bounds()
    step = jax.jit(je2e.make_e2e_train_step(jnet, jren, opt_r, opt_t, bounds,
                                            1.0))
    out = step(pr, pt, opt_r.init(pr), opt_t.init(pt), *args,
               jnp.asarray(ro), jnp.asarray(rays), jnp.asarray(rgbs))
    *_, loss, next_pos, _, aux = out
    return weights, {
        "t_pos": np.asarray(t_pos), "t_nn": np.asarray(t_nn),
        "loss": float(loss), "next_pos": np.asarray(next_pos),
        "grad_norm_r": float(aux["grad_norm_renderer"]),
        "grad_norm_t": float(aux["grad_norm_transition"])}


def _port_models(weights):
    pr, pt = weights
    transition, renderer = dryrun.build_tiny_models(kernel_size=TAPS)
    transition.load_state_dict(transition_state_from_flax(pt))
    renderer.load_state_dict(renderer_state_from_flax(pr))
    return transition, renderer


def test_replicated_transition_step_matches_jax(jax_replicated):
    weights, want = jax_replicated
    transition, _ = _port_models(weights)
    pos, vel, box, nrm = dryrun.tensors_of(dryrun._tiny_problem(2)[:4], "cpu")
    with torch.no_grad():
        p, _, nn_, diag = transition(pos, vel, box, nrm)
    assert not diag["grid_overflow"]
    np.testing.assert_array_equal(nn_.numpy(), want["t_nn"])
    np.testing.assert_allclose(p.numpy(), want["t_pos"], rtol=0, atol=1e-5)


def test_replicated_e2e_step_matches_jax(jax_replicated, monkeypatch):
    """The replicated step the dry run holds every sharded step to, from
    JAX's weights, against JAX's jitted step with optax Adam."""
    weights, want = jax_replicated
    models = _port_models(weights)
    monkeypatch.setattr(dryrun, "build_tiny_models", lambda *a, **k: models)
    got = dryrun.replicated_e2e_steps(dryrun._tiny_problem(2), 1,
                                      kernel_size=TAPS)
    np.testing.assert_allclose(got["loss"][0], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm_r"][0], want["grad_norm_r"],
                               rtol=2e-3)
    np.testing.assert_allclose(got["grad_norm_t"][0], want["grad_norm_t"],
                               rtol=2e-3)
    np.testing.assert_allclose(got["next_pos"].numpy(), want["next_pos"],
                               rtol=0, atol=1e-5)


def test_sharded_net_rejects_halo_without_group():
    with pytest.raises(ValueError, match="shard_group"):
        ParticleNet(halo_size=8, device="cpu")
