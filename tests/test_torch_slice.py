"""The port's forward slice as a whole, and its boundaries with the JAX
package: a 2-step rollout then a render of the last frame against
neurofluid_tpu; the package imports no JAX; weights survive the round trip
through neurofluid_tpu/utils/torch_import.py; the scene equals bench.py's."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from neurofluid_tpu.models.particle_net import ParticleNet as JParticleNet
from neurofluid_tpu.models.render_net import RenderNet as JRenderNet
from neurofluid_tpu.train.transition import make_rollout_fn as jrollout
from neurofluid_tpu.utils import torch_import
from neurofluid_torch import scene
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train.transition import make_rollout_fn
from neurofluid_torch.utils.params import (
    renderer_state_from_flax, transition_state_from_flax,
)

REPO = Path(__file__).resolve().parent.parent
TIGHT = dict(grid_lower=(-0.5, -0.5, -0.65), grid_upper=(0.5, 0.5, 0.55),
             fused_cell_scale=2.0, layer_channels=(8, 24, 3))
RENDER = dict(near=1.0, far=3.0, n_samples=16, n_importance=16, nerf_depth=6,
              nerf_width=32, grid_lower=(-0.5, -0.5, -0.65),
              grid_upper=(0.5, 0.5, 0.55), grid_max_per_cell=64)


def _tree_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.fixture(scope="module")
def slice_case():
    """A small scene and the JAX models' own initial weights."""
    rng = np.random.default_rng(4)
    n, m = 160, 24
    pos = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    box = rng.uniform(-0.45, 0.45, (m, 3)).astype(np.float32)
    box[:, 2] = -0.45
    nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (m, 1))
    o = np.tile(np.asarray([0.0, 0.02, 2.0], np.float32), (8, 1))
    d = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (8, 1))
    d[:, 0] += np.linspace(-0.1, 0.1, 8, dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d], -1).astype(np.float32)
    ro = o[0]
    jargs = [jnp.asarray(x) for x in (pos, vel, box, nrm)]
    jnet = JParticleNet(search_backend="fused_cconv", gravity=(0, 0, -9.81),
                        **TIGHT)
    pj = jnet.init(jax.random.PRNGKey(1), *jargs)
    jren = JRenderNet(**RENDER)
    rj = jren.init(jax.random.PRNGKey(2), jargs[0], jnp.asarray(ro),
                   jnp.asarray(rays))
    return (pos, vel, box, nrm, ro, rays), (jnet, pj), (jren, rj)


def test_rollout_then_render_matches_jax(slice_case):
    (pos, vel, box, nrm, ro, rays), (jnet, pj), (jren, rj) = slice_case
    jargs = [jnp.asarray(x) for x in (pos, vel, box, nrm)]
    traj_j, diag_j = jrollout(jnet, with_diag=True)(pj, *jargs, n_steps=2)
    out_j = jren.apply(rj, traj_j[-1], jnp.asarray(ro), jnp.asarray(rays))

    tnet = ParticleNet(gravity=(0, 0, -9.81), device="cpu", **TIGHT)
    tnet.load_state_dict(transition_state_from_flax(_tree_np(pj)))
    tren = RenderNet(device="cpu", **RENDER)
    tren.load_state_dict(renderer_state_from_flax(_tree_np(rj)))
    with torch.no_grad():
        traj_t, diag_t = make_rollout_fn(tnet)(
            *map(torch.from_numpy, (pos, vel, box, nrm)), 2)
        out_t = tren(traj_t[-1], torch.from_numpy(ro), torch.from_numpy(rays))

    # two steps of the one-step position tolerance (tests/test_models.py)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), atol=4e-5)
    assert not any(bool(v) for v in diag_t.values())
    assert not any(bool(v) for v in diag_j.values())
    for key in ("num_nn_0", "num_nn_1", "mask_0", "mask_1", "overflow"):
        np.testing.assert_array_equal(out_t[key].numpy(),
                                      np.asarray(out_j[key]), err_msg=key)
    assert 0 < int(out_t["mask_0"].sum()) < 8 * 16
    # the renders differ by the rollout's f32 drift plus the render's own
    # summation order
    for key in ("rgb0", "opacity0", "rgb1", "opacity1"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=0, atol=2e-4, err_msg=key)
    for key in ("depth0", "depth1"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=0, atol=4e-4, err_msg=key)


def test_package_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil, neurofluid_torch\n"
        "for m in pkgutil.walk_packages(neurofluid_torch.__path__, "
        "'neurofluid_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'neurofluid_tpu', 'tensorboard', "
        "'tensorflow')]\n"
        "assert not bad, bad\n"
        "for name in ('models.render_net', 'ops.fused_query', 'data.blender', "
        "'ops.neighbor_search', 'ops.segment_ops', 'train.transition', "
        "'utils.config', 'train.trainer_base', 'train.warmup', "
        "'train.evaluation', 'cli.train_e2e', 'utils.jax_random', "
        "'models.init'):\n"
        "    assert 'neurofluid_torch.' + name in sys.modules, name\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_weight_round_trip_through_torch_import(slice_case):
    _, (_, pj), (_, rj) = slice_case
    pj, rj = _tree_np(pj), _tree_np(rj)
    back, skipped = torch_import.import_transition_state(
        transition_state_from_flax(pj))
    assert not skipped
    _assert_trees_equal(back, pj["params"])
    back, skipped = torch_import.import_renderer_state(
        renderer_state_from_flax(rj))
    assert not skipped
    _assert_trees_equal(back, rj["params"])
    # and the port's own modules take the state_dicts as they are
    ParticleNet(device="cpu", **TIGHT).load_state_dict(
        transition_state_from_flax(pj))
    RenderNet(device="cpu", **RENDER).load_state_dict(
        renderer_state_from_flax(rj))


def test_scene_equals_bench_problem():
    for a, b in zip(scene.build_problem(), bench.build_problem()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (scene.N_PARTICLES, scene.N_BOX, scene.N_RAYS) == (
        bench.N_PARTICLES, bench.N_BOX, bench.N_RAYS)
