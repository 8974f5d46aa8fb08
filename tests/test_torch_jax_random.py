"""JAX's seeded draws in the port: neurofluid_torch/utils/jax_random.py and
models/init.py's flax draw against JAX 0.9.0 and flax 0.12.3 on the CPU.

- Keys (`prng_key`, `split`, `fold_in`, `flax_param_key`), bits, uniform
  and truncated-normal draws: bitwise, 0 ulp (the truncated normal through
  XLA's f32 ErfInv, log1p and log, with their fused multiply-adds).
- flax's initialisers (`lecun_normal`, `glorot_uniform`) bitwise.
- `flax_init_state` of a port RenderNet (depth 2, width 32, its default
  encodings) and ParticleNet (8, 16, 16, 3) against the
  converted params of the JAX modules' own `init`: every name and tensor
  bitwise. (The trainers' draws are held in
  tests/test_torch_trainer_{warmup,transition,e2e}.py.)
- `chip_smoke.py`'s phase-16 pins recomputed with JAX at full width, and
  met by the port's draw on the CPU.
"""

import flax.core.scope as flax_scope
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from neurofluid_tpu.models.particle_net import ParticleNet as JParticleNet
from neurofluid_tpu.models.render_net import RenderNet as JRenderNet
from neurofluid_tpu.train.transition import (
    build_particle_net as jbuild_particle_net,
)
from neurofluid_tpu.train.warmup import build_renderer as jbuild_renderer
from neurofluid_tpu.utils.config import ConfigNode as JConfigNode
from neurofluid_torch.cli.full_protocol_run import renderer_cfg
from neurofluid_torch.models import init
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.utils import jax_random as jr
from neurofluid_torch.utils.params import (
    renderer_state_from_flax, transition_state_from_flax,
)

SEEDS = (0, 10, 2**31 - 1, 2**32 + 5, -1)
SHAPES = ((), (1,), (7,), (5, 16), (4, 4, 4, 3, 8))
KEY_SEED = 10


def _equal_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        _equal_bits(got[name].numpy(), w.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    _equal_bits(jr.prng_key(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", (2, 3))
def test_split(num):
    _equal_bits(jr.split(jr.prng_key(KEY_SEED), num),
                jax.random.split(jax.random.PRNGKey(KEY_SEED), num))


@pytest.mark.parametrize("data", (0, 1, 12345, 2**32 - 1))
def test_fold_in(data):
    _equal_bits(jr.fold_in(jr.prng_key(KEY_SEED), data),
                jax.random.fold_in(jax.random.PRNGKey(KEY_SEED),
                                   np.uint32(data)))


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits(shape):
    _equal_bits(jr.random_bits(jr.prng_key(KEY_SEED), shape),
                jax.random.bits(jax.random.PRNGKey(KEY_SEED), shape))


@pytest.mark.parametrize("bounds", ((0.0, 1.0), (-1.0, 1.0), (-0.3, 0.7)))
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(shape, bounds):
    lo, hi = bounds
    _equal_bits(jr.uniform(jr.prng_key(KEY_SEED), shape, lo, hi),
                jax.random.uniform(jax.random.PRNGKey(KEY_SEED), shape,
                                   jnp.float32, lo, hi))


@pytest.mark.parametrize("bounds", ((-2.0, 2.0), (-1.0, 3.0)))
@pytest.mark.parametrize("shape", SHAPES)
def test_truncated_normal(shape, bounds):
    lo, hi = bounds
    _equal_bits(jr.truncated_normal(jr.prng_key(KEY_SEED), lo, hi, shape),
                jax.random.truncated_normal(jax.random.PRNGKey(KEY_SEED),
                                            lo, hi, shape))


@pytest.mark.parametrize("seed", (0, 3, 10))
def test_truncated_normal_many_draws(seed):
    """100,000 draws of flax's (-2, 2) bounds: 0 ulp everywhere (the
    uniform's fused multiply-add cancels near 0, where a separate multiply
    and add would differ by thousands of ulp)."""
    _equal_bits(jr.truncated_normal(jr.prng_key(seed), -2.0, 2.0, (100_000,)),
                jax.random.truncated_normal(jax.random.PRNGKey(seed), -2.0,
                                            2.0, (100_000,)))


def test_erfinv_both_branches():
    """Giles' two polynomials: w < 5 and, past |x| ~ 0.9966, w >= 5."""
    x = np.linspace(-0.999999, 0.999999, 200_001, dtype=np.float32)
    assert np.any(-np.log1p(-x.astype(np.float64) ** 2) >= 5)
    _equal_bits(jr.erfinv_f32(x), jax.lax.erf_inv(jnp.asarray(x)))


@pytest.mark.parametrize("path, counter", [
    ((), 1), (("nerf_coarse", "xyz_encoding_1"), 1),
    (("nerf_fine", "rgb"), 2), (("conv0_fluid",), 2), (("dense3",), 300)])
def test_flax_param_key(path, counter):
    root = jax.random.PRNGKey(KEY_SEED)
    got = jr.flax_param_key(jr.prng_key(KEY_SEED), path, counter)
    _equal_bits(got, flax_scope._fold_in_static(root, (*path, counter)))
    scope_rng = flax_scope.LazyRng.create(root, *path)
    _equal_bits(got, flax_scope.LazyRng.create(scope_rng, counter)
                .as_jax_rng())


@pytest.mark.parametrize("shape", ((5, 16), (63, 256), (4, 4, 4, 3, 8)))
@pytest.mark.parametrize("name", ("lecun_normal", "glorot_uniform"))
def test_flax_initialisers(name, shape):
    key = jax.random.PRNGKey(KEY_SEED)
    want = getattr(fnn.initializers, name)()(key, shape, jnp.float32)
    _equal_bits(getattr(init, name)(jr.prng_key(KEY_SEED), shape), want)


def test_particle_net_draw():
    rng = np.random.default_rng(4)
    pos = rng.uniform(-0.25, 0.25, (40, 3)).astype(np.float32)
    box = rng.uniform(-0.45, 0.45, (12, 3)).astype(np.float32)
    nrm = np.tile(np.float32([0, 0, 1]), (12, 1))
    kw = dict(search_backend="brute", gravity=(0, 0, -9.81),
              layer_channels=(8, 16, 16, 3))
    jnet = JParticleNet(**kw)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7), *map(
        jnp.asarray, (pos, np.zeros_like(pos), box, nrm)))
    net = ParticleNet(device="cpu", **kw)
    got = init.flax_init_state(net, jr.prng_key(7))
    assert set(got) == set(net.state_dict())
    _assert_states_equal(got, transition_state_from_flax(_tree_np(params)))


def test_render_net_draw():
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.25, 0.25, (40, 3)).astype(np.float32)
    rays = np.tile(np.float32([0, 0.02, 2.0, 0, 0, -1.0]), (4, 1))
    kw = dict(near=1.0, far=3.0, n_samples=8, n_importance=8, nerf_depth=2,
              nerf_width=32, search_backend="brute")
    params = jax.jit(JRenderNet(**kw).init)(
        jax.random.PRNGKey(KEY_SEED), jnp.asarray(pos),
        jnp.asarray(rays[0, :3]), jnp.asarray(rays))
    ren = RenderNet(device="cpu", **kw)
    got = init.flax_init_state(ren, jr.prng_key(KEY_SEED))
    assert set(got) == set(ren.state_dict())
    _assert_states_equal(got, renderer_state_from_flax(_tree_np(params)))


def test_seed_pins_match_jax():
    """chip_smoke.py's phase-16 pins from the JAX package's own draw at
    full width: `build_renderer` (NeRF 8 x 256) and `build_particle_net`
    ((32, 64, 64, 3)) initialised under the first key of a seeded JAX
    trainer (`TrainerBase.next_key`); and the port's `seed_models` on
    the CPU meets them."""
    cfg = JConfigNode(dict(near=9.0, far=13.0,
                           TRAIN=dict(seed=chip_smoke.SEED),
                           RENDERER=renderer_cfg()))
    key = jax.random.split(jax.random.PRNGKey(chip_smoke.SEED))[1]
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32))
    box = jnp.asarray(rng.uniform(-1, 1, (32, 3)).astype(np.float32))
    rays = jnp.asarray(np.tile(np.float32([0, -10, 0.2, 0, 1, 0]), (8, 1)))
    rj = jax.jit(jbuild_renderer(cfg).init)(key, pos, rays[0, :3], rays)
    pj = jax.jit(jbuild_particle_net(cfg).init)(
        key, pos, jnp.zeros_like(pos), box,
        jnp.tile(jnp.float32([0, 0, 1]), (32, 1)))
    want = {**renderer_state_from_flax(_tree_np(rj)),
            **transition_state_from_flax(_tree_np(pj))}
    for name, pin in chip_smoke.SEED_PINS.items():
        assert chip_smoke.seed_summary(want[name].numpy()) == pin, name
    ren, net = chip_smoke.seed_models("cpu")
    got = {**ren.state_dict(), **net.state_dict()}
    _assert_states_equal(got, want)
