"""Port parity: RenderNet's options on the dense path against
neurofluid_tpu.models.RenderNet (8 rays, 16 + 16 samples, NeRF D=6 W=32,
the JAX weights carried across by `renderer_state_from_flax`): each
encoding switch off in turn, `exclude_ray=False` with both
`same_smooth_factor` values, bf16 products, `coarse_rendering` and
`fine_rendering`, and the random forms (`perturb`, `noise_std`) with the
JAX package's own draws fed through the port's `ray_ops.uniform` /
`ray_ops.normal`. Forwards in f32 within 1e-4 (depth, a weighted sum of
z ~ 2, within 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.models.nerf import NeRF as JNeRF
from neurofluid_tpu.models.render_net import RenderNet as JRenderNet
from neurofluid_tpu.ops import ray_ops as jray
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.ops import ray_ops as tray
from neurofluid_torch.utils.params import renderer_state_from_flax

SMALL = dict(near=1.0, far=3.0, n_samples=16, n_importance=16, nerf_depth=6,
             nerf_width=32, grid_lower=(-0.5, -0.5, -0.5),
             grid_upper=(0.5, 0.5, 0.5), grid_max_per_cell=48)
TOL = {"rgb": 1e-4, "opacity": 1e-4, "depth": 2e-4}
SIGMA_BIAS = 5.0  # sigma ~ 5 per unit length: alpha ~ 0.5 per coarse step


def rays_through_origin(n):
    o = np.tile(np.asarray([0.0, 0.05, 2.0], np.float32), (n, 1))
    d = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (n, 1))
    d[:, 0] += np.linspace(-0.12, 0.12, n, dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(10)
    particles = rng.uniform(-0.3, 0.3, (400, 3)).astype(np.float32)
    ro = np.asarray([0.0, 0.05, 2.0], np.float32)
    return particles, ro, rays_through_origin(8)


def nets(seed=0, jax_dtype=jnp.float32, torch_dtype=torch.float32, **kw):
    """A JAX RenderNet with params from its NeRFs' own init (no render at
    init; the sigma heads' bias set to SIGMA_BIAS), and the port's on the
    same weights."""
    jnet = JRenderNet(**SMALL, compute_dtype=jax_dtype, **kw)
    nerf = JNeRF(depth=jnet.nerf_depth, width=jnet.nerf_width,
                 in_channels_xyz=jnet.in_channels_xyz,
                 in_channels_dir=jnet.in_channels_dir)
    x = jnp.zeros((1, jnet.in_channels_xyz + jnet.in_channels_dir))
    keys = jax.random.split(jax.random.PRNGKey(seed))
    params = {"params": {name: nerf.init(k, x)["params"]
                         for name, k in zip(("nerf_coarse", "nerf_fine"),
                                            keys)}}
    for p in params["params"].values():  # opaque where the mask is set
        p["sigma"]["bias"] = jnp.full_like(p["sigma"]["bias"], SIGMA_BIAS)
    tnet = RenderNet(device="cpu", compute_dtype=torch_dtype, **SMALL, **kw)
    tnet.load_state_dict(renderer_state_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, tnet


def render(jnet, params, tnet, scene, method=None, **kw):
    particles, ro, rays = scene
    fn = getattr(JRenderNet, method) if method else None
    out_j = jnet.apply(params, jnp.asarray(particles), jnp.asarray(ro),
                       jnp.asarray(rays), method=fn, **kw)
    call = getattr(tnet, method) if method else tnet
    with torch.no_grad():
        out_t = call(torch.from_numpy(particles), torch.from_numpy(ro),
                     torch.from_numpy(rays),
                     **{k: v for k, v in kw.items() if k != "key"})
    return out_t, out_j


def assert_close(out_t, out_j, tol=TOL):
    assert set(out_t) == set(out_j)
    for key in out_j:
        if key.startswith(("num_nn", "mask", "overflow")):
            np.testing.assert_array_equal(out_t[key].numpy(),
                                          np.asarray(out_j[key]), err_msg=key)
        else:
            np.testing.assert_allclose(out_t[key].numpy(),
                                       np.asarray(out_j[key]), rtol=0,
                                       atol=tol[key.rstrip("01")],
                                       err_msg=key)


@pytest.mark.parametrize("flags", [
    dict(encode_density=False), dict(encode_var=False),
    dict(encode_smoothed_pos=False), dict(encode_smoothed_dir=False),
    dict(exclude_ray=False), dict(exclude_ray=False, same_smooth_factor=True)],
    ids=["no_density", "no_var", "no_smoothed_pos", "no_smoothed_dir",
         "blend_smaller_alpha", "blend_same_alpha"])
def test_encoding_options_match_jax(scene, flags):
    jnet, params, tnet = nets(**flags)
    assert (tnet.in_channels_xyz, tnet.in_channels_dir) == (
        jnet.in_channels_xyz, jnet.in_channels_dir)
    out_t, out_j = render(jnet, params, tnet, scene)
    assert_close(out_t, out_j)
    assert 0 < int(out_t["mask_0"].sum()) < 8 * 16
    assert float(out_t["opacity1"].max()) > 0.1


def test_exclude_ray_blend_uses_the_literal_20(scene):
    """num_nn never exceeds K = 20, so the blend takes smaller_alpha
    everywhere; with same_smooth_factor it takes larger_alpha. The two
    differ wherever a sample has a neighbour."""
    outs = [render(*nets(exclude_ray=False, same_smooth_factor=s), scene)[0]
            for s in (False, True)]
    assert float((outs[0]["rgb1"] - outs[1]["rgb1"]).abs().max()) > 1e-4


def test_bf16_products_match_jax(scene):
    """bf16 products (f32 params, f32 heads) against flax's bf16 Dense,
    the bias added in bf16 after the bf16 product. The two agree to 2.3e-5
    on rgb1 here (measured); the products' summation order is the
    libraries' own, so each output is held to one bf16 ulp at its scale
    (2^-8 at rgb and opacity ~1, 2^-7 at depth ~2). The same weights in
    f32 render 1.5e-3 away: the test sees bf16 run."""
    jnet, params, tnet = nets(jax_dtype=jnp.bfloat16,
                              torch_dtype=torch.bfloat16)
    out_t, out_j = render(jnet, params, tnet, scene)
    assert out_t["rgb1"].dtype == torch.float32
    assert_close(out_t, out_j, {"rgb": 2.0 ** -8, "opacity": 2.0 ** -8,
                                "depth": 2.0 ** -7})
    out_f = render(*nets(), scene)[0]
    assert float((out_f["rgb1"] - out_t["rgb1"]).abs().max()) > 1e-4


@pytest.mark.parametrize("method", ["coarse_rendering", "fine_rendering"])
def test_coarse_and_fine_rendering_match_jax(scene, method):
    out_t, out_j = render(*nets(), scene, method=method)
    assert_close(out_t, out_j)
    key = "opacity0" if method == "coarse_rendering" else "opacity1"
    assert float(out_t[key].max()) > 0.1


class JaxDraws:
    """Stands in for `ray_ops.uniform` / `ray_ops.normal`: returns the
    draws the JAX function takes from its split key, in the order the
    port asks for them, and checks each shape."""

    def __init__(self, monkeypatch, draws):
        self.draws = list(draws)
        for name in ("uniform", "normal"):
            monkeypatch.setattr(tray, name, self.fake(name))

    def fake(self, name):
        def draw(shape, generator, dtype, device):
            assert isinstance(generator, torch.Generator)
            kind, value = self.draws.pop(0)
            assert kind == name and tuple(shape) == value.shape
            return torch.from_numpy(np.array(value)).to(dtype)
        return draw


def jax_draws(key, n_split, kinds):
    keys = jax.random.split(key, n_split)
    return [(kind, np.asarray(getattr(jax.random, kind)(k, shape)))
            for k, (kind, shape) in zip(keys, kinds) if kind]


@pytest.mark.parametrize("method,perturb,noise_std", [
    (None, 1.0, 1.0), (None, 0.5, 0.0), ("coarse_rendering", 1.0, 1.0),
    ("fine_rendering", 1.0, 0.0)])
def test_random_forms_match_jax_on_its_draws(scene, monkeypatch, method,
                                             perturb, noise_std):
    """perturb / noise_std / det=False: the port's draws replaced by JAX's
    (split(key, 4) in `__call__`: coarse jitter, coarse noise, fine CDF
    levels, fine noise; 2 in coarse_rendering, 3 in fine_rendering)."""
    r, s0, s1 = 8, SMALL["n_samples"], SMALL["n_importance"]
    noise = "normal" if noise_std > 0 else None
    kinds = {None: [("uniform", (r, s0)), (noise, (r, s0)),
                    ("uniform", (r, s1)), (noise, (r, s0 + s1))],
             "coarse_rendering": [("uniform", (r, s0)), (noise, (r, s0))],
             "fine_rendering": [("uniform", (r, s0)), (noise, (r, s0)),
                                ("uniform", (r, s1))]}[method]
    key = jax.random.PRNGKey(4)
    fed = JaxDraws(monkeypatch, jax_draws(key, len(kinds), kinds))
    kw = dict(perturb=perturb, noise_std=noise_std)
    particles, ro, rays = scene
    jnet, params, tnet = nets()
    fn = getattr(JRenderNet, method) if method else None
    out_j = jnet.apply(params, jnp.asarray(particles), jnp.asarray(ro),
                       jnp.asarray(rays), key=key, method=fn, **kw)
    call = getattr(tnet, method) if method else tnet
    with torch.no_grad():
        out_t = call(torch.from_numpy(particles), torch.from_numpy(ro),
                     torch.from_numpy(rays),
                     generator=torch.Generator().manual_seed(0), **kw)
    assert not fed.draws
    assert_close(out_t, out_j)


def test_seeded_random_render_repeats(scene):
    """The same seed gives the same render, bitwise; another seed does
    not; and the random forms refuse to run without a generator."""
    _, _, tnet = nets()
    args = [torch.from_numpy(a) for a in scene]
    kw = dict(perturb=1.0, noise_std=1.0)
    with torch.no_grad():
        a, b, c = (tnet(*args, generator=torch.Generator().manual_seed(s),
                        **kw) for s in (3, 3, 4))
        for key in a:
            assert torch.equal(a[key], b[key]), key
        assert not torch.equal(a["rgb1"], c["rgb1"])
        for bad in (dict(perturb=1.0), dict(noise_std=1.0)):
            with pytest.raises(ValueError, match="torch.Generator"):
                tnet(*args, **bad)
        # the fine compositing of fine_rendering takes no random stream,
        # as in the JAX package
        with pytest.raises(ValueError, match="torch.Generator"):
            tnet.fine_rendering(*args, generator=torch.Generator(),
                                noise_std=1.0)


@pytest.mark.parametrize("use_disp", [False, True])
def test_coarse_sample_rays_use_disp_and_perturb(monkeypatch, use_disp):
    """`use_disp` (even in inverse depth) and the stratified jitter on
    JAX's uniforms: z values within 2e-6 (z ~ 13), points within 3e-6."""
    rays = rays_through_origin(5)
    key = jax.random.PRNGKey(1)
    JaxDraws(monkeypatch, [("uniform", np.asarray(
        jax.random.uniform(key, (5, 64))))])
    zj, xj = jray.coarse_sample_rays(9.0, 13.0, jnp.asarray(rays), 64,
                                     use_disp=use_disp, perturb=0.7, key=key)
    zt, xt = tray.coarse_sample_rays(9.0, 13.0, torch.from_numpy(rays), 64,
                                     use_disp=use_disp, perturb=0.7,
                                     generator=torch.Generator())
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=3e-6)
    assert bool((zt[:, 1:] >= zt[:, :-1]).all())
