"""Port parity: positional encoding and the NeRF MLP against
neurofluid_tpu.models, with the flax weights carried across by
`nerf_state_from_flax`. D=6 so the skip at layer 4 is exercised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.models.embedding import positional_encoding as jpe
from neurofluid_tpu.models.nerf import NeRF as JNeRF
from neurofluid_torch.models.embedding import embedding_channels
from neurofluid_torch.models.embedding import positional_encoding as tpe
from neurofluid_torch.models.nerf import NeRF
from neurofluid_torch.utils.params import nerf_state_from_flax


@pytest.mark.parametrize("n_freqs", [4, 10])
def test_positional_encoding_matches_jax(rng, n_freqs):
    x = rng.normal(size=(50, 3)).astype(np.float32) * 2.0
    out = tpe(torch.from_numpy(x), n_freqs).numpy()
    assert out.shape == (50, embedding_channels(3, n_freqs))
    # sin/cos of arguments up to 2^9 * 6: the two libms differ by ~1 ulp
    np.testing.assert_allclose(out, np.asarray(jpe(jnp.asarray(x), n_freqs)),
                               rtol=0, atol=1e-5)


def test_nerf_matches_jax_with_imported_weights(rng):
    in_xyz, in_dir = 198, 54
    jnet = JNeRF(depth=6, width=32, in_channels_xyz=in_xyz,
                 in_channels_dir=in_dir)
    x = rng.normal(size=(40, in_xyz + in_dir)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tnet = NeRF(depth=6, width=32, in_channels_xyz=in_xyz,
                in_channels_dir=in_dir, device="cpu")
    tnet.load_state_dict(nerf_state_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    assert tnet.xyz_encoding_5[0].weight.shape == (32, 32 + in_xyz)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x)).numpy()
        sig = tnet(torch.from_numpy(x[:, :in_xyz]), sigma_only=True).numpy()
    # f32 matmuls in another summation order
    np.testing.assert_allclose(out, np.asarray(jnet.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        sig, np.asarray(jnet.apply(params, jnp.asarray(x[:, :in_xyz]),
                                   sigma_only=True)), rtol=1e-5, atol=1e-5)


def test_nerf_seeded_init_is_reproducible():
    a = NeRF(depth=2, width=16, device="cpu",
             generator=torch.Generator().manual_seed(7))
    b = NeRF(depth=2, width=16, device="cpu",
             generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb)
    assert "xyz_encoding_1.0.weight" in a.state_dict()
    assert "rgb.0.weight" in a.state_dict()


def _dense_layers(state):
    """(weight (out, in), bias) of each Linear in a NeRF state_dict."""
    return {k[:-len(".weight")]: (state[k], state[k[:-len("weight")] + "bias"])
            for k in state if k.endswith(".weight")}


def test_seeded_init_is_flax_dense_default():
    """Every Linear of the NeRF (8 x 256, as the renderer builds it) is
    drawn as flax's `Dense` default, as in the JAX package: zero bias, the
    weight a truncated normal of variance 1 / fan_in, cut at two of its
    scale units. PyTorch's default init (uniform weight and bias) fails
    this; under it the sigma head often started negative at every sample
    and its MLP never trained. Held against JAX's NeRF initialised from a
    key, layer by layer: the same bound, zeros and spread."""
    in_xyz, in_dir = 63, 27
    jnet = JNeRF(in_channels_xyz=in_xyz, in_channels_dir=in_dir)
    jparams = jnet.init(jax.random.PRNGKey(10),
                        jnp.zeros((1, in_xyz + in_dir)))
    jlayers = _dense_layers(nerf_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    tlayers = _dense_layers(NeRF(
        in_channels_xyz=in_xyz, in_channels_dir=in_dir, device="cpu",
        generator=torch.Generator().manual_seed(10)).state_dict())
    assert tlayers.keys() == jlayers.keys() and len(tlayers) == 12
    for name, (w, b) in tlayers.items():
        jw, jb = (torch.as_tensor(np.asarray(a)) for a in jlayers[name])
        fan_in = w.shape[1]
        assert jw.shape == w.shape
        assert not b.any() and not jb.any(), name
        bound = 2.0 / (0.87962566103423978 * fan_in ** 0.5)
        for x in (w, jw):
            assert float(x.abs().max()) <= bound * (1 + 1e-6), name
        if w.numel() >= 4096:  # spreads estimated within ~2%
            for x in (w, jw):
                assert abs(float(x.std()) * fan_in ** 0.5 - 1.0) < 0.03, name
