"""Port parity, checkpoints: neurofluid_torch.train.checkpoint over
`torch.save` (the reference's <step>.pt files) against the staged-transfer
semantics of neurofluid_tpu.train.checkpoint, and the port's schedules
against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.models.render_net import RenderNet as JRenderNet
from neurofluid_tpu.train import checkpoint as jckpt
from neurofluid_tpu.train import schedules as jsched
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.train import checkpoint as ckpt
from neurofluid_torch.train import schedules
from neurofluid_torch.utils.params import renderer_state_from_flax

SMALL = dict(near=1.0, far=3.0, n_samples=8, n_importance=4, nerf_depth=2,
             nerf_width=16)


def test_save_latest_restore_round_trip(tmp_path):
    d = str(tmp_path / "models")
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d)
    net = ParticleNet(layer_channels=(4, 3), device="cpu")
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    sum(p.sum() for p in net.parameters()).backward()
    opt.step()
    for step in (5, 20, 10):
        path = ckpt.save_checkpoint(d, step, {
            "step": step, "transition": net.state_dict(),
            "opt_state": opt.state_dict()})
        assert path == f"{d}/{step}.pt"
    (tmp_path / "models" / "7.pt.123.tmp").write_bytes(b"")  # not a step
    assert ckpt.latest_step(d) == 20
    state, step = ckpt.restore_checkpoint(d)
    assert step == 20 and state["step"] == 20
    state, step = ckpt.restore_checkpoint(d, 5)
    assert step == 5
    fresh = ParticleNet(layer_channels=(4, 3), device="cpu",
                        generator=torch.Generator().manual_seed(9))
    fresh.load_state_dict(state["transition"])
    for name, p in fresh.state_dict().items():
        np.testing.assert_array_equal(p.numpy(),
                                      net.state_dict()[name].numpy())
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    fresh_opt.load_state_dict(state["opt_state"])
    assert {int(s["step"]) for s in
            fresh_opt.state_dict()["state"].values()} == {1}


@pytest.fixture(scope="module")
def renderer_weights():
    """Two different JAX RenderNet initialisations, as numpy trees."""
    net = JRenderNet(**SMALL)
    rng = np.random.default_rng(0)
    particles = jnp.asarray(rng.uniform(-0.3, 0.3, (40, 3)), jnp.float32)
    ro = jnp.asarray([0.0, 0.0, 2.0], jnp.float32)
    rays = jnp.asarray(np.tile([0, 0, 2.0, 0, 0, -1.0], (4, 1)), jnp.float32)
    return [jax.tree_util.tree_map(
        np.asarray, net.init(jax.random.PRNGKey(k), particles, ro, rays))
        for k in (0, 1)]


@pytest.mark.parametrize("partial_load", [False, True])
def test_merge_renderer_params_matches_jax(renderer_weights, partial_load):
    """The same weights merged by both packages: the same leaves kept and
    replaced (only `sigma` / `xyz_encoding` ones with partial_load)."""
    target, loaded = renderer_weights
    merged_j = jckpt.merge_renderer_params(
        target["params"], loaded["params"], partial_load=partial_load)
    want = renderer_state_from_flax(merged_j)
    got = ckpt.merge_renderer_params(renderer_state_from_flax(target),
                                     renderer_state_from_flax(loaded),
                                     partial_load=partial_load)
    assert set(got) == set(want)
    t_state, l_state = (renderer_state_from_flax(w) for w in renderer_weights)
    moved = 0
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)
        takes = not partial_load or "sigma" in name or "xyz_encoding" in name
        src = l_state if takes else t_state
        np.testing.assert_array_equal(got[name].numpy(), src[name].numpy(),
                                      err_msg=name)
        moved += takes
    assert 0 < moved < len(want) if partial_load else moved == len(want)


def test_merge_tolerates_extra_keys_and_strips_gravity():
    target = {"nerf_coarse.sigma.weight": torch.zeros(2)}
    loaded = {"nerf_coarse.sigma.weight": torch.ones(2),
              "extra.weight": torch.ones(2)}
    merged = ckpt.merge_renderer_params(target, loaded)
    assert set(merged) == set(target)
    np.testing.assert_array_equal(merged["nerf_coarse.sigma.weight"], 1.0)
    # JAX tolerates the same extra leaf
    merged_j = jckpt.merge_renderer_params(
        {"a": {"w": np.zeros(2)}}, {"a": {"w": np.ones(2)},
                                    "extra": {"w": np.ones(2)}})
    assert set(merged_j) == {"a"}
    # an upstream transition state_dict carries a gravity buffer
    net = ParticleNet(layer_channels=(4, 3), device="cpu")
    upstream = dict(net.state_dict(), gravity=torch.tensor([0.0, 0.0, -9.81]))
    stripped = ckpt.transition_state(upstream)
    assert "gravity" not in stripped
    net.load_state_dict(stripped)  # strict: every other key is there


def test_schedules_match_jax():
    steps = [0, 1, 5, 9_999, 10_000, 10_001, 25_000]
    pairs = [
        (schedules.exponential_decay(5e-4, 10_000, gamma=0.1),
         jsched.exponential_decay(5e-4, 10_000, gamma=0.1)),
        (schedules.warmup_exponential_decay(1e-3, 10_000, warmup_epochs=100),
         jsched.warmup_exponential_decay(1e-3, 10_000, warmup_epochs=100)),
    ]
    for ts, js in pairs:
        for s in steps:
            np.testing.assert_allclose(ts(s), float(js(s)), rtol=1e-6)
    # as a LambdaLR factor, stepped after each update: the lr of update i
    # is the schedule at the update count i, as optax reads it
    w = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([w], lr=5e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, schedules.lr_lambda(pairs[0][0], 5e-4))
    for i in range(3):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(pairs[0][1](i)), rtol=1e-6)
        opt.step()
        sched.step()
