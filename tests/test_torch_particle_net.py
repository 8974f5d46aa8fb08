"""Port parity: ParticleNet (fused_cconv backend) and the rollout against
neurofluid_tpu, at the sizes of tests/test_models.py's fused-backend test
(n=64, m=24, tight grid, fused_cell_scale=2, channels (8, 24, 3)), with the
flax weights carried across by `transition_state_from_flax`; and the `fused`
backend (compact neighbour lists, K7 and K8 on the card, their plain
versions here) against JAX's `fused` backend and against the port's own
`fused_cconv`, at the sizes of tests/test_fused_query.py's ParticleNet test
(512 fluid and 256 box particles in clustered clouds, default caps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.models.particle_net import ParticleNet as JParticleNet
from neurofluid_tpu.train.transition import make_rollout_fn as jrollout
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.train.transition import make_rollout_fn
from neurofluid_torch.utils.params import transition_state_from_flax

TIGHT = dict(grid_lower=(-0.5, -0.5, -0.65), grid_upper=(0.5, 0.5, 0.55),
             fused_cell_scale=2.0, layer_channels=(8, 24, 3))


def _scene(rng, n=64, m=24):
    pos = rng.uniform(-0.4, 0.4, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    box = rng.uniform(-0.6, 0.6, size=(m, 3)).astype(np.float32)
    box[:, 2] = -0.5
    nrm = np.zeros((m, 3), np.float32)
    nrm[:, 2] = 1.0
    return pos, vel, box, nrm


@pytest.fixture(scope="module")
def nets():
    scene = _scene(np.random.default_rng(10))
    jnet = JParticleNet(search_backend="fused_cconv", **TIGHT)
    params = jnet.init(jax.random.PRNGKey(0), *map(jnp.asarray, scene))
    tnet = ParticleNet(device="cpu", **TIGHT)
    tnet.load_state_dict(transition_state_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return scene, jnet, params, tnet


def test_one_step_matches_jax(nets):
    scene, jnet, params, tnet = nets
    pj, vj, nj, dj = jnet.apply(params, *map(jnp.asarray, scene),
                                return_diag=True)
    with torch.no_grad():
        pt, vt, nt, dt = tnet(*map(torch.from_numpy, scene))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))  # exact counts
    assert nt.numpy().max() > 3
    # as tests/test_models.py: f32 conv sums in another order; the velocity
    # is (pos - pos0) / dt, so its tolerance is 1/dt = 50x wider
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=2e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1.5e-3)
    for key in ("grid_overflow", "cap_exceeded"):
        assert bool(dt[key]) == bool(dj[key]) is False


def test_rollout_matches_jax(nets):
    scene, jnet, params, tnet = nets
    pos, vel, box, nrm = scene
    traj_j, diag_j = jax.jit(jrollout(jnet, with_diag=True),
                             static_argnames=("n_steps",))(
        params, *map(jnp.asarray, scene), n_steps=3)
    with torch.no_grad():
        traj_t, diag_t = make_rollout_fn(tnet)(*map(torch.from_numpy, scene),
                                               3)
    assert traj_t.shape == (3, len(pos), 3)
    # three steps of the one-step tolerance
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), atol=6e-5)
    for key in diag_j:
        assert bool(diag_t[key]) == bool(diag_j[key])


def test_box_plan_reuse_matches_rebuild(nets):
    scene, _, _, tnet = nets
    pos, vel, box, nrm = map(torch.from_numpy, scene)
    with torch.no_grad():
        a = tnet(pos, vel, box, nrm)
        b = tnet(pos, vel, box, nrm, box_plan=tnet.make_box_plan(box))
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


# ---- the `fused` backend (neighbour lists)

LIST = dict(fluid_neighbor_k=64, obstacle_neighbor_k=48, grid_max_per_cell=32,
            gravity=(0, 0, -9.81))


def _cloud(rng, n, spread):
    centers = rng.uniform(-spread, spread, (8, 3))
    pts = (centers[rng.integers(0, 8, n)]
           + rng.normal(size=(n, 3)) * 0.08).astype(np.float32)
    return np.clip(pts, -1.0, 1.0)


def _list_scene(rng):
    pos = _cloud(rng, 512, 0.3)
    vel = (rng.normal(size=(512, 3)) * 0.1).astype(np.float32)
    box = _cloud(rng, 256, 0.8)
    nrm = rng.normal(size=(256, 3)).astype(np.float32)
    return pos, vel, box, nrm


def _loss_t(out):
    p1, v1, nn, _ = out
    return (p1 ** 2).sum() + 0.1 * (v1 ** 2).sum() + nn.sum()


@pytest.fixture(scope="module")
def list_nets():
    scene = _list_scene(np.random.default_rng(10))
    jnet = JParticleNet(search_backend="fused", **LIST)
    params = jnet.init(jax.random.PRNGKey(0), *map(jnp.asarray, scene))
    state = transition_state_from_flax(
        jax.tree_util.tree_map(np.asarray, params))
    tnet = ParticleNet(device="cpu", search_backend="fused", **LIST)
    tnet.load_state_dict(state)
    return scene, jnet, params, tnet, state


def test_fused_backend_matches_jax(list_nets):
    """Counts and flags equal; positions, velocities and the gradients with
    respect to the weights and the positions at the bounds JAX holds its
    own `fused` backend to against its grid search
    (tests/test_fused_query.py: pos 2e-6, vel 1e-4, gradients 5e-4)."""
    scene, jnet, params, tnet, _ = list_nets
    pos, vel, box, nrm = map(jnp.asarray, scene)
    pj, vj, nj, dj = jnet.apply(params, pos, vel, box, nrm, return_diag=True)

    def jloss(p, x):
        p1, v1, nn = jnet.apply(p, x, vel, box, nrm)
        return jnp.sum(p1 ** 2) + 0.1 * jnp.sum(v1 ** 2) + jnp.sum(nn)

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(params, pos)

    tpos = torch.from_numpy(scene[0]).requires_grad_(True)
    out = tnet(tpos, *map(torch.from_numpy, scene[1:]))
    tnet.zero_grad()
    _loss_t(out).backward()
    pt, vt, nt, dt = out
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert nt.max() > 20
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj), rtol=0,
                               atol=1e-4)
    for key in ("grid_overflow", "cap_exceeded"):
        assert bool(dt[key]) == bool(dj[key])
    np.testing.assert_allclose(tpos.grad.numpy(), np.asarray(gx_j), rtol=0,
                               atol=5e-4)
    want = transition_state_from_flax(
        jax.tree_util.tree_map(np.asarray, gp_j))
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=5e-4, err_msg=name)


def test_fused_backend_matches_fused_cconv(list_nets):
    """Where no count exceeds its cap the two backends sum the same pairs:
    equal counts, and positions, velocities and gradients to f32 rounding
    (the bounds of the JAX comparison above)."""
    scene, _, _, tnet, state = list_nets
    cnet = ParticleNet(device="cpu", search_backend="fused_cconv",
                       gravity=(0, 0, -9.81))
    cnet.load_state_dict(state)
    res = []
    for net in (tnet, cnet):
        tpos = torch.from_numpy(scene[0]).requires_grad_(True)
        out = net(tpos, *map(torch.from_numpy, scene[1:]))
        net.zero_grad()
        _loss_t(out).backward()
        res.append((out, tpos.grad))
    (a, ga), (b, gb) = res
    assert not bool(a[3]["cap_exceeded"])
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())
    np.testing.assert_allclose(a[0].detach().numpy(), b[0].detach().numpy(),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(a[1].detach().numpy(), b[1].detach().numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=0, atol=5e-4)
    for (name, p), q in zip(tnet.named_parameters(), cnet.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), rtol=0,
                                   atol=5e-4, err_msg=name)


def test_fused_backend_flags_cap_exceeded(list_nets):
    scene, jnet, params, _, state = list_nets
    small = dict(LIST, fluid_neighbor_k=8)
    tnet = ParticleNet(device="cpu", search_backend="fused", **small)
    tnet.load_state_dict(state)
    jsmall = JParticleNet(search_backend="fused", **small)
    with torch.no_grad():
        pt, _, nt, dt = tnet(*map(torch.from_numpy, scene))
    pj, _, nj, dj = jsmall.apply(params, *map(jnp.asarray, scene),
                                 return_diag=True)
    assert bool(dt["cap_exceeded"]) and bool(dj["cap_exceeded"])
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))  # true counts
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=2e-6)


@pytest.mark.parametrize("backend", ["fused_cconv", "fused"])
def test_other_feats_match_jax(backend):
    """The optional per-particle features (`other_feats_channels`), on both
    backends: they widen conv0_fluid and dense0_fluid. The small scene and
    tight grid of the fused_cconv tests above; tolerances as there."""
    rng = np.random.default_rng(11)
    scene = _scene(rng)
    feats = rng.normal(size=(64, 2)).astype(np.float32)
    jnet = JParticleNet(search_backend=backend, other_feats_channels=2,
                        **TIGHT)
    jargs = [jnp.asarray(x) for x in scene]
    params = jnet.init(jax.random.PRNGKey(3), *jargs, jnp.asarray(feats))
    pj, vj, nj = jnet.apply(params, *jargs, jnp.asarray(feats))
    tnet = ParticleNet(device="cpu", search_backend=backend,
                       other_feats_channels=2, **TIGHT)
    assert tnet.conv0_fluid.kernel.shape[-2] == 6
    tnet.load_state_dict(transition_state_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        pt, vt, nt, _ = tnet(*map(torch.from_numpy, scene),
                             feats=torch.from_numpy(feats))
        p0 = tnet(*map(torch.from_numpy, scene),
                  feats=torch.zeros(64, 2))[0]
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1.5e-3)
    assert float((pt - p0).abs().max()) > 1e-5  # the features are used


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="unknown search_backend 'octree'"):
        ParticleNet(device="cpu", search_backend="octree")


def _grid_run(query_chunk, conv_precision="highest", steps=3):
    """`steps` transition train steps on 'grid' from one seeded init: the
    losses and the final weights."""
    from neurofluid_torch.train import losses
    from neurofluid_torch.train.transition import make_transition_train_step

    pos, vel, box, nrm = map(torch.from_numpy,
                             _scene(np.random.default_rng(3), n=300, m=40))
    net = ParticleNet(search_backend="grid", query_chunk=query_chunk,
                      conv_precision=conv_precision, device="cpu",
                      generator=torch.Generator().manual_seed(1), **TIGHT)
    step = make_transition_train_step(
        net, torch.optim.Adam(net.parameters(), lr=1e-3),
        losses.default_box_bounds(), 1.0)
    out = [float(step(pos, vel, pos + 0.001, pos + 0.002, box, nrm)[0])
           for _ in range(steps)]
    return out, net.state_dict()


def test_query_chunk_smaller_than_n_changes_nothing():
    """3 grid-search train steps with the searches in chunks of 64 queries
    (of 300) equal the unchunked steps: the chunking is memory only."""
    losses_c, state_c = _grid_run(64)
    losses_u, state_u = _grid_run(4096)
    assert losses_c == losses_u
    for name, w in state_c.items():
        torch.testing.assert_close(w, state_u[name], rtol=0, atol=0,
                                   msg=name)


def _assert_f32_class_values_agree():
    outs = []
    for precision in ("highest", "high", "HIGH"):
        net = ParticleNet(conv_precision=precision, device="cpu",
                          generator=torch.Generator().manual_seed(2), **TIGHT)
        pos, vel, box, nrm = map(torch.from_numpy,
                                 _scene(np.random.default_rng(4)))
        with torch.no_grad():
            outs.append(net(pos, vel, box, nrm)[0])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_conv_precision_values_give_the_same_output():
    """The f32-class values of JAX's conv_precision, 'highest', 'high' and
    'HIGH', give the same output bit for bit ('high', JAX's bf16_3x in its
    list conv, is f32 in the port on purpose); `test_conv_precision_contract`
    holds 'default' and unknown values."""
    _assert_f32_class_values_agree()


def _loss_and_grads_jax(jnet, params, scene, ct):
    """sum(pos' * ct) of one JAX step and its gradients, as port-named
    numpy arrays (the parameters by `transition_state_from_flax`, then
    'pos' and 'vel')."""
    def loss(p, pos, vel):
        out = jnet.apply(p, pos, vel, *map(jnp.asarray, scene[2:]))[0]
        return jnp.sum(out * jnp.asarray(ct)), out

    (_, out), (g_p, g_pos, g_vel) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        params, *map(jnp.asarray, scene[:2]))
    grads = {k: v.numpy() for k, v in transition_state_from_flax(
        jax.tree_util.tree_map(np.asarray, g_p)).items()}
    return np.asarray(out), dict(grads, pos=np.asarray(g_pos),
                                 vel=np.asarray(g_vel))


def _loss_and_grads_port(net, scene, ct):
    pos, vel = (torch.from_numpy(a).requires_grad_(True) for a in scene[:2])
    out = net(pos, vel, *map(torch.from_numpy, scene[2:]))[0]
    (out * torch.from_numpy(ct)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    return out.detach().numpy(), dict(grads, pos=pos.grad.numpy(),
                                      vel=vel.grad.numpy())


@pytest.mark.parametrize("case", ["f32_class_bitwise", "default_bf16",
                                  "unknown_raises"])
def test_conv_precision_contract(nets, monkeypatch, case):
    """JAX's conv_precision values in the port. 'highest', 'high' and
    'HIGH' compute the same f32-class step bit for bit. 'default' rounds
    every conv contraction's operands to bf16 (the TPU's `DEFAULT`): on
    every search backend one step's output and every gradient of
    sum(pos' * ct) (each parameter, pos, vel) differ from 'highest' and
    are at least MARGIN times closer, by mean absolute deviation, to the
    oracle of tests/torch_bf16_oracle.py (JAX's step on 'brute' with its
    list conv's einsums at `DEFAULT`, patched in for this test) than to
    JAX's 'highest' step; the leaves whose oracle and 'highest' agree to
    1e-6 of their largest entry (the last layer's biases, since the loss is
    linear in the output, and the box conv's filter, which no box pair of
    this scene reaches) are held to the oracle within 1e-5 of it. An
    unknown value raises."""
    if case == "f32_class_bitwise":
        _assert_f32_class_values_agree()
        return
    if case == "unknown_raises":
        with pytest.raises(ValueError, match="conv_precision"):
            ParticleNet(conv_precision="bf16", device="cpu", **TIGHT)
        with pytest.raises(ValueError, match="conv precision"):
            ParticleNet(device="cpu", **TIGHT).conv1.__class__(
                4, 4, (4, 4, 4), "bf16")
        return
    from neurofluid_tpu.ops import cconv as jcc
    from torch_bf16_oracle import assert_bf16_oracle, continuous_conv_default

    scene, _, params, _ = nets
    ct = np.random.default_rng(8).normal(size=scene[0].shape).astype(
        np.float32)
    jnet = JParticleNet(search_backend="brute", **TIGHT)
    highest = _loss_and_grads_jax(jnet, params, scene, ct)
    monkeypatch.setattr(jcc, "continuous_conv_apply",
                        continuous_conv_default)
    oracle = _loss_and_grads_jax(jnet, params, scene, ct)
    monkeypatch.undo()
    state = transition_state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              params))
    for backend in ("fused_cconv", "fused", "grid", "brute", "auto"):
        net = ParticleNet(search_backend=backend, conv_precision="default",
                          device="cpu", **TIGHT)
        net.load_state_dict(state)
        out, grads = _loss_and_grads_port(net, scene, ct)
        assert_bf16_oracle(f"{backend} pos", out, oracle[0], highest[0])
        for name, g in grads.items():
            o, h = oracle[1][name], highest[1][name]
            if np.abs(o - h).max() <= 1e-6 * np.abs(o).max():
                np.testing.assert_allclose(g, o, rtol=0,
                                           atol=1e-5 * np.abs(o).max(),
                                           err_msg=f"{backend} {name}")
            else:
                assert_bf16_oracle(f"{backend} {name}", g, o, h)


def test_fused_cconv_matches_brute_at_default(nets):
    """One step and its gradients at 'default' on `fused_cconv` (the plain
    K1 and K2) against `brute` (the list conv's bf16_product), from the same
    weights: the same bf16-rounded operands summed in another f32 order, so
    an f32 sum on the edge of a bf16 rounding step can round one way on each
    backend; the output within 2e-5 (the f32 tolerance of
    test_one_step_matches_jax), each gradient within one bf16 unit (2^-8)
    of its largest entry."""
    scene, _, params, _ = nets
    ct = np.random.default_rng(9).normal(size=scene[0].shape).astype(
        np.float32)
    state = transition_state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              params))
    res = {}
    for backend in ("fused_cconv", "brute"):
        net = ParticleNet(search_backend=backend, conv_precision="default",
                          device="cpu", **TIGHT)
        net.load_state_dict(state)
        res[backend] = _loss_and_grads_port(net, scene, ct)
    (out_f, g_f), (out_b, g_b) = res["fused_cconv"], res["brute"]
    np.testing.assert_allclose(out_f, out_b, rtol=0, atol=2e-5)
    for name, g in g_f.items():
        np.testing.assert_allclose(g, g_b[name], rtol=0,
                                   atol=2.0 ** -8 * np.abs(g_b[name]).max(),
                                   err_msg=name)


def test_trainer_net_and_its_clone_carry_conv_precision():
    """TRAIN.conv_precision reaches every conv layer of the transition
    trainer's net (`build_particle_net`, JAX's default 'highest' when
    unset), and `clone` (the protocol runner's retry with doubled caps)
    keeps it."""
    from neurofluid_torch.models.particle_net import ContinuousConvLayer
    from neurofluid_torch.train.transition import build_particle_net
    from neurofluid_torch.utils.config import ConfigNode

    def precisions(net):
        return {m.precision for m in net.modules()
                if isinstance(m, ContinuousConvLayer)}

    gen = torch.Generator().manual_seed(0)
    net = build_particle_net(ConfigNode(dict(TRAIN=dict(
        conv_precision="DEFAULT", search_backend="fused_cconv"))),
        device="cpu", generator=gen)
    assert precisions(net) == {"default"}
    assert precisions(net.clone(fluid_neighbor_k=128)) == {"default"}
    unset = build_particle_net(ConfigNode(dict(TRAIN=dict())), device="cpu",
                               generator=gen)
    assert precisions(unset) == {"highest"}
