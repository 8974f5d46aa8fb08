"""Port parity, the transition-only train step: three steps of the port's
`make_transition_train_step` against the step of
neurofluid_tpu.train.transition (`TransitionTrainer.build_steps`, written
out here as bench.py writes it: two chained ParticleNet steps, 0.5 wmse +
0.5 wmse + boundary + boundary, optax `clip_by_global_norm(1.0)` then
`adam(1e-4)`), on four search backends, with the same weights through
`transition_state_from_flax`. On the 200-particle scene `'auto'` searches
the fluid by brute force and the box (32 particles) by grid, since both
trainers pass the box's grid (JAX's `make_grid`, the port's
`make_box_plan`); `'grid'` searches both by grid.

On the list backends JAX runs its segment-sum Pallas kernel in interpret
mode (NF_SEGSUM_PALLAS=1) and its compact query through the XLA composition
(what backend="auto" picks on the CPU; the Pallas query kernel is held
against the port in tests/test_torch_fused_query.py). On `fused_cconv` the
second step asks the fused conv for its position gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurofluid_tpu.models.particle_net import ParticleNet as JParticleNet
from neurofluid_tpu.train import losses as jlosses
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.train import losses as tlosses
from neurofluid_torch.train.transition import make_transition_train_step
from neurofluid_torch.utils.params import transition_state_from_flax

# two layers (three convs): what JAX compiles for the fused_cconv step in
# interpret mode grows with every conv; the residual layers are held in
# tests/test_torch_particle_net.py
TIGHT = dict(grid_lower=(-0.5, -0.5, -0.65), grid_upper=(0.5, 0.5, 0.55),
             fused_cell_scale=2.0, layer_channels=(8, 3),
             gravity=(0, 0, -9.81))
LR, CLIP, STEPS = 1e-4, 1.0, 3
# tight box bounds, so that some predicted particles lie outside and the
# boundary loss has a gradient
LO = np.asarray([-0.2, -0.2, -0.3], np.float32)
HI = np.asarray([0.2, 0.2, 0.2], np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _keep_grads():
    """An identity optax transform whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _scene():
    rng = np.random.default_rng(5)
    n, m = 200, 32
    pos = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    box = rng.uniform(-0.45, 0.45, (m, 3)).astype(np.float32)
    box[:, 2] = -0.3
    nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (m, 1))
    return pos, vel, (pos + 0.001).astype(np.float32), \
        (pos + 0.002).astype(np.float32), box, nrm


def _jax_steps(backend):
    """The JAX model's own initial weights and STEPS jitted train steps:
    (weights, per step (loss, aux, raw gradients), final weights)."""
    pos0, vel0, pos1, pos2, box, nrm = map(jnp.asarray, _scene())
    net = JParticleNet(search_backend=backend, conv_precision="highest",
                       **TIGHT)
    params = net.init(jax.random.PRNGKey(1), pos0, vel0, box, nrm)
    tx = optax.chain(_keep_grads(), optax.clip_by_global_norm(CLIP),
                     optax.adam(LR))
    bounds = jlosses.BoxBounds(jnp.asarray(LO), jnp.asarray(HI))

    def train_step(params, opt_state):
        box_grid = net.make_grid(box)

        def one_step(p, pos, vel):
            return net.apply(p, pos, vel, box, nrm, return_diag=True,
                             box_grid=box_grid)

        def loss_fn(p):
            pred1, v1, nn1, diag1 = one_step(p, pos0, vel0)
            pred2, _, nn2, diag2 = one_step(p, pred1, v1)
            l1 = jlosses.weighted_mse_loss(pred1, pos1, nn1)
            l2 = jlosses.weighted_mse_loss(pred2, pos2, nn2)
            b1 = jlosses.boundary_loss(pred1, bounds)
            b2 = jlosses.boundary_loss(pred2, bounds)
            return 0.5 * l1 + 0.5 * l2 + b1 + b2, {
                "loss1": l1, "loss2": l2, "bloss1": b1, "bloss2": b2,
                "search_overflow": jnp.logical_or(diag1["grid_overflow"],
                                                  diag2["grid_overflow"]),
                "search_cap_exceeded": jnp.logical_or(diag1["cap_exceeded"],
                                                      diag2["cap_exceeded"]),
            }

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        aux["grad_norm"] = optax.global_norm(grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, aux

    step = jax.jit(train_step)
    weights = _np(params)
    state = tx.init(params)
    steps = []
    for _ in range(STEPS):
        params, state, loss, aux = step(params, state)
        steps.append((float(loss), _np(aux), _np(state[0])))
    return weights, steps, _np(params)


@pytest.fixture(scope="module", params=["fused_cconv", "fused", "grid",
                                        "auto"])
def runs(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NF_SEGSUM_PALLAS", "1")
        return request.param, _jax_steps(request.param)


def _port(backend, weights, clip=CLIP):
    net = ParticleNet(device="cpu", search_backend=backend, **TIGHT)
    net.load_state_dict(transition_state_from_flax(weights))
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    bounds = tlosses.BoxBounds(torch.from_numpy(LO), torch.from_numpy(HI))
    return net, make_transition_train_step(net, opt, bounds, clip)


def _assert_grads(net, want_state):
    for name, p in net.named_parameters():
        want = want_state[name].numpy()
        # relative to the leaf's largest entry: f32 sums in another order
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=name)


def test_transition_steps_match_jax(runs):
    backend, (weights, steps, final) = runs
    net, step = _port(backend, weights)
    data = list(map(torch.from_numpy, _scene()))
    box_plan = net.make_box_plan(data[4])
    losses_t = []
    for i, (loss_j, aux_j, grads_j) in enumerate(steps):
        loss, aux = step(*data, box_plan=box_plan)
        losses_t.append(float(loss))
        np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
        assert set(aux) == set(aux_j)
        for key in ("search_overflow", "search_cap_exceeded"):
            assert bool(aux[key]) == bool(aux_j[key]) is False, key
        for key in ("loss1", "loss2", "bloss1", "bloss2", "grad_norm"):
            np.testing.assert_allclose(aux[key].numpy(), aux_j[key],
                                       rtol=2e-4, atol=1e-9, err_msg=key)
        assert float(aux["bloss2"]) > 0 and float(aux["grad_norm"]) > 0
        if i == 0:  # below the clip, so p.grad is the raw gradient
            assert float(aux["grad_norm"]) < CLIP
            _assert_grads(net, transition_state_from_flax(grads_j))
    assert losses_t[-1] < losses_t[0]
    # Adam moves each entry by ~lr per step whatever its gradient's size,
    # so after three steps the weights agree within 2 lr
    want = transition_state_from_flax(final)
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * LR, err_msg=name)
        assert float((p - transition_state_from_flax(weights)[name])
                     .abs().max()) > 0.5 * LR, name


def test_clipped_step_matches_optax(runs):
    """One step with a clip below the gradient norm: the clipped gradients
    and the updated weights follow optax's chain(clip_by_global_norm, adam)
    on JAX's gradients."""
    backend, (weights, steps, _) = runs
    grads_j = steps[0][2]
    clip = 0.5 * float(steps[0][1]["grad_norm"])
    net, step = _port(backend, weights, clip=clip)
    _, aux = step(*map(torch.from_numpy, _scene()))
    assert float(aux["grad_norm"]) > clip
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(LR))
    clipped, _ = optax.clip_by_global_norm(clip).update(grads_j, None)
    updates, _ = tx.update(grads_j, tx.init(weights), weights)
    _assert_grads(net, transition_state_from_flax(_np(clipped)))
    new = transition_state_from_flax(_np(optax.apply_updates(weights,
                                                             updates)))
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), new[name].numpy(), rtol=0,
                                   atol=2 * LR, err_msg=name)


def test_backends_agree_on_the_first_step(runs):
    """Same weights, no count above its cap: the step's loss and gradients
    on this backend and on another (`fused_cconv`; `fused` for
    `fused_cconv`) agree to f32 rounding."""
    backend, (weights, _, _) = runs
    other = "fused" if backend == "fused_cconv" else "fused_cconv"
    res = []
    for b in (backend, other):
        net, step = _port(b, weights)
        loss, aux = step(*map(torch.from_numpy, _scene()))
        res.append((float(loss), aux, net))
    (la, aa, na), (lb, ab, nb) = res
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    np.testing.assert_allclose(float(aa["grad_norm"]), float(ab["grad_norm"]),
                               rtol=1e-4)
    for (name, p), q in zip(na.named_parameters(), nb.parameters()):
        np.testing.assert_allclose(
            p.grad.numpy(), q.grad.numpy(), rtol=0,
            atol=1e-4 * float(q.grad.abs().max()) + 1e-12, err_msg=name)
