"""Port parity, the transition trainer: neurofluid_torch.train.transition
`TransitionTrainer` against neurofluid_tpu's on the tiny synthetic scene
(tests/test_torch_trainer_common.py), on the CPU.

(a) The host loop: both trainers' `train_step`, `eval` and
    `save_checkpoint` replaced by recorders for four epochs: the same
    samples (shuffled order and random z-rotations) reach the step, and
    the logged tags, the checkpoint and the eval steps agree.
(b) The step's math: one real epoch of each from JAX's initial weights, at
    the settings of tests/test_train.py's one-epoch test (search backend
    'brute', clip 1.0, lr 1e-4): per-step loss within rtol 1e-5 and the
    final weights within 2 lr (tests/test_torch_train.py's tolerances).
(c) Resume: the port restores weights and optimizer state and continues at
    the saved step, as JAX's does.
"""

import jax
import numpy as np
import pytest
import torch

from neurofluid_tpu.train.transition import (
    TransitionTrainer as JTransitionTrainer,
)
from neurofluid_torch.train.transition import TransitionTrainer
from neurofluid_torch.utils.params import transition_state_from_flax
from test_torch_trainer_common import (
    CallRecorder, StepRecorder, assert_calls_equal, configs, metric_events,
    metric_values, write_scene,
)

LR = 1e-4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("scene")))


def _cfg(root, **train):
    return dict(
        expname="trans", resume_from="",
        TRAIN=dict(dict(seed=10, N_iters=1, save_interval=100,
                        log_interval=100, lr=LR, grad_clip_value=1.0,
                        start_index=0, end_index=4, particle_radius=0.025,
                        gravity=[0.0, 0.0, -9.81], pretrained="",
                        search_backend="brute",
                        datapath=dict(train=root, train_datatype="blender_all",
                                      eval=root, eval_datatype="blender_all")),
                   **train),
    )


def test_host_loop_matches_jax(scene, tmp_path):
    jcfg, tcfg = configs(_cfg(scene, log_interval=3, save_interval=2),
                         tmp_path)
    jtr, ttr = JTransitionTrainer(jcfg), TransitionTrainer(tcfg, device="cpu")
    aux_keys = ("loss1", "loss2", "bloss1", "bloss2", "search_cap_exceeded",
                "grad_norm")

    def jax_result(i, params, opt_state, *_):
        aux = {k: np.float32(i) for k in aux_keys}
        aux["search_overflow"] = np.bool_(False)
        return params, opt_state, np.float32(i), aux

    def torch_result(i, *_):
        aux = {k: torch.tensor(float(i)) for k in aux_keys}
        aux["search_overflow"] = torch.tensor(False)
        return torch.tensor(float(i)), aux

    jtr.train_step, ttr.train_step = (StepRecorder(jax_result),
                                      StepRecorder(torch_result))
    for tr in (jtr, ttr):
        tr.eval, tr.save_checkpoint = CallRecorder(), CallRecorder()
        tr.train(n_epochs=4)
    # JAX's step takes (params, opt_state, pos0, vel0, pos1, pos2, box, nrm)
    jcalls = [c[2:] for c in jtr.train_step.calls]
    assert len(jcalls) == 4 * len(ttr.dataset) == 24
    assert_calls_equal(ttr.train_step.calls, jcalls, "train_step")
    # the rotations differ from sample to sample
    assert not np.array_equal(jcalls[0][4], jcalls[1][4])
    assert ttr.save_checkpoint.calls == jtr.save_checkpoint.calls == [
        (6,), (12,), (18,), (24,)]
    assert ttr.eval.calls == jtr.eval.calls == [(12,), (24,)]
    assert metric_events(ttr.exppath) == metric_events(jtr.exppath)


@pytest.fixture(scope="module")
def trained(scene, tmp_path_factory):
    """One real epoch of each trainer, each from its own initial draw (the
    port's is JAX's), and the two initial states."""
    tmp = tmp_path_factory.mktemp("epoch")
    jcfg, tcfg = configs(_cfg(scene, log_interval=1), tmp)
    jtr, ttr = JTransitionTrainer(jcfg), TransitionTrainer(tcfg, device="cpu")
    init = (transition_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params)),
        {k: v.clone() for k, v in ttr.net.state_dict().items()})
    jtr.train(n_epochs=1)
    ttr.train(n_epochs=1)
    return jtr, ttr, tcfg, init


def test_initial_weights_are_jax_draw(trained):
    """From one config (TRAIN.seed 10) the port's trainer starts from the
    JAX trainer's initial ParticleNet: flax's init under the first key of
    PRNGKey(10), drawn by the port on the host."""
    want, got = trained[3]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w.numpy(),
                                      err_msg=name)


def test_one_epoch_matches_jax(trained):
    jtr, ttr, _, _ = trained
    losses_j = metric_values(jtr.exppath, "loss")
    losses_t = metric_values(ttr.exppath, "loss")
    assert len(losses_t) == len(losses_j) == 6
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    for key in ("loss1", "loss2", "grad_norm"):
        np.testing.assert_allclose(metric_values(ttr.exppath, key),
                                   metric_values(jtr.exppath, key),
                                   rtol=1e-4, err_msg=key)
    # Adam moves each entry by ~lr per step whatever its gradient's size:
    # the weights agree within 2 lr
    want = transition_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params))
    for name, p in ttr.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * LR, err_msg=name)


def test_resume_restores_optimizer(trained):
    jtr, ttr, tcfg, _ = trained
    # each saved after its epoch, at global step 6
    jtr.resume(jtr.modelpath)
    resumed = TransitionTrainer(tcfg.clone().merge(
        dict(resume_from=ttr.modelpath)), device="cpu")
    assert resumed.start_step == jtr.start_step == 6
    state = resumed.optimizer.state_dict()["state"]
    assert {int(s["step"]) for s in state.values()} == {6}
    for name, p in resumed.net.state_dict().items():
        np.testing.assert_array_equal(p.numpy(),
                                      ttr.net.state_dict()[name].numpy())
    want = ttr.optimizer.state_dict()["state"]
    for i, s in state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(s[k].numpy(), want[i][k].numpy())
