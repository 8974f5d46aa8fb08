"""Shared pieces of the trainer parity tests (tests/test_torch_trainer_*.py
and tests/test_torch_evaluation.py); it holds no test of its own.

- the tiny synthetic scene of tests/test_train.py (3^3 particles, 4 frames,
  24 x 24 views; here two training views, so that a step's loop over views
  has more than one), written by the port's `data.synthetic`;
- the trainers' configs at that size, one dict that both packages' trainers
  read (each through its own ConfigNode);
- `StepRecorder`, which stands in for a trainer's `train_step`, keeps each
  call's array arguments on the host and returns what the caller asks.
"""

import json
import os

import jax
import numpy as np
import torch

from neurofluid_tpu.utils.config import ConfigNode as JConfigNode
from neurofluid_torch.data import synthetic
from neurofluid_torch.utils.config import ConfigNode

SCENE = dict(n_frames=4, n_side=3, img_wh=(24, 24),
             train_views=("view_1", "view_2"), test_views=("view_5",))


def write_scene(root: str) -> str:
    synthetic.generate_blender_scene(root, **SCENE)
    return root


def scene_cfg(root: str) -> dict:
    return dict(
        data_type="splishsplash", near=9.0, far=13.0,
        gravity=[0.0, 0.0, -9.81],
        train=dict(start_index=0, end_index=4, path=root,
                   views=dict(warmup=["view_1", "view_2"],
                              dynamic=["view_1"])),
        test=dict(start_index=0, end_index=4, path=root, views=["view_5"]),
    )


def renderer_cfg() -> dict:
    """tests/test_train.py's tiny renderer; full-image evals in chunks of
    64 rays."""
    return dict(
        ray=dict(ray_chunk=64, N_importance=4, N_samples=8,
                 eval_ray_chunk=64),
        NN_search=dict(fix_radius=True, particle_radius=0.025,
                       search_radius_scale=9.0, N_neighbor=6,
                       backend="brute", mode="dense"),
        encoding=dict(density=True, var=True, smoothed_pos=True,
                      smoothed_dir=True, exclude_ray=True,
                      same_smooth_factor=False),
        use_mask=True,
    )


def configs(cfg: dict, tmp_path):
    """(JAX config, port config) of one dict, each with its own expdir."""
    return (JConfigNode(dict(cfg, expdir=str(tmp_path / "jax"))),
            ConfigNode(dict(cfg, expdir=str(tmp_path / "torch"))))


def host(x):
    """An array argument on the host; anything else (a grid, a plan,
    None) as None."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (np.ndarray, jax.Array)):
        return np.asarray(x)
    return None


class StepRecorder:
    """A train_step stand-in: records each call's arguments (on the host)
    and returns `result(i, *args)` for call i."""

    def __init__(self, result):
        self.result = result
        self.calls = []

    def __call__(self, *args):
        self.calls.append([host(a) for a in args])
        return self.result(len(self.calls) - 1, *args)


class CallRecorder:
    """Stands in for a trainer method (eval, save_checkpoint): records the
    arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append(args)


def assert_calls_equal(got, want, what, atol=0.0):
    """Recorded calls equal, argument by argument; `atol` for arrays that
    each package computes on its own (the pixel rays: within 1e-6, as
    tests/test_torch_data.py holds them)."""
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (what, i)
        for j, (a, b) in enumerate(zip(g, w)):
            if a is None or b is None:
                assert a is None and b is None, (what, i, j)
                continue
            assert a.shape == b.shape, (what, i, j, a.shape, b.shape)
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=f"{what} call {i} argument {j}")


def metric_events(exppath) -> list:
    """(tag, step) of every event in <exppath>/metrics.jsonl."""
    with open(os.path.join(exppath, "metrics.jsonl")) as f:
        return [(e["tag"], e["step"]) for e in map(json.loads, f)]


def metric_values(exppath, tag) -> list:
    with open(os.path.join(exppath, "metrics.jsonl")) as f:
        return [e["value"] for e in map(json.loads, f) if e["tag"] == tag]
