"""Checkpoint save/restore with the reference's staged-transfer semantics
(port of neurofluid_tpu/train/checkpoint.py over `torch.save`).

The reference saves torch state dicts {step, renderer_state_dict,
transition_model_state_dict, optimizer_state_dict} every save_interval
as `<exp>/models/<step>.pt` (reference trainer/trainer_e2e.py:152-158,
trainer_renderer.py:68-72, trainer_transmodel.py:216-220); so does this
module, one `torch.save` file per step. It supports the cross-stage
transfers:
- loading a transition model while stripping the `gravity` buffer
  (reference trainer/basetrainer.py:87-103): gravity is config in both
  packages, so `transition_state` drops it,
- partial renderer load of only `sigma` / `xyz_encoding` parameters
  (reference trainer/basetrainer.py:106-122), `merge_renderer_params`.

State dicts keep the upstream layout (`nerf_coarse.sigma.weight`,
`conv0_fluid.kernel`, ...), so an upstream state_dict loads into the port's
modules as it is.
"""

from __future__ import annotations

import os
import os.path as osp
import re

import torch


def checkpoint_path(directory: str, step: int) -> str:
    return osp.join(directory, f"{step}.pt")


def save_checkpoint(directory: str, step: int, state: dict) -> str:
    """Save `state` (tensors, numbers and nested dicts and lists of them,
    such as state_dicts) as <directory>/<step>.pt."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a reader sees a whole file or none
    return path


def latest_step(directory: str) -> int | None:
    if not osp.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"(\d+)\.pt", f))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None):
    """(state, step) of <directory>/<step>.pt, the latest step when `step`
    is None; tensors on the CPU."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    state = torch.load(checkpoint_path(directory, step), map_location="cpu",
                       weights_only=True)
    return state, step


def transition_state(state: dict) -> dict:
    """A transition model's state_dict without the upstream `gravity`
    buffer (reference basetrainer.py:87-103); gravity is config here."""
    return {k: v for k, v in state.items() if k != "gravity"}


def merge_renderer_params(target: dict, loaded: dict,
                          partial_load: bool = False) -> dict:
    """`target` (a RenderNet state_dict) with the entries of `loaded`
    overlaid. With `partial_load`, only parameters whose name mentions
    `sigma` or `xyz_encoding` are transferred (reference
    basetrainer.py:114-121): the warm-started geometry trunk, leaving the
    colour heads fresh. Keys of `loaded` that `target` lacks are ignored,
    as the reference's state_dict.update leaves them unused."""
    out = dict(target)
    for name, value in loaded.items():
        if partial_load and not ("sigma" in name or "xyz_encoding" in name):
            continue
        if name in out:
            out[name] = value
    return out
