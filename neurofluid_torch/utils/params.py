"""Flax parameter trees (as numpy) -> port state_dicts.

The port's modules use the upstream NeuroFluid state_dict layout, the one
`neurofluid_tpu/utils/torch_import.py` reads:

- ParticleNet: `conv0_fluid.kernel` (kz, ky, kx, Cin, Cout) and `.bias`
  as they are; `dense*.weight` (out, in) = flax kernel.T, `.bias`;
- RenderNet: `nerf_coarse.xyz_encoding_1.0.weight` (the Linear inside
  Sequential(Linear, ReLU)), likewise `dir_encoding.0` and `rgb.0`; bare
  `xyz_encoding_final` and `sigma`.

`flax_param_path` is the inverse of that naming, parameter by parameter.
"""

from __future__ import annotations

import numpy as np
import torch

_SEQUENTIAL = ("dir_encoding", "rgb")


def _params(tree: dict) -> dict:
    return tree["params"] if "params" in tree else tree


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def flax_param_path(name: str) -> tuple[tuple[str, ...], str, bool]:
    """A port parameter's name -> (its flax scope path, its flax leaf name,
    whether the port holds it transposed): `nerf_fine.rgb.0.weight` ->
    (("nerf_fine", "rgb"), "kernel", True), `conv0_fluid.kernel` ->
    (("conv0_fluid",), "kernel", False). The inverse of the converters
    below: Sequential indices dropped, a Linear's `weight` is flax's
    `kernel` transposed."""
    *path, leaf = name.split(".")
    path = tuple(p for p in path if not p.isdigit())
    if leaf == "weight":
        return path, "kernel", True
    if leaf in ("kernel", "bias"):
        return path, leaf, False
    raise ValueError(f"no flax counterpart for parameter {name!r}")


def transition_state_from_flax(tree: dict) -> dict:
    """Flax ParticleNet params ({"params": ...} or the inner dict) ->
    ParticleNet state_dict."""
    state = {}
    for layer, p in _params(tree).items():
        if layer.startswith("conv"):
            state[f"{layer}.kernel"] = _tensor(p["kernel"])
        elif layer.startswith("dense"):
            state[f"{layer}.weight"] = _tensor(np.asarray(p["kernel"]).T)
        else:
            raise ValueError(f"unknown ParticleNet layer {layer!r}")
        state[f"{layer}.bias"] = _tensor(p["bias"])
    return state


def nerf_state_from_flax(tree: dict, prefix: str = "") -> dict:
    """Flax NeRF params -> NeRF state_dict, keys prefixed by `prefix`."""
    state = {}
    for layer, p in _params(tree).items():
        seq = layer.startswith("xyz_encoding_") and layer != "xyz_encoding_final"
        name = f"{prefix}{layer}.0" if seq or layer in _SEQUENTIAL else f"{prefix}{layer}"
        state[f"{name}.weight"] = _tensor(np.asarray(p["kernel"]).T)
        state[f"{name}.bias"] = _tensor(p["bias"])
    return state


def renderer_state_from_flax(tree: dict) -> dict:
    """Flax RenderNet params -> RenderNet state_dict."""
    params = _params(tree)
    state = {}
    for net in ("nerf_coarse", "nerf_fine"):
        state.update(nerf_state_from_flax(params[net], prefix=f"{net}."))
    return state
