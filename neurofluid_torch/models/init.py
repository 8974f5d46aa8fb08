"""Seeded parameter initialisation.

Modules are built on the meta device, moved to their device empty, and
filled from an explicit CPU `torch.Generator`, so one seed gives the same
weights on the CPU and on the card and the global RNG is never touched.

The trainers draw instead what the JAX package's trainers draw:
`flax_init_state` gives a module the parameters flax's `init` draws from a
JAX key, computed on the host by `utils.jax_random`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from neurofluid_torch.utils import jax_random


def generator_or_default(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


@torch.no_grad()
def uniform_(param: torch.Tensor, bound: float, generator: torch.Generator):
    sample = torch.empty(param.shape, dtype=torch.float32)
    param.copy_(sample.uniform_(-bound, bound, generator=generator))


# the standard deviation of N(0, 1) truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


def init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax's `Dense` default, the JAX package's: the weight `lecun_normal`
    (N(0, 1) truncated to [-2, 2], scaled to variance 1 / in_features) and
    a zero bias, drawn from `generator`.

    Not PyTorch's default U(+-1/sqrt(in)) for weight and bias: under it
    the NeRF's sigma head often starts below zero at every sample of a
    scene (the warm-up of the protocol run, seed 10, began so in its
    coarse MLP), and the ReLU on sigma then passes that MLP no gradient,
    ever."""
    # N(0, 1) truncated to [-2, 2] by the inverse CDF of a uniform draw
    # (torch.nn.init.trunc_normal_'s method, written out: its own draws
    # change between torch versions, and one seed must give one set of
    # weights wherever the port runs)
    edge = math.erf(2.0 / math.sqrt(2.0))
    sample = torch.empty(layer.weight.shape, dtype=torch.float32)
    sample.uniform_(-edge, edge, generator=generator)
    sample = (torch.erfinv(sample) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
    scale = 1.0 / (math.sqrt(layer.in_features) * TRUNCATED_STD)
    with torch.no_grad():
        layer.weight.copy_(sample * scale)
        layer.bias.zero_()


# ----------------------------------------------------------------------
# flax's initial parameters from a JAX key
# ----------------------------------------------------------------------

# the draws of one flax scope, in creation order: `nn.Dense` and the
# ContinuousConvLayer both create `kernel`, then `bias`
_FLAX_PARAM_ORDER = {"kernel": 1, "bias": 2}


def _fans(shape) -> tuple[int, int]:
    """flax's fans (in_axis -2, out_axis -1): each times the receptive
    field, the product of the leading axes."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def lecun_normal(key, shape) -> np.ndarray:
    """flax's `lecun_normal()`: `variance_scaling(1, 'fan_in',
    'truncated_normal')`, in JAX's f32 order."""
    fan_in, _ = _fans(shape)
    variance = np.float32(1.0 / fan_in)
    stddev = np.sqrt(variance) / np.float32(TRUNCATED_STD)
    return jax_random.truncated_normal(key, -2.0, 2.0, shape) * stddev


def glorot_uniform(key, shape) -> np.ndarray:
    """flax's `glorot_uniform()`: `variance_scaling(1, 'fan_avg',
    'uniform')`, in JAX's f32 order."""
    fan_in, fan_out = _fans(shape)
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    return (jax_random.uniform(key, shape, -1.0, 1.0)
            * np.sqrt(np.float32(3) * variance))


def zeros(key, shape) -> np.ndarray:
    """flax's `zeros`: it draws nothing, but its key still takes a place in
    its scope's count."""
    return np.zeros(shape, np.float32)


# the port's parameter leaf -> flax's initialiser: a Linear's weight is a
# `nn.Dense` kernel, a bare `kernel` the ContinuousConvLayer's
_FLAX_INIT = {"weight": lecun_normal, "kernel": glorot_uniform,
              "bias": zeros}


def flax_init_state(module: nn.Module, key) -> dict:
    """The state_dict of `module` (a port RenderNet or ParticleNet) holding
    what flax's `init` under the JAX `key` draws for its JAX counterpart:
    each parameter from `flax_param_key(key, scope path, creation count)`,
    by the flax initialiser of its layer, converted as JAX params are."""
    from neurofluid_torch.models.render_net import RenderNet
    from neurofluid_torch.utils import params

    tree = {}
    for name, p in module.named_parameters():
        path, leaf, transposed = params.flax_param_path(name)
        shape = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
        sub = jax_random.flax_param_key(key, path, _FLAX_PARAM_ORDER[leaf])
        node = tree
        for scope in path:
            node = node.setdefault(scope, {})
        node[leaf] = _FLAX_INIT[name.rsplit(".", 1)[1]](sub, shape)
    if isinstance(module, RenderNet):
        return params.renderer_state_from_flax(tree)
    return params.transition_state_from_flax(tree)
