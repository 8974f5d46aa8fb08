"""Seeded parameter initialisation.

Modules are built on the meta device, moved to their device empty, and
filled from an explicit CPU `torch.Generator`, so one seed gives the same
weights on the CPU and on the card and the global RNG is never touched.
"""

from __future__ import annotations

import math

import torch
from torch import nn


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

