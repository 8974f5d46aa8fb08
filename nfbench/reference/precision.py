"""Operand rounding of the plain reference, and a matrix product that
rounds its operands the way a lower-precision unit would.

A precision is a name: 'f32' (no rounding), 'tf32' (10 mantissa bits,
round to nearest), 'bf16' (7 mantissa bits, round to nearest even) and
'fp8' (e4m3 with one scale per tensor, its largest magnitude mapped to
448, the usual way fp8 products are fed). Products and sums are always
f32; only the operands are rounded.
"""

from __future__ import annotations

import torch

NAMES = ("f32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rounding(name: str):
    """The rounding function of a precision name."""
    if name == "f32":
        return lambda x: x
    if name == "tf32":
        return _tf32
    if name == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if name == "fp8":
        return _fp8
    raise ValueError(f"unknown precision {name!r}: expected one of {NAMES}")


class RoundedMatmul(torch.autograd.Function):
    """a @ b on rounded operands; the backward rounds the cotangent and the
    other operand before each of its two products, as a unit of that
    precision computes the transposed products (JAX's transpose of a
    `DEFAULT` dot, cuBLAS's TF32 backward)."""

    @staticmethod
    def forward(ctx, a, b, name):
        rnd = rounding(name)
        a_r, b_r = rnd(a), rnd(b)
        ctx.save_for_backward(a_r, b_r)
        ctx.name = name
        return a_r @ b_r

    @staticmethod
    def backward(ctx, ct):
        a_r, b_r = ctx.saved_tensors
        ct_r = rounding(ctx.name)(ct)
        da = ct_r @ b_r.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        db = a_r.transpose(-1, -2) @ ct_r if ctx.needs_input_grad[1] else None
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor, name: str) -> torch.Tensor:
    if name == "f32":
        return a @ b
    return RoundedMatmul.apply(a, b, name)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           name: str) -> torch.Tensor:
    """x W^T + b, the product at precision `name`."""
    return matmul(x, weight.t(), name) + bias
