"""The JAX package's conv contractions at `jax.lax.Precision.DEFAULT` as the
TPU computes them, for the CPU tests of the port's `conv_precision='default'`.

On the TPU a `DEFAULT` f32 dot is one bf16 MXU pass: both operands rounded
to bf16, the products summed in f32. XLA on the CPU computes the same dot
in f32, so the JAX package's own functions cannot show the difference here.
`bf16_einsum` puts the rounding in by hand: a `jax.custom_vjp` whose forward
rounds both operands with `lax.reduce_precision(x, 8, 7)` and whose backward
rounds the cotangent and the other operand before each product, as JAX's
transpose of a `DEFAULT` dot runs on the TPU; every product is taken in
float64 after the rounding (numpy, through `jax.pure_callback`).
`continuous_conv_default` applies it to the JAX package's public geometry
(`cconv_tap_matrix`) and the two einsums of `continuous_conv_apply`.

The tests hold each port result at 'default' to this oracle by its mean
absolute deviation: at least MARGIN times smaller than the deviation from
JAX's 'highest' result. An f32 result cannot pass, and neither can a bf16
result rounded at the wrong operands (one bf16 rounding is about 2^-9 of a
value, f32's 2^-24)."""

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from neurofluid_tpu.ops import cconv as jcc

MARGIN = 10.0


def bf16(x):
    """`lax.reduce_precision(x, 8, 7)`: f32 -> the nearest bf16, ties to
    even, as f32."""
    return lax.reduce_precision(jnp.asarray(x, jnp.float32), exponent_bits=8,
                                mantissa_bits=7)


def _product(spec):
    def run(a, b):
        return np.einsum(spec, np.asarray(a, np.float64),
                         np.asarray(b, np.float64)).astype(np.float32)
    return run


def bf16_einsum(spec):
    """jnp.einsum(spec, a, b) at the TPU's `DEFAULT` precision, for a spec
    of two operands whose every index appears in two of the three terms."""
    ins, out = spec.split("->")
    sa, sb = ins.split(",")
    fwd = _product(spec)
    grad_a = _product(f"{out},{sb}->{sa}")
    grad_b = _product(f"{sa},{out}->{sb}")

    def call(fn, x, y, like):
        return jax.pure_callback(fn, jax.ShapeDtypeStruct(like, jnp.float32),
                                 bf16(x), bf16(y))

    @jax.custom_vjp
    def product(a, b):
        shape = jax.eval_shape(lambda x, y: jnp.einsum(spec, x, y), a, b)
        return call(fwd, a, b, shape.shape)

    def product_fwd(a, b):
        return product(a, b), (a, b)

    def product_bwd(res, ct):
        a, b = res
        return call(grad_a, ct, b, a.shape), call(grad_b, a, ct, b.shape)

    product.defvjp(product_fwd, product_bwd)
    return product


_basis = bf16_einsum("qtk,qkc->qtc")
_fold = bf16_einsum("qtc,tco->qo")


def continuous_conv_default(filters, corner, tapw, feats, neighbors,
                            kernel_size=(4, 4, 4), tap_matrix=None, **_):
    """`neurofluid_tpu.ops.cconv.continuous_conv_apply` with its two
    einsums at the TPU's `DEFAULT` (its keywords accepted, its chunking
    and gather plan immaterial to the sums)."""
    num_taps = int(np.prod(kernel_size))
    cin, cout = filters.shape[-2], filters.shape[-1]
    gathered = feats[jnp.maximum(neighbors.idx, 0)]
    nb_feats = jnp.where(neighbors.mask[..., None], gathered, 0.0)
    tw = tap_matrix if tap_matrix is not None else jcc.cconv_tap_matrix(
        corner, tapw, num_taps)
    return _fold(_basis(tw, nb_feats), filters.reshape(num_taps, cin, cout))


def mean_dev(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).mean())


def assert_bf16_oracle(name, got, oracle, highest, margin=MARGIN):
    """`got` (a port result at 'default') is MARGIN times closer to the
    oracle than to JAX's 'highest' result, by mean absolute deviation; and
    'default' moves the result at all."""
    d_oracle, d_highest = mean_dev(got, oracle), mean_dev(got, highest)
    assert d_highest > 0.0, name
    assert margin * d_oracle <= d_highest, (name, d_oracle, d_highest)
    return d_oracle, d_highest
