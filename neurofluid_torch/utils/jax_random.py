"""JAX's seeded random draws, in numpy: what flax's initialisers need.

A seeded trainer of the JAX package starts from `jax.random.PRNGKey(seed)`
and flax draws every parameter from a key folded out of it. This module
reproduces those draws on the host with `uint32` numpy arithmetic and no
JAX, so that the port's trainers start from the weights the JAX package's
trainers start from. Each function is named and shaped like its
counterpart in `jax.random`; a key is a `uint32` array of shape (2,).

Pinned behaviour:

- JAX 0.9.0's default PRNG, threefry2x32, with `jax_threefry_partitionable`
  True (the default since JAX 0.5.0): `random_bits` and `split` feed
  threefry the flattened element index as (hi, lo) words; bits are
  `out0 ^ out1`, `split` stacks `(out0, out1)`. Under the older,
  non-partitionable default every draw differs. `PROTOCOL_R5.json` does not
  name the JAX it ran on; had that JAX predated the partitionable default,
  R5's own initial weights differ from the ones drawn here.
- flax 0.12.3's `_fold_in_static` with `flax_fix_rng_separator` False (its
  default): a parameter's key is `fold_in(root, h)`, `h` the first 4
  big-endian bytes of the SHA-1 over the scope names and the scope's
  per-collection counter (minimal big-endian bytes), with no separator.
- JAX's default 32-bit mode (`jax_enable_x64` off, as the JAX package
  runs): `PRNGKey(seed)` keeps the seed's low 32 bits and a high word of 0.

Everything here equals JAX's CPU results bitwise (`tests/
test_torch_jax_random.py`), `truncated_normal` included: it follows JAX's
f32 steps through XLA's f32 `ErfInv` (M. Giles, "Approximating the erfinv
function", single precision) and the `log1p` and `log` it calls, with
XLA's CPU contraction of `x * y + z` into one fused multiply-add.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k1, k2, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (JAX's `threefry2x32_p`): the key words
    `k1`, `k2` and counter words `x0`, `x1` (broadcast uint32 arrays) ->
    the two output words."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(_PARITY))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` in JAX's 32-bit mode: (0, the seed's low
    32 bits; a negative seed in two's complement)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    """The flattened element index over `shape` as (hi, lo) uint32 words
    (JAX's `iota_2x32_shape`)."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: (num, 2) keys."""
    hi, lo = _iota_2x32((num,))
    out0, out1 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([out0, out1], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    out0, out1 = threefry2x32(key[0], key[1], _U32(0), _U32(data))
    return np.array([out0, out1], _U32)


def random_bits(key, shape) -> np.ndarray:
    """`jax.random.bits(key, shape)`: uint32 bits of `shape`."""
    hi, lo = _iota_2x32(tuple(shape))
    out0, out1 = threefry2x32(key[0], key[1], hi, lo)
    return out0 ^ out1


def _fma32(a, b, c) -> np.ndarray:
    """f32 fused multiply-add, a * b + c rounded once, as XLA's CPU code
    contracts `x * y + z`: the product is exact in f64, the sum is rounded
    to odd in f64 (53 bits, enough that rounding it to f32 is rounding the
    exact sum)."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    bits = s.view(np.uint64)
    odd = (bits & np.uint64(1)) == np.uint64(1)
    away = (err > 0) == (s > 0)
    step = np.where(away, np.uint64(1), np.uint64(0xFFFFFFFFFFFFFFFF))
    with np.errstate(over="ignore"):
        bits = np.where((err != 0) & ~odd, bits + step, bits)
    return bits.view(np.float64).astype(np.float32)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: 23 random
    mantissa bits under exponent 0, less 1, scaled and shifted in f32 (one
    fused multiply-add)."""
    minval, maxval = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    return np.maximum(minval, _fma32(floats, maxval - minval, minval))


# XLA's CPU f32 log (Cephes' logf): log(1 + x) on [sqrt(1/2), sqrt(2))
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
# XLA's log1p below |x| = sqrt(2) - 1 (Cephes): numerator and denominator,
# highest power first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 log of a positive normal `v`: the mantissa in
    [sqrt(1/2), sqrt(2)) by a degree-8 polynomial, plus the exponent times
    ln 2 in two parts."""
    f32 = np.float32
    bits = v.view(_U32)
    e = ((bits >> _U32(23)).astype(np.int32) - 0x7E).astype(f32)
    x = ((bits & _U32(0x807FFFFF)) | f32(0.5).view(_U32)).view(f32)
    low = x < f32(0.707106781186547524)
    e = e - np.where(low, f32(1), f32(0))
    x = (x - f32(1)) + np.where(low, x, f32(0))
    x2 = x * x
    x3 = x2 * x
    p = [f32(c) for c in _LOG_P]
    y = _fma32(_fma32(x, p[0], p[1]), x, p[2])
    y1 = _fma32(_fma32(x, p[3], p[4]), x, p[5])
    y2 = _fma32(_fma32(x, p[6], p[7]), x, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, e * f32(-2.12194440e-4))
    x = x - x2 * f32(0.5)
    return (x + y) + e * f32(0.693359375)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 log1p of `x` in (-1, 0]: Cephes' rational form below
    |x| = sqrt(2) - 1, log(1 + x) above."""
    f32 = np.float32
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma32(num, x, f32(c))
    for c in _LOG1P_DEN:
        den = _fma32(den, x, f32(c))
    x2 = x * x
    small = x + _fma32(f32(-0.5), x2, x * x2 * (num / den))
    large = _log_f32(x + f32(1))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


# XLA's f32 ErfInv: Giles' coefficients for w < 5 and for w >= 5, highest
# power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision `ErfInv` of `x` in (-1, 1): w = -log1p(-x^2);
    a degree-8 polynomial (Horner, fused multiply-adds) in w - 2.5 below
    w = 5, in sqrt(w) - 3 above; times x."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -_log1p_f32(-(x * x))
    lt = w < f32(5.0)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, np.where(lt, f32(c_lt), f32(c_ge)))
    return p * x


def truncated_normal(key, lower, upper, shape) -> np.ndarray:
    """`jax.random.truncated_normal(key, lower, upper, shape, float32)`:
    uniform between the f32 erf of the bounds over sqrt(2), sqrt(2) *
    erfinv of it, clipped inside the open interval."""
    sqrt2 = np.float32(np.sqrt(2))
    lower, upper = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lower / sqrt2)))
    b = np.float32(math.erf(float(upper / sqrt2)))
    u = uniform(key, shape, a, b)
    out = sqrt2 * erfinv_f32(u)
    return np.clip(out, np.nextafter(lower, np.float32(np.inf)),
                   np.nextafter(upper, np.float32(-np.inf))).astype(np.float32)


def flax_param_key(root, path, counter: int) -> np.ndarray:
    """The key flax gives the `counter`-th draw of a scope at `path` (a
    sequence of module names) under `root`: `_fold_in_static(root,
    (*path, counter))`."""
    h = hashlib.sha1()
    for name in path:
        h.update(name.encode("utf-8"))
    h.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(h.digest()[:4], "big"))
