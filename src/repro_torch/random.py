"""Counter-based threefry-2x32 random numbers, bit-compatible with
``jax.random`` under its default *partitionable* threefry layout.

The JAX package draws every random number of the main path from
``jax.random``; the port has to draw the same numbers so that the two
packages make the same exchange decisions from the same seed.  This
module re-implements the pieces that path uses, following the installed
``jax/_src/prng.py`` and ``jax/_src/random.py``:

  key(seed)          ``jax.random.key``: the raw key ``[seed >> 32, seed]``
  split(key, num)    ``_threefry_split_foldlike``: hash of the 64-bit
                     counters ``0 .. num - 1`` (high word, low word)
  fold_in(key, d)    ``_threefry_fold_in``: hash of the counter pair
                     ``(0, d)``
  random_bits        ``_threefry_random_bits_partitionable``: ``bits1 ^
                     bits2`` of the hashed flat-index counters
  uniform / normal   the mantissa trick of ``_uniform``, then XLA's
                     float32 ``erf_inv`` polynomial (M. Giles), ``* sqrt 2``
  permutation        ``_shuffle``: stable sorts of ``arange(n)`` by
                     32-bit random keys
  randint            ``_randint`` for int32: two words per value from a
                     split key, folded into the span with a modulus

For ``normal`` to match bit for bit, the pieces XLA's CPU backend
computes differently from PyTorch are mirrored too: its ``log1p`` and
``log`` (Cephes), its ``sqrt`` (``x * rsqrt(x)`` + one Newton step) and
the FMAs it contracts polynomial steps into (emulated in float64).

A key is an int64 tensor whose last axis holds the two uint32 words;
leading axes batch keys (the counterpart of ``vmap`` over keys), so
``normal(keys (S, R, 2), (N, 3))`` is ``(S, R, N, 3)``.  uint32
arithmetic is emulated in int64 with ``& 0xFFFFFFFF`` after every add
and shift (torch has no full uint32 arithmetic).  Every operation is a
device op on the key's device: drawing never synchronises with the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as raw key data: shape (2,), int64."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be a non-negative 64-bit int, got {seed}")
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def _words(keys: torch.Tensor, n_new: int):
    """Split (..., 2) keys into words shaped (..., 1 x n_new) so they
    broadcast against a trailing block of ``n_new`` counter axes."""
    shape = keys.shape[:-1] + (1,) * n_new
    return keys[..., 0].reshape(shape), keys[..., 1].reshape(shape)


def _counters(n: int, device, offset: int = 0):
    """The flat 64-bit counters offset .. offset+n-1 as (high, low)
    uint32 words."""
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M32


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    k1, k2 = _words(keys, 1)
    hi, lo = _counters(num, keys.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: (..., 2) keys with int (or int64 tensor
    broadcastable to ``keys[..., 0]``) data -> (..., 2)."""
    k1, k2 = keys[..., 0], keys[..., 1]
    if not torch.is_tensor(data):
        data = torch.full_like(k1, int(data) & _M32)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data & _M32)
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """32-bit random words: (..., 2) keys -> (..., *shape) int64.

    ``offset`` starts the flat counters there: the words of elements
    ``offset .. offset + prod(shape) - 1`` of a larger draw from the same
    key, bitwise (each element's words depend on its flat index alone),
    so a large draw can be made in slices."""
    shape = tuple(shape)
    n = math.prod(shape)
    k1, k2 = _words(keys, 1)
    hi, lo = _counters(n, keys.device, offset)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(keys.shape[:-1] + shape)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    return bits_to_uniform(random_bits(keys, shape), minval, maxval)


def bits_to_uniform(bits: torch.Tensor, minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """32-bit words -> float32 on [minval, maxval), ``_uniform``'s map."""
    one = (bits >> 9) | 0x3F800000                 # mantissa bits, exponent 0
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(_fma(floats, span, lo), lo)


def _f64(v):
    return v.double() if torch.is_tensor(v) else v


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add ``a * b + c``, emulated in float64 (the
    product of two float32 values is exact there) so that it rounds the
    same on every device.  XLA's CPU code generator contracts the
    polynomial steps below into FMAs; plain float32 steps miss by 1-2 ulp."""
    return (a.double() * _f64(b) + _f64(c)).float()


# XLA's CPU float32 logarithm (Cephes ``logf``): exponent split around
# sqrt(1/2), a degree-8 polynomial in the reduced argument, two-part ln 2
_LOG_P = [float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRT_HALF = float(np.float32(0.707106781186547524))


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` for positive normal inputs."""
    m, e = torch.frexp(x)                     # x = m * 2^e, m in [0.5, 1)
    e = e.to(torch.float32)
    small = m < _SQRT_HALF
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    y0 = _fma(_fma(m, _LOG_P[0], _LOG_P[1]), m, _LOG_P[2])
    y1 = _fma(_fma(m, _LOG_P[3], _LOG_P[4]), m, _LOG_P[5])
    y2 = _fma(_fma(m, _LOG_P[6], _LOG_P[7]), m, _LOG_P[8])
    y = _fma(_fma(_fma(y0, m3, y1), m3, y2), m3, _LOG_Q1 * e)
    return ((m - 0.5 * m2) + y) + _LOG_Q2 * e


# XLA's float32 ``log1p``: a Cephes rational function below sqrt(2) - 1,
# log(1 + x) above it (Horner coefficients, highest power first)
_LOG1P_NUM = [float(np.float32(c)) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_DEN = [float(np.float32(c)) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coefs:
        p = _fma(p, x, c)
    return p


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` for x in (-1, 0]: the range erf_inv needs."""
    x2 = x * x
    rational = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + (-0.5 * x2 + (x * x2) * rational)
    return torch.where(x.abs() < 0.41421356237309504880, small, _log(x + 1.0))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``sqrt``: ``x * rsqrt(x)`` refined by one FMA
    Newton step (not always the correctly rounded root)."""
    r = torch.rsqrt(x.double()).float()
    y = x * r
    return _fma(_fma(-y, y, x), 0.5 * r, y)


# XLA's float32 ErfInv (M. Giles, "Approximating the erfinv function"):
# coefficients for w = -log1p(-x^2) below 5 and at or above 5
_ERFINV_LT5 = [float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)]
_ERFINV_GE5 = [float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)]


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function on (-1, 1), XLA's CPU lowering step
    for step: ``w = -log1p(-x^2)``, Giles' polynomial with FMA steps."""
    w = -_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, c_lt, c_ge))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: (..., 2) keys -> (..., *shape)."""
    return bits_to_normal(random_bits(keys, shape))


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> standard normals: ``sqrt(2) erf_inv(u)`` with u
    on (-1, 1), the float32 pipeline of ``jax.random.normal``."""
    return _SQRT2 * bits_to_erf_inv(bits)


def bits_to_erf_inv(bits: torch.Tensor) -> torch.Tensor:
    """``erf_inv(u)``, the normal before its ``sqrt(2)`` factor, which
    compiled XLA folds into a constant the normal is multiplied by."""
    return erf_inv(bits_to_uniform(bits, _NORMAL_LO, 1.0))


# XLA's CPU float32 arithmetic, for modules that mirror a compiled JAX
# expression: the fused multiply-add and the square root
fma = _fma
xla_sqrt = _sqrt


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``_shuffle`` of ``arange(n)``,
    ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each a split of the key and a
    stable sort by 32 fresh random bits (``lax.sort_key_val``)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_M32)))
    for _ in range(rounds):
        key, sub = split(key)
        bits = random_bits(sub, (n,))
        x = x[torch.sort(bits, stable=True).indices]
    return x


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 (the
    default dtype), bitwise: words ``hi`` and ``lo`` from the two halves
    of ``split(key)``, then ``minval + ((hi % span) * m + lo % span) %
    span`` with ``m = (2^16 % span)^2 % span``, every product and sum
    wrapping at 2^32 as uint32 does (so m = 0 for spans above 2^16).
    Returns int64 values."""
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= minval <= maxval < 2 ** 31:
        raise ValueError(f"randint bounds must be int32 with minval <= "
                         f"maxval, got {minval}, {maxval}")
    span = max(maxval - minval, 1)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    offset = ((((higher % span) * mult) & _M32) + lower % span) & _M32
    return minval + offset % span
