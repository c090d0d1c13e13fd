"""Counter-based threefry-2x32 keys and draws, written from the published
algorithm (Salmon et al., SC 2011) and ``jax.random``'s documented layouts.

The benchmark's reference draws the same random numbers a REMD run of
this system is defined to draw from its seed:

  key(seed)         the raw key ``[seed >> 32, seed & 0xffffffff]``
  split(k, n)       the hash of the 64-bit counters ``0 .. n - 1``
  fold_in(k, d)     the hash of the counter pair ``(0, d)``
  bits(k, n)        "partitionable" layout: element i hashes the counter
                    pair ``(i >> 32, i & 0xffffffff)``, the word is the
                    XOR of the two outputs
  bits_legacy(k, n) the legacy layout: the counters ``0 .. n - 1`` (an odd
                    n padded with one zero) cut in halves, the halves
                    hashed as the two words of one block, the outputs
                    concatenated
  uniform(bits)     the mantissa map onto [lo, hi), float32
  normal(bits)      sqrt(2) erfinv(u) with u on (-1, 1), evaluated in
                    float64 and rounded once to the working dtype

The normal is computed in exact arithmetic (float64 ``erfinv``), not with a
float32 polynomial: it differs from a float32 implementation by an ulp or
two, far below what the comparison resolves.  uint32 arithmetic runs in
int64 with a mask after each add and shift.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry(k1, k2, x1, x2):
    """20 rounds of threefry-2x32 on broadcastable int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """(..., 2) -> (..., num, 2)."""
    idx = torch.arange(num, dtype=torch.int64, device=k.device)
    b1, b2 = threefry(k[..., 0:1], k[..., 1:2], idx >> 32, idx & M32)
    return torch.stack([b1, b2], -1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """(..., 2) keys, int or broadcastable int64 data -> (..., 2)."""
    k1, k2 = k[..., 0], k[..., 1]
    if not torch.is_tensor(data):
        data = torch.full_like(k1, int(data) & M32)
    b1, b2 = threefry(k1, k2, torch.zeros_like(data), data & M32)
    return torch.stack([b1, b2], -1)


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """Partitionable layout: (..., 2) keys -> (..., n) words."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    b1, b2 = threefry(k[..., 0:1], k[..., 1:2], idx >> 32, idx & M32)
    return b1 ^ b2


def bits_legacy(k: torch.Tensor, n: int) -> torch.Tensor:
    """Legacy layout: (R, 2) keys -> (R, n) words."""
    half = (n + 1) // 2
    counts = torch.arange(2 * half, dtype=torch.int64, device=k.device)
    counts[n:] = 0
    b0, b1 = threefry(k[:, 0:1], k[:, 1:2], counts[None, :half],
                      counts[None, half:])
    return torch.cat([b0, b1], 1)[:, :n]


def _unit(words: torch.Tensor) -> torch.Tensor:
    """Words -> float64 values on [0, 1) from their top 23 bits."""
    return (words >> 9).to(torch.float64) * 2.0 ** -23


def uniform(words: torch.Tensor) -> torch.Tensor:
    """float32 on [0, 1)."""
    return _unit(words).to(torch.float32)


_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Standard normals from words: u = 2 f + lo rounded to float32 and
    clamped at lo (lo the float32 just above -1), then sqrt(2) erfinv(u)
    in float64, rounded to ``dtype``."""
    u = torch.clamp_min((2.0 * _unit(words) + _LO).to(torch.float32), _LO)
    return (math.sqrt(2.0) * torch.erfinv(u.to(torch.float64))).to(dtype)
