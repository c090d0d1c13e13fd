"""The plain versions of the noise kernel: the threefry hash and the
bits -> normal map of ``repro_torch.random`` in PyTorch ops (~600
elementwise launches a draw on the card).  They are the CPU path and
what ``chip_smoke.py`` holds the kernel against on the card.

``step_noise_unrolled`` is the fused propagate's stream, the counterpart
of the JAX package's ``md/noise.py``: iteration ``t``'s block
``normal(fold_in(key_r, t), shape)`` for every replica with the hash
written out (``random.threefry2x32``), so a loop body can draw its own
block instead of indexing a pre-drawn stack.  Its counter layout is
threefry's *legacy* one, not the partitionable layout of
``random.random_bits``: the flat counters ``0 .. size - 1`` (an odd size
padded with one zero) are cut into halves, the halves are hashed as the
two words of one block, and the two output words are concatenated.  The
JAX fused path draws exactly this stream, so it is reproduced bit for
bit; it is not ``stacked_step_noise``'s stream under the installed JAX,
which is why a fused-path trajectory differs from a ``"pallas"``-path one
from the same seed.

``stacked_step_noise`` pre-draws every step of the per-pass loop in the
partitionable layout, and ``add_noise`` is the SGLD update ``p + std *
normal(key, p.shape)`` as compiled XLA computes it (``optim/sgld.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.models import params as PRM

_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _counts(size: int, device):
    """The padded counter vector: an odd flat size gets one ZERO count
    (not a continued iota) before halving.  Returns (counts, half)."""
    odd = size % 2
    counts = torch.arange(size, dtype=torch.int64, device=device)
    if odd:
        counts = torch.cat([counts, counts.new_zeros(1)])
    return counts, (size + odd) // 2


def step_noise_unrolled(rngs: torch.Tensor, t, shape) -> torch.Tensor:
    """Iteration ``t``'s noise block for (R, 2) keys -> (R, *shape)."""
    folded = jr.fold_in(rngs, t)                      # (R, 2)
    size = math.prod(shape)
    counts, half = _counts(size, rngs.device)
    b0, b1 = jr.threefry2x32(folded[:, 0:1], folded[:, 1:2],
                             counts[None, :half], counts[None, half:])
    bits = torch.cat([b0, b1], dim=1)[:, :size]
    return jr.bits_to_normal(bits).reshape((rngs.shape[0],) + tuple(shape))


def stacked_step_noise(rngs, max_steps: int, shape) -> torch.Tensor:
    """Pre-draw every step's noise: noise[t, r] = normal(fold_in(rngs[r],
    t), shape), as one wide draw -> (max_steps, R, *shape)."""
    ts = torch.arange(max_steps, dtype=torch.int64, device=rngs.device)
    keys = jr.fold_in(rngs[None, :, :], ts[:, None])            # (S, R, 2)
    return jr.normal(keys, shape)


def add_noise(p: torch.Tensor, key: torch.Tensor, std: torch.Tensor,
              offset: int = 0) -> torch.Tensor:
    """``p + std * normal(key, p.shape)`` for a float32 leaf, as a new
    tensor, with the normal's ``sqrt(2)`` folded into the scale and the
    multiply-add fused, ``fma(erf_inv(u), std sqrt(2), p)``.  Element
    ``j`` takes the bits of flat index ``offset + j``; the leaf is drawn
    ``SLICE`` elements at a time (each element's bits depend on its flat
    index alone), so the int64 / float64 emulation of a 2.7e8-element
    leaf never holds more than a slice."""
    s2 = std * _SQRT2
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    src, dst = p.reshape(-1), out.view(-1)
    n = dst.numel()
    for a in range(0, n, PRM.SLICE):
        b = min(n, a + PRM.SLICE)
        e = jr.bits_to_erf_inv(jr.random_bits(key, (b - a,), offset + a))
        dst[a:b] = jr.fma(e, s2, src[a:b])
    return out
