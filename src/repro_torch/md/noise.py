"""The noise stream of the fused propagate path.

The counterpart of the JAX package's ``md/noise.py``:
``step_noise_unrolled(rngs, t, shape)`` draws iteration ``t``'s block
``normal(fold_in(key_r, t), shape)`` for every replica with the hash
written out (``random.threefry2x32``), so a loop body can draw its own
block instead of indexing a pre-drawn stack.

Its counter layout is threefry's *legacy* one, not the partitionable
layout of ``random.random_bits``: the flat counters ``0 .. size - 1``
(an odd size padded with one zero) are cut into halves, the halves are
hashed as the two words of one block, and the two output words are
concatenated.  The JAX fused path draws exactly this stream, so this
module reproduces it bit for bit; it is not ``stacked_step_noise``'s
stream under the installed JAX, which is why a fused-path trajectory
differs from a ``"pallas"``-path one from the same seed.
"""
from __future__ import annotations

import math

import torch

from repro_torch import random as jr


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
