"""Tempered SGLD noise, the coupling between RepEx and LM training: the
port of the JAX package's ``repro/optim/sgld.py``.

Replica-exchange SGLD (parallel tempering over training runs): each
replica trains with Langevin noise scaled by its temperature; the RepEx
layer swaps temperatures between replicas with the Metropolis criterion
on the loss (energy).  At T -> 0 this degenerates to plain AdamW.

The noise is bitwise the JAX package's jitted step (the LM engine's
propagate runs under the driver's ``jit``): ``split(rng, n_leaves)``,
one key per leaf in JAX's flatten order, and ``p + std * normal(k)``
as compiled XLA computes it, with the normal's ``sqrt(2)`` folded into
the scale and the multiply-add fused, ``fma(std sqrt(2), erf_inv(u),
p)``.  A leaf is drawn ``SLICE`` elements at a time (each element's bits
depend on its flat index alone), so the int64 / float64 emulation of a
2.7e8-element leaf never holds more than a slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.models import params as PRM
from repro_torch.tree import tree_paths, tree_unflatten

_SQRT2 = float(np.float32(np.sqrt(2.0)))


def sgld_std(lr: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    """sqrt(max(2 lr T, 0)) in float32, XLA's CPU square root (which
    returns 0 at 0, where x rsqrt(x) is NaN)."""
    var = torch.clamp_min(2.0 * lr * temperature, 0.0)
    return torch.where(var == 0, var, jr.xla_sqrt(var))


def add_noise(p: torch.Tensor, key: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    """``p + std * normal(key, p.shape)`` for a float32 leaf, as a new
    tensor: the compiled form of the module docstring."""
    s2 = std * _SQRT2
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    src, dst = p.reshape(-1), out.view(-1)
    n = dst.numel()
    for a in range(0, n, PRM.SLICE):
        b = min(n, a + PRM.SLICE)
        e = jr.bits_to_erf_inv(jr.random_bits(key, (b - a,), a))
        dst[a:b] = jr.fma(e, s2, src[a:b])
    return out


def sgld_noise(rng: torch.Tensor, params, lr: torch.Tensor,
               temperature: torch.Tensor):
    """Add sqrt(2 * lr * T) Gaussian noise to a float32 parameter tree."""
    pairs = tree_paths(params)
    keys = jr.split(rng, len(pairs))
    std = sgld_std(lr, temperature)
    return tree_unflatten(params, [add_noise(p, keys[i], std)
                                   for i, (_, p) in enumerate(pairs)])
