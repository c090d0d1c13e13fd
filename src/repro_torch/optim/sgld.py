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
p)`` (``add_noise``): on the card one launch of the noise kernel a leaf
(``kernels/noise``), on the CPU its plain version, in slices of the
flat index.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.kernels.noise.ops import add_noise
from repro_torch.tree import tree_paths, tree_unflatten


def sgld_std(lr: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    """sqrt(max(2 lr T, 0)) in float32, XLA's CPU square root (which
    returns 0 at 0, where x rsqrt(x) is NaN)."""
    var = torch.clamp_min(2.0 * lr * temperature, 0.0)
    return torch.where(var == 0, var, jr.xla_sqrt(var))


def sgld_noise(rng: torch.Tensor, params, lr: torch.Tensor,
               temperature: torch.Tensor):
    """Add sqrt(2 * lr * T) Gaussian noise to a float32 parameter tree."""
    pairs = tree_paths(params)
    keys = jr.split(rng, len(pairs))
    std = sgld_std(lr, temperature)
    return tree_unflatten(params, [add_noise(p, keys[i], std)
                                   for i, (_, p) in enumerate(pairs)])
