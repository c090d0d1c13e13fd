"""AdamW with decoupled weight decay, cosine schedule, global-norm
clipping: the port of the JAX package's ``repro/optim/adamw.py``.

Moments are float32 trees shaped like the parameters.  Leaves are walked
in JAX's flatten order (``tree.tree_paths``: dict keys sorted), so the
global norm sums the leaves in JAX's order.  A division by a tensor is
tensor by tensor, where JAX divides (on the card PyTorch turns a
division by a Python scalar into a multiplication by its reciprocal); a
division by a constant of the configuration is the multiplication by its
reciprocal that compiled XLA makes of it.  ``adamw_leaf``
is one leaf's update, shared by ``adamw_update`` and the LM engine's
step, which updates its stacked state leaf by leaf in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.config import TrainConfig
from repro_torch.tree import tree_map, tree_paths, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    mu: Any                # first moment  (tree like params)
    nu: Any                # second moment


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    any_leaf = tree_paths(params)[0][1]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=any_leaf.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


_F32_09, _F32_01 = float(np.float32(0.9)), float(np.float32(0.1))


def _recip(c: int) -> float:
    """The float32 reciprocal of a constant divisor: compiled XLA turns
    ``x / c`` into ``x * (1 / c)``."""
    return float(np.float32(1.0) / np.float32(c))


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine from 1 to 0.1 of the peak rate;
    ``step`` an integer tensor, the rate a float32 tensor of its shape.
    The divisions by the configuration's constants are multiplications
    by their float32 reciprocals and ``0.1 + 0.9 cos`` one fused
    multiply-add, as the JAX package's jitted step computes them."""
    warm = torch.clamp_max(step.to(torch.float32)
                           * _recip(max(cfg.warmup_steps, 1)), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                       * _recip(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    # the float32 angle's cosine rounded once (XLA's float32 cos is
    # within an ulp of it; PyTorch's float32 cos is not always)
    cos = 0.5 * (1.0 + torch.cos((math.pi * prog).double()).float())
    return cfg.learning_rate * warm * jr.fma(cos, _F32_09, _F32_01)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, leaves in JAX's
    order."""
    total = 0
    for _, g in tree_paths(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (gnorm + 1e-9))."""
    top = torch.full((), float(max_norm), dtype=torch.float32,
                     device=gnorm.device)
    return torch.clamp_max(top / (gnorm + 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def bias_corrections(cfg: TrainConfig, step: torch.Tensor):
    """1 - beta1^t and 1 - beta2^t for the new step t, float32 powers of
    float32 t."""
    t = step.to(torch.float32)
    return tuple(1 - torch.pow(torch.full_like(t, b), t)
                 for b in (cfg.beta1, cfg.beta2))


def adamw_leaf(cfg: TrainConfig, p, g, m, v, lr, bc1, bc2):
    """One leaf's AdamW update: (new p in p's dtype, new m, new v)."""
    b1, b2 = cfg.beta1, cfg.beta2
    g32 = g.to(torch.float32)
    m = b1 * m + (1 - b1) * g32
    v = b2 * v + (1 - b2) * g32 * g32
    mhat = m / bc1
    vhat = v / bc2
    p32 = p.to(torch.float32)
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
    return (p32 - lr * delta).to(p.dtype), m, v


def adamw_update(cfg: TrainConfig, params, grads, state: AdamWState
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """The clipped AdamW step, leaf by leaf (each gradient leaf scaled by
    the clip as it is used, ``clip_by_global_norm``'s values), written in
    place: each leaf's new parameter and moments go into ``params``,
    ``state.mu`` and ``state.nu`` as it is done, and the returned trees
    hold those tensors, so no second copy of the state is allocated.  A
    caller that keeps its old state clones it first."""
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    bc1, bc2 = bias_corrections(cfg, step)
    out = []
    for (_, p), (_, g), (_, m), (_, v) in zip(
            tree_paths(params), tree_paths(grads), tree_paths(state.mu),
            tree_paths(state.nu)):
        new = adamw_leaf(cfg, p, g * scale.to(g.dtype), m, v, lr, bc1, bc2)
        for dst, src in zip((p, m, v), new):
            dst.copy_(src)
        out.append((p, m, v))
    new_p, new_m, new_v = (tree_unflatten(params, [o[j] for o in out])
                           for j in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step, new_m, new_v), metrics
