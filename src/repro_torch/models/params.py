"""Parameter definitions: a tree of :class:`ParamDef` (shape, init, dtype)
per model, and the tensors drawn from it.

``init_params`` is bitwise the JAX package's (``repro/models/params.py``):
leaf ``i`` of the tree, in JAX's flatten order (dict keys sorted at every
level), draws ``normal(fold_in(rng, i), shape)`` in float32, times its
std in float32.  A large leaf is drawn in slices of its flat index
(``SLICE`` elements each): element ``i``'s bits depend on ``i`` alone, so
the slices are bitwise the whole draw, and they bound the int64 / float64
emulation's transient memory on the card.  The JAX package's
``abstract_params`` and ``param_shardings`` (XLA and mesh tools) wait for
the multi-device slice; the sharding axes are kept for that.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.tree import tree_map

SLICE = 1 << 26          # elements per slice of a large draw


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # multiplier on the default std
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _leaves_sorted(defs, path=()):
    """(path, ParamDef) pairs in JAX's flatten order: keys sorted."""
    if is_def(defs):
        return [(path, defs)]
    return [leaf for k in sorted(defs)
            for leaf in _leaves_sorted(defs[k], path + (k,))]


def stack(defs, n_layers: int):
    """Lift a block's ParamDefs into a stack of ``n_layers``."""
    return tree_map(lambda d: replace(d, shape=(n_layers,) + d.shape,
                                      axes=("layers",) + d.axes), defs)


def _std_for(d: ParamDef) -> float:
    if d.init == "embed":
        return 1.0 * d.scale
    # fan-in: last-but-one dim for matrices, last for vectors
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    return d.scale / math.sqrt(max(fan_in, 1))


def _normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` drawn ``SLICE`` elements at a
    time."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for a in range(0, n, SLICE):
        b = min(n, a + SLICE)
        out[a:b] = jr.bits_to_normal(jr.random_bits(key, (b - a,), a))
    return out.reshape(shape)


def init_params(rng: torch.Tensor, defs, dtype=None):
    """Materialize a tree of ParamDefs on ``rng``'s device; ``rng`` is a
    raw key (``repro_torch.random.key``), folded per leaf by its index in
    JAX's flatten order."""
    flat = {}
    for i, (path, d) in enumerate(_leaves_sorted(defs)):
        pdtype = dtype or d.dtype
        if d.init == "zeros":
            arr = torch.zeros(d.shape, dtype=pdtype, device=rng.device)
        elif d.init == "ones":
            arr = torch.ones(d.shape, dtype=pdtype, device=rng.device)
        else:
            std = float(np.float32(_std_for(d)))
            arr = (_normal(jr.fold_in(rng, i), d.shape) * std).to(pdtype)
        flat[path] = arr

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        return flat[path]
    return rebuild(defs)


def param_count(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in _leaves_sorted(defs))


def dense(d_in: int, d_out: int, in_ax: Optional[str], out_ax: Optional[str],
          scale: float = 1.0) -> ParamDef:
    return ParamDef((d_in, d_out), (in_ax, out_ax), "normal", scale)
