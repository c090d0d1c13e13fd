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
from repro_torch.tree import tree_map, tree_unflatten

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


def _draw_(out: torch.Tensor, key: torch.Tensor, std: float) -> None:
    """``normal(key, out.shape) * std`` in float32, written into the
    contiguous ``out`` (cast to its dtype) ``SLICE`` elements at a time."""
    flat = out.view(-1)
    n = flat.numel()
    for a in range(0, n, SLICE):
        b = min(n, a + SLICE)
        flat[a:b] = jr.bits_to_normal(jr.random_bits(key, (b - a,), a)) * std


def _normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` drawn ``SLICE`` elements at a
    time."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=key.device)
    _draw_(out, key, 1.0)
    return out


def init_params(rng: torch.Tensor, defs, dtype=None):
    """Materialize a tree of ParamDefs on ``rng``'s device; ``rng`` is a
    raw key (``repro_torch.random.key``), folded per leaf by its index in
    JAX's flatten order.  Keys with a leading axis, (R, 2), draw a
    stacked tree: leaf shapes (R, ...), replica r's leaves bitwise
    ``init_params(rng[r])`` (the JAX package's ``vmap`` of the draw),
    written replica by replica into one allocation per leaf."""
    stacked = rng.ndim == 2
    lead = (rng.shape[0],) if stacked else ()
    arrs = []
    for i, (_, d) in enumerate(_leaves_sorted(defs)):
        pdtype = dtype or d.dtype
        shape = lead + tuple(d.shape)
        if d.init == "zeros":
            arr = torch.zeros(shape, dtype=pdtype, device=rng.device)
        elif d.init == "ones":
            arr = torch.ones(shape, dtype=pdtype, device=rng.device)
        else:
            std = float(np.float32(_std_for(d)))
            arr = torch.empty(shape, dtype=pdtype, device=rng.device)
            for r in range(lead[0] if stacked else 1):
                _draw_(arr[r] if stacked else arr,
                       jr.fold_in(rng[r] if stacked else rng, i), std)
        arrs.append(arr)
    return tree_unflatten(defs, arrs)


def param_count(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in _leaves_sorted(defs))


def dense(d_in: int, d_out: int, in_ax: Optional[str], out_ax: Optional[str],
          scale: float = 1.0) -> ParamDef:
    return ParamDef((d_in, d_out), (in_ax, out_ax), "normal", scale)
