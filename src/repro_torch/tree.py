"""Nested engine state: dicts of tensors, possibly of dicts (the sparse
path keeps its neighbor list as ``state["nlist"]``).  The two walks the
port needs, in the spirit of ``jax.tree.map`` / ``jax.tree.leaves``."""
from __future__ import annotations

from typing import Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the same-shaped
    ``rest``; dicts keep their keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Every leaf of ``tree``, depth first in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
