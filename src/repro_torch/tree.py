"""Nested engine state: dicts of tensors, possibly of dicts (the sparse
path keeps its neighbor list as ``state["nlist"]``; an LM replica its
parameter tree).  The walks the port needs, in the spirit of
``jax.tree.map`` / ``jax.tree.leaves`` / ``jax.tree.flatten``."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

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


def tree_paths(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted at
    every level, so leaf ``i`` here is leaf ``i`` of ``jax.tree.leaves``
    (the order a per-leaf key split follows)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_paths(tree[k], path + (k,))]
    return [(path, tree)]


def tree_unflatten(tree, leaves) -> Dict:
    """``tree``'s structure, empty dicts included, with its leaves in
    :func:`tree_paths` order replaced by ``leaves``: the inverse of
    ``[leaf for _, leaf in tree_paths(tree)]``."""
    return _rebuild(tree, iter(leaves))


def _rebuild(tree, leaves):
    # a module-level recursion: a recursive closure would form a reference
    # cycle that keeps ``leaves`` (gigabytes of tensors) alive until the
    # garbage collector runs
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)
