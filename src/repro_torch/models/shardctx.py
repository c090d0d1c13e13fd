"""Ambient activation sharding: the port of the JAX package's
``repro/models/shardctx.py``.

Model code is mesh-agnostic; a launcher opts in to explicit activation
placements (batch axes + vocab axis) with ``set_activation_sharding``.
Each ``constrain_*`` returns its input unchanged unless that was called
and the input is a ``torch.distributed.tensor.DTensor``: then it
redistributes the DTensor to the placements the JAX package's
``with_sharding_constraint`` names, over the DTensor's own device mesh
(``sharding.placements_for``; mesh dims the spec does not name are
replicated).  Plain tensors, on the card or the CPU, pass through as
they are: nothing here launches or allocates then.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_BATCH_AXES: Optional[Tuple[str, ...]] = None
_MODEL_AXIS: Optional[str] = None
_AXIS_SIZES: dict = {}


def set_activation_sharding(batch_axes: Optional[Tuple[str, ...]],
                            model_axis: Optional[str] = "model",
                            axis_sizes: Optional[dict] = None) -> None:
    """``axis_sizes`` ({axis: size}) decides divisibility, as in the JAX
    package, where the abstract mesh is not visible while tracing."""
    global _BATCH_AXES, _MODEL_AXIS, _AXIS_SIZES
    _BATCH_AXES = tuple(batch_axes) if batch_axes else None
    _MODEL_AXIS = model_axis
    _AXIS_SIZES = dict(axis_sizes or {})


def clear() -> None:
    set_activation_sharding(None, None, None)


def _constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """``x`` redistributed to ``spec`` (one entry per dim: None, an axis
    name or a tuple of names) when it is a DTensor, else ``x``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding import placements_for
    mesh = x.device_mesh
    return x.redistribute(mesh, placements_for(spec, mesh.mesh_dim_names))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 to the batch axes, replicate the rest."""
    if _BATCH_AXES is None or getattr(x, "ndim", 0) < 1:
        return x
    if x.shape[0] % _prod_size() != 0:
        return x
    return _constrain(x, (_BATCH_AXES,) + (None,) * (x.ndim - 1))


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    """(B, S, V): batch over the data axes, vocab over the model axis."""
    if _BATCH_AXES is None or x.ndim != 3:
        return x
    if x.shape[0] % _prod_size() != 0:
        return x
    return _constrain(x, (_BATCH_AXES, None, _MODEL_AXIS))


def constrain_seq_parallel_q(q: torch.Tensor,
                             n_heads_total: int) -> torch.Tensor:
    """q (B, S, H, D): when the head count does not divide the model axis,
    shard the query sequence over it (context-parallel attention)."""
    if _BATCH_AXES is None or q.ndim != 4:
        return q
    msize = _axis_len(_MODEL_AXIS)
    if msize <= 1 or n_heads_total % msize == 0:
        return q
    if q.shape[1] % msize != 0:
        return q
    return _constrain(q, (_BATCH_AXES, _MODEL_AXIS, None, None))


def constrain_qchunk(qc: torch.Tensor, n_heads_total: int) -> torch.Tensor:
    """qc (B, c, G, Hg, D), a chunk of ``chunked_attention``'s queries:
    for head counts that do not divide the model axis, the chunk dim over
    the model axis."""
    if _BATCH_AXES is None or qc.ndim != 5:
        return qc
    msize = _axis_len(_MODEL_AXIS)
    if msize <= 1 or n_heads_total % msize == 0:
        return qc
    if qc.shape[1] % msize != 0 or qc.shape[0] % _prod_size() != 0:
        return qc
    return _constrain(qc, (_BATCH_AXES, _MODEL_AXIS, None, None, None))


def constrain_expert_weight(w: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Expert weights (E, d_in, d_out) at their use site: experts over the
    model axis (where they divide it), the other dims gathered."""
    if _BATCH_AXES is None or w.ndim != 3:
        return w
    msize = _axis_len(_MODEL_AXIS)
    if msize <= 1:
        return w
    e_spec = _MODEL_AXIS if n_experts % msize == 0 else None
    return _constrain(w, (e_spec, None, None))


def _axis_len(axis: Optional[str]) -> int:
    if axis is None:
        return 1
    return _AXIS_SIZES.get(axis, 1)


def _prod_size() -> int:
    size = 1
    for ax in _BATCH_AXES or ():
        size *= _AXIS_SIZES.get(ax, 1)
    return size
