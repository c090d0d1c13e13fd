"""Replica-exchange patterns: the synchronous cycle.

Synchronous (paper Fig 1a): every replica propagates exactly
``md_steps`` and then one exchange sweep runs — the exchange IS the
barrier.  ``fused_cycle`` derives the sweep's (dim, parity) from
``ens.cycle`` on the device, so a chunk of cycles runs with no host
read.  The exchange is the DEO neighbor sweep of that (dim, parity), or
with ``scheme="matrix"`` the Gibbs exchange over the whole grid.  The
asynchronous pattern is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import random as jr
from repro_torch.core import modes as M
from repro_torch.core.controls import ControlGrid, ctrl_for_assignment
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.exchange import matrix_exchange, neighbor_exchange


def _propagate(engine, ens: Ensemble, grid: ControlGrid, n_steps, rng,
               execution: Dict[str, Any], max_steps: int):
    if execution["mode"] != "mode1":
        raise NotImplementedError("execution mode2 is not ported yet")
    ctrl = ctrl_for_assignment(grid, ens.assignment,
                               getattr(engine, "ctrl_keys", None))
    return M.propagate_mode1(engine, ens.state, ctrl, n_steps, rng,
                             max_steps=max_steps)


def _exchange(engine, state, grid, assignment, dim_index, parity, rng,
              scheme: str, ready=None):
    if scheme == "matrix":
        return matrix_exchange(engine, state, grid, assignment, rng)
    return neighbor_exchange(engine, state, grid, assignment, dim_index,
                             parity, rng, ready=ready)


def _cycle_core(engine, grid: ControlGrid, ens: Ensemble, *, pattern: str,
                md_steps: int, dim_index, parity, scheme: str, execution
                ) -> Tuple[Ensemble, Dict[str, Any], torch.Tensor]:
    """The cycle body: split the driver key, propagate every replica,
    then one exchange sweep.  Returns (new_ens, exchange_stats, ready)."""
    if pattern != "synchronous":
        raise NotImplementedError(f"pattern {pattern!r} is not ported yet")
    k_md, k_ex, k_next = jr.split(ens.rng, 3)
    n_steps = torch.full(ens.assignment.shape, md_steps, dtype=torch.int64,
                         device=ens.assignment.device)
    state = _propagate(engine, ens, grid, n_steps, k_md, execution, md_steps)
    ready = ens.alive
    assignment, stats = _exchange(engine, state, grid, ens.assignment,
                                  dim_index, parity, k_ex, scheme,
                                  ready=ready)
    new_ens = ens._replace(state=state, assignment=assignment, rng=k_next,
                           cycle=ens.cycle + 1)
    return new_ens, stats, ready


def fused_cycle(engine, grid: ControlGrid, ens: Ensemble, *, pattern: str,
                md_steps: int, scheme: str = "neighbor", execution=None
                ) -> Tuple[Ensemble, Dict[str, torch.Tensor]]:
    """One cycle with dim/parity derived ON DEVICE from ``ens.cycle``.

    Returns (new_ens, stats): fixed-shape device tensors ``dim``,
    ``accepted``, ``attempted``, ``ready_frac`` and the post-cycle
    ``assignment`` row, for the driver to stack per chunk."""
    execution = execution or {"mode": "mode1", "n_waves": 1}
    n_dims = len(grid.dims)
    dim_index = torch.remainder(ens.cycle, n_dims)
    parity = torch.remainder(torch.div(ens.cycle, n_dims,
                                       rounding_mode="floor"), 2)
    new_ens, stats, ready = _cycle_core(
        engine, grid, ens, pattern=pattern, md_steps=md_steps,
        dim_index=dim_index, parity=parity, scheme=scheme,
        execution=execution)
    return new_ens, {
        "dim": dim_index,
        "accepted": stats["accepted"],
        "attempted": stats["attempted"],
        "ready_frac": torch.mean(ready.to(torch.float32)),
        "assignment": new_ens.assignment,
    }
