"""Replica-exchange patterns: synchronous vs asynchronous cycles.

Synchronous (paper Fig 1a): every replica propagates exactly
``md_steps`` and then one exchange sweep runs — the exchange IS the
barrier.

Asynchronous (paper Fig 1b): replica i advances ``round(window *
speed_i)`` steps per window (clipped to [1, 2 window]), banks its
progress in ``debt``, and only replicas whose debt reaches ``md_steps``
are *ready*; a pair with an un-ready member auto-rejects and the
un-ready replica keeps simulating.  A straggler delays only its ladder
neighbours, never the ensemble.

``fused_cycle`` derives the sweep's (dim, parity) from ``ens.cycle`` on
the device, so a chunk of cycles runs with no host read; every mask of
either pattern is a device tensor.  The exchange is the DEO neighbor
sweep of that (dim, parity), or with ``scheme="matrix"`` the Gibbs
exchange over the whole grid.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import random as jr
from repro_torch.core import modes as M
from repro_torch.core.controls import ControlGrid, ctrl_for_assignment
from repro_torch.core.engine import nb_zero_stats
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.exchange import matrix_exchange, neighbor_exchange


def _propagate(engine, ens: Ensemble, grid: ControlGrid, n_steps, rng,
               execution: Dict[str, Any], max_steps: int):
    ctrl = ctrl_for_assignment(grid, ens.assignment,
                               getattr(engine, "ctrl_keys", None))
    if execution["mode"] == "mode2":
        return M.propagate_mode2(engine, ens.state, ctrl, n_steps, rng,
                                 execution["n_waves"], max_steps=max_steps)
    return M.propagate_mode1(engine, ens.state, ctrl, n_steps, rng,
                             max_steps=max_steps)


def _exchange(engine, state, grid, assignment, dim_index, parity, rng,
              scheme: str, ready=None):
    if scheme == "matrix":
        return matrix_exchange(engine, state, grid, assignment, rng)
    return neighbor_exchange(engine, state, grid, assignment, dim_index,
                             parity, rng, ready=ready)


def _cycle_core(engine, grid: ControlGrid, ens: Ensemble, *, pattern: str,
                md_steps: int, window_steps: int, dim_index, parity,
                scheme: str, execution
                ) -> Tuple[Ensemble, Dict[str, Any], torch.Tensor]:
    """The cycle body of both patterns: split the driver key, propagate
    every replica, then one exchange sweep (masked by readiness under the
    asynchronous pattern).  Returns (new_ens, exchange_stats, ready)."""
    k_md, k_ex, k_next = jr.split(ens.rng, 3)
    if pattern == "asynchronous":
        max_steps = 2 * window_steps
        n_steps = torch.clamp(torch.round(window_steps * ens.speed)
                              .to(torch.int64), 1, max_steps)
    else:
        max_steps = md_steps
        n_steps = torch.full(ens.assignment.shape, md_steps,
                             dtype=torch.int64, device=ens.assignment.device)
    state = _propagate(engine, ens, grid, n_steps, k_md, execution,
                       max_steps)
    if pattern == "asynchronous":
        debt = ens.debt + n_steps.to(torch.float32)
        ready = (debt >= md_steps) & ens.alive
        ens = ens._replace(debt=torch.where(ready, debt - md_steps, debt))
    else:
        ready = ens.alive
    assignment, stats = _exchange(engine, state, grid, ens.assignment,
                                  dim_index, parity, k_ex, scheme,
                                  ready=ready)
    new_ens = ens._replace(state=state, assignment=assignment, rng=k_next,
                           cycle=ens.cycle + 1)
    return new_ens, stats, ready


def _pop_pair_rows(stats: Dict[str, Any], keep: bool):
    """Remove the per-pair telemetry rows from an exchange stats dict and
    return them as float32 (W,) rows when ``keep``, else (None, None): the
    cast is the only operation they cost, and only when kept.  The matrix
    (Gibbs) scheme redraws its pairs every sweep, so it has no static
    pair-slot axis and no rows."""
    pa = stats.pop("_pair_attempt", None)
    pc = stats.pop("_pair_accept", None)
    if keep and pa is not None:
        return pa.to(torch.float32), pc.to(torch.float32)
    return None, None


def fused_cycle(engine, grid: ControlGrid, ens: Ensemble, *, pattern: str,
                md_steps: int, window_steps: int = 0,
                scheme: str = "neighbor", execution=None,
                telemetry_rows: bool = False
                ) -> Tuple[Ensemble, Dict[str, torch.Tensor]]:
    """One cycle with dim/parity derived ON DEVICE from ``ens.cycle``.

    Returns (new_ens, stats): fixed-shape device tensors ``dim``,
    ``accepted``, ``attempted``, ``ready_frac``, the neighbor-list health
    scalars (:func:`nb_health`) and the post-cycle ``assignment`` row,
    for the driver to stack per chunk.  ``telemetry_rows`` adds the
    exchange's per-pair rows ``pair_attempt`` / ``pair_accept`` (float32,
    the pair table's width W; the neighbor scheme only)."""
    execution = execution or {"mode": "mode1", "n_waves": 1}
    n_dims = len(grid.dims)
    dim_index = torch.remainder(ens.cycle, n_dims)
    parity = torch.remainder(torch.div(ens.cycle, n_dims,
                                       rounding_mode="floor"), 2)
    new_ens, stats, ready = _cycle_core(
        engine, grid, ens, pattern=pattern, md_steps=md_steps,
        window_steps=window_steps, dim_index=dim_index, parity=parity,
        scheme=scheme, execution=execution)
    pa, pc = _pop_pair_rows(stats, telemetry_rows)
    flat = {
        "dim": dim_index,
        "accepted": stats["accepted"],
        "attempted": stats["attempted"],
        "ready_frac": torch.mean(ready.to(torch.float32)),
        "assignment": new_ens.assignment,
        **nb_health(engine, new_ens.state, new_ens.assignment.device),
    }
    if pa is not None:
        flat["pair_attempt"], flat["pair_accept"] = pa, pc
    return new_ens, flat


def nb_health(engine, state, device) -> Dict[str, torch.Tensor]:
    """Neighbor-list health scalars for the cycle stats: an engine with
    ``nb_stats`` (the sparse nonbonded path) reports its cumulative
    overflow / rebuild counters, anything else zeros, so the stats keep
    one shape across engines."""
    fn = getattr(engine, "nb_stats", None)
    if callable(fn):
        return fn(state)
    return nb_zero_stats(device)
