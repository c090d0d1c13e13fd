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

``dim_index`` / ``parity`` come in two flavours:

  * ``sync_cycle`` / ``async_cycle``: host ints, the caller's schedule
    (the paper's M-REMD round robin: one dimension at a time);
  * ``fused_cycle``: derived from ``ens.cycle`` on the device, so a chunk
    of cycles runs with no host read.

Both run the one cycle body, ``_cycle_core``; every mask of either
pattern is a device tensor.  The exchange is the DEO neighbor
sweep of that (dim, parity), or with ``scheme="matrix"`` the Gibbs
exchange over the whole grid.

Replica sharding (``fused_cycle(mesh=...)``, the ``run_sharded`` path):
the same cycle body runs on each rank of a replica mesh.  Propagate is
per replica and stays on the rank (positions, velocities and neighbor
lists never leave it); the ctrl rows, step counts and keys are computed
at full (R,) size and cut to the rank's block (``modes.shard_rows``).
The exchange is the one per-ensemble phase, on the ``exchange_comm``
wire: ``"halo"`` rings only the block's exchange scalars and failure
flags, ``"gather"`` all-gathers the feature rows and failure flags (see
``core/exchange.py``).  The neighbor-list health counters are reduced by
an all-reduce max (exact), and only on an engine whose counters can move.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import random as jr
from repro_torch import sharding as S
from repro_torch.core import modes as M
from repro_torch.core.controls import ControlGrid, ctrl_for_assignment
from repro_torch.core.engine import nb_zero_stats
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.exchange import (matrix_exchange,
                                       matrix_exchange_sharded,
                                       neighbor_exchange,
                                       neighbor_exchange_sharded)
from repro_torch.tree import tree_map


def _propagate(engine, ens: Ensemble, grid: ControlGrid, n_steps, rng,
               execution: Dict[str, Any], max_steps: int,
               donate: bool = False):
    ctrl = ctrl_for_assignment(grid, ens.assignment,
                               getattr(engine, "ctrl_keys", None))
    if execution["mode"] == "mode2":
        return M.propagate_mode2(engine, ens.state, ctrl, n_steps, rng,
                                 execution["n_waves"], max_steps=max_steps,
                                 donate=donate)
    return M.propagate_mode1(engine, ens.state, ctrl, n_steps, rng,
                             max_steps=max_steps, donate=donate)


def _propagate_sharded(engine, ens: Ensemble, grid: ControlGrid, n_steps,
                       rng, execution: Dict[str, Any], max_steps: int, mesh,
                       donate: bool = False):
    """Propagate on one rank: ``ens.state`` is its block; the ctrl rows,
    step counts and per-replica keys are computed for all R replicas and
    cut to the block, and the engine is told the ensemble's count
    (``stack=R``), so every replica's inputs and bits are the unsharded
    run's; a rebuild of the neighbor list is decided for the whole
    ensemble (``sharding.ensemble_scope``).  Mode II's waves run within
    the block."""
    r = ens.assignment.shape[0]
    ctrl = tree_map(lambda x: M.shard_rows(x, mesh), ctrl_for_assignment(
        grid, ens.assignment, getattr(engine, "ctrl_keys", None)))
    keys = M.shard_rows(M.per_replica_keys(rng, r), mesh)
    steps = M.shard_rows(n_steps, mesh)
    with S.ensemble_scope(mesh, r):
        if execution["mode"] == "mode2":
            return M.propagate_mode2(engine, ens.state, ctrl, steps,
                                     n_waves=execution["n_waves"],
                                     max_steps=max_steps, keys=keys,
                                     stack=r, donate=donate)
        return M.propagate_mode1(engine, ens.state, ctrl, steps,
                                 max_steps=max_steps, keys=keys, stack=r,
                                 donate=donate)


def _exchange(engine, state, grid, assignment, dim_index, parity, rng,
              scheme: str, ready=None, features=None, fail=None, mesh=None):
    """Scheme dispatch.  With ``mesh`` the halo variants run on the
    rank's block and return a third element, the (R,) failure row;
    otherwise the whole-ensemble entry points run on ``state`` or on the
    gathered ``features`` / ``fail``."""
    if mesh is not None:
        if scheme == "matrix":
            return matrix_exchange_sharded(engine, state, grid, assignment,
                                           rng, mesh=mesh)
        return neighbor_exchange_sharded(engine, state, grid, assignment,
                                         dim_index, parity, rng, mesh=mesh,
                                         ready=ready)
    if scheme == "matrix":
        return matrix_exchange(engine, state, grid, assignment, rng,
                               features=features, fail=fail)
    return neighbor_exchange(engine, state, grid, assignment, dim_index,
                             parity, rng, ready=ready, features=features,
                             fail=fail)


def exchange_inputs(engine, state, mesh, exchange_comm: str,
                    n_replicas: int):
    """What the exchange needs on a wire: (features, fail, halo).
    Unsharded, nothing (the exchange reads ``state``).  On the gather
    wire the all-gathered feature rows and failure flags; on the halo
    wire the mesh, for the sharded exchange to ring its own scalars."""
    if mesh is None:
        return None, None, None
    if exchange_comm == "gather":
        with S.ensemble_scope(mesh, n_replicas):
            feats = engine.replica_features(state)
        features = tree_map(lambda x: S.all_gather_rows(x, mesh), feats)
        return features, S.all_gather_rows(engine.is_failed(state),
                                           mesh), None
    return None, None, mesh


def _cycle_core(engine, grid: ControlGrid, ens: Ensemble, *, pattern: str,
                md_steps: int, window_steps: int, dim_index, parity,
                scheme: str, execution, mesh=None,
                exchange_comm: str = "halo", donate: bool = False
                ) -> Tuple[Ensemble, Dict[str, Any], torch.Tensor]:
    """The cycle body of both patterns: split the driver key, propagate
    every replica, then one exchange sweep (masked by readiness under the
    asynchronous pattern).  With ``mesh`` the body runs on one rank's
    block and exchanges on the ``exchange_comm`` wire, and the stats carry
    ``_fail_row``, the (R,) failure row the wire moved.  ``donate``: the
    engine may write the new state into ``ens.state`` (the driver's call
    when nothing reads the pre-cycle state).  Returns (new_ens,
    exchange_stats, ready)."""
    k_md, k_ex, k_next = jr.split(ens.rng, 3)
    if pattern == "asynchronous":
        max_steps = 2 * window_steps
        n_steps = torch.clamp(torch.round(window_steps * ens.speed)
                              .to(torch.int64), 1, max_steps)
    else:
        max_steps = md_steps
        n_steps = torch.full(ens.assignment.shape, md_steps,
                             dtype=torch.int64, device=ens.assignment.device)
    if mesh is None:
        state = _propagate(engine, ens, grid, n_steps, k_md, execution,
                           max_steps, donate)
    else:
        state = _propagate_sharded(engine, ens, grid, n_steps, k_md,
                                   execution, max_steps, mesh, donate)
    features, fail, halo = exchange_inputs(engine, state, mesh,
                                           exchange_comm,
                                           ens.assignment.shape[0])
    if pattern == "asynchronous":
        debt = ens.debt + n_steps.to(torch.float32)
        ready = (debt >= md_steps) & ens.alive
        ens = ens._replace(debt=torch.where(ready, debt - md_steps, debt))
    else:
        ready = ens.alive
    out = _exchange(engine, state, grid, ens.assignment, dim_index, parity,
                    k_ex, scheme, ready=ready, features=features, fail=fail,
                    mesh=halo)
    assignment, stats = out[:2]
    if mesh is not None:
        stats["_fail_row"] = out[2] if halo is not None else fail
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


def _host_sweep(ens: Ensemble, dim_index: int, parity: int):
    """A host-scheduled sweep's (dim, parity) as device scalars."""
    dev = ens.assignment.device
    return (torch.tensor(dim_index, device=dev),
            torch.tensor(parity, device=dev))


def _with_pair_rows(out_stats: Dict[str, Any], pa, pc) -> Dict[str, Any]:
    if pa is not None:
        out_stats["pair_attempt"], out_stats["pair_accept"] = pa, pc
    return out_stats


def sync_cycle(engine, grid: ControlGrid, ens: Ensemble, md_steps: int,
               dim_index: int, parity: int, scheme: str = "neighbor",
               execution=None, telemetry_rows: bool = False
               ) -> Tuple[Ensemble, Dict[str, Any]]:
    """One synchronous cycle: every replica propagates ``md_steps``, then
    one exchange sweep along dimension ``dim_index`` at DEO ``parity``
    (host ints).  Paper Fig 1a.

    Returns (new_ens, stats) in the JAX package's layout: ``{"dim{d}":
    {"attempted", "accepted", "mean_delta"}}``, plus the per-pair rows
    ``pair_attempt`` / ``pair_accept`` when ``telemetry_rows`` (the
    neighbor scheme only).  The JAX package's ``mesh`` (device
    placement, values unchanged) has no counterpart on one device; a
    replica-sharded cycle is ``fused_cycle(mesh=...)``."""
    execution = execution or {"mode": "mode1", "n_waves": 1}
    d, p = _host_sweep(ens, dim_index, parity)
    new_ens, stats, _ = _cycle_core(
        engine, grid, ens, pattern="synchronous", md_steps=md_steps,
        window_steps=0, dim_index=d, parity=p, scheme=scheme,
        execution=execution)
    pa, pc = _pop_pair_rows(stats, telemetry_rows)
    return new_ens, _with_pair_rows({f"dim{dim_index}": stats}, pa, pc)


def async_cycle(engine, grid: ControlGrid, ens: Ensemble, md_steps: int,
                window_steps: int, dim_index: int, parity: int,
                scheme: str = "neighbor", execution=None,
                telemetry_rows: bool = False
                ) -> Tuple[Ensemble, Dict[str, Any]]:
    """One asynchronous real-time window.  Paper Fig 1b.

    Each replica advances by its own speed; replicas whose banked
    progress reaches ``md_steps`` become ready, exchange, and bank the
    remainder; a pair with an un-ready member auto-rejects.  The stats
    are :func:`sync_cycle`'s plus ``ready_frac``, the share of replicas
    ready this window."""
    execution = execution or {"mode": "mode1", "n_waves": 1}
    d, p = _host_sweep(ens, dim_index, parity)
    new_ens, stats, ready = _cycle_core(
        engine, grid, ens, pattern="asynchronous", md_steps=md_steps,
        window_steps=window_steps, dim_index=d, parity=p, scheme=scheme,
        execution=execution)
    pa, pc = _pop_pair_rows(stats, telemetry_rows)
    return new_ens, _with_pair_rows(
        {f"dim{dim_index}": stats,
         "ready_frac": torch.mean(ready.to(torch.float32))}, pa, pc)


def fused_cycle(engine, grid: ControlGrid, ens: Ensemble, *, pattern: str,
                md_steps: int, window_steps: int = 0,
                scheme: str = "neighbor", execution=None,
                telemetry_rows: bool = False, mesh=None,
                exchange_comm: str = "halo", donate: bool = False
                ) -> Tuple[Ensemble, Dict[str, torch.Tensor]]:
    """One cycle with dim/parity derived ON DEVICE from ``ens.cycle``.

    Returns (new_ens, stats): fixed-shape device tensors ``dim``,
    ``accepted``, ``attempted``, ``ready_frac``, the neighbor-list health
    scalars (:func:`nb_health`) and the post-cycle ``assignment`` row,
    for the driver to stack per chunk.  ``telemetry_rows`` adds the
    exchange's per-pair rows ``pair_attempt`` / ``pair_accept`` (float32,
    the pair table's width W; the neighbor scheme only).  With ``mesh``
    the cycle runs on one rank's block (module docstring); the stats then
    also carry ``_fail_row``, the (R,) failure row the exchange moved,
    which the driver pops and hands to the recovery.  ``donate`` as for
    :func:`_cycle_core`."""
    execution = execution or {"mode": "mode1", "n_waves": 1}
    n_dims = len(grid.dims)
    dim_index = torch.remainder(ens.cycle, n_dims)
    parity = torch.remainder(torch.div(ens.cycle, n_dims,
                                       rounding_mode="floor"), 2)
    new_ens, stats, ready = _cycle_core(
        engine, grid, ens, pattern=pattern, md_steps=md_steps,
        window_steps=window_steps, dim_index=dim_index, parity=parity,
        scheme=scheme, execution=execution, mesh=mesh,
        exchange_comm=exchange_comm, donate=donate)
    pa, pc = _pop_pair_rows(stats, telemetry_rows)
    nb = nb_health(engine, new_ens.state, new_ens.assignment.device)
    if mesh is not None and nb_live(engine):
        # the worst replica over every rank (max is exact)
        worst = S.all_reduce_max(torch.stack(list(nb.values())), mesh)
        nb = dict(zip(nb, worst))
    flat = {
        "dim": dim_index,
        "accepted": stats["accepted"],
        "attempted": stats["attempted"],
        "ready_frac": torch.mean(ready.to(torch.float32)),
        "assignment": new_ens.assignment,
        **nb,
    }
    if pa is not None:
        flat["pair_attempt"], flat["pair_accept"] = pa, pc
    if "_fail_row" in stats:
        flat["_fail_row"] = stats["_fail_row"]
    return new_ens, flat


def nb_live(engine) -> bool:
    """Can the engine's neighbor-list counters ever be nonzero?  (Not
    without ``nb_stats``, nor on a dense nonbonded path.)"""
    return (callable(getattr(engine, "nb_stats", None))
            and getattr(engine, "nonbonded", None) != "dense")


def nb_health(engine, state, device) -> Dict[str, torch.Tensor]:
    """Neighbor-list health scalars for the cycle stats: an engine with
    ``nb_stats`` (the sparse nonbonded path) reports its cumulative
    overflow / rebuild counters, anything else zeros, so the stats keep
    one shape across engines."""
    fn = getattr(engine, "nb_stats", None)
    if callable(fn):
        return fn(state)
    return nb_zero_stats(device)
