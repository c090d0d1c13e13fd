"""Replica-level fault tolerance: inject, detect, recover, escalate, on
the device.

  * inject   — ``inject_failures``: NaN in every floating state leaf of a
               random subset of replicas (a hardware fault or an MD
               blow-up), drawn as JAX's ``bernoulli`` draws it.
  * detect   — ``engine.is_failed`` (non-finite state or an engine's
               declared thresholds), masked by ``alive``.
  * recover  — policy 'relaunch': failed replicas are reset to their
               last clean state (keeps the ladder full); policy
               'continue': failed replicas are marked dead and masked out
               of all later exchanges.

Escalation ladder (``relaunch_budget`` B > 0): a replica's consecutive
failure streak rides the ensemble as ``ens.relaunches`` (reset on any
clean cycle).  Streak <= B relaunches from the replica's own backup;
B < streak <= 2B re-initialises from the next ladder rung's backup
(``_peer_backup``); streak > 2B marks the replica dead and the ladder
continues degraded.  B = 0 (the default) is unlimited relaunching.
Every mask is a device tensor: nothing here reads the device from the
host.

Under replica sharding (``mesh`` set) the state and the backup hold one
rank's block; ``alive``, ``failures`` and ``relaunches`` are the whole
control plane.  The hit mask is drawn at full (R,) size and sliced, the
failure row comes from the exchange's ring (``fail_row``), and the
tier-2 donor's boundary row takes one reverse ring hop, so every
decision and counter is the unsharded run's bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import sharding as S
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.modes import shard_rows
from repro_torch.tree import tree_map

# the per-cycle escalation counters every detect/recover path emits
ESC_STAT_KEYS = ("failed", "esc_relaunch", "esc_reinit", "esc_dead")


def inject_failures(ens: Ensemble, rng: torch.Tensor, rate: float,
                    mesh=None) -> Ensemble:
    """Corrupt each replica's state with probability ``rate``: the (R,)
    hit mask is ``uniform(rng, (R,)) < rate`` in float32, as JAX's
    ``bernoulli`` draws it, and a hit row of every floating leaf (the
    sparse path's list planes included) becomes NaN.  With ``mesh`` the
    state is this rank's block and takes its slice of the same mask."""
    hit = jr.uniform(rng, (ens.assignment.shape[0],)) \
        < float(np.float32(rate))
    if mesh is not None:
        hit = shard_rows(hit, mesh)
    r = hit.shape[0]

    def corrupt(x):
        if x.ndim < 1 or x.shape[0] != r or not x.is_floating_point():
            return x
        return torch.where(hit.reshape((r,) + (1,) * (x.ndim - 1)),
                           float("nan"), x)

    return ens._replace(state=tree_map(corrupt, ens.state))


def detect(engine, ens: Ensemble) -> torch.Tensor:
    return engine.is_failed(ens.state) & ens.alive


def _mend(state, donor_state, mask_rows: torch.Tensor):
    """Replace ``state`` rows flagged in ``mask_rows`` with the donor's,
    leaf by leaf through the nested state (the sparse path's neighbor
    list included)."""
    def one(cur, don):
        shape = (mask_rows.shape[0],) + (1,) * (cur.ndim - 1)
        return torch.where(mask_rows.reshape(shape), don, cur)
    return tree_map(one, state, donor_state)


def _peer_backup(backup_state, mesh=None):
    """The tier-2 donor: replica i's donor is the next ladder rung's
    backup, peer(i) = backup[(i + 1) mod R], exact copies of its rows.
    Sharded, each rank rolls its block and fills its last row with the
    next rank's first backup row, one reverse ring hop per leaf."""
    if mesh is None or mesh.n_shards == 1:
        return tree_map(lambda b: torch.roll(b, -1, dims=0) if b.ndim >= 1
                        else b, backup_state)

    def roll(b):
        first = S.ring_shift(b[:1], mesh, reverse=True)
        return torch.cat([b[1:], first])
    return tree_map(roll, backup_state)


def _escalate_masks(failed: torch.Tensor, streak: torch.Tensor, budget: int):
    """Split the failure mask into the three escalation tiers."""
    if budget <= 0:
        zeros = torch.zeros_like(failed)
        return failed, zeros, zeros
    relaunch = failed & (streak <= budget)
    reinit = failed & (streak > budget) & (streak <= 2 * budget)
    dead = failed & (streak > 2 * budget)
    return relaunch, reinit, dead


def _esc_stats(failed, relaunch, reinit, dead) -> Dict[str, torch.Tensor]:
    def c(m):
        return torch.sum(m.to(torch.int64))
    return {"failed": c(failed), "esc_relaunch": c(relaunch),
            "esc_reinit": c(reinit), "esc_dead": c(dead)}


def recover(engine, ens: Ensemble, failed: torch.Tensor, policy: str,
            backup_state: Any) -> Tuple[Ensemble, torch.Tensor]:
    """Apply the recovery policy (the tier-1-only entry point).  Returns
    (ensemble, n_failed)."""
    n_failed = torch.sum(failed.to(torch.int64))
    streak = torch.where(failed, ens.relaunches + 1, 0)
    if policy == "continue":
        return ens._replace(alive=ens.alive & ~failed,
                            failures=ens.failures + n_failed,
                            relaunches=streak), n_failed
    state = _mend(ens.state, backup_state, failed)
    return ens._replace(state=state, failures=ens.failures + n_failed,
                        relaunches=streak), n_failed


def detect_recover(engine, ens: Ensemble, policy: str, backup_state: Any,
                   relaunch_budget: int = 0, mesh=None,
                   fail_row: torch.Tensor = None
                   ) -> Tuple[Ensemble, Any, Dict[str, torch.Tensor]]:
    """Device-side detect + escalate + recover + backup carry, with no
    host read: recovery on an all-False mask is the identity, so it
    always runs; the backup advances to the post-cycle state only on
    clean cycles.  Returns (ensemble, new_backup_state, stats of
    ``ESC_STAT_KEYS``).

    With ``mesh`` the state and the backup are this rank's block.
    ``fail_row``: the (R,) raw failure row the exchange already moved
    this cycle (the exchange never changes the state), so tier-1
    recovery adds nothing to the wire; without it the block's flags are
    all-gathered here.  Every rank agrees on ``alive``, the counters and
    whether the backup freezes; the mend is per row on the block, and a
    ``relaunch_budget`` adds the tier-2 donor's boundary hop
    (:func:`_peer_backup`)."""
    if mesh is None:
        failed = detect(engine, ens)
    elif fail_row is not None:
        failed = fail_row & ens.alive
    else:
        failed = S.all_gather_rows(engine.is_failed(ens.state), mesh) \
            & ens.alive
    any_failed = torch.any(failed)
    n_failed = torch.sum(failed.to(torch.int64))
    streak = torch.where(failed, ens.relaunches + 1, 0)

    if policy == "continue":
        new_ens = ens._replace(alive=ens.alive & ~failed,
                               failures=ens.failures + n_failed,
                               relaunches=streak)
        zeros = torch.zeros_like(failed)
        stats = _esc_stats(failed, zeros, zeros, failed)
    else:
        def rows(mask):                 # the (R,) mask's rows of the state
            return mask if mesh is None else shard_rows(mask, mesh)
        relaunch, reinit, dead = _escalate_masks(failed, streak,
                                                 relaunch_budget)
        state = _mend(ens.state, backup_state, rows(relaunch))
        alive = ens.alive
        if relaunch_budget > 0:
            state = _mend(state, _peer_backup(backup_state, mesh),
                          rows(reinit))
            alive = alive & ~dead
        new_ens = ens._replace(state=state, alive=alive,
                               failures=ens.failures + n_failed,
                               relaunches=streak)
        stats = _esc_stats(failed, relaunch, reinit, dead)

    # where(c, s, s) is s: a leaf the backup shares with the state (an
    # in-place engine's) is kept without a copy
    new_backup = tree_map(
        lambda b, s: s if b is s else torch.where(any_failed, b, s),
        backup_state, new_ens.state)
    return new_ens, new_backup, stats
