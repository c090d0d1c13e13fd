"""Replica-level fault tolerance: detect and recover, on the device.

  * detect   — ``engine.is_failed`` (non-finite state or an engine's
               declared thresholds), masked by ``alive``.
  * recover  — policy 'relaunch': failed replicas are reset to their
               last clean state (keeps the ladder full); policy
               'continue': failed replicas are marked dead and masked out
               of all later exchanges.

The escalation ladder (``relaunch_budget`` B > 0: relaunch, then reinit
from the next rung's backup, then degrade) is not ported yet; the
default B = 0 is the unlimited-relaunch behaviour.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.ensemble import Ensemble

# the per-cycle escalation counters every detect/recover path emits
ESC_STAT_KEYS = ("failed", "esc_relaunch", "esc_reinit", "esc_dead")


def detect(engine, ens: Ensemble) -> torch.Tensor:
    return engine.is_failed(ens.state) & ens.alive


def _mend(state, donor_state, mask_rows: torch.Tensor):
    """Replace ``state`` rows flagged in ``mask_rows`` with the donor's."""
    def one(cur, don):
        shape = (mask_rows.shape[0],) + (1,) * (cur.ndim - 1)
        return torch.where(mask_rows.reshape(shape), don, cur)
    return {k: one(v, donor_state[k]) for k, v in state.items()}


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
    """Apply the recovery policy.  Returns (ensemble, n_failed)."""
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
                   relaunch_budget: int = 0
                   ) -> Tuple[Ensemble, Any, Dict[str, torch.Tensor]]:
    """Device-side detect + recover + backup carry, with no host read:
    recovery on an all-False mask is the identity, so it always runs;
    the backup advances to the post-cycle state only on clean cycles.
    Returns (ensemble, new_backup_state, stats of ``ESC_STAT_KEYS``)."""
    if relaunch_budget != 0:
        raise NotImplementedError(
            "relaunch_budget > 0 (the escalation ladder) is not ported yet")
    failed = detect(engine, ens)
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
        relaunch, reinit, dead = _escalate_masks(failed, streak,
                                                 relaunch_budget)
        new_ens = ens._replace(state=_mend(ens.state, backup_state,
                                           relaunch),
                               failures=ens.failures + n_failed,
                               relaunches=streak)
        stats = _esc_stats(failed, relaunch, reinit, dead)

    new_backup = {k: torch.where(any_failed, b, new_ens.state[k])
                  for k, b in backup_state.items()}
    return new_ens, new_backup, stats
