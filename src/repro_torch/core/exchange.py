"""Exchange phase: Metropolis acceptance over DEO neighbor pairs, or
over random pairings of the whole cross-energy matrix (Gibbs scheme).

We swap *control parameters*, never configurations: the ensemble keeps
``assignment[r] = ctrl index held by replica r`` and an accepted exchange
swaps two of its entries.  For a proposed swap of ctrls (a, b) held by
replicas (i, j):

    delta = [u_b(x_i) + u_a(x_j)] - [u_a(x_i) + u_b(x_j)]
    P(accept) = min(1, exp(-delta))

Every step is a device op: the sweep's pairs are gathered from the
grid's stacked pair table with the cycle-derived (dim, parity) tensors,
so an exchange never synchronises with the host.  JAX's
``.at[i].set(..., mode="drop")`` with ``n`` as the drop slot becomes a
scatter into an (n + 1) buffer and a slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import random as jr
from repro_torch.core.controls import ControlGrid, ctrl_for_assignment


def inverse_permutation(assignment: torch.Tensor) -> torch.Tensor:
    """inv[c] = replica holding ctrl c."""
    n = assignment.shape[0]
    idx = torch.arange(n, dtype=assignment.dtype, device=assignment.device)
    return torch.zeros_like(assignment).scatter(0, assignment, idx)


def _set_drop(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """``x.at[idx].set(vals, mode="drop")`` where index ``len(x)`` is the
    only out-of-range value used (the drop slot of padding pairs)."""
    buf = torch.cat([x, x.new_zeros(1)])
    return buf.scatter(0, idx, vals)[:-1]


def metropolis(delta: torch.Tensor, rng: torch.Tensor) -> torch.Tensor:
    u = jr.uniform(rng, tuple(delta.shape))
    return u < torch.exp(torch.clamp_max(-delta, 0.0))


def pair_energies(engine, state, ctrl_self: Dict, ctrl_swap: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced energies under the current and the swapped assignment;
    engines with ``energy_pair`` evaluate both from ONE feature pass."""
    if hasattr(engine, "energy_pair"):
        return engine.energy_pair(state, ctrl_self, ctrl_swap)
    return (engine.energy(state, ctrl_self),
            engine.energy(state, ctrl_swap))


def _sweep_row(tab: torch.Tensor, dim_index, parity) -> torch.Tensor:
    """Row [dim_index, parity] of an (n_dims, 2, P) table, selected by
    device scalars (no host read)."""
    flat = tab.reshape(-1, tab.shape[-1])
    return flat.index_select(0, (dim_index * 2 + parity).reshape(1))[0]


def _sweep_pairs(grid: ControlGrid, assignment: torch.Tensor, dim_index,
                 parity):
    """Gather one DEO sweep from the stacked pair table and map its ctrl
    pairs to replicas.  Padding pairs map to replica ``n``: dropped."""
    tab = grid.pair_table
    left = _sweep_row(tab.left, dim_index, parity)
    right = _sweep_row(tab.right, dim_index, parity)
    valid = _sweep_row(tab.valid, dim_index, parity)
    inv = inverse_permutation(assignment)
    n = assignment.shape[0]
    ri = torch.where(valid, inv[left], n)     # replicas holding left ctrls
    rj = torch.where(valid, inv[right], n)
    swapped = _set_drop(_set_drop(assignment, ri, right), rj, left)
    n_valid = _sweep_row(tab.count.unsqueeze(-1), dim_index, parity)[0]
    return left, right, valid, ri, rj, swapped, n_valid


def _decide_sweep(assignment, u_self, u_swap, left, right, valid, ri, rj,
                  n_valid, rng, ready, fail):
    """The Metropolis decision on the (R,) energy rows.  The delta keeps
    the association ``(u_swap[ri] + u_swap[rj]) - (u_self[ri] +
    u_self[rj])``.  Reads at the drop slot are clamped; their pairs are
    invalid, so the clamped values never reach a decision."""
    last = assignment.shape[0] - 1
    ri_c, rj_c = ri.clamp(max=last), rj.clamp(max=last)
    delta = (u_swap[ri_c] + u_swap[rj_c]) - (u_self[ri_c] + u_self[rj_c])
    accept = metropolis(delta, rng) & valid
    if ready is not None:
        accept = accept & ready[ri_c] & ready[rj_c]
    accept = accept & ~fail[ri_c] & ~fail[rj_c]

    new_left = torch.where(accept, right, left)
    new_right = torch.where(accept, left, right)
    new_assignment = _set_drop(_set_drop(assignment, ri, new_left), rj,
                               new_right)
    stats = {
        "attempted": n_valid,
        "accepted": torch.sum(accept.to(torch.float32)),
        "mean_delta": (torch.sum(torch.where(valid, delta, 0.0))
                       / torch.clamp_min(n_valid, 1.0)),
    }
    return new_assignment, stats


def neighbor_exchange(engine, state, grid: ControlGrid,
                      assignment: torch.Tensor, dim_index, parity,
                      rng: torch.Tensor, ready: torch.Tensor = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One DEO exchange sweep along one grid dimension.

    ``dim_index`` / ``parity`` are device scalars derived from the cycle
    count.  ``ready`` masks replicas eligible to exchange.  Returns
    (new_assignment, stats)."""
    left, right, valid, ri, rj, swapped, n_valid = _sweep_pairs(
        grid, assignment, dim_index, parity)
    ctrl_keys = getattr(engine, "ctrl_keys", None)
    ctrl_self = ctrl_for_assignment(grid, assignment, ctrl_keys)
    ctrl_swap = ctrl_for_assignment(grid, swapped, ctrl_keys)
    u_self, u_swap = pair_energies(engine, state, ctrl_self, ctrl_swap)
    fail = engine.is_failed(state)
    return _decide_sweep(assignment, u_self, u_swap, left, right, valid,
                         ri, rj, n_valid, rng, ready, fail)


def matrix_exchange(engine, state, grid: ControlGrid,
                    assignment: torch.Tensor, rng: torch.Tensor,
                    n_sweeps: int = 1
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Gibbs-style exchange from the full (R, C) cross-energy matrix.

    ``u[i, c]`` is replica i's reduced energy under ctrl c
    (``engine.cross_energy``: one feature pass, then the exchange-matrix
    kernel).  Each of ``n_sweeps`` sweeps pairs the ctrls by a random
    permutation and makes one independent Metropolis decision per pair,
    as the JAX package's ``matrix_exchange`` does, key for key."""
    n = assignment.shape[0]
    u = engine.cross_energy(state, dict(grid.values))
    fail = engine.is_failed(state)
    accepted = []
    for key in jr.split(rng, n_sweeps):
        perm = jr.permutation(key, n)
        a, b = perm[: n // 2 * 2: 2], perm[1: n // 2 * 2: 2]
        inv = inverse_permutation(assignment)
        ri, rj = inv[a], inv[b]
        delta = (u[ri, b] + u[rj, a]) - (u[ri, a] + u[rj, b])
        accept = metropolis(delta, jr.fold_in(key, 7))
        accept = accept & ~fail[ri] & ~fail[rj]
        new_a = torch.where(accept, b, a)
        new_b = torch.where(accept, a, b)
        assignment = (assignment.scatter(0, ri, new_a)
                      .scatter(0, rj, new_b))
        accepted.append(torch.sum(accept.to(torch.float32)))
    stats = {
        "attempted": torch.full((), float(n_sweeps * (n // 2)),
                                dtype=torch.float32, device=u.device),
        "accepted": torch.sum(torch.stack(accepted)),
        "mean_delta": torch.zeros((), dtype=torch.float32, device=u.device),
    }
    return assignment, stats
