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

Under replica sharding (``run_sharded``) the exchange is the one
per-ensemble phase, on either of two wires:

  * halo (``exchange_comm="halo"``, the default):
    :func:`neighbor_exchange_sharded` / :func:`matrix_exchange_sharded`.
    Each rank reduces its own block's features to exchange scalars (the
    u_self / u_swap rows, or its (B, C) tile of the cross-energy
    matrix), and only those scalars and the (B,) failure flags hop the
    ladder ring (``sharding.ring_all_gather``);
  * gather (``"gather"``): the (R,)-per-field feature rows and the (R,)
    failure flags are all-gathered and every rank runs the whole
    reduction (``features=`` / ``fail=`` of :func:`neighbor_exchange` and
    :func:`matrix_exchange`).

Either way the decision is taken on every rank from the same (R,) rows
and the same key, rows that the ring or the gather copies and never
reduces, so the discrete trajectory is the unsharded one bitwise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import random as jr
from repro_torch import sharding as S
from repro_torch.core.controls import ControlGrid, ctrl_for_assignment
from repro_torch.core.modes import shard_rows
from repro_torch.tree import tree_map


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
    invalid, so the clamped values never reach a decision.  The stats
    carry the per-pair rows ``_pair_attempt`` / ``_pair_accept`` (bool,
    (W,)) for the telemetry."""
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
        # the per-pair-slot telemetry rows (W,), slot w of the stacked
        # pair table's sweep: the masks as they are, no operation; a
        # caller that keeps them (``patterns._pop_pair_rows``) casts them,
        # so with telemetry off they cost nothing
        "_pair_attempt": valid,
        "_pair_accept": accept,
    }
    return new_assignment, stats


def neighbor_exchange(engine, state, grid: ControlGrid,
                      assignment: torch.Tensor, dim_index, parity,
                      rng: torch.Tensor, ready: torch.Tensor = None,
                      features=None, fail: torch.Tensor = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One DEO exchange sweep along one grid dimension.

    ``dim_index`` / ``parity`` are device scalars derived from the cycle
    count.  ``ready`` masks replicas eligible to exchange.  ``features``
    / ``fail``: the whole ensemble's feature rows and failure flags,
    when ``state`` holds one rank's block (the gather wire); else both
    come from ``state``.  Returns (new_assignment, stats)."""
    left, right, valid, ri, rj, swapped, n_valid = _sweep_pairs(
        grid, assignment, dim_index, parity)
    ctrl_keys = getattr(engine, "ctrl_keys", None)
    ctrl_self = ctrl_for_assignment(grid, assignment, ctrl_keys)
    ctrl_swap = ctrl_for_assignment(grid, swapped, ctrl_keys)
    if features is not None:
        u_self, u_swap = engine.energy_pair_from_features(
            features, ctrl_self, ctrl_swap)
    else:
        u_self, u_swap = pair_energies(engine, state, ctrl_self, ctrl_swap)
    if fail is None:
        fail = engine.is_failed(state)
    return _decide_sweep(assignment, u_self, u_swap, left, right, valid,
                         ri, rj, n_valid, rng, ready, fail)


def neighbor_exchange_sharded(engine, state, grid: ControlGrid,
                              assignment: torch.Tensor, dim_index, parity,
                              rng: torch.Tensor, *, mesh,
                              ready: torch.Tensor = None):
    """The DEO sweep on the halo wire.  ``state`` is this rank's block of
    B = R / n_shards rows; the assignment, ``ready`` and the key are the
    whole control plane.  Each rank

      1. issues the (B,) failure-flag ring first (on the card its hops
         overlap the feature pass that follows);
      2. reduces its own block's features on its slice of the ctrl rows
         (O(B) work; a kernel that splits its sums by the stack splits
         them by the ensemble, ``sharding.ensemble_scope``);
      3. rings the packed (2B,) ``[u_self, u_swap]`` block and reassembles
         the (R,) rows in replica order,

    then takes the decision as :func:`neighbor_exchange` does.  Returns
    (new_assignment, stats, fail_row), the (R,) failure row for the
    recovery to reuse."""
    n = assignment.shape[0]
    b = n // mesh.n_shards
    fail_row = S.ring_all_gather(engine.is_failed(state), mesh).reshape(n)
    left, right, valid, ri, rj, swapped, n_valid = _sweep_pairs(
        grid, assignment, dim_index, parity)
    ctrl_keys = getattr(engine, "ctrl_keys", None)
    ctrl_self = ctrl_for_assignment(grid, assignment, ctrl_keys)
    ctrl_swap = ctrl_for_assignment(grid, swapped, ctrl_keys)
    with S.ensemble_scope(mesh, n):
        feats = engine.replica_features(state)
    u_self_loc, u_swap_loc = engine.energy_pair_from_features(
        feats, tree_map(lambda x: shard_rows(x, mesh), ctrl_self),
        tree_map(lambda x: shard_rows(x, mesh), ctrl_swap))
    rows = S.ring_all_gather(torch.cat([u_self_loc, u_swap_loc]), mesh)
    u_self = rows[:, :b].reshape(n)
    u_swap = rows[:, b:].reshape(n)
    new_assignment, stats = _decide_sweep(
        assignment, u_self, u_swap, left, right, valid, ri, rj, n_valid,
        rng, ready, fail_row)
    return new_assignment, stats, fail_row


def _gibbs_sweeps(assignment: torch.Tensor, rng: torch.Tensor,
                  n_sweeps: int, fail: torch.Tensor, terms_of):
    """The Gibbs scheme's sweeps: each pairs the ctrls by a random
    permutation and makes one Metropolis decision per pair, as the JAX
    package's ``matrix_exchange`` does, key for key.  ``terms_of(
    assignment, ri, rj, a, b)`` gives the four energies ``u[ri, b],
    u[rj, a], u[ri, a], u[rj, b]`` of the delta, under the assignment
    the sweep starts from."""
    n = assignment.shape[0]
    accepted = []
    for key in jr.split(rng, n_sweeps):
        perm = jr.permutation(key, n)
        a, b = perm[: n // 2 * 2: 2], perm[1: n // 2 * 2: 2]
        inv = inverse_permutation(assignment)
        ri, rj = inv[a], inv[b]
        u_rib, u_rja, u_ria, u_rjb = terms_of(assignment, ri, rj, a, b)
        delta = (u_rib + u_rja) - (u_ria + u_rjb)
        accept = metropolis(delta, jr.fold_in(key, 7))
        accept = accept & ~fail[ri] & ~fail[rj]
        new_a = torch.where(accept, b, a)
        new_b = torch.where(accept, a, b)
        assignment = (assignment.scatter(0, ri, new_a)
                      .scatter(0, rj, new_b))
        accepted.append(torch.sum(accept.to(torch.float32)))
    dev = assignment.device
    stats = {
        "attempted": torch.full((), float(n_sweeps * (n // 2)),
                                dtype=torch.float32, device=dev),
        "accepted": torch.sum(torch.stack(accepted)),
        "mean_delta": torch.zeros((), dtype=torch.float32, device=dev),
    }
    return assignment, stats


def matrix_exchange(engine, state, grid: ControlGrid,
                    assignment: torch.Tensor, rng: torch.Tensor,
                    n_sweeps: int = 1, features=None,
                    fail: torch.Tensor = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Gibbs-style exchange from the full (R, C) cross-energy matrix.

    ``u[i, c]`` is replica i's reduced energy under ctrl c
    (``engine.cross_energy``: one feature pass, then the exchange-matrix
    kernel).  ``features`` / ``fail`` as for :func:`neighbor_exchange`
    (the matrix is then built from the gathered feature rows)."""
    if features is not None:
        u = engine.cross_energy_from_features(features, dict(grid.values))
    else:
        u = engine.cross_energy(state, dict(grid.values))
    if fail is None:
        fail = engine.is_failed(state)
    return _gibbs_sweeps(
        assignment, rng, n_sweeps, fail,
        lambda _, ri, rj, a, b: (u[ri, b], u[rj, a], u[ri, a], u[rj, b]))


def matrix_exchange_sharded(engine, state, grid: ControlGrid,
                            assignment: torch.Tensor, rng: torch.Tensor,
                            n_sweeps: int = 1, *, mesh):
    """The Gibbs exchange on the halo wire, from (B, C) tiles.

    Each rank builds only its tile of the cross-energy matrix from its
    block (``cross_energy_from_features`` on B rows).  A sweep pairs
    every replica with one other, so each replica i enters the delta
    through two entries of its own row: ``u[i, c_i]`` (its own ctrl) and
    ``u[i, c']`` (its partner's).  Per sweep a rank rings those two per
    replica of its block, a packed (2B,) row as the neighbor sweep's, and
    the (R,) rows reassembled in replica order give the four terms of
    :func:`matrix_exchange`'s delta as copies, never sums, so the
    decision is its bit for bit.  (The JAX package rings a (2R,) vector
    of one-hot contributions per sweep and sums the blocks; this wire
    carries B values where that one carries R.)  The failure ring is
    issued first, as in :func:`neighbor_exchange_sharded`.  Returns
    (new_assignment, stats, fail_row)."""
    n = assignment.shape[0]
    b = n // mesh.n_shards
    fail = S.ring_all_gather(engine.is_failed(state), mesh).reshape(n)
    with S.ensemble_scope(mesh, n):
        tile = engine.cross_energy_from_features(
            engine.replica_features(state), dict(grid.values))  # (B, C)
    loc = torch.arange(b, device=tile.device)

    def terms_of(assignment, ri, rj, a, bb):
        # partner[c]: the ctrl paired with c this sweep (an unpaired
        # ctrl, R odd, is its own partner and never decided on)
        partner = torch.arange(n, dtype=a.dtype, device=a.device)
        partner = partner.scatter(0, a, bb).scatter(0, bb, a)
        own = shard_rows(assignment, mesh)
        rows = S.ring_all_gather(
            torch.cat([tile[loc, own], tile[loc, partner[own]]]), mesh)
        u_own = rows[:, :b].reshape(n)
        u_par = rows[:, b:].reshape(n)
        return u_par[ri], u_par[rj], u_own[ri], u_own[rj]

    assignment, stats = _gibbs_sweeps(assignment, rng, n_sweeps, fail,
                                      terms_of)
    return assignment, stats, fail
