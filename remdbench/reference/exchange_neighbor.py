"""The exchange scheme ``neighbor``: deterministic even-odd (DEO) sweeps
of neighbour pairs on the control grid, one dimension a cycle in turn,
each pair a Metropolis decision on the reduced energies.

  sweep(cycle)   dimension ``cycle % D``, pairs (s, s + 1) of parity
                 ``(cycle // D) % 2`` along it, in row-major order
  decide         delta = u_i(c_j) + u_j(c_i) - u_i(c_i) - u_j(c_j) for
                 the replicas i, j holding the pair's controls; accept
                 where log(u) < min(-delta, 0), u the pair's uniform draw
                 from the cycle's exchange key (one draw the width of the
                 widest sweep), neither replica failed
  rows_bad       a history row that is not its cycle's sweep applied to
                 the row before
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import prng

Row = Tuple[int, np.ndarray, float]       # (cycle, assignment, accepted)


class Decision(NamedTuple):
    left: np.ndarray      # (P,) ctrl indices of each pair
    right: np.ndarray
    ri: np.ndarray        # (P,) the replicas holding them
    rj: np.ndarray
    accept: np.ndarray    # (P,) bool
    log_u: np.ndarray     # (P,) float64
    log_p: np.ndarray     # (P,) float64: min(-delta, 0)


def sweep_pairs(shape, dim: int, parity: int):
    """The ctrl pairs of one DEO sweep along ``dim``: neighbours (s, s+1)
    for s of the given parity, in row-major order of the grid."""
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    starts = np.arange(parity % 2, shape[dim] - 1, 2)
    return (np.take(idx, starts, axis=dim).reshape(-1),
            np.take(idx, starts + 1, axis=dim).reshape(-1))


def pair_width(shape) -> int:
    """The widest sweep: the length of every sweep's uniform draw."""
    return max([len(sweep_pairs(shape, d, p)[0])
                for d in range(len(shape)) for p in (0, 1)] + [1])


def sweep(shape, cycle: int):
    """(left, right) ctrl pairs of ``cycle``'s sweep."""
    nd = len(shape)
    return sweep_pairs(shape, cycle % nd, (cycle // nd) % 2)


def _holders(a: np.ndarray, left, right):
    inv = np.empty_like(a)
    inv[a] = np.arange(len(a))
    return inv[left], inv[right]


def decide(model, feats, assignment: np.ndarray, cycle: int,
           k_ex: torch.Tensor) -> Decision:
    """The sweep's Metropolis decisions from ``model``'s energies."""
    shape = model.grid.shape
    left, right = sweep(shape, cycle)
    a = np.asarray(assignment)
    ri, rj = _holders(a, left, right)
    swapped = a.copy()
    swapped[ri], swapped[rj] = right, left
    dev = model.device
    u_self = model.reduced(feats, model.controls(torch.as_tensor(
        a, device=dev)))
    u_swap = model.reduced(feats, model.controls(torch.as_tensor(
        swapped, device=dev)))
    us, uw = u_self.double().cpu().numpy(), u_swap.double().cpu().numpy()
    delta = (uw[ri] + uw[rj]) - (us[ri] + us[rj])
    u = prng.uniform(prng.bits(k_ex, pair_width(shape))).double()
    u = u.cpu().numpy()[:len(left)]
    log_p = np.minimum(-delta, 0.0)
    with np.errstate(divide="ignore"):
        log_u = np.log(u)
    fail = model.failed(feats)
    accept = (log_u < log_p) & ~fail[ri] & ~fail[rj]
    return Decision(left, right, ri, rj, accept, log_u, log_p)


def apply(assignment: np.ndarray, d: Decision) -> np.ndarray:
    """The row after the accepted swaps of ``d``."""
    b = np.array(assignment, copy=True)
    b[d.ri[d.accept]], b[d.rj[d.accept]] = d.right[d.accept], d.left[d.accept]
    return b


def taken(row: np.ndarray, d: Decision) -> np.ndarray:
    """(P,) bool: the pairs of ``d`` that ``row`` swapped."""
    return np.asarray(row)[d.ri] == d.right


def rows_bad(model, rows: List[Row]) -> int:
    """History rows that are not a valid outcome of their cycle's sweep
    from the row before (the first from the identity): each pair kept or
    swapped, as many swaps as the cycle counted, no other change."""
    n_rep = model.n_rep
    bad = 0
    prev = np.arange(n_rep)
    expect = 0
    for cyc, row, accepted in rows:
        row = np.asarray(row)
        if cyc != expect or sorted(row.tolist()) != list(range(n_rep)):
            bad += 1
            prev, expect = row, cyc + 1
            continue
        left, right = sweep(model.grid.shape, cyc)
        ri, rj = _holders(prev, left, right)
        kept = (row[ri] == left) & (row[rj] == right)
        swap = (row[ri] == right) & (row[rj] == left)
        others = np.ones(n_rep, bool)
        others[ri] = others[rj] = False
        if (not np.all(kept | swap) or int(swap.sum()) != int(accepted)
                or not np.array_equal(row[others], prev[others])):
            bad += 1
        prev, expect = row, cyc + 1
    return bad
