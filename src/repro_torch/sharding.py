"""Replica-sharded REMD placement and its wire (``REMDDriver.run_sharded``).

The port of the replica part of the JAX package's ``sharding.py``.  The
ensemble has two placement classes on a replica mesh
(``repro_torch.launch.mesh``):

  * the engine state (positions, velocities, neighbor lists; leading
    axis R): each rank holds its contiguous block of ``B = R / n_shards``
    rows, and rows cross ranks only at the tier-2 reinit hop of one
    boundary backup row, at checkpoints and at the end of a run;
  * the control plane (assignment, rng, cycle, debt, speed, alive,
    failures, relaunches): (R,)-small or scalar, held in full on every
    rank and computed identically there.

The collectives are ``torch.distributed`` calls on the mesh's group:
``ring_all_gather`` (the counterpart of JAX's ladder-ring ``ppermute``
hops, built from ``batch_isend_irecv``), ``all_gather_rows`` and
``all_reduce_max``.  Each records its op, its shape and its bytes in
the active :class:`WireCensus` (``wire_census``): the driver opens one
per chunk, and its per-op totals are the wire ledger of the telemetry,
the torch form of the JAX package's HLO collective census.  Op names are
the HLO ones (``collective-permute``, ``all-gather``, ``all-reduce``),
so the two packages' ledgers read alike; here a chunk's census counts
the collectives it issued (K cycles' worth), where the HLO census counts
the instructions of the compiled chunk.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.ensemble import Ensemble
from repro_torch.tree import tree_map

# dist.all_gather_single replaces all_gather_into_tensor in newer releases
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class WireCensus:
    """The collectives issued while the census is open: one entry per
    collective, ``(op, shape, bytes)`` with the bytes one rank puts on
    the wire (a ring hop's block, an all-gather's output, an all-reduce's
    tensor)."""

    def __init__(self):
        self.calls: List[Tuple[str, tuple, int]] = []

    def budget(self) -> Dict[str, Dict[str, int]]:
        """``{op: {"count": n, "bytes": total}}``, the ledger's form."""
        out: Dict[str, Dict[str, int]] = {}
        for op, _, nbytes in self.calls:
            b = out.setdefault(op, {"count": 0, "bytes": 0})
            b["count"] += 1
            b["bytes"] += nbytes
        return out


# the census open now (``wire_census``), else None
_CENSUS: contextvars.ContextVar = contextvars.ContextVar("census",
                                                         default=None)


@contextlib.contextmanager
def wire_census():
    """Record every collective issued inside the block."""
    census = WireCensus()
    token = _CENSUS.set(census)
    try:
        yield census
    finally:
        _CENSUS.reset(token)


def _note(op: str, t: torch.Tensor) -> None:
    census = _CENSUS.get()
    if census is not None:
        census.calls.append((op, tuple(t.shape),
                             t.numel() * t.element_size()))


# --- collectives -------------------------------------------------------------


def ring_shift(x: torch.Tensor, mesh, reverse: bool = False) -> torch.Tensor:
    """One hop of the ladder ring: each shard sends ``x`` to its upper
    neighbor (``reverse``: its lower one) and returns the block it
    received from the other side.  Identity on one shard."""
    n = mesh.n_shards
    if n == 1:
        return x
    step = -1 if reverse else 1
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (mesh.rank + step) % n, mesh.group),
           dist.P2POp(dist.irecv, recv, (mesh.rank - step) % n, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _note("collective-permute", send)
    return recv


def ring_all_gather(x: torch.Tensor, mesh,
                    reverse: bool = False) -> torch.Tensor:
    """Every shard's block, stacked in global shard order, from
    ``n_shards - 1`` ladder-ring hops and no all-gather: returns
    ``(n_shards,) + x.shape`` (``x[None]`` on one shard), so
    ``out.reshape(-1, ...)`` is the full replica-ordered row, bitwise: the
    blocks are copied, never reduced.  Each hop carries one block."""
    n = mesh.n_shards
    if n == 1:
        return x[None]
    blocks = [None] * n
    blocks[mesh.rank] = x
    blk = x
    step = 1 if reverse else -1
    for t in range(1, n):
        blk = ring_shift(blk, mesh, reverse)
        # after t hops the block in hand started t shards back
        blocks[(mesh.rank + step * t) % n] = blk
    return torch.stack(blocks)


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The shards' (B, ...) blocks concatenated in shard order, (R, ...)."""
    src = x.contiguous()
    out = torch.empty((mesh.n_shards * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_flat(out, src, group=mesh.group)
    _note("all-gather", out)
    return out


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise max over the shards (exact in any order)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    _note("all-reduce", out)
    return out


# --- engine calls on a block -------------------------------------------------

# (mesh, R) of the engine call on one rank's block running now
_ENSEMBLE: contextvars.ContextVar = contextvars.ContextVar(
    "ensemble", default=None)


@contextlib.contextmanager
def ensemble_scope(mesh, n_replicas: int):
    """Mark an engine call on one rank's block of an ensemble of
    ``n_replicas`` on ``mesh``.  Inside it a kernel that sizes its
    per-replica split by the stack sizes it by the ensemble
    (:func:`ensemble_rows`), and a decision the engine takes for the
    whole stack (the neighbor list's collective rebuild) is taken for the
    whole ensemble (:func:`ensemble_any`): a replica's bits are then
    those of the unsharded call."""
    token = _ENSEMBLE.set((mesh, n_replicas))
    try:
        yield
    finally:
        _ENSEMBLE.reset(token)


def ensemble_rows():
    """The ensemble's replica count inside :func:`ensemble_scope`, else
    None."""
    scope = _ENSEMBLE.get()
    return None if scope is None else scope[1]


def ensemble_any(flag: torch.Tensor) -> torch.Tensor:
    """``flag`` (a bool tensor, the stack's own ``any``) or-ed over the
    ranks of the mesh in scope; unchanged outside a sharded call."""
    scope = _ENSEMBLE.get()
    if scope is None:
        return flag
    return all_reduce_max(flag.to(torch.uint8), scope[0]).to(torch.bool)


# --- placement ---------------------------------------------------------------


def block_slice(mesh, n_replicas: int) -> slice:
    """This rank's rows ``[rank * B, (rank + 1) * B)``."""
    b = n_replicas // mesh.n_shards
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def ensemble_shardings(mesh, ens: Ensemble) -> Ensemble:
    """Which rows this rank holds, as an ``Ensemble`` of specs: each state
    leaf the slice of its block, each control-plane field None (held in
    full).  ``load_checkpoint(..., shardings=)`` takes the same specs."""
    rows = block_slice(mesh, ens.assignment.shape[0])
    return Ensemble(state=tree_map(lambda _: rows, ens.state),
                    **{f: None for f in Ensemble._fields if f != "state"})


def shard_state(state, mesh, n_replicas: int):
    """This rank's block of a state tree: full (R, ...) leaves are sliced,
    block (B, ...) leaves kept as they are."""
    rows = block_slice(mesh, n_replicas)
    b = rows.stop - rows.start

    def one(x):
        if x.shape[0] == n_replicas:
            return x[rows]
        if x.shape[0] == b:
            return x
        raise ValueError(f"a state leaf of {x.shape[0]} rows is neither "
                         f"the ensemble's {n_replicas} nor a block of {b}")
    return tree_map(one, state)


def shard_ensemble(ens: Ensemble, mesh) -> Ensemble:
    """The ensemble with its state cut to this rank's block (the control
    plane stays whole)."""
    return ens._replace(state=shard_state(ens.state, mesh,
                                          ens.assignment.shape[0]))


def gather_state(state, mesh):
    """The whole state from the shards' blocks (every rank gets it)."""
    if mesh.n_shards == 1:
        return state
    return tree_map(lambda x: all_gather_rows(x, mesh), state)


def gather_ensemble(ens: Ensemble, mesh) -> Ensemble:
    """Inverse of :func:`shard_ensemble`, on every rank."""
    return ens._replace(state=gather_state(ens.state, mesh))
