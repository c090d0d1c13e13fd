"""Execution Modes — how replicas map onto the device.

  Mode I  (R <= slots): all replicas propagate concurrently, in one
          engine call on the replica stack.
  Mode II (R > slots):  replicas are time-multiplexed in waves of
          ``W = ceil(R / n_waves)``, one engine call per wave in a host
          loop over the static ``n_waves`` (the pilot executing a task
          queue in batches; the JAX package's ``lax.map``).

Both modes wrap the SAME engine call, and keys are replica-indexed
(``per_replica_keys``), so every mode consumes the same per-replica
noise streams.  Each wave is told the ensemble's replica count
(``stack=R``), from which the all-pairs kernels size their per-replica
split: a replica's output bits do not depend on its wave.

Under ``run_sharded`` both modes run on one rank's block of replicas:
the caller computes the ctrl rows, step counts and keys at full (R,)
size, cuts them to the block with :func:`shard_rows`, and passes the
keys (``keys=``) and the ensemble's count (``stack=R``), so a replica's
inputs and bits are those of the unsharded run.  Mode II's waves then
run within the block: the mesh is the spatial resource dimension, the
waves the temporal one.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import random as jr
from repro_torch import sharding
from repro_torch.tree import tree_map


def per_replica_keys(rng: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """Replica-indexed key assignment: (2,) -> (R, 2)."""
    return jr.split(rng, n_replicas)


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous block of ``R // n_shards`` rows of a
    per-replica array computed at full (R, ...) size."""
    return x[sharding.block_slice(mesh, x.shape[0])]


def _donated(donate: bool) -> Dict[str, Any]:
    """The ``donate`` keyword for ``engine.propagate``: passed only when
    set, so engines without it are called as before."""
    return {"donate": True} if donate else {}


def propagate_mode1(engine, state, ctrl, n_steps, rng=None, *,
                    max_steps: int, keys=None, stack=None,
                    donate: bool = False):
    """Mode I: all replicas in ``state`` propagate in one engine call.
    Per-replica: nothing crosses replica rows.  ``keys``: the per-replica
    keys (else derived from ``rng``); ``stack``: the ensemble's replica
    count when ``state`` is a block of it; ``donate``: the engine may
    write into ``state`` (see ``core/engine.py``)."""
    if keys is None:
        keys = per_replica_keys(rng, n_steps.shape[0])
    return engine.propagate(state, ctrl, n_steps, keys, max_steps=max_steps,
                            stack=stack, **_donated(donate))


def propagate_mode2(engine, state, ctrl, n_steps, rng=None, n_waves: int = 1,
                    *, max_steps: int, keys=None, stack=None,
                    donate: bool = False):
    """Mode II: ``n_waves`` sequential engine calls of ``W = ceil(R /
    n_waves)`` replicas each.  Waves never exchange data.  When
    ``n_waves`` does not divide R the last wave is padded with copies of
    replica 0 (state, ctrl row and key) at ``n_steps = 0``: every engine
    keeps a zero-step lane bitwise frozen, and the pad rows are dropped.
    ``keys`` / ``stack`` / ``donate`` as for :func:`propagate_mode1`
    (``stack`` defaults to the rows of ``state``)."""
    r = n_steps.shape[0]
    w = -(-r // n_waves)
    pad = n_waves * w - r
    if keys is None:
        keys = per_replica_keys(rng, r)

    def pad_rep(x):
        if pad == 0 or x.ndim < 1 or x.shape[0] != r:
            return x
        return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])

    state_p = tree_map(pad_rep, state)
    ctrl_p = tree_map(pad_rep, ctrl)
    steps_p = torch.cat([n_steps, n_steps.new_zeros(pad)]) if pad else n_steps
    keys_p = pad_rep(keys)
    outs = []
    for i in range(n_waves):
        def rows(x, i=i):
            return x[i * w:(i + 1) * w]
        outs.append(engine.propagate(
            tree_map(rows, state_p), tree_map(rows, ctrl_p), rows(steps_p),
            rows(keys_p), max_steps=max_steps, stack=stack or r,
            **_donated(donate)))
    return tree_map(lambda *xs: torch.cat(xs)[:r], *outs)


def auto_mode(n_replicas: int, slots: int) -> Dict[str, Any]:
    """Pick the execution mode from the replica count vs the slots:
    ``ceil(R / slots)`` waves (clamped to [1, R]) when R exceeds them."""
    if slots <= 0 or n_replicas <= slots:
        return {"mode": "mode1", "n_waves": 1}
    n_waves = min(max(-(-n_replicas // slots), 1), n_replicas)
    return {"mode": "mode2", "n_waves": n_waves}
