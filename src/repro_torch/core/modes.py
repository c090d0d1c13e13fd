"""Execution Modes — how replicas map onto the device.

  Mode I  (R <= slots): all replicas propagate concurrently, in one
          engine call on the replica stack.
  Mode II (R > slots):  replicas time-multiplexed in waves (not ported
          yet).

Keys are replica-indexed (``per_replica_keys``), so every mode consumes
the same per-replica noise streams.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import random as jr


def per_replica_keys(rng: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """Replica-indexed key assignment: (2,) -> (R, 2)."""
    return jr.split(rng, n_replicas)


def propagate_mode1(engine, state, ctrl, n_steps, rng, *, max_steps: int):
    """Mode I: all replicas in ``state`` propagate in one engine call.
    Per-replica: nothing crosses replica rows."""
    keys = per_replica_keys(rng, n_steps.shape[0])
    return engine.propagate(state, ctrl, n_steps, keys, max_steps=max_steps)


def auto_mode(n_replicas: int, slots: int) -> Dict[str, Any]:
    """Pick the execution mode from the replica count vs the slots:
    ``ceil(R / slots)`` waves (clamped to [1, R]) when R exceeds them."""
    if slots <= 0 or n_replicas <= slots:
        return {"mode": "mode1", "n_waves": 1}
    n_waves = min(max(-(-n_replicas // slots), 1), n_replicas)
    return {"mode": "mode2", "n_waves": n_waves}
