"""Replica ensemble state — one tuple carrying everything the driver needs.

``state`` is the engine's stacked state (leading axis R).  ``assignment``
maps replica -> ctrl index (the exchange phase permutes it).  ``debt`` and
``speed`` implement the asynchronous pattern's progress model; ``alive``
implements failure masking.  Every field is a tensor on one device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as jr


class Ensemble(NamedTuple):
    state: Any                  # engine state dict, leading axis R
    assignment: torch.Tensor    # (R,) int64: replica -> ctrl index
    rng: torch.Tensor           # (2,) int64 driver key
    cycle: torch.Tensor         # () int64
    debt: torch.Tensor          # (R,) f32: accumulated un-exchanged MD steps
    speed: torch.Tensor         # (R,) f32: relative propagation speed
    alive: torch.Tensor         # (R,) bool: active replicas
    failures: torch.Tensor      # () int64: total failures recovered
    relaunches: torch.Tensor    # (R,) int64: consecutive failure streak


def make_ensemble(engine, rng: torch.Tensor, n_replicas: int,
                  hetero_speed: bool = False) -> Ensemble:
    k_state, k_speed, k_run = jr.split(rng, 3)
    state = engine.init_state(k_state, n_replicas)
    dev = rng.device
    if hetero_speed:
        # lognormal speeds: the heterogeneous-engines scenario
        speed = torch.exp(jr.normal(k_speed, (n_replicas,)) * 0.25)
    else:
        speed = torch.ones(n_replicas, device=dev)
    return Ensemble(
        state=state,
        assignment=torch.arange(n_replicas, device=dev),
        rng=k_run,
        cycle=torch.zeros((), dtype=torch.int64, device=dev),
        debt=torch.zeros(n_replicas, device=dev),
        speed=speed,
        alive=torch.ones(n_replicas, dtype=torch.bool, device=dev),
        failures=torch.zeros((), dtype=torch.int64, device=dev),
        relaunches=torch.zeros(n_replicas, dtype=torch.int64, device=dev),
    )


def control_multiset_ok(ens: Ensemble) -> bool:
    """Invariant: assignment is always a permutation (no ctrl lost or
    duplicated).  Reads the assignment back to the host."""
    a = ens.assignment.cpu().numpy()
    return bool(np.array_equal(np.sort(a), np.arange(a.shape[0])))
