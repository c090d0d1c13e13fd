"""The engine protocol — the boundary between the RE algorithm (exchange
math, ladder bookkeeping, fault handling) and the engines.

An engine provides ``init_state(rng, n_replicas)``, ``propagate(state,
ctrl, n_steps, rngs, max_steps, stack=None)``, ``energy(state, ctrl)``
and ``is_failed(state)``, each stacked over replicas (leading axis R) on
the engine's device; ``max_steps`` is a Python int so that the step loop
needs no host read, and ``stack`` is the ensemble's replica count when
the state is one Mode II wave of it (kernels whose sums are split by the
replica count size the split by it, so a replica's bits do not depend on
its wave).  Optional extensions (``energy_pair``, the split
feature API, ``force_paths``, ``failure_detectors``, a ``donate``
keyword of ``propagate``) are duck-typed and reported by
:func:`engine_capabilities`.  An engine whose ``propagate`` takes
``donate`` may, when handed ``donate=True``, write the new state into
the one it is given; the driver hands it only when nothing reads the
pre-cycle state afterwards.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

import torch

# The neighbor-list health extension (``nb_stats``) reports these keys,
# always and with one shape; the dense engines' zeros, the cycle stats and
# the driver's stats row all derive from this one definition.
NB_STAT_KEYS = ("nb_overflow", "nb_rebuilds")


def nb_zero_stats(device) -> Dict[str, torch.Tensor]:
    """The all-zero ``nb_stats`` (float32 scalars on ``device``)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {k: z for k in NB_STAT_KEYS}


def engine_capabilities(engine) -> Dict[str, Any]:
    """Feature-detect the optional engine extensions (duck-typed, as the
    driver and the exchange dispatch on them)."""
    keys = getattr(engine, "ctrl_keys", None)
    paths = getattr(engine, "force_paths", None)
    return {
        "energy_pair": callable(getattr(engine, "energy_pair", None)),
        "replica_features": callable(
            getattr(engine, "replica_features", None)),
        "energy_pair_from_features": callable(
            getattr(engine, "energy_pair_from_features", None)),
        "cross_energy_from_features": callable(
            getattr(engine, "cross_energy_from_features", None)),
        "ctrl_keys": tuple(keys) if keys is not None else None,
        "force_path": getattr(engine, "force_path", None),
        "force_paths": tuple(paths) if paths is not None else None,
        "batched": bool(getattr(engine, "batched", False)),
        "nonbonded": getattr(engine, "nonbonded", None),
        "nb_stats": callable(getattr(engine, "nb_stats", None)),
        "failure_detectors": tuple(
            getattr(engine, "failure_detectors", ("nonfinite",))),
        "donate": "donate" in inspect.signature(
            engine.propagate).parameters,
    }
