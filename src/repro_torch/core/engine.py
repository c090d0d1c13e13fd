"""The engine protocol — the boundary between the RE algorithm (exchange
math, ladder bookkeeping, fault handling) and the engines.

An engine provides ``init_state(rng, n_replicas)``, ``propagate(state,
ctrl, n_steps, rngs, max_steps)``, ``energy(state, ctrl)`` and
``is_failed(state)``, each stacked over replicas (leading axis R) on the
engine's device; ``max_steps`` is a Python int so that the step loop
needs no host read.  Optional extensions (``energy_pair``, the split
feature API, ``force_paths``, ``failure_detectors``) are duck-typed and
reported by :func:`engine_capabilities`.
"""
from __future__ import annotations

from typing import Any, Dict


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
    }
