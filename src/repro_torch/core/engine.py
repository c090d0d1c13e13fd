"""The engine protocol — the boundary between the RE algorithm (exchange
math, ladder bookkeeping, fault handling) and the engines.

An engine provides ``init_state(rng, n_replicas)``, ``propagate(state,
ctrl, n_steps, rngs, max_steps, stack=None)``, ``energy(state, ctrl)``,
``cross_energy(state, ctrl)`` and ``is_failed(state)`` (the
:class:`SimulationEngine` protocol), each stacked over replicas (leading
axis R) on the engine's device; ``max_steps`` is a Python int so that
the step loop needs no host read, and ``stack`` is the ensemble's
replica count when the state is one Mode II wave of it (kernels whose
sums are split by the replica count size the split by it, so a
replica's bits do not depend on its wave).  Optional extensions
(``energy_pair``, the split feature API, ``force_paths``,
``failure_detectors``, a ``donate`` keyword of ``propagate``) are
duck-typed and reported by :func:`engine_capabilities`.  An engine
whose ``propagate`` takes ``donate`` may, when handed ``donate=True``,
write the new state into the one it is given; the driver hands it only
when nothing reads the pre-cycle state afterwards.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Protocol, runtime_checkable

import torch

Ctrl = Dict[str, torch.Tensor]   # control parameters, each (R, ...)
StateStack = Any                 # tree of tensors with leading replica axis


@runtime_checkable
class SimulationEngine(Protocol):
    """The contract every pluggable simulation engine implements: the
    paper's engine-agnosticism boundary.  The driver reaches the engine
    through these five methods only; the optional extensions of the
    module docstring are duck-typed (:func:`engine_capabilities`), so a
    minimal engine stays minimal.  ``isinstance(engine,
    SimulationEngine)`` checks that the methods exist."""

    def init_state(self, rng: torch.Tensor, n_replicas: int) -> StateStack:
        """Stacked initial states for R replicas from one raw key."""
        ...

    def propagate(self, state: StateStack, ctrl: Ctrl,
                  n_steps: torch.Tensor, rngs: torch.Tensor,
                  max_steps: int, stack: Optional[int] = None
                  ) -> StateStack:
        """The MD phase: advance replica i ``n_steps[i]`` steps under its
        ctrl row, with its own key ``rngs[i]``.  ``max_steps`` (a Python
        int) bounds the step loop; a replica with fewer steps keeps its
        trailing iterations masked.  ``stack``: the ensemble's replica
        count when ``state`` is a block of it."""
        ...

    def energy(self, state: StateStack, ctrl: Ctrl) -> torch.Tensor:
        """Reduced (dimensionless) energy u_i(x_i) per replica: (R,)."""
        ...

    def cross_energy(self, state: StateStack, ctrl: Ctrl) -> torch.Tensor:
        """The (R, C) matrix u_j(x_i): row i the state of replica i,
        column j ctrl row j (the Gibbs scheme's single-point energies)."""
        ...

    def is_failed(self, state: StateStack) -> torch.Tensor:
        """(R,) bool replica-level failure flags; non-finite state at
        least (``failure_detectors`` names what an engine checks)."""
        ...


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
