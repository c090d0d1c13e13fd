"""The MD engine of the port: the 'Amber' stand-in on the chain molecule.

``MDEngine`` implements the SimulationEngine protocol of the JAX
package's ``md/engine.py`` for dense bonded and dense nonbonded passes
on two force paths, with umbrella and salt controls on both:

  ``"pallas"``  per-pass analytic forces: the bonded kernel
                (``kernels.chain_forces``, its bias variant when the grid
                has umbrella dimensions) and the nonbonded kernel
                (``kernels.lj_forces``) on the card, their PyTorch oracles
                on the CPU, around the pre-drawn-noise BAOAB loop;
  ``"fused"``   one launch per BAOAB iteration on the card
                (``kernels.fused_propagate``); on the CPU the fused loop of
                ``integrators.propagate_replica_major_fused`` with the
                oracles, as the JAX package runs it there.

``cross_energy`` builds the (R, C) matrix of the Gibbs exchange (the
``kernels.exchange_matrix`` kernel on the card).  The other force paths
and the sparse passes are not ported yet; asking for them raises.

State is ``{"pos": (R, N, 3), "vel": (R, N, 3)}`` on ``engine.device``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.kernels import default_use_kernel
from repro_torch.kernels.chain_forces import ops as chain_ops
from repro_torch.kernels.exchange_matrix import ops as xops
from repro_torch.kernels.fused_propagate import ops as fused_ops
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.md import energy as E
from repro_torch.md import integrators as I
from repro_torch.md.system import (MolecularSystem, chain_molecule,
                                   initial_positions)

FORCE_PATHS = ("pallas", "fused")
NONBONDED_PATHS = ("dense",)
BONDED_PATHS = ("dense",)


def _any_nonfinite(state) -> torch.Tensor:
    """(R,) bool: replica-level NaN/inf scan over every state leaf."""
    bad = [(~torch.isfinite(x)).flatten(1).any(dim=1)
           for x in state.values()]
    return functools.reduce(torch.logical_or, bad)


def _kinetic_energy(vel, masses) -> torch.Tensor:
    """(R, N, 3) velocities -> (R,) kinetic energy (the divergence
    detector keys on it: a blow-up shows as a velocity spike first)."""
    return 0.5 * torch.sum(masses[None, :, None] * vel * vel, dim=(1, 2))


def _bond_overstretch(pos, bonds, r0, max_stretch: float) -> torch.Tensor:
    """(R,) bool: any bond stretched past ``max_stretch`` x r0."""
    ri = pos[:, bonds[:, 0]]
    rj = pos[:, bonds[:, 1]]
    r = torch.sqrt(torch.sum((ri - rj) ** 2, dim=-1))
    return torch.any(r > max_stretch * r0[None, :], dim=1)


class MDEngine:
    force_paths = FORCE_PATHS
    batched = True

    def __init__(self, system: Optional[MolecularSystem] = None,
                 dt: float = 5e-4, gamma: float = 5.0,
                 init_temperature: float = 300.0,
                 force_path: str = "pallas", nonbonded: str = "dense",
                 bonded: str = "dense",
                 max_energy: Optional[float] = None,
                 max_bond_stretch: Optional[float] = None,
                 device="cuda"):
        """``device``: where the state and the force passes live
        (default ``"cuda"``; raises if CUDA is missing — pass ``"cpu"``
        to run the PyTorch oracles on the CPU).

        ``max_energy`` / ``max_bond_stretch``: opt-in failure detectors
        beyond the non-finite scan — kinetic energy above the threshold,
        or any bond stretched past that multiple of its rest length."""
        for name, value, paths in (("force_path", force_path, FORCE_PATHS),
                                   ("nonbonded", nonbonded, NONBONDED_PATHS),
                                   ("bonded", bonded, BONDED_PATHS)):
            if value not in paths:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet (ported: {paths})")
        self.device = resolve_device(device)
        self.system = (system or chain_molecule()).to(self.device)
        self.dt = dt
        self.gamma = gamma
        self.init_temperature = init_temperature
        self.force_path = force_path
        self.nonbonded = nonbonded
        self.bonded = bonded
        self.max_energy = None if max_energy is None else float(max_energy)
        self.max_bond_stretch = (None if max_bond_stretch is None
                                 else float(max_bond_stretch))
        self.failure_detectors = (
            ("nonfinite",)
            + (("energy",) if self.max_energy is not None else ())
            + (("bond",) if self.max_bond_stretch is not None else ()))
        self._pack = chain_ops.build_pack(self.system)
        self._nb_pack = nb_ops.build_pack(self.system)
        self._feature_quads = E.feature_quads(self.system)

    # -- protocol ----------------------------------------------------------

    def init_state(self, rng: torch.Tensor, n_replicas: int):
        keys = jr.split(rng, n_replicas)                 # (R, 2)
        kpv = jr.split(keys, 2)                          # (R, 2, 2)
        pos = initial_positions(self.system, kpv[:, 0])
        vel = I.maxwell_boltzmann(kpv[:, 1], self.system.masses,
                                  self.init_temperature,
                                  (self.system.n_atoms, 3))
        return {"pos": pos, "vel": vel}

    def propagate(self, state, ctrl, n_steps, rngs, max_steps: int):
        """``rngs``: per-replica keys (R, 2); ``max_steps``: the Python
        int bound on ``n_steps`` (the loop length)."""
        if self.force_path == "fused":
            return self._propagate_fused(state, ctrl, n_steps, rngs,
                                         max_steps)
        return I.propagate_replica_major(
            state, self._analytic_force_fn(ctrl), self.system.masses,
            ctrl["temperature"], n_steps, rngs, max_steps, self.dt,
            self.gamma)

    def _propagate_fused(self, state, ctrl, n_steps, rngs, max_steps: int):
        """``force_path="fused"``: on the card one fused-kernel launch per
        BAOAB iteration; on the CPU the fused loop around the oracles."""
        sys = self.system
        if default_use_kernel(state["pos"]):
            return fused_ops.fused_propagate(
                state, self._pack, self._nb_pack, sys.masses, ctrl, n_steps,
                rngs, max_steps, self.dt, self.gamma)
        return I.propagate_replica_major_fused(
            state, self._analytic_force_fn(ctrl), sys.masses,
            ctrl["temperature"], n_steps, rngs, max_steps, self.dt,
            self.gamma)

    def _analytic_force_fn(self, ctrl):
        """One bonded pass + one nonbonded pass, hand-derived gradients.
        The umbrella and salt terms apply only when the grid carries
        them."""
        u_c, u_k = ctrl.get("umbrella_center"), ctrl.get("umbrella_k")
        salt = ctrl.get("salt")
        salt_scale = None if salt is None else 1.0 - 0.5 * salt

        def force_fn(pos):
            f, _ = chain_ops.bonded_forces(pos, self._pack, u_c, u_k)
            return f + nb_ops.nonbonded_force(pos, self._nb_pack, salt_scale)

        return force_fn

    def energy(self, state, ctrl):
        return E.batched_reduced_energy_from_features(
            self.replica_features(state), ctrl)

    def replica_features(self, state):
        return E.batched_features(state["pos"], self.system,
                                  self._feature_quads)

    def energy_pair(self, state, ctrl_a, ctrl_b):
        """u(x; ctrl_a), u(x; ctrl_b) from ONE feature pass."""
        return self.energy_pair_from_features(self.replica_features(state),
                                              ctrl_a, ctrl_b)

    def energy_pair_from_features(self, feats, ctrl_a, ctrl_b):
        return (E.batched_reduced_energy_from_features(feats, ctrl_a),
                E.batched_reduced_energy_from_features(feats, ctrl_b))

    def cross_energy(self, state, ctrl_grid):
        """(R, C) matrix u_c(x_i): one feature pass, then the matrix."""
        return self.cross_energy_from_features(self.replica_features(state),
                                               ctrl_grid)

    def cross_energy_from_features(self, feats, ctrl_grid):
        """Feature rows -> (R, C): the exchange-matrix kernel on the card,
        its oracle on the CPU."""
        return xops.exchange_matrix(feats, ctrl_grid)

    def is_failed(self, state):
        bad = _any_nonfinite(state)
        if self.max_energy is not None:
            ke = _kinetic_energy(state["vel"], self.system.masses)
            bad = bad | (ke > self.max_energy)
        if self.max_bond_stretch is not None:
            bad = bad | _bond_overstretch(state["pos"], self.system.bonds,
                                          self.system.bond_r0,
                                          self.max_bond_stretch)
        return bad
