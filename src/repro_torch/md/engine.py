"""The MD engine of the port: the 'Amber' stand-in on the chain molecule.

``MDEngine`` implements the SimulationEngine protocol of the JAX
package's ``md/engine.py`` on four force paths, with umbrella and salt
controls on each, for dense or sparse bonded and nonbonded passes:

  ``"pallas"``  per-pass analytic forces: the bonded kernel
                (``kernels.chain_forces``, its bias variant when the grid
                has umbrella dimensions) and the nonbonded kernel
                (``kernels.lj_forces``) on the card, their PyTorch oracles
                on the CPU, around the pre-drawn-noise BAOAB loop;
  ``"fused"``   one launch per BAOAB iteration on the card
                (``kernels.fused_propagate``); on the CPU the fused loop of
                ``integrators.propagate_replica_major_fused`` with the
                oracles, as the JAX package runs it there;
  ``"batched"`` the oracle: ``torch.autograd.grad`` of the replica-major
                potential (``energy.batched_potential_energy``) around the
                same loop, plain PyTorch on either device;
  ``"vmap"``    the reference oracle (``batched=False``): the
                single-replica program run once per replica — whole BAOAB
                steps, the force from autograd of
                ``energy.potential_energy`` — and per-replica exchange
                energies.

``nonbonded="sparse"`` replaces the all-pairs sweep with a neighbor list
(``md/neighbors.py``) that rides the state as ``state["nlist"]``: every
force evaluation runs the skin check and the device-gated build
(``kernels.nlist_build``), then the sparse nonbonded kernel
(``kernels.lj_forces``, ``nonbonded_sparse.cu``), on both analytic
paths; the fused path then runs the fused loop around them, as the JAX
package does.  ``bonded="sparse"`` selects the slot-table bonded oracle
on the CPU; the card keeps its bonded kernel either way.  As in the JAX
package, the sparse passes need an analytic path ("pallas", "fused").

``cross_energy`` builds the (R, C) matrix of the Gibbs exchange (the
``kernels.exchange_matrix`` kernel on the card).  The list is built by
the masked dense build or the cell-list build (``nlist_build``), each a
device-gated kernel pair on the card.

``propagate(..., stack=R)``: the replica count of the ensemble when the
state is one wave of it (Mode II); the all-pairs kernels size their
per-replica split by it, so a replica's bits do not depend on its wave.

State is ``{"pos": (R, N, 3), "vel": (R, N, 3)}`` (plus ``"nlist"`` on
the sparse path) on ``engine.device``.

Two temperature-only engines complete the set: ``LJEngine``, the
Lennard-Jones fluid in a periodic box (the ``kernels.lj_forces`` fluid
kernels on the card), and ``HarmonicEngine``, replicas in a harmonic
well under the exact Ornstein-Uhlenbeck update (no kernel: the driver
overhead probe).  Their exchange reductions share ``_TOnlyFeatureAPI``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np

import torch

from repro_torch import random as jr
from repro_torch.core.engine import nb_zero_stats
from repro_torch.device import resolve_device
from repro_torch.kernels import default_use_kernel
from repro_torch.kernels.chain_forces import ops as chain_ops
from repro_torch.kernels.exchange_matrix import ops as xops
from repro_torch.kernels.fused_propagate import ops as fused_ops
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.md import energy as E
from repro_torch.md import integrators as I
from repro_torch.md import neighbors as NB
from repro_torch.md.system import (MolecularSystem, base_positions,
                                   chain_molecule, initial_positions)
from repro_torch.tree import tree_leaves

FORCE_PATHS = ("pallas", "batched", "vmap", "fused")
NONBONDED_PATHS = ("dense", "sparse")
BONDED_PATHS = ("dense", "sparse")


def _any_nonfinite(state) -> torch.Tensor:
    """(R,) bool: replica-level NaN/inf scan over every state leaf, the
    neighbor list's integer leaves included (always finite)."""
    bad = [(~torch.isfinite(x)).reshape(x.shape[0], -1).any(dim=1)
           for x in tree_leaves(state)]
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


def _autograd_force(potential, pos) -> torch.Tensor:
    """-dU/dx of a differentiable potential (summed over any replica
    axis: replicas are independent, so its gradient is the stacked
    per-replica force field)."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        (f,) = torch.autograd.grad(-potential(p).sum(), p)
    return f


class MDEngine:
    force_paths = FORCE_PATHS

    def __init__(self, system: Optional[MolecularSystem] = None,
                 dt: float = 5e-4, gamma: float = 5.0,
                 init_temperature: float = 300.0, batched: bool = True,
                 force_path: Optional[str] = None, nonbonded: str = "dense",
                 cutoff: float = 9.0, skin: float = 1.5,
                 k_max: Optional[int] = None,
                 nlist_build: Optional[str] = None,
                 cell_capacity: Optional[int] = None,
                 bonded: str = "dense",
                 nb_pair_planes: Optional[bool] = None,
                 max_energy: Optional[float] = None,
                 max_bond_stretch: Optional[float] = None,
                 device="cuda"):
        """``device``: where the state and the force passes live
        (default ``"cuda"``; raises if CUDA is missing — pass ``"cpu"``
        to run the PyTorch oracles on the CPU).

        ``force_path``: "pallas" (the default), "batched", "vmap" or
        "fused" (module docstring).  ``batched=False`` implies "vmap";
        asking for another path with it raises ``ValueError``, as do the
        sparse passes on the autograd oracles.

        ``nonbonded="sparse"``: the neighbor-list pass over the potential
        truncated at ``cutoff``, the list built to ``cutoff + skin`` and
        rebuilt on the device when an atom drifts more than ``skin / 2``.
        ``k_max`` and ``nlist_build`` default to the JAX package's
        host-side heuristics on the reference geometry, as there.
        ``cell_capacity`` caps the "cell" build's atoms per cell (default
        the JAX package's suggestion); atoms past it are dropped and
        counted in ``nb_overflow``.  ``nb_pair_planes`` carries the build-time
        parameter planes in the list (default: on the CPU only, where
        the oracle reads them; the card's kernel gathers its atom rows).
        ``bonded="sparse"``: the slot-table bonded oracle on the CPU.

        ``max_energy`` / ``max_bond_stretch``: opt-in failure detectors
        beyond the non-finite scan — kinetic energy above the threshold,
        or any bond stretched past that multiple of its rest length."""
        if not batched:
            if nonbonded == "sparse":
                raise ValueError(
                    "nonbonded='sparse' needs the batched analytic path; it "
                    "cannot run batched=False (the vmap oracle)")
            if force_path not in (None, "vmap"):
                raise ValueError(f"batched=False is the vmap oracle; it "
                                 f"cannot run force_path={force_path!r}")
            force_path = "vmap"
        elif force_path is None:
            force_path = "pallas"
        for name, value, paths in (("force_path", force_path, FORCE_PATHS),
                                   ("nonbonded", nonbonded, NONBONDED_PATHS),
                                   ("bonded", bonded, BONDED_PATHS)):
            if value not in paths:
                raise ValueError(f"{name} must be one of {paths}, got "
                                 f"{value!r}")
        for name, value in (("nonbonded", nonbonded), ("bonded", bonded)):
            if value == "sparse" and force_path not in ("pallas", "fused"):
                raise ValueError(
                    f"{name}='sparse' is an analytic-force feature; it "
                    f"cannot run force_path={force_path!r}")
        if nb_pair_planes and nonbonded != "sparse":
            raise ValueError(
                "nb_pair_planes=True needs nonbonded='sparse' (there is "
                "no neighbor list to carry the planes otherwise)")
        self.device = resolve_device(device)
        self.system = (system or chain_molecule()).to(self.device)
        self.dt = dt
        self.gamma = gamma
        self.init_temperature = init_temperature
        self.batched = batched
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
        if nonbonded == "sparse":
            self._init_sparse(cutoff, skin, k_max, nlist_build,
                              cell_capacity, nb_pair_planes)

    def _init_sparse(self, cutoff, skin, k_max, nlist_build, cell_capacity,
                     nb_pair_planes) -> None:
        """The sparse path's constants, from the JAX package's host-side
        heuristics on the reference geometry."""
        sys = self.system
        self.cutoff = float(cutoff)
        self.skin = float(skin)
        self.r_list = self.cutoff + self.skin
        if nb_pair_planes is None:
            nb_pair_planes = self.device.type != "cuda"
        self._pair_params = ((sys.lj_sigma, sys.lj_eps, sys.charges)
                             if nb_pair_planes else None)
        base = base_positions(sys)
        mask = sys.nb_mask.cpu().numpy()
        self.k_max = (NB.suggest_k_max(sys.n_atoms, base, mask, self.r_list)
                      if k_max is None else int(k_max))
        extent = base.max(0) - base.min(0) + 2.0 * self.r_list
        self._grid_dims = NB.suggest_grid_dims(extent, self.r_list)
        self._cell_capacity = (
            int(cell_capacity) if cell_capacity is not None
            else NB.suggest_cell_capacity(base, self.r_list,
                                          self._grid_dims))
        if self._cell_capacity < 1:
            raise ValueError(f"cell_capacity must be >= 1, got "
                             f"{self._cell_capacity}")
        if nlist_build is None:
            nlist_build = NB.suggest_build_method(
                sys.n_atoms, self._grid_dims, self._cell_capacity)
        if nlist_build not in ("dense", "cell"):
            raise ValueError(f"nlist_build must be 'dense' or 'cell', got "
                             f"{nlist_build!r}")
        self.nlist_build = nlist_build

    # -- neighbor-list plumbing (nonbonded="sparse") -----------------------

    def _build_nlist(self, pos, prev=None):
        return NB.build_neighbor_list(
            pos, self._nb_pack, self.r_list, self.k_max,
            method=self.nlist_build, grid_dims=self._grid_dims,
            cell_capacity=self._cell_capacity, prev=prev,
            pair_params=self._pair_params)

    def _refresh_nlist(self, pos, nlist):
        """The propagate loop's policy, ``sync=True``: one tripped
        replica rebuilds every replica's list."""
        return NB.maybe_rebuild(
            pos, nlist, self._nb_pack, self.r_list, self.skin, self.k_max,
            method=self.nlist_build, grid_dims=self._grid_dims,
            cell_capacity=self._cell_capacity, sync=True,
            pair_params=self._pair_params)

    def nb_stats(self, state):
        """Neighbor-list health, worst replica, as float32 scalars:
        ``nb_overflow`` (cumulative dropped pairs) and ``nb_rebuilds``
        (cumulative rebuilds); zeros on the dense path."""
        if self.nonbonded != "sparse":
            return nb_zero_stats(self.device)
        nl = state["nlist"]
        return {"nb_overflow": torch.amax(nl["overflow"]).to(torch.float32),
                "nb_rebuilds": torch.amax(nl["rebuilds"]).to(torch.float32)}

    # -- protocol ----------------------------------------------------------

    def init_state(self, rng: torch.Tensor, n_replicas: int):
        keys = jr.split(rng, n_replicas)                 # (R, 2)
        kpv = jr.split(keys, 2)                          # (R, 2, 2)
        pos = initial_positions(self.system, kpv[:, 0])
        vel = I.maxwell_boltzmann(kpv[:, 1], self.system.masses,
                                  self.init_temperature,
                                  (self.system.n_atoms, 3))
        state = {"pos": pos, "vel": vel}
        if self.nonbonded == "sparse":
            state["nlist"] = self._build_nlist(pos)
        return state

    def propagate(self, state, ctrl, n_steps, rngs, max_steps: int,
                  stack: Optional[int] = None):
        """``rngs``: per-replica keys (R, 2); ``max_steps``: the Python
        int bound on ``n_steps`` (the loop length); ``stack``: the
        ensemble's replica count when ``state`` is one wave of it."""
        if self.force_path == "vmap":
            return self._propagate_vmap(state, ctrl, n_steps, rngs,
                                        max_steps)
        if self.force_path == "fused":
            return self._propagate_fused(state, ctrl, n_steps, rngs,
                                         max_steps)
        if self.nonbonded == "sparse":
            return self._propagate_sparse(state, ctrl, n_steps, rngs,
                                          max_steps)
        if self.force_path == "batched":
            def force_fn(pos):
                return _autograd_force(
                    lambda p: E.batched_potential_energy(
                        p, self.system, ctrl, self._feature_quads), pos)
        else:
            force_fn = self._analytic_force_fn(ctrl, stack)
        return I.propagate_replica_major(
            state, force_fn, self.system.masses, ctrl["temperature"],
            n_steps, rngs, max_steps, self.dt, self.gamma)

    def _propagate_vmap(self, state, ctrl, n_steps, rngs, max_steps: int):
        """The reference oracle: each replica's own program, ``max_steps``
        whole BAOAB steps (step t keyed ``fold_in(rngs[r], t)``), lanes
        past their ``n_steps`` frozen."""
        sys = self.system
        out = {"pos": [], "vel": []}
        for r in range(n_steps.shape[0]):
            row = {k: v[r] for k, v in ctrl.items()}

            def force_fn(pos, row=row):
                return _autograd_force(
                    lambda p: E.potential_energy(p, sys, row), pos)

            pos, vel = state["pos"][r], state["vel"][r]
            for t in range(max_steps):
                npos, nvel = I.baoab_step(
                    pos, vel, jr.fold_in(rngs[r], t), force_fn, sys.masses,
                    row["temperature"], self.dt, self.gamma)
                active = n_steps[r] > t
                pos = torch.where(active, npos, pos)
                vel = torch.where(active, nvel, vel)
            out["pos"].append(pos)
            out["vel"].append(vel)
        return {k: torch.stack(v) for k, v in out.items()}

    def _sparse_force_aux(self, ctrl):
        """The sparse force field with its neighbor-list carry: every
        evaluation runs the skin check and the gated build, then one
        bonded pass and one O(N K) nonbonded pass.  Shared by the
        per-pass and the fused loops."""
        u_c, u_k = ctrl.get("umbrella_center"), ctrl.get("umbrella_k")
        salt = ctrl.get("salt")
        salt_scale = None if salt is None else 1.0 - 0.5 * salt
        sparse_bonded = self.bonded == "sparse"

        def force_aux(pos, nlist):
            nlist = self._refresh_nlist(pos, nlist)
            f, _ = chain_ops.bonded_forces(pos, self._pack, u_c, u_k,
                                           sparse=sparse_bonded)
            f = f + nb_ops.nonbonded_force_sparse(
                pos, self._nb_pack, nlist["idx"], nlist["valid"],
                self.cutoff, salt_scale, pair=nlist.get("pair"))
            return f, nlist

        return force_aux

    def _propagate_sparse(self, state, ctrl, n_steps, rngs, max_steps: int):
        """The per-pass sparse loop: the list rides the loop carry and
        comes back in the returned state."""
        out, nlist = I.propagate_replica_major_aux(
            {"pos": state["pos"], "vel": state["vel"]},
            self._sparse_force_aux(ctrl), state["nlist"], self.system.masses,
            ctrl["temperature"], n_steps, rngs, max_steps, self.dt,
            self.gamma)
        out["nlist"] = nlist
        return out

    def _propagate_fused(self, state, ctrl, n_steps, rngs, max_steps: int):
        """``force_path="fused"``: on the card with the dense nonbonded
        sweep, one fused-kernel launch per BAOAB iteration; otherwise
        (the CPU, or the sparse list, whose carry rides the loop) the
        fused loop around the force passes, as the JAX package runs it."""
        sys = self.system
        md_state = {"pos": state["pos"], "vel": state["vel"]}
        if self.nonbonded == "sparse":
            out, nlist = I.propagate_replica_major_fused(
                md_state, self._sparse_force_aux(ctrl), state["nlist"],
                sys.masses, ctrl["temperature"], n_steps, rngs, max_steps,
                self.dt, self.gamma)
            out["nlist"] = nlist
            return out
        if default_use_kernel(state["pos"]):
            return fused_ops.fused_propagate(
                state, self._pack, self._nb_pack, sys.masses, ctrl, n_steps,
                rngs, max_steps, self.dt, self.gamma)
        force_fn = self._analytic_force_fn(ctrl)
        out, _ = I.propagate_replica_major_fused(
            md_state, lambda pos, aux: (force_fn(pos), aux), (), sys.masses,
            ctrl["temperature"], n_steps, rngs, max_steps, self.dt,
            self.gamma)
        return out

    def _analytic_force_fn(self, ctrl, stack: Optional[int] = None):
        """One bonded pass + one nonbonded pass, hand-derived gradients.
        The umbrella and salt terms apply only when the grid carries
        them; ``stack`` as for :meth:`propagate`."""
        u_c, u_k = ctrl.get("umbrella_center"), ctrl.get("umbrella_k")
        salt = ctrl.get("salt")
        salt_scale = None if salt is None else 1.0 - 0.5 * salt

        sparse_bonded = self.bonded == "sparse"

        def force_fn(pos):
            f, _ = chain_ops.bonded_forces(pos, self._pack, u_c, u_k,
                                           sparse=sparse_bonded)
            return f + nb_ops.nonbonded_force(pos, self._nb_pack, salt_scale,
                                              stack)

        return force_fn

    def energy(self, state, ctrl):
        return self._reduce(self.replica_features(state), ctrl)

    def _reduce(self, feats, ctrl):
        """u(x; ctrl) from feature rows: the replica-major reduction, or
        on the vmap oracle one replica at a time."""
        if self.batched:
            return E.batched_reduced_energy_from_features(feats, ctrl)
        return torch.stack([E.reduced_energy_from_features(
            {k: v[r] for k, v in feats.items()},
            {k: v[r] for k, v in ctrl.items()})
            for r in range(feats["u_base"].shape[0])])

    def replica_features(self, state):
        """(R,) feature rows; on the sparse path those of the truncated
        potential, through the list the propagate loop kept fresh (one
        launch of the sparse kernel on the card); on the vmap oracle each
        replica's own features."""
        if self.nonbonded == "sparse":
            nl = state["nlist"]
            return E.sparse_features(state["pos"], self.system,
                                     self._feature_quads, self._nb_pack,
                                     nl["idx"], nl["valid"], self.cutoff,
                                     nl.get("pair"))
        if self.batched:
            return E.batched_features(state["pos"], self.system,
                                      self._feature_quads)
        rows = [E.features(p, self.system) for p in state["pos"]]
        return {k: torch.stack([f[k] for f in rows]) for k in rows[0]}

    def energy_pair(self, state, ctrl_a, ctrl_b):
        """u(x; ctrl_a), u(x; ctrl_b) from ONE feature pass."""
        return self.energy_pair_from_features(self.replica_features(state),
                                              ctrl_a, ctrl_b)

    def energy_pair_from_features(self, feats, ctrl_a, ctrl_b):
        return self._reduce(feats, ctrl_a), self._reduce(feats, ctrl_b)

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


class _TOnlyFeatureAPI:
    """Shared exchange reductions for T-only engines: u(x; ctrl) =
    beta(ctrl) * U(x), so the single feature is the bare potential.
    Subclasses provide ``replica_features(state) -> {"u": (R,)}``.  The
    Gibbs scheme's matrix is the outer product ``u[:, None] * beta[None,
    :]`` (no exchange-matrix kernel)."""

    def energy_pair(self, state, ctrl_a, ctrl_b):
        return self.energy_pair_from_features(self.replica_features(state),
                                              ctrl_a, ctrl_b)

    def energy_pair_from_features(self, feats, ctrl_a, ctrl_b):
        return ctrl_a["beta"] * feats["u"], ctrl_b["beta"] * feats["u"]

    def cross_energy(self, state, ctrl_grid):
        return self.cross_energy_from_features(self.replica_features(state),
                                               ctrl_grid)

    def cross_energy_from_features(self, feats, ctrl_grid):
        return feats["u"][:, None] * ctrl_grid["beta"][None, :]  # (R, C)


class HarmonicEngine(_TOnlyFeatureAPI):
    """Replicas in a D-dimensional harmonic well, propagated by the EXACT
    Ornstein-Uhlenbeck solution of overdamped Langevin dynamics:

        x_{t+1} = a x_t + sigma(T) xi_t,   a = exp(-gamma dt),
        sigma(T)^2 = (kB T / k_spring) (1 - a^2)

    ``n`` masked steps fold into one closed-form update (a suffix product
    of the per-step decay and the summed noise), a few launches whatever
    the step count: the overhead-characterization engine.  With T_MD ~ 0
    a cycle's time is the driver's own, and the stationary distribution
    N(0, kB T / k_spring) makes the exchange statistics analytically
    checkable.  Temperature exchange only.  ``batched=False`` runs the
    per-replica oracle (a loop over replicas, the JAX package's vmap)."""

    KB = I.KB
    ctrl_keys = ("temperature", "beta")

    def __init__(self, n_dim: int = 3, k_spring: float = 1.0,
                 dt: float = 1e-2, gamma: float = 1.0,
                 init_temperature: float = 300.0, batched: bool = True,
                 device="cuda"):
        """``device``: where the state lives (default ``"cuda"``; raises if
        CUDA is missing)."""
        self.device = resolve_device(device)
        self.n_dim = n_dim
        self.k_spring = k_spring
        self.dt = dt
        self.gamma = gamma
        self.init_temperature = init_temperature
        self.batched = batched

    def init_state(self, rng: torch.Tensor, n_replicas: int):
        std = (self.KB * self.init_temperature / self.k_spring) ** 0.5
        return {"x": jr.normal(rng, (n_replicas, self.n_dim)) * std}

    def _sigma(self, temperature, a: float):
        """The per-step noise scale sqrt(kB T / k (1 - a^2)), float32 at
        every step as JAX forms it (divisions tensor by tensor)."""
        var = self.KB * temperature / torch.full_like(temperature,
                                                      self.k_spring)
        a32 = np.float32(a)
        return torch.sqrt(var * float(np.float32(1.0) - a32 * a32))

    def propagate(self, state, ctrl, n_steps, rngs, max_steps: int,
                  stack: Optional[int] = None):
        """``rngs``: per-replica keys (R, 2); step t of replica r draws
        ``normal(fold_in(rngs[r], t), (D,))``.  ``stack`` (the Mode II
        wave's ensemble size) changes nothing here: every op is
        per-replica."""
        a = I.decay(self.gamma, self.dt)
        x = state["x"]
        ts = torch.arange(max_steps, dtype=torch.int64, device=x.device)
        sigma = self._sigma(ctrl["temperature"], a)               # (R,)
        xi = jr.normal(jr.fold_in(rngs[:, None, :], ts[None, :]),
                       (self.n_dim,))                            # (R, S, D)
        active = ts[None, :] < n_steps[:, None]                   # (R, S)
        if not self.batched:
            return {"x": torch.stack([
                self._one(x[r], sigma[r], active[r], xi[r], a)
                for r in range(x.shape[0])])}
        decay = torch.where(active, a, 1.0)
        noise = torch.where(active[..., None],
                            sigma[:, None, None] * xi, 0.0)
        # x_S = (prod_i f_i) x_0 + sum_i (prod_{j>i} f_j) g_i
        cp = torch.flip(torch.cumprod(torch.flip(decay, [1]), dim=1), [1])
        suffix = torch.cat([cp[:, 1:], torch.ones_like(cp[:, :1])], dim=1)
        return {"x": cp[:, 0:1] * x
                + torch.sum(suffix[..., None] * noise, dim=1)}

    @staticmethod
    def _one(x, sigma, active, xi, a: float):
        """One replica of the oracle: (D,) state, (S,) step mask, (S, D)
        normals."""
        decay = torch.where(active, a, 1.0)                       # (S,)
        noise = torch.where(active[:, None], sigma * xi, 0.0)
        cp = torch.flip(torch.cumprod(torch.flip(decay, [0]), dim=0), [0])
        suffix = torch.cat([cp[1:], torch.ones_like(cp[:1])])
        return cp[0] * x + torch.sum(suffix[:, None] * noise, dim=0)

    def _potential_stack(self, x):
        """(R, D) -> (R,)."""
        if self.batched:
            return 0.5 * self.k_spring * torch.sum(x * x, dim=-1)
        return torch.stack([0.5 * self.k_spring * torch.sum(xi * xi)
                            for xi in x])

    def energy(self, state, ctrl):
        return ctrl["beta"] * self._potential_stack(state["x"])

    def replica_features(self, state):
        """T-only exchange feature: the bare potential, (R,)."""
        return {"u": self._potential_stack(state["x"])}

    def is_failed(self, state):
        return _any_nonfinite(state)


class LJEngine(_TOnlyFeatureAPI):
    """Lennard-Jones fluid of argon (sigma 3.4 A, eps 0.238 kcal/mol,
    39.9 amu) in a periodic cubic box under the minimum image;
    temperature exchange only.

    ``batched=True`` (default): the force-sharing BAOAB loop over the
    whole stack, one launch of the forces kernel per force evaluation,
    positions wrapped into the box after each step.  ``batched=False``:
    the per-replica oracle, whole BAOAB steps with two force evaluations
    each, the force from ``torch.autograd.grad`` of ``LJEnergy`` (whose
    backward is the forces pass), as the JAX package takes ``jax.grad``
    through its ``custom_vjp``.

    ``use_pallas`` is kept for the JAX package's signature and selects
    nothing: as in ``MDEngine``, the kernels run exactly where the data
    lives, on the card whatever the flag says, the PyTorch oracles on the
    CPU."""

    ctrl_keys = ("temperature", "beta")

    def __init__(self, n_particles: int = 64, box: float = 12.0,
                 dt: float = 2e-3, gamma: float = 2.0,
                 use_pallas: bool = False, batched: bool = True,
                 max_energy: Optional[float] = None, device="cuda"):
        """``device``: where the state and the force passes live (default
        ``"cuda"``; raises if CUDA is missing — pass ``"cpu"`` to run the
        PyTorch oracles on the CPU).  ``max_energy``: opt-in kinetic-
        energy failure threshold beyond the non-finite scan."""
        self.device = resolve_device(device)
        self.n = n_particles
        self.box = box
        self.dt = dt
        self.gamma = gamma
        self.use_pallas = use_pallas
        self.batched = batched
        self.masses = torch.full((n_particles,), 39.9,      # argon
                                 dtype=torch.float32, device=self.device)
        self.sigma = 3.4
        self.eps = 0.238
        self.max_energy = None if max_energy is None else float(max_energy)
        self.failure_detectors = (
            ("nonfinite",)
            + (("energy",) if self.max_energy is not None else ()))

    def _potential(self, pos):
        """One configuration (N, 3) -> scalar, differentiable."""
        return nb_ops.lj_energy(pos, self.sigma, self.eps, self.box)

    def _potential_stack(self, pos):
        """Replica stack (R, N, 3) -> (R,): one launch of the energy
        kernel (batched), or one per replica (the oracle)."""
        if not self.batched:
            return torch.stack([self._potential(p) for p in pos])
        return nb_ops.fluid_energy(pos, self.sigma, self.eps, self.box)

    def init_state(self, rng: torch.Tensor, n_replicas: int):
        """A cubic lattice (the first N sites of side^3, side from the
        float32 cube root as JAX takes it) with 0.05 A jitter, velocities
        from Maxwell-Boltzmann at 120 K; keys split per replica, then
        into (position, velocity) keys."""
        keys = jr.split(rng, n_replicas)                 # (R, 2)
        kpv = jr.split(keys, 2)                          # (R, 2, 2)
        side = int(math.ceil(np.float32(self.n ** (1 / 3))))
        ar = torch.arange(side, device=self.device)
        grid = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                           -1).reshape(-1, 3)
        base = (grid[: self.n] + 0.5) * (self.box / side)
        pos = base + jr.normal(kpv[:, 0], (self.n, 3)) * 0.05
        vel = I.maxwell_boltzmann(kpv[:, 1], self.masses, 120.0,
                                  (self.n, 3))
        return {"pos": pos, "vel": vel}

    def _force_stack(self, pos, stack: Optional[int] = None):
        """Analytic forces for the stack: one launch of the forces kernel
        on the card (its split sized by ``stack``, the ensemble's replica
        count, when given), the oracle's pairwise sweep on the CPU."""
        return nb_ops.fluid_forces(pos, self.sigma, self.eps, self.box,
                                   stack)

    def propagate(self, state, ctrl, n_steps, rngs, max_steps: int,
                  stack: Optional[int] = None):
        """``rngs``: per-replica keys (R, 2); ``max_steps``: the Python
        int bound on ``n_steps`` (the loop length); ``stack``: the
        ensemble's replica count when ``state`` is one wave of it."""
        if not self.batched:
            return self._propagate_vmap(state, ctrl, n_steps, rngs,
                                        max_steps)
        # The shared force is evaluated at the wrapped positions; the
        # oracle evaluates its trailing half-B at the pre-wrap positions,
        # which agrees up to fp rounding (the minimum-image force is
        # wrap-invariant).
        return I.propagate_replica_major(
            state, lambda pos: self._force_stack(pos, stack), self.masses,
            ctrl["temperature"], n_steps, rngs, max_steps, self.dt,
            self.gamma, box=self.box)

    def _autograd_force(self, pos):
        """-dU/dx of the stack through ``LJEnergy``'s backward (the forces
        pass): bitwise the forces pass itself."""
        return _autograd_force(
            lambda p: nb_ops.LJEnergy.apply(p, self.sigma, self.eps,
                                            self.box), pos)

    def _propagate_vmap(self, state, ctrl, n_steps, rngs, max_steps: int):
        """The reference oracle: ``max_steps`` whole BAOAB steps per
        replica (step t keyed ``fold_in(rngs[r], t)``), each wrapped into
        the box, lanes past their ``n_steps`` frozen."""
        pos, vel = state["pos"], state["vel"]
        temp = ctrl["temperature"]
        for t in range(max_steps):
            npos, nvel = I.baoab_step(pos, vel, jr.fold_in(rngs, t),
                                      self._autograd_force, self.masses,
                                      temp, self.dt, self.gamma)
            npos = torch.remainder(npos, self.box)
            active = (n_steps > t)[:, None, None]
            pos = torch.where(active, npos, pos)
            vel = torch.where(active, nvel, vel)
        return {"pos": pos, "vel": vel}

    def energy(self, state, ctrl):
        return ctrl["beta"] * self._potential_stack(state["pos"])

    def replica_features(self, state):
        """T-only exchange feature: the bare potential, (R,) — one
        O(N^2) evaluation serves both exchange assignments."""
        return {"u": self._potential_stack(state["pos"])}

    def is_failed(self, state):
        bad = _any_nonfinite(state)
        if self.max_energy is not None:
            ke = _kinetic_energy(state["vel"], self.masses)
            bad = bad | (ke > self.max_energy)
        return bad
