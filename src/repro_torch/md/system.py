"""Toy molecular systems: the alanine-dipeptide-class chain molecule.

``chain_molecule(n)`` builds the same chain as the JAX package: harmonic
bonds and angles, periodic torsions (two designated phi/psi dihedrals for
the umbrella dimensions), LJ + Coulomb nonbonded with 1-2/1-3 exclusions.
The atom count is free, so the paper's 2 881-atom solvated system is
emulated by ``chain_molecule(2881)``.  Topology is built host-side with
numpy on the CPU; ``to(device)`` moves the tensors.

Units: AKMA-ish — kcal/mol, Angstrom, ps, amu.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch import random as jr


@dataclass(frozen=True)
class MolecularSystem:
    n_atoms: int
    masses: torch.Tensor            # (N,) f32
    bonds: torch.Tensor             # (B, 2) int64
    bond_r0: torch.Tensor           # (B,)
    bond_k: torch.Tensor            # (B,)
    angles: torch.Tensor            # (A, 3) int64
    angle_t0: torch.Tensor          # (A,) radians
    angle_k: torch.Tensor           # (A,)
    dihedrals: torch.Tensor         # (D, 4) int64
    dihedral_n: torch.Tensor        # (D,) periodicity
    dihedral_k: torch.Tensor        # (D,)
    dihedral_phase: torch.Tensor    # (D,)
    charges: torch.Tensor           # (N,)
    lj_sigma: torch.Tensor          # (N,)
    lj_eps: torch.Tensor            # (N,)
    nb_mask: torch.Tensor           # (N, N) 1.0 where the pair interacts
    phi_quad: Tuple[int, int, int, int] = (1, 2, 3, 4)
    psi_quad: Tuple[int, int, int, int] = (3, 4, 5, 6)

    def to(self, device) -> "MolecularSystem":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


def chain_molecule(n_atoms: int = 22) -> MolecularSystem:
    if n_atoms < 8:
        raise ValueError("need at least 8 atoms for phi/psi torsions")
    bonds = np.stack([np.arange(n_atoms - 1), np.arange(1, n_atoms)], 1)
    bond_r0 = np.full(len(bonds), 1.5)
    bond_k = np.full(len(bonds), 300.0)

    angles = np.stack([np.arange(n_atoms - 2), np.arange(1, n_atoms - 1),
                       np.arange(2, n_atoms)], 1)
    angle_t0 = np.full(len(angles), np.deg2rad(109.5))
    angle_k = np.full(len(angles), 50.0)

    quads = np.stack([np.arange(n_atoms - 3), np.arange(1, n_atoms - 2),
                      np.arange(2, n_atoms - 1), np.arange(3, n_atoms)], 1)
    dihedral_n = np.full(len(quads), 3.0)
    dihedral_k = np.full(len(quads), 0.8)
    dihedral_phase = np.zeros(len(quads))
    # give the phi/psi torsions a 2-fold double-well term (Ramachandran-ish)
    for i, quad in enumerate(quads):
        if tuple(quad) in ((1, 2, 3, 4), (3, 4, 5, 6)):
            dihedral_n[i] = 2.0
            dihedral_k[i] = 1.5

    charges = np.where(np.arange(n_atoms) % 2 == 0, 0.30, -0.30)
    charges -= charges.mean()
    lj_sigma = np.full(n_atoms, 3.0)
    lj_eps = np.full(n_atoms, 0.10)

    # nonbonded exclusions: self, 1-2, 1-3
    mask = 1.0 - np.eye(n_atoms)
    mask[bonds[:, 0], bonds[:, 1]] = mask[bonds[:, 1], bonds[:, 0]] = 0.0
    mask[angles[:, 0], angles[:, 2]] = mask[angles[:, 2], angles[:, 0]] = 0.0

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64))

    return MolecularSystem(
        n_atoms=n_atoms, masses=f32(np.full(n_atoms, 12.0)),
        bonds=i64(bonds), bond_r0=f32(bond_r0), bond_k=f32(bond_k),
        angles=i64(angles), angle_t0=f32(angle_t0), angle_k=f32(angle_k),
        dihedrals=i64(quads), dihedral_n=f32(dihedral_n),
        dihedral_k=f32(dihedral_k), dihedral_phase=f32(dihedral_phase),
        charges=f32(charges), lj_sigma=f32(lj_sigma), lj_eps=f32(lj_eps),
        nb_mask=f32(mask),
    )


def base_positions(system: MolecularSystem) -> np.ndarray:
    """The deterministic extended-chain geometry (host numpy)."""
    n = system.n_atoms
    base = np.zeros((n, 3), np.float32)
    base[:, 0] = np.arange(n) * 1.45
    base[:, 1] = (np.arange(n) % 2) * 0.6
    return base


def initial_positions(system: MolecularSystem, keys: torch.Tensor,
                      jitter: float = 0.1) -> torch.Tensor:
    """Extended-chain start + small jitter: (..., 2) keys -> (..., N, 3)."""
    noise = jr.normal(keys, (system.n_atoms, 3)) * jitter
    base = torch.as_tensor(base_positions(system), device=keys.device)
    return base + noise
