"""The system of kind ``chain``: a chain molecule built from a
configuration file's numbers.

The configuration states every force-field constant (``system`` block);
``build`` turns them into the topology as host arrays, which the harness
hands to the program (``program_fields``) and the reference alike.
The chain: harmonic bonds between consecutive atoms, harmonic angles
over consecutive triples, periodic torsions over consecutive quads (two
of them, phi and psi, with their own periodicity and barrier),
alternating charges made neutral, one LJ type, and nonbonded exclusions
of self, 1-2 and 1-3 pairs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class Chain:
    n_atoms: int
    masses: np.ndarray        # (N,) float32
    bonds: np.ndarray         # (B, 2) int64
    bond_r0: np.ndarray
    bond_k: np.ndarray
    angles: np.ndarray        # (A, 3)
    angle_t0: np.ndarray      # radians
    angle_k: np.ndarray
    dihedrals: np.ndarray     # (D, 4)
    dihedral_n: np.ndarray
    dihedral_k: np.ndarray
    dihedral_phase: np.ndarray
    charges: np.ndarray
    lj_sigma: np.ndarray
    lj_eps: np.ndarray
    phi_quad: Tuple[int, int, int, int]
    psi_quad: Tuple[int, int, int, int]
    base: np.ndarray          # (N, 3) float32 extended-chain start
    jitter: float             # A, the start's random displacement scale

    def excluded_pairs(self) -> np.ndarray:
        """(E, 2) excluded unordered pairs (1-2 and 1-3), self aside."""
        return np.concatenate([self.bonds, self.angles[:, [0, 2]]])

    def interaction_mask(self) -> np.ndarray:
        """(N, N) float32: 1.0 where a pair interacts, 0.0 on the
        diagonal and the excluded pairs."""
        n = self.n_atoms
        mask = np.ones((n, n), np.float32)
        np.fill_diagonal(mask, 0.0)
        ex = self.excluded_pairs()
        mask[ex[:, 0], ex[:, 1]] = mask[ex[:, 1], ex[:, 0]] = 0.0
        return mask

    def kept_pairs(self) -> int:
        """Unordered atom pairs the nonbonded sum keeps."""
        ex = {tuple(sorted(p)) for p in self.excluded_pairs().tolist()}
        return self.n_atoms * (self.n_atoms - 1) // 2 - len(ex)


def build(spec: Dict) -> Chain:
    """The chain of a configuration's ``system`` block."""
    n = int(spec["n_atoms"])
    i = np.arange(n)
    bonds = np.stack([i[:-1], i[1:]], 1)
    angles = np.stack([i[:-2], i[1:-1], i[2:]], 1)
    quads = np.stack([i[:-3], i[1:-2], i[2:-1], i[3:]], 1)
    phi_quad = tuple(int(v) for v in spec["phi_quad"])
    psi_quad = tuple(int(v) for v in spec["psi_quad"])
    dn = np.full(len(quads), float(spec["torsion_n"]))
    dk = np.full(len(quads), float(spec["torsion_k"]))
    for j, q in enumerate(quads.tolist()):
        if tuple(q) in (phi_quad, psi_quad):
            dn[j] = float(spec["phi_psi_torsion_n"])
            dk[j] = float(spec["phi_psi_torsion_k"])
    q = float(spec["charge"])
    charges = np.where(i % 2 == 0, q, -q)
    charges = charges - charges.mean()
    base = np.zeros((n, 3), np.float32)
    base[:, 0] = i * float(spec["start_spacing"])
    base[:, 1] = (i % 2) * float(spec["start_zigzag"])

    def f32(a):
        return np.asarray(a, np.float32)

    return Chain(
        n_atoms=n, masses=f32(np.full(n, float(spec["mass"]))),
        bonds=bonds, bond_r0=f32(np.full(len(bonds), spec["bond_r0"])),
        bond_k=f32(np.full(len(bonds), spec["bond_k"])),
        angles=angles,
        angle_t0=f32(np.full(len(angles),
                             np.deg2rad(float(spec["angle_t0_deg"])))),
        angle_k=f32(np.full(len(angles), spec["angle_k"])),
        dihedrals=quads, dihedral_n=f32(dn), dihedral_k=f32(dk),
        dihedral_phase=f32(np.zeros(len(quads))),
        charges=f32(charges), lj_sigma=f32(np.full(n, spec["lj_sigma"])),
        lj_eps=f32(np.full(n, spec["lj_eps"])),
        phi_quad=phi_quad, psi_quad=psi_quad, base=base,
        jitter=float(spec["start_jitter"]))


def program_fields(c: Chain) -> Dict:
    """The chain as the keyword arguments of the program's molecular
    system (the configuration's ``program.system``): host arrays, the
    nonbonded mask (1.0 where a pair interacts) among them."""
    names = ("masses", "bonds", "bond_r0", "bond_k", "angles", "angle_t0",
             "angle_k", "dihedrals", "dihedral_n", "dihedral_k",
             "dihedral_phase", "charges", "lj_sigma", "lj_eps")
    return dict({k: getattr(c, k) for k in names}, n_atoms=c.n_atoms,
                nb_mask=c.interaction_mask(), phi_quad=c.phi_quad,
                psi_quad=c.psi_quad)
