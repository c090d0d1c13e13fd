"""Operations and bytes of the MD kernels and of a whole REMD cycle on a
system of kind ``chain``, counted from its topology and the
configuration alone.

The per-term and per-pair operation counts are those the port's kernel
bounds were first stated with (one per add, multiply, divide, square
root or transcendental; an FMA two), frozen here so that a change to the
program's layouts or packs cannot move the yardstick:

  bond 21, angle 76, torsion 116, a slot's signed 3-vector accumulate 6;
  a kept unordered pair, forces and both energies, 52 (displacement 3,
  r^2 5, mixing 3, 1/r^2 and 1/r 2, (s^2/r^2)^3 4, LJ energy 3 + sum 1,
  LJ force coefficient 4, Coulomb energy 1 + sum 1, its coefficient 1,
  two force rows x 3 components x both atoms as FMAs 24);
  the fused step's pair 46 (52 less the energy terms), per atom the
  salt-scaled sum 9 and the B-A-O-A-B update 27; the two bias torques
  of a replica 16.

Bytes: each input read once (positions, the per-atom rows, the exclusion
mask as one bit a pair, the term tables) and each output written once.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

BOND_OPS, ANGLE_OPS, TORSION_OPS, SLOT_OPS = 21, 76, 116, 6
PAIR_OPS = 52
PAIR_FORCE_OPS = PAIR_OPS - 6
ATOM_UPDATE_OPS = 9 + 27
BIAS_OPS = 16


def topology(chain) -> Dict[str, int]:
    """Term counts of a reference ``Chain``: bonds, angles, quads (the
    torsions with the phi and psi feature quads appended), the most
    gradient-edge incidences of one atom (the slots a per-atom force sum
    reads) and the kept unordered pairs."""
    n = chain.n_atoms
    quads = np.concatenate([chain.dihedrals,
                            np.asarray([chain.phi_quad, chain.psi_quad])])
    inc = np.zeros(n, np.int64)
    for a, b in chain.bonds:                  # d = r_a - r_b
        inc[a] += 1
        inc[b] += 1
    for a, b, c in chain.angles:              # v1 = a - b, v2 = c - b
        inc[[a, c]] += 1
        inc[b] += 2
    for p0, p1, p2, p3 in quads:              # b0, b1, b2
        inc[[p0, p3]] += 1
        inc[[p1, p2]] += 2
    return {"n_atoms": n, "bonds": len(chain.bonds),
            "angles": len(chain.angles), "quads": len(quads),
            "slots": int(inc.max()), "pairs": chain.kept_pairs()}


def bonded_ops(t: Dict[str, int]) -> int:
    """One replica's bonded forces and energy."""
    return (t["bonds"] * BOND_OPS + t["angles"] * ANGLE_OPS
            + t["quads"] * TORSION_OPS
            + t["n_atoms"] * t["slots"] * SLOT_OPS)


def _mask_bytes(n: int) -> int:
    return n * ((n + 31) // 32) * 4


def _table_bytes(t: Dict[str, int]) -> int:
    """Term tables: atom indices (int32) and parameters (float32)."""
    return 4 * (t["bonds"] * (2 + 2) + t["angles"] * (3 + 2)
                + t["quads"] * (4 + 3))


def _bound(ops: float, nbytes: float) -> Dict[str, float]:
    t_ops, t_bytes = ops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "ms": max(t_ops, t_bytes) * 1e3,
            "by": "operations" if t_ops >= t_bytes else "bytes"}


def nonbonded_bound(t: Dict[str, int], n_rep: int) -> Dict[str, float]:
    """All-pairs nonbonded forces and both energies of ``n_rep`` replicas:
    positions, three per-atom rows and the mask in; two force stacks and
    two energies out."""
    n = t["n_atoms"]
    nbytes = (n_rep * n * 3 * 4 + 3 * n * 4 + _mask_bytes(n)
              + 2 * n_rep * n * 3 * 4 + 2 * n_rep * 4)
    return _bound(n_rep * t["pairs"] * PAIR_OPS, nbytes)


def fused_bound(t: Dict[str, int], n_rep: int, bias: bool
                ) -> Dict[str, float]:
    """One fused BAOAB iteration of ``n_rep`` replicas: positions,
    velocities and noise in, the step and bias rows, the term tables,
    four per-atom rows and the mask in; new positions and velocities
    out."""
    n = t["n_atoms"]
    stack = n_rep * n * 3 * 4
    nbytes = (3 * stack + 2 * n_rep * 8 * 4 + _table_bytes(t) + 4 * n * 4
              + _mask_bytes(n) + 2 * stack)
    ops = n_rep * (t["pairs"] * PAIR_FORCE_OPS + bonded_ops(t)
                   + (BIAS_OPS if bias else 0) + n * ATOM_UPDATE_OPS)
    return _bound(ops, nbytes)


def has_bias(config: Dict) -> bool:
    """Whether the configuration's grid has umbrella windows."""
    return any(kind == "umbrella"
               for kind, _ in config["exchange"]["dimensions"])


def cycle_ops(t: Dict[str, int], config: Dict, n_rep: int) -> float:
    """The float32 operations one exchange cycle of ``n_rep`` replicas
    needs: ``md_steps_per_cycle + 1`` force-and-energy evaluations of
    every replica, each with its bonded terms, its bias where the grid
    has umbrellas, and the per-atom update.  No separate feature pass:
    the last evaluation's energies serve the exchange."""
    md_steps = int(config["exchange"]["md_steps_per_cycle"])
    bias = has_bias(config)
    per_eval = (t["pairs"] * PAIR_OPS + bonded_ops(t)
                + (BIAS_OPS if bias else 0)
                + t["n_atoms"] * ATOM_UPDATE_OPS)
    return float((md_steps + 1) * n_rep * per_eval)
