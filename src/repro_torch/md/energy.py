"""Per-replica features and the control-decomposed reduced energy.

    U(x; ctrl) = U_base(x) + salt(ctrl) * U_elec(x) + U_bias(torsions(x); ctrl)
    u(x; ctrl) = beta(ctrl) * U(x; ctrl)

The features (U_base, U_elec, phi, psi) are computed once per exchange
and every ctrl assignment is an O(R) reduction over them.  This is the
replica-major forward path of the JAX package's ``md/energy.py``
(``batched_features`` and the reductions); like there, it is plain
tensor code, not a kernel.  The (R, N, N) pair pass is chunked over
replicas so that its planes stay near a GB at N = 2881.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import REPLICA_CHUNK, wrap_deg
from repro_torch.kernels.lj_forces.ref import COULOMB
from repro_torch.md.system import MolecularSystem

_RAD2DEG = 180.0 / 3.141592653589793


def _torsion_from_gathered(p) -> torch.Tensor:
    """Dihedral angles from pre-gathered quad positions (..., 4, 3)."""
    b0 = p[..., 1, :] - p[..., 0, :]
    b1 = p[..., 2, :] - p[..., 1, :]
    b2 = p[..., 3, :] - p[..., 2, :]
    n1 = torch.linalg.cross(b0, b1, dim=-1)
    n2 = torch.linalg.cross(b1, b2, dim=-1)
    b1n = b1 / (torch.linalg.vector_norm(b1, dim=-1, keepdim=True) + 1e-9)
    m1 = torch.linalg.cross(n1, b1n, dim=-1)
    x = torch.sum(n1 * n2, -1)
    y = torch.sum(m1 * n2, -1)
    return torch.atan2(y, x)


def feature_quads(sys: MolecularSystem) -> torch.Tensor:
    """The dihedrals with the phi/psi feature quads appended; engines
    build it once (it copies to the device)."""
    extra = torch.tensor([sys.phi_quad, sys.psi_quad], dtype=torch.int64)
    return torch.cat([sys.dihedrals, extra.to(sys.dihedrals.device)])


def _batched_bonded_terms(pos, sys: MolecularSystem, quads: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Bonded energy + the (phi, psi) feature torsions from ONE gather.
    pos (R, N, 3); ``quads`` = dihedrals + [phi, psi] quads.  Returns
    (e_bonded (R,), phi (R,), psi (R,))."""
    nb, na, nd = sys.bonds.shape[0], sys.angles.shape[0], quads.shape[0]
    idx = torch.cat([sys.bonds.reshape(-1), sys.angles.reshape(-1),
                     quads.reshape(-1)])
    g = torch.index_select(pos, 1, idx)           # (R, 2B + 3A + 4D', 3)
    r_cnt = pos.shape[0]
    gb = g[:, : 2 * nb].reshape(r_cnt, nb, 2, 3)
    ga = g[:, 2 * nb: 2 * nb + 3 * na].reshape(r_cnt, na, 3, 3)
    gq = g[:, 2 * nb + 3 * na:].reshape(r_cnt, nd, 4, 3)

    r = torch.linalg.vector_norm(gb[:, :, 0] - gb[:, :, 1] + 1e-12, dim=-1)
    e_bond = torch.sum(sys.bond_k * (r - sys.bond_r0) ** 2, dim=-1)

    v1 = ga[:, :, 0] - ga[:, :, 1]
    v2 = ga[:, :, 2] - ga[:, :, 1]
    cos = torch.sum(v1 * v2, -1) / (
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1) + 1e-9)
    theta = torch.acos(torch.clamp(cos, -1 + 1e-6, 1 - 1e-6))
    e_angle = torch.sum(sys.angle_k * (theta - sys.angle_t0) ** 2, dim=-1)

    ang = _torsion_from_gathered(gq)              # (R, D + 2)
    n_dih = sys.dihedrals.shape[0]
    e_dih = torch.sum(sys.dihedral_k
                      * (1 + torch.cos(sys.dihedral_n * ang[:, :n_dih]
                                       - sys.dihedral_phase)), dim=-1)
    return e_bond + e_angle + e_dih, ang[:, n_dih], ang[:, n_dih + 1]


def _pair_energies(pos, sys: MolecularSystem):
    """(LJ, elec) energies of one replica chunk from one (R, N, N) pass."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    dx = x[..., :, None] - x[..., None, :]
    dy = y[..., :, None] - y[..., None, :]
    dz = z[..., :, None] - z[..., None, :]
    eye = torch.eye(pos.shape[1], dtype=pos.dtype, device=pos.device)
    r2 = dx * dx + dy * dy + dz * dz + eye
    sig = 0.5 * (sys.lj_sigma[:, None] + sys.lj_sigma[None, :])
    eps = torch.sqrt(sys.lj_eps[:, None] * sys.lj_eps[None, :])
    s6 = (sig * sig / r2) ** 3
    e_lj = 0.5 * torch.sum(4.0 * eps * (s6 * s6 - s6) * sys.nb_mask,
                           dim=(-2, -1))
    qq = sys.charges[:, None] * sys.charges[None, :]
    e_el = 0.5 * torch.sum(COULOMB * qq / torch.sqrt(r2) * sys.nb_mask,
                           dim=(-2, -1))
    return e_lj, e_el


def _batched_pair_terms(pos, sys: MolecularSystem
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LJ, elec) energies, each (R,), chunked over replicas."""
    parts = [_pair_energies(pos[i:i + REPLICA_CHUNK], sys)
             for i in range(0, pos.shape[0], REPLICA_CHUNK)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def batched_features(pos, sys: MolecularSystem,
                     quads: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """Per-replica features for the whole stack: each entry (R,)."""
    if quads is None:
        quads = feature_quads(sys)
    e_bonded, phi, psi = _batched_bonded_terms(pos, sys, quads)
    e_lj, e_elec = _batched_pair_terms(pos, sys)
    return {"u_base": e_bonded + e_lj, "u_elec": e_elec,
            "phi": phi, "psi": psi}


def batched_bias_energy(phi, psi, ctrl_center, ctrl_k) -> torch.Tensor:
    """Umbrella restraints for the stack: phi/psi (R,), centers (R, U)."""
    angles = torch.stack([phi * _RAD2DEG, psi * _RAD2DEG], dim=-1)
    n = ctrl_center.shape[-1]
    d = wrap_deg(angles[..., :n] - ctrl_center)
    return torch.sum(ctrl_k * d * d, dim=-1)


def _batched_ctrl_reduction(f: Dict, ctrl: Dict) -> torch.Tensor:
    n_rep = f["phi"].shape[0]
    salt = ctrl.get("salt")
    salt_scale = 1.0 if salt is None else 1.0 - 0.5 * salt
    u = f["u_base"] + salt_scale * f["u_elec"]
    zeros = torch.zeros((n_rep, 1), dtype=u.dtype, device=u.device)
    return u + batched_bias_energy(
        f["phi"], f["psi"], ctrl.get("umbrella_center", zeros),
        ctrl.get("umbrella_k", zeros))


def batched_reduced_energy_from_features(f: Dict, ctrl: Dict
                                         ) -> torch.Tensor:
    """u(x; ctrl) for the stack from precomputed (R,) features."""
    return ctrl["beta"] * _batched_ctrl_reduction(f, ctrl)
