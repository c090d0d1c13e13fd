"""PyTorch oracle for the chain-molecule nonbonded pass: LJ + bare
Coulomb forces AND both energy accumulators from one pairwise sweep,
with per-atom LJ parameters (Lorentz-Berthelot mixing), charges and an
exclusion mask.

The same math as the JAX package's ``lj_forces/ref.py``; this is also
the CPU path of ``MDEngine``.  Batch-agnostic: ``pos`` may be (N, 3) or a
replica stack (..., N, 3).
"""
from __future__ import annotations

import torch

COULOMB = 332.0637   # kcal mol^-1 Angstrom e^-2


def _coef_force(coef, pos):
    """F_i = sum_j coef_ij (x_i - x_j) without the (..., N, N, 3)
    displacement stack: ``rowsum(coef) * x - coef @ x``."""
    return (torch.sum(coef, dim=-1)[..., None] * pos
            - torch.einsum("...ij,...jc->...ic", coef, pos))


def _nonbonded_coefs(pos, lj_sigma, lj_eps, charges, nb_mask):
    """Pair coefficients and energies on component-split (..., N, N)
    planes: (c_lj, c_el, e_lj, e_el)."""
    n = pos.shape[-2]
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    dx = x[..., :, None] - x[..., None, :]
    dy = y[..., :, None] - y[..., None, :]
    dz = z[..., :, None] - z[..., None, :]
    eye = torch.eye(n, dtype=pos.dtype, device=pos.device)
    r2 = dx * dx + dy * dy + dz * dz + eye          # guard the diagonal
    sig = 0.5 * (lj_sigma[:, None] + lj_sigma[None, :])
    eps = torch.sqrt(lj_eps[:, None] * lj_eps[None, :])
    s6 = (sig * sig / r2) ** 3
    r = torch.sqrt(r2)
    qq = charges[:, None] * charges[None, :]
    c_lj = 24.0 * eps * (2.0 * s6 * s6 - s6) / r2 * nb_mask
    c_el = COULOMB * qq / (r2 * r) * nb_mask
    e_lj = 0.5 * torch.sum(4.0 * eps * (s6 * s6 - s6) * nb_mask,
                           dim=(-2, -1))
    e_el = 0.5 * torch.sum(COULOMB * qq / r * nb_mask, dim=(-2, -1))
    return c_lj, c_el, e_lj, e_el


def nonbonded(pos, lj_sigma, lj_eps, charges, nb_mask):
    """LJ + bare electrostatics in one pairwise sweep, forces AND
    energies: ``(f_lj (..., N, 3), f_el (..., N, 3), e_lj (...,),
    e_el (...,))``, the electrostatic pieces unscaled (the salt control
    applies outside)."""
    c_lj, c_el, e_lj, e_el = _nonbonded_coefs(pos, lj_sigma, lj_eps,
                                              charges, nb_mask)
    return _coef_force(c_lj, pos), _coef_force(c_el, pos), e_lj, e_el


def nonbonded_force(pos, lj_sigma, lj_eps, charges, nb_mask,
                    salt_scale=None):
    """The propagate-loop variant: ONE combined nonbonded force, with the
    per-replica salt scaling (``salt_scale`` (...,) or None) folded into
    the pair coefficients."""
    c_lj, c_el, _, _ = _nonbonded_coefs(pos, lj_sigma, lj_eps, charges,
                                        nb_mask)
    if salt_scale is not None:
        c_el = salt_scale[..., None, None] * c_el
    return _coef_force(c_lj + c_el, pos)
