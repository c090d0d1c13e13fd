"""PyTorch oracles of the Lennard-Jones passes.

The LJ fluid (``lj_energy``, ``lj_forces``): uniform sigma and eps under
the minimum-image periodic box, over all pairs; the CPU path of
``LJEngine`` and the plain versions of ``csrc/lj_fluid.cu``.

The chain-molecule nonbonded pass: LJ + bare Coulomb forces AND both
energy accumulators from one pairwise sweep, with per-atom LJ parameters
(Lorentz-Berthelot mixing), charges and an exclusion mask.

The same math as the JAX package's ``lj_forces/ref.py``, with its sparse
(neighbor-list) pass and the dense matched-cutoff oracle; this is also
the CPU path of ``MDEngine``.  Batch-agnostic: ``pos`` may be (N, 3) or a
replica stack (..., N, 3).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import REPLICA_CHUNK, f32_square

COULOMB = 332.0637   # kcal mol^-1 Angstrom e^-2


# -- the LJ fluid (uniform sigma, eps; minimum image) -------------------------


def fluid_constants(sigma: float, eps: float, box: float):
    """(sigma^2, 4 eps, 24 eps, box) as the float32 values JAX forms: the
    products in float64 (Python), each rounded once when it meets a
    float32 array.  The kernels get the same four."""
    return tuple(float(np.float32(v)) for v in
                 (sigma * sigma, 4.0 * eps, 24.0 * eps, box))


def _pair_terms(pos, sig2: float, box: float):
    """Minimum-image displacements, guarded r^2, (sigma^2 / r^2)^3 and
    the off-diagonal mask on (..., N, N) planes.  Divisions are tensor by
    tensor (a scalar divisor is a reciprocal multiply on CUDA), the cube
    is JAX's ``integer_pow``, ``x * (x * x)``."""
    disp = pos[..., :, None, :] - pos[..., None, :, :]
    if box > 0:
        b = torch.full((), box, dtype=pos.dtype, device=pos.device)
        disp = disp - box * torch.round(disp / b)
    n = pos.shape[-2]
    eye = torch.eye(n, dtype=pos.dtype, device=pos.device)
    r2 = torch.sum(disp * disp, -1) + eye              # guard the diagonal
    t = torch.full((), sig2, dtype=pos.dtype, device=pos.device) / r2
    s6 = t * (t * t)
    return disp, r2, s6, 1.0 - eye


def _by_replica_chunks(fn, pos, *args):
    """``fn`` over a replica stack in chunks of ``REPLICA_CHUNK``, so the
    (R, N, N, 3) displacement planes stay small (573 MB at R = 64,
    N = 864 unchunked)."""
    if pos.ndim < 3 or pos.shape[0] <= REPLICA_CHUNK:
        return fn(pos, *args)
    return torch.cat([fn(pos[i:i + REPLICA_CHUNK], *args)
                      for i in range(0, pos.shape[0], REPLICA_CHUNK)])


def _lj_energy(pos, sigma, eps, box):
    sig2, c4, _, box = fluid_constants(sigma, eps, box)
    _, _, s6, mask = _pair_terms(pos, sig2, box)
    e = c4 * (s6 * s6 - s6) * mask
    return 0.5 * torch.sum(e, dim=(-2, -1))


def _lj_forces(pos, sigma, eps, box):
    sig2, _, c24, box = fluid_constants(sigma, eps, box)
    disp, r2, s6, mask = _pair_terms(pos, sig2, box)
    coef = c24 * (2.0 * s6 * s6 - s6) / r2 * mask
    return torch.sum(coef[..., None] * disp, dim=-2)


def lj_energy(pos, sigma: float, eps: float, box: float) -> torch.Tensor:
    """(..., N, 3) -> (...) total LJ energy per configuration."""
    return _by_replica_chunks(_lj_energy, pos, sigma, eps, box)


def lj_forces(pos, sigma: float, eps: float, box: float) -> torch.Tensor:
    """F = -dU/dx, analytic: (..., N, 3) -> (..., N, 3)."""
    return _by_replica_chunks(_lj_forces, pos, sigma, eps, box)


# -- the chain-molecule nonbonded pass ----------------------------------------


def _coef_force(coef, pos):
    """F_i = sum_j coef_ij (x_i - x_j) without the (..., N, N, 3)
    displacement stack: ``rowsum(coef) * x - coef @ x``."""
    return (torch.sum(coef, dim=-1)[..., None] * pos
            - torch.einsum("...ij,...jc->...ic", coef, pos))


def _nonbonded_coefs(pos, lj_sigma, lj_eps, charges, nb_mask,
                     cutoff=None):
    """Pair coefficients and energies on component-split (..., N, N)
    planes: (c_lj, c_el, e_lj, e_el).  ``cutoff`` folds a radial
    truncation into the pair mask."""
    n = pos.shape[-2]
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    dx = x[..., :, None] - x[..., None, :]
    dy = y[..., :, None] - y[..., None, :]
    dz = z[..., :, None] - z[..., None, :]
    eye = torch.eye(n, dtype=pos.dtype, device=pos.device)
    r2 = dx * dx + dy * dy + dz * dz + eye          # guard the diagonal
    if cutoff is not None:
        nb_mask = nb_mask * (r2 <= f32_square(cutoff))
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


def nonbonded_cutoff(pos, lj_sigma, lj_eps, charges, nb_mask,
                     cutoff: float):
    """The dense pass truncated at ``cutoff``: the same pair math as
    :func:`nonbonded` over all (N, N) pairs, the oracle the sparse pass
    is held against."""
    c_lj, c_el, e_lj, e_el = _nonbonded_coefs(pos, lj_sigma, lj_eps,
                                              charges, nb_mask, cutoff)
    return _coef_force(c_lj, pos), _coef_force(c_el, pos), e_lj, e_el


# -- the sparse (neighbor-list) pass ------------------------------------------
#
# The same physics on each atom's padded (R, N, K) neighbor slots instead of
# all (R, N, N) pairs.  Lists are two-sided (j in list(i) iff i in list(j)),
# so the force is a plain K-sum and the energies halve.  Exclusions are
# pruned at build time; the true ``cutoff`` (below the list radius
# ``cutoff + skin``) is applied at every evaluation.


def _sparse_pair_coefs(pos, lj_sigma, lj_eps, charges, idx, valid,
                       cutoff: float, pair=None):
    """Per-slot coefficients and energies: pos (..., N, 3), idx / valid
    (..., N, K) -> (c_lj, c_el, e_lj, e_el, (dx, dy, dz)).

    ``pair`` (optional, (..., 3, N, K)): the build-time planes
    [sig^2, eps, COULOMB * qq] (``md.neighbors.pair_planes``); each holds
    exactly the sub-expression the gather path forms first, so the two
    forms are bitwise identical."""
    n = pos.shape[-2]
    j = torch.clamp(idx, 0, n - 1).to(torch.int64)   # padding -> atom n-1,
    flat = j.reshape(j.shape[:-2] + (-1,))            # masked out below

    def take(comp):
        return torch.gather(comp, -1, flat).reshape(j.shape)

    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    dx = x[..., :, None] - take(x)
    dy = y[..., :, None] - take(y)
    dz = z[..., :, None] - take(z)
    r2 = dx * dx + dy * dy + dz * dz
    mask = valid * (r2 <= f32_square(cutoff))
    r2 = r2 + (1.0 - mask)                    # guard padded / self slots
    if pair is None:
        sig = 0.5 * (lj_sigma[..., :, None] + lj_sigma[j])
        sig2 = sig * sig
        eps = torch.sqrt(lj_eps[..., :, None] * lj_eps[j])
        cqq = COULOMB * (charges[..., :, None] * charges[j])
    else:
        sig2 = pair[..., 0, :, :]
        eps = pair[..., 1, :, :]
        cqq = pair[..., 2, :, :]
    s6 = (sig2 / r2) ** 3
    r = torch.sqrt(r2)
    c_lj = 24.0 * eps * (2.0 * s6 * s6 - s6) / r2 * mask
    c_el = cqq / (r2 * r) * mask
    e_lj = 0.5 * torch.sum(4.0 * eps * (s6 * s6 - s6) * mask, dim=(-2, -1))
    e_el = 0.5 * torch.sum(cqq / r * mask, dim=(-2, -1))
    return c_lj, c_el, e_lj, e_el, (dx, dy, dz)


def slot_force(coef, comps):
    """F_i = sum_k coef_ik * disp_ik on component planes -> (..., N, 3)."""
    return torch.stack([torch.sum(coef * c, dim=-1) for c in comps], dim=-1)


def nonbonded_sparse(pos, lj_sigma, lj_eps, charges, idx, valid,
                     cutoff: float, pair=None):
    """The sparse analogue of :func:`nonbonded`: ``(f_lj, f_el, e_lj,
    e_el)`` from one O(N K) neighbor sweep, the electrostatic pieces
    unscaled."""
    c_lj, c_el, e_lj, e_el, comps = _sparse_pair_coefs(
        pos, lj_sigma, lj_eps, charges, idx, valid, cutoff, pair)
    return (slot_force(c_lj, comps), slot_force(c_el, comps),
            e_lj, e_el)


def nonbonded_force_sparse(pos, lj_sigma, lj_eps, charges, idx, valid,
                           cutoff: float, salt_scale=None, pair=None):
    """The propagate-loop variant: one combined sparse force, the salt
    scale folded into the coefficients."""
    c_lj, c_el, _, _, comps = _sparse_pair_coefs(
        pos, lj_sigma, lj_eps, charges, idx, valid, cutoff, pair)
    if salt_scale is not None:
        c_el = salt_scale[..., None, None] * c_el
    return slot_force(c_lj + c_el, comps)
