"""PyTorch analytic bonded forces: bonds + angles + torsions + umbrella
bias, with hand-derived gradients — no autodiff graph.

The same formulas as the JAX package's ``chain_forces/ref.py`` (same
guard epsilons, same clip bounds), term for term:

  bonds      E = k (r - r0)^2,  r = |d|,  d = r_i - r_j + 1e-12
  angles     c = v1.v2 / (|v1||v2| + 1e-9), theta = arccos(clip(c))
             (gradient gated to the interior of the clip interval)
  torsions   phi = atan2(m1.n2, n1.n2) with n1 = b0 x b1, n2 = b1 x b2
  bias       E = sum_u k_u wrap(deg(phi_u) - c_u)^2 on the appended
             phi/psi quads: torque 2 k_u wrap(...) * 180/pi

Both contractions of the per-edge gradients live here:
``bonded_forces`` is the dense signed-incidence form (the oracle and the
CPU path of ``MDEngine``), ``bonded_forces_sparse`` the per-atom slot
sum that the CUDA kernel computes (its plain version).

All functions take a replica stack ``pos`` (..., N, 3) and return forces
of the same shape plus (...,)-shaped energies.
"""
from __future__ import annotations

from typing import NamedTuple

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import wrap_deg

DEG = 180.0 / math.pi


class ChainTopology(NamedTuple):
    """Bonded topology + parameters as tensors.

    ``quads`` carries the force-field dihedrals with the phi/psi feature
    quads appended (cosine weight 0 for the appended two).  ``inc_stack``
    is the signed per-edge scatter operator: six (W, N) incidence
    matrices, one per gradient-edge role [bond d | angle v1 arm | angle
    v2 arm | quad b0 | quad b1 | quad b2], +1 at an edge's head atom and
    -1 at its tail, lane-padded to ``edge_width``.
    """
    bonds: torch.Tensor        # (B, 2) int64
    bond_r0: torch.Tensor      # (B,)
    bond_k: torch.Tensor       # (B,)
    angles: torch.Tensor       # (A, 3) int64
    angle_t0: torch.Tensor     # (A,)
    angle_k: torch.Tensor      # (A,)
    quads: torch.Tensor        # (Q, 4) int64 — dihedrals + [phi, psi]
    quad_n: torch.Tensor       # (Q,)
    quad_k: torch.Tensor       # (Q,) — 0 for the two appended quads
    quad_phase: torch.Tensor   # (Q,)
    gather_idx: torch.Tensor   # (2B + 3A + 4Q,) role-major atom indices
    inc_stack: torch.Tensor    # (6, W, N) f32 signed edge scatter per role
    edge_width: int            # W = max(B, A, Q)


def _incidence(bonds, angles, quads, n: int) -> np.ndarray:
    """The (6, W, N) signed incidence stack (host numpy)."""
    width = max(len(bonds), len(angles), len(quads))

    def inc_mat(head, tail):
        m = np.zeros((width, n), np.float32)
        rows = np.arange(len(head))
        np.add.at(m, (rows, head), 1.0)
        np.add.at(m, (rows, tail), -1.0)
        return m

    return np.stack([
        inc_mat(bonds[:, 0], bonds[:, 1]),       # d  = r_i - r_j
        inc_mat(angles[:, 0], angles[:, 1]),     # v1 = a - b
        inc_mat(angles[:, 2], angles[:, 1]),     # v2 = c - b
        inc_mat(quads[:, 1], quads[:, 0]),       # b0 = p1 - p0
        inc_mat(quads[:, 2], quads[:, 1]),       # b1 = p2 - p1
        inc_mat(quads[:, 3], quads[:, 2]),       # b2 = p3 - p2
    ])


def chain_topology(system) -> ChainTopology:
    """Build a ChainTopology from any object with MolecularSystem's
    bonded attributes (duck-typed), on the system's device."""
    dev = system.masses.device
    bonds = system.bonds.cpu().numpy()
    angles = system.angles.cpu().numpy()
    quads = np.concatenate(
        [system.dihedrals.cpu().numpy(),
         np.asarray([system.phi_quad, system.psi_quad], np.int64)], axis=0)
    inc = _incidence(bonds, angles, quads, int(system.n_atoms))
    gather = np.concatenate([bonds[:, 0], bonds[:, 1], angles[:, 0],
                             angles[:, 1], angles[:, 2], quads[:, 0],
                             quads[:, 1], quads[:, 2], quads[:, 3]])
    zeros2 = torch.zeros(2, dtype=torch.float32, device=dev)
    return ChainTopology(
        bonds=system.bonds, bond_r0=system.bond_r0, bond_k=system.bond_k,
        angles=system.angles, angle_t0=system.angle_t0,
        angle_k=system.angle_k,
        quads=torch.as_tensor(quads, device=dev),
        quad_n=torch.cat([system.dihedral_n, zeros2 + 1.0]),
        quad_k=torch.cat([system.dihedral_k, zeros2]),
        quad_phase=torch.cat([system.dihedral_phase, zeros2]),
        gather_idx=torch.as_tensor(gather, device=dev),
        inc_stack=torch.as_tensor(inc, device=dev),
        edge_width=inc.shape[1],
    )


def _dot(a, b):
    return torch.sum(a * b, -2)


def _edge_grads(pos, top: ChainTopology,
                umbrella_center: Optional[torch.Tensor] = None,
                umbrella_k: Optional[torch.Tensor] = None,
                per_term: bool = False):
    """Per-edge gradient tensors + bonded energy — the O(W) half both
    contractions share.  Returns (edges (..., 6, 3, W), e_bonded (...,)),
    one lane-padded gradient row per role; geometry runs on (..., 3, W)
    component tensors as in the JAX package.  ``umbrella_center`` /
    ``umbrella_k`` (..., U), U in {1, 2}, add the bias torque on the
    appended phi (and psi) quads; the energy stays ctrl-independent.
    ``per_term``: the energy as (..., B + A + Q) term energies (bonds,
    angles, torsions) instead of their sum."""
    nb, na, nq = (top.bonds.shape[0], top.angles.shape[0],
                  top.quads.shape[0])
    g = torch.index_select(pos, -2, top.gather_idx).transpose(-1, -2)

    def seg(off, w):
        return g[..., :, off:off + w]

    def ex(s):                       # (..., W) scalar row -> (..., 1, W)
        return s[..., None, :]

    # bonds: dE/dr_i = 2k(r - r0) d/r
    d = seg(0, nb) - seg(nb, nb) + 1e-12
    r = torch.sqrt(_dot(d, d))
    t_bond = top.bond_k * (r - top.bond_r0) ** 2
    e_bond = torch.sum(t_bond, dim=-1)
    cb = 2.0 * top.bond_k * (r - top.bond_r0) / r

    # angles
    o = 2 * nb
    v1 = seg(o, na) - seg(o + na, na)
    v2 = seg(o + 2 * na, na) - seg(o + na, na)
    n1 = torch.sqrt(_dot(v1, v1))
    n2 = torch.sqrt(_dot(v2, v2))
    den = n1 * n2 + 1e-9
    dot = _dot(v1, v2)
    cosv = dot / den
    cc = torch.clamp(cosv, -1 + 1e-6, 1 - 1e-6)
    theta = torch.acos(cc)
    t_angle = top.angle_k * (theta - top.angle_t0) ** 2
    e_angle = torch.sum(t_angle, dim=-1)
    interior = ((cosv > -1 + 1e-6) & (cosv < 1 - 1e-6)).to(cosv.dtype)
    g_c = (2.0 * top.angle_k * (theta - top.angle_t0)
           * (-1.0 / torch.sqrt(1.0 - cc * cc)) * interior)
    # the + 1e-12 guards keep degenerate (zero-length) terms finite
    w1 = dot * n2 / (den * den * (n1 + 1e-12))
    w2 = dot * n1 / (den * den * (n2 + 1e-12))
    e_a1 = ex(g_c) * (v2 / ex(den) - ex(w1) * v1)
    e_a2 = ex(g_c) * (v1 / ex(den) - ex(w2) * v2)

    # torsions
    o = 2 * nb + 3 * na
    p0, p1 = seg(o, nq), seg(o + nq, nq)
    p2, p3 = seg(o + 2 * nq, nq), seg(o + 3 * nq, nq)
    b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
    n1v = torch.linalg.cross(b0, b1, dim=-2)
    n2v = torch.linalg.cross(b1, b2, dim=-2)
    nb1 = torch.sqrt(_dot(b1, b1))
    m1 = torch.linalg.cross(n1v, b1 / ex(nb1 + 1e-9), dim=-2)
    phi = torch.atan2(_dot(m1, n2v), _dot(n1v, n2v))
    t_dih = top.quad_k * (1.0 + torch.cos(top.quad_n * phi
                                          - top.quad_phase))
    e_dih = torch.sum(t_dih, dim=-1)
    torque = -top.quad_k * top.quad_n * torch.sin(top.quad_n * phi
                                                  - top.quad_phase)
    if umbrella_center is not None:
        n_u = umbrella_center.shape[-1]
        lo = nq - 2
        dev = wrap_deg(phi[..., lo:lo + n_u] * DEG - umbrella_center)
        tq = 2.0 * umbrella_k * dev * DEG
        torque = torch.cat([torque[..., :lo], torque[..., lo:lo + n_u] + tq,
                            torque[..., lo + n_u:]], dim=-1)
    inv1 = 1.0 / (_dot(n1v, n1v) + 1e-12)
    inv2 = 1.0 / (_dot(n2v, n2v) + 1e-12)
    invb = 1.0 / (nb1 + 1e-12)
    c0 = torque * -nb1 * inv1                  # torque-folded db0 = c0 n1
    c2 = torque * -nb1 * inv2                  # torque-folded db2 = c2 n2
    d1a = torque * _dot(b0, b1) * invb * inv1
    d1b = torque * _dot(b2, b1) * invb * inv2

    w = top.edge_width

    def pad_w(a):
        return torch.nn.functional.pad(a, (0, w - a.shape[-1]))

    edges = torch.stack([pad_w(ex(cb) * d),
                         pad_w(e_a1), pad_w(e_a2),
                         pad_w(ex(c0) * n1v),
                         pad_w(ex(d1a) * n1v + ex(d1b) * n2v),
                         pad_w(ex(c2) * n2v)], dim=-3)     # (..., 6, 3, W)
    if per_term:
        return edges, torch.cat([t_bond, t_angle, t_dih], dim=-1)
    return edges, e_bond + e_angle + e_dih


def bonded_forces(pos, top: ChainTopology,
                  umbrella_center: Optional[torch.Tensor] = None,
                  umbrella_k: Optional[torch.Tensor] = None):
    """Analytic bonded (+ bias) forces for a replica stack — the DENSE
    incidence contraction (the oracle, and ``MDEngine``'s CPU path).

    pos: (..., N, 3); umbrella rows (..., U) or None.  Returns (force
    (..., N, 3), e_bonded (...,)), the energy without the bias.  One
    contraction against ``top.inc_stack`` per replica and role, then a
    sum over the six roles, as in the JAX package.  The contraction is a
    batched matmul, one product per replica and role: a replica's sums do
    not depend on how many replicas the stack holds (a Mode II wave
    gives each replica the bits of Mode I)."""
    edges, e = _edge_grads(pos, top, umbrella_center, umbrella_k)
    out = torch.matmul(edges, top.inc_stack)                 # (..., 6, 3, N)
    force = -torch.sum(out, dim=-3).transpose(-1, -2)        # (..., N, 3)
    return force, e


class BondedSlots(NamedTuple):
    """Static per-atom gather tables: for each atom, the flattened slots
    ``role * W + w`` of the incidence stack that touch it, and their
    signs (+1 head / -1 tail / 0 padding).  S is bounded by the topology
    (at most 15 for a chain), independent of N."""
    idx: torch.Tensor    # (N, S) int64
    sign: torch.Tensor   # (N, S) f32
    n_slots: int         # S


def bonded_slots(top: ChainTopology) -> BondedSlots:
    """Invert the signed incidence stack into per-atom gather tables
    (host-side, once).  Slots of one atom are in increasing flat index
    order — the order the CUDA kernel sums them in."""
    inc = top.inc_stack.cpu().numpy()                      # (6, W, N)
    n, w = inc.shape[2], inc.shape[1]
    role, edge, atom = np.nonzero(inc)
    order = np.argsort(atom, kind="stable")
    atom, flat = atom[order], (role * w + edge)[order]
    sign = inc[role[order], edge[order], atom]
    first = np.searchsorted(atom, atom, side="left")
    rank = np.arange(len(atom)) - first
    s = max(int(rank.max(initial=0)) + 1, 1) if len(atom) else 1
    idx = np.zeros((n, s), np.int64)
    sgn = np.zeros((n, s), np.float32)
    idx[atom, rank] = flat
    sgn[atom, rank] = sign
    dev = top.inc_stack.device
    return BondedSlots(idx=torch.as_tensor(idx, device=dev),
                       sign=torch.as_tensor(sgn, device=dev), n_slots=s)


def bonded_forces_sparse(pos, top: ChainTopology, slots: BondedSlots,
                         umbrella_center: Optional[torch.Tensor] = None,
                         umbrella_k: Optional[torch.Tensor] = None):
    """Analytic bonded (+ bias) forces via the per-atom SLOT contraction
    — the same per-edge gradients as :func:`bonded_forces`, summed onto
    atoms through the (N, S) slot tables: O(N * S).  This is the plain
    PyTorch version of the CUDA bonded kernel (same two phases)."""
    edges, e = _edge_grads(pos, top, umbrella_center, umbrella_k)
    flat = edges.transpose(-3, -2).reshape(
        edges.shape[:-3] + (3, 6 * top.edge_width))        # (..., 3, 6W)
    gathered = flat[..., slots.idx]                        # (..., 3, N, S)
    force = -torch.sum(slots.sign * gathered, dim=-1).transpose(-1, -2)
    return force, e
