"""The reference model ``chain_dense``: forces, energies and the BAOAB
Langevin step with its noise stream, for a chain system with the dense
all-pairs nonbonded sum.

Written from the model's equations in plain PyTorch, nothing of the
program under test imported:

  U(x; c) = sum_bonds k (r - r0)^2 + sum_angles k (theta - theta0)^2
          + sum_torsions k (1 + cos(n phi - phase))
          + sum_{i<j kept} [4 eps (s^12 - s^6) + C q_i q_j / r]
          + sum_u k_u wrap(deg(phi_u) - c_u)^2          (umbrella grids)
  u(x; c) = beta_c U(x; c)

Bonded and bias forces are ``-grad`` of their energy by autograd (O(N));
the pair forces are the analytic pair sum over all kept pairs, in chunks
of replicas.  A step of BAOAB with two force evaluations, the force of a
step's last half-kick shared with the next step's first, ``steps + 1``
evaluations a cycle.

``dtype`` sets the arithmetic of every force evaluation and of the start's
normals, ``feature_dtype`` (default ``dtype``) that of the exchange's
energies and angles: the displacements are formed from the float32
state, then cast, and every operation after runs in that dtype; the noise
is rounded to ``dtype``.  The state and the integration stay float32.
``torch.float32`` is the reference; ``torch.bfloat16`` the control.

Parameters from the configuration: ``md`` (``dt``, ``gamma``,
``init_temperature``), ``exchange`` (the control grid) and ``reference``
(``noise_layout``: the threefry layout of the path's noise, "stacked"
or "unrolled").
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import prng
from .controls import grid as make_grid
from .units import AKMA, COULOMB, KB

PAIR_CHUNK = 16          # replicas per chunk of the (c, N, N) pair planes
DEG = 180.0 / math.pi


def wrap_deg(d):
    """Angle differences in degrees wrapped to [-180, 180)."""
    return torch.remainder(d + 180.0, 360.0) - 180.0


def _torsion(p0, p1, p2, p3):
    b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
    n1 = torch.linalg.cross(b0, b1, dim=-1)
    n2 = torch.linalg.cross(b1, b2, dim=-1)
    m1 = torch.linalg.cross(
        n1, b1 / (torch.linalg.vector_norm(b1, dim=-1, keepdim=True) + 1e-9),
        dim=-1)
    return torch.atan2(torch.sum(m1 * n2, -1), torch.sum(n1 * n2, -1))


@dataclass
class Controls:
    """Per-replica control rows (R,) / (R, U) on the device."""
    beta: torch.Tensor
    temperature: torch.Tensor
    center: torch.Tensor
    k: torch.Tensor


class Model:
    def __init__(self, system, config: Dict, device, dtype=torch.float32,
                 feature_dtype=None):
        md = config["md"]
        self.sys, self.device, self.dtype = system, device, dtype
        self.feature_dtype = feature_dtype or dtype
        self.grid = make_grid(config["exchange"])
        self.dt = float(md["dt"])
        self.gamma = float(md["gamma"])
        self.t_init = float(md["init_temperature"])
        self.noise_layout = config["reference"]["noise_layout"]
        t = lambda a: torch.as_tensor(a, device=device)
        s = system
        self.masses = t(s.masses)
        self.bonds, self.angles = t(s.bonds), t(s.angles)
        self.quads = t(s.dihedrals)
        self.fquads = t(np.asarray([s.phi_quad, s.psi_quad]))
        mask = s.interaction_mask()
        sig = 0.5 * (s.lj_sigma[:, None] + s.lj_sigma[None, :])
        eps = np.sqrt(s.lj_eps[:, None].astype(np.float64)
                      * s.lj_eps[None, :])
        qq = s.charges[:, None].astype(np.float64) * s.charges[None, :]
        # the pair planes, constant over replicas, mask folded in
        self._host_planes = {
            "guard": 1.0 - mask, "sig2": sig * sig, "eps4": 4.0 * eps * mask,
            "eps24": 24.0 * eps * mask, "cq": COULOMB * qq * mask,
            "bond_r0": s.bond_r0, "bond_k": s.bond_k,
            "angle_t0": s.angle_t0, "angle_k": s.angle_k,
            "dn": s.dihedral_n, "dk": s.dihedral_k,
            "dphase": s.dihedral_phase}
        self._planes: Dict = {}
        self.c1 = float(np.float32(math.exp(float(np.float32(
            -self.gamma * self.dt)))))
        self.o_scale = float(np.sqrt(np.float32(1.0) - np.float32(self.c1)
                                     * np.float32(self.c1)))

    @property
    def n_rep(self) -> int:
        return self.grid.n_ctrl

    def _p(self, w) -> Dict[str, torch.Tensor]:
        """The parameter planes and tables in dtype ``w``."""
        if w not in self._planes:
            self._planes[w] = {k: torch.as_tensor(v, device=self.device,
                                                  dtype=w)
                               for k, v in self._host_planes.items()}
        return self._planes[w]

    # -- controls -----------------------------------------------------------

    def controls(self, assignment: torch.Tensor) -> Controls:
        g = self.grid
        t = lambda a: torch.as_tensor(a, device=self.device)[assignment]
        return Controls(beta=t(g.beta), temperature=t(g.temperature),
                        center=t(g.umbrella_center), k=t(g.umbrella_k))

    # -- energies and forces --------------------------------------------------

    def _bonded(self, pos, ctl, with_bias: bool, w):
        """(e_bonded (R,), e_bias (R,), phi (R,), psi (R,)) in ``w``;
        differentiable in ``pos``."""
        p = self._p(w)
        g = lambda idx: pos[:, idx]
        d = (g(self.bonds[:, 0]) - g(self.bonds[:, 1])).to(w)
        r = torch.linalg.vector_norm(d + 1e-12, dim=-1)
        e = torch.sum(p["bond_k"] * (r - p["bond_r0"]) ** 2, -1)
        a = self.angles
        v1 = (g(a[:, 0]) - g(a[:, 1])).to(w)
        v2 = (g(a[:, 2]) - g(a[:, 1])).to(w)
        cos = torch.sum(v1 * v2, -1) / (
            torch.linalg.vector_norm(v1, dim=-1)
            * torch.linalg.vector_norm(v2, dim=-1) + 1e-9)
        # the clip keeps acos's gradient finite; in a precision whose
        # spacing below 1 exceeds 1e-6 the bound is that spacing
        lim = 1.0 - max(1e-6, torch.finfo(w).eps)
        theta = torch.acos(torch.clamp(cos, -lim, lim))
        e = e + torch.sum(p["angle_k"] * (theta - p["angle_t0"]) ** 2, -1)
        q = torch.cat([self.quads, self.fquads])
        p0 = g(q[:, 0])
        ang = _torsion(*[(g(q[:, j]) - p0).to(w) for j in range(4)])
        nd = self.quads.shape[0]
        e = e + torch.sum(p["dk"] * (1 + torch.cos(p["dn"] * ang[:, :nd]
                                                   - p["dphase"])), -1)
        phi, psi = ang[:, nd], ang[:, nd + 1]
        bias = torch.zeros_like(phi)
        if with_bias and self.grid.n_umbrella:
            nu = self.grid.n_umbrella
            angles = torch.stack([phi, psi], -1)[:, :nu] * DEG
            dev = wrap_deg(angles - ctl.center[:, :nu].to(w))
            bias = torch.sum(ctl.k[:, :nu].to(w) * dev * dev, -1)
        return e, bias, phi, psi

    def _pairs(self, pos, need_force: bool, need_energy: bool, w):
        """Pair forces (R, N, 3) float32 and (e_lj, e_el) (R,) in chunks."""
        p = self._p(w)
        forces, e_lj, e_el = [], [], []
        for i in range(0, pos.shape[0], PAIR_CHUNK):
            x = pos[i:i + PAIR_CHUNK]
            dx = (x[..., :, None, 0] - x[..., None, :, 0]).to(w)
            dy = (x[..., :, None, 1] - x[..., None, :, 1]).to(w)
            dz = (x[..., :, None, 2] - x[..., None, :, 2]).to(w)
            r2 = dx * dx + dy * dy + dz * dz + p["guard"]
            inv2 = 1.0 / r2
            s6 = (p["sig2"] * inv2) ** 3
            inv1 = torch.sqrt(inv2)
            if need_energy:
                e_lj.append(0.5 * torch.sum(p["eps4"] * (s6 * s6 - s6),
                                            dim=(-2, -1)))
                e_el.append(0.5 * torch.sum(p["cq"] * inv1, dim=(-2, -1)))
            if need_force:
                coef = (p["eps24"] * (2.0 * s6 * s6 - s6)
                        + p["cq"] * inv1) * inv2
                forces.append(torch.stack(
                    [torch.sum(coef * dd, -1) for dd in (dx, dy, dz)],
                    -1).to(torch.float32))
        out_f = torch.cat(forces) if need_force else None
        out_e = ((torch.cat(e_lj), torch.cat(e_el)) if need_energy
                 else None)
        return out_f, out_e

    def forces(self, pos, ctl: Controls) -> torch.Tensor:
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            e, bias, _, _ = self._bonded(p, ctl, True, self.dtype)
            (g,) = torch.autograd.grad((e + bias).sum(), p)
        f, _ = self._pairs(pos, True, False, self.dtype)
        return f - g.to(torch.float32)

    def features(self, pos) -> Dict[str, torch.Tensor]:
        """u_base, u_elec, phi, psi per replica, in ``feature_dtype``."""
        w = self.feature_dtype
        with torch.no_grad():
            e, _, phi, psi = self._bonded(pos, None, False, w)
            _, (e_lj, e_el) = self._pairs(pos, False, True, w)
        return {"u_base": e + e_lj, "u_elec": e_el, "phi": phi, "psi": psi}

    def reduced(self, feats, ctl: Controls) -> torch.Tensor:
        """u(x_r; c_r) for each replica r under its control row."""
        w = feats["u_base"].dtype
        u = feats["u_base"] + feats["u_elec"]
        nu = self.grid.n_umbrella
        if nu:
            angles = torch.stack([feats["phi"], feats["psi"]], -1)[:, :nu]
            dev = wrap_deg(angles * DEG - ctl.center[:, :nu].to(w))
            u = u + torch.sum(ctl.k[:, :nu].to(w) * dev * dev, -1)
        return ctl.beta.to(w) * u

    def failed(self, feats) -> np.ndarray:
        """(R,) bool: replicas whose energy is not finite."""
        return ~torch.isfinite(feats["u_base"]).cpu().numpy()

    # -- the start and the propagate -----------------------------------------

    def init_state(self, seed: int):
        """The ensemble a run of ``seed`` starts from: (pos, vel, rng)."""
        n_rep = self.n_rep
        k_state, _, k_run = prng.split(prng.key(seed, self.device), 3)
        kpv = prng.split(prng.split(k_state, n_rep), 2)      # (R, 2, 2)
        n = self.sys.n_atoms
        z_pos = prng.normal(prng.bits(kpv[:, 0], 3 * n), self.dtype)
        z_vel = prng.normal(prng.bits(kpv[:, 1], 3 * n), self.dtype)
        base = torch.as_tensor(self.sys.base, device=self.device)
        pos = base + (z_pos.reshape(n_rep, n, 3)
                      * self.sys.jitter).to(torch.float32)
        var = torch.full_like(self.masses, AKMA * KB * self.t_init) \
            / self.masses
        vel = (torch.sqrt(var)[:, None].to(self.dtype)
               * z_vel.reshape(n_rep, n, 3)).to(torch.float32)
        return pos, vel, k_run

    def _noise(self, keys: torch.Tensor, i: int, n: int) -> torch.Tensor:
        """Iteration ``i``'s normals (R, N, 3) from per-replica keys."""
        k = prng.fold_in(keys, i)
        words = (prng.bits(k, 3 * n) if self.noise_layout == "stacked"
                 else prng.bits_legacy(k, 3 * n))
        return prng.normal(words, self.dtype).to(torch.float32).reshape(
            keys.shape[0], n, 3)

    def propagate(self, pos, vel, ctl: Controls, keys, steps: int):
        """``steps`` BAOAB steps of every replica; (pos, vel)."""
        m = self.masses[None, :, None]
        sigma = torch.sqrt(AKMA * KB * ctl.temperature[:, None]
                           / self.masses[None, :])[..., None]
        scale = self.o_scale * sigma
        dt = self.dt
        f = self.forces(pos, ctl)
        for i in range(steps):
            vel = vel + 0.5 * dt * AKMA * f / m                      # B
            pos = pos + 0.5 * dt * vel                               # A
            vel = self.c1 * vel + scale * self._noise(keys, i,
                                                      pos.shape[1])  # O
            pos = pos + 0.5 * dt * vel                               # A
            f = self.forces(pos, ctl)
            vel = vel + 0.5 * dt * AKMA * f / m                      # B
        return pos, vel
