"""PyTorch oracle for the (R x C) cross-energy matrix:

    u[i, c] = beta_c * ( u_base_i
                       + (1 - 0.5 salt_c) * u_elec_i
                       + sum_a k_c[a] * wrap(angle_i[a] - center_c[a])^2 )

angles in degrees, wrap to [-180, 180) with ``jnp.mod``'s convention.
The JAX package's ``exchange_matrix/ref.py``, term for term; it is also
the kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import wrap_deg


def exchange_matrix(features, ctrl) -> torch.Tensor:
    """``features``: (R,) rows u_base, u_elec, phi, psi (radians);
    ``ctrl``: (C,) beta, optional salt, (C, U) umbrella rows."""
    phi = torch.rad2deg(features["phi"])[:, None]        # (R, 1)
    psi = torch.rad2deg(features["psi"])[:, None]
    beta = ctrl["beta"][None, :]                         # (1, C)
    salt = ctrl.get("salt")
    center = ctrl.get("umbrella_center")                 # (C, U) or absent
    k = ctrl.get("umbrella_k")
    scale = 1.0 - 0.5 * (salt[None, :] if salt is not None else 0.0)
    u = features["u_base"][:, None] + scale * features["u_elec"][:, None]
    n_u = center.shape[1] if center is not None else 0
    for a, angle in enumerate([phi, psi][:n_u]):
        d = wrap_deg(angle - center[None, :, a])
        u = u + k[None, :, a] * d * d
    return beta * u
