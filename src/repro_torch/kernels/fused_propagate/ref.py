"""PyTorch oracle for ONE fused BAOAB iteration.

Composes the port's reference math — ``chain_forces.ref`` bonded
gradients (with the umbrella torque), ``lj_forces.ref`` nonbonded force
(with the salt scale folded into its coefficients) and the shared
``integrators.baoab_fused_iteration`` update — into the (force
evaluation, masked update) pair every fused-path iteration performs, as
the JAX package's ``fused_propagate/ref.py`` does.
"""
from __future__ import annotations

from repro_torch.kernels.chain_forces import ref as chain_ref
from repro_torch.kernels.lj_forces import ref as nb_ref
from repro_torch.md import integrators as I


def fused_iteration_ref(i: int, pos, vel, noise_i, system, ctrl, n_steps,
                        max_steps: int, dt: float, gamma: float, top=None):
    """One fused iteration on the replica stack: the full analytic force
    at ``pos``, then the masked force-sharing BAOAB update with iteration
    index ``i`` and this iteration's (unscaled) noise block.

    ``ctrl`` rows: ``temperature`` (required), optional
    ``umbrella_center`` / ``umbrella_k`` / ``salt`` as the engine
    consumes them.  Returns (pos, vel)."""
    top = chain_ref.chain_topology(system) if top is None else top
    salt = ctrl.get("salt")
    salt_scale = None if salt is None else 1.0 - 0.5 * salt
    f, _ = chain_ref.bonded_forces(pos, top, ctrl.get("umbrella_center"),
                                   ctrl.get("umbrella_k"))
    f = f + nb_ref.nonbonded_force(pos, system.lj_sigma, system.lj_eps,
                                   system.charges, system.nb_mask,
                                   salt_scale)
    c1, noise_scale = I.baoab_scales(system.masses, ctrl["temperature"],
                                     dt, gamma)
    return I.baoab_fused_iteration(i, pos, vel, f, noise_i, c1, noise_scale,
                                   system.masses, n_steps, max_steps, dt)
