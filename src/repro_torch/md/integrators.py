"""BAOAB Langevin integrator (Leimkuhler-Matthews) in AKMA-ish units.

positions Angstrom, velocities Angstrom/ps, masses amu, energies kcal/mol.
acceleration = F / m * AKMA  (AKMA = 418.4 converts kcal/mol/A/amu to A/ps^2).

The replica-major, force-sharing loop of the JAX package's
``md/integrators.py``: ``max_steps + 1`` iterations, one force evaluation
each, per-lane trail/lead masks so lanes with fewer steps stay frozen.
``max_steps`` is a Python int from the caller (reading it off the device
would synchronise with the host).  Noise is the same threefry stream the
JAX package draws: ``repro_torch.random`` for the pre-drawn stack of the
per-pass loop, ``md/noise.py`` for the fused loop.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.md import noise as NZ

AKMA = 418.4
KB = 0.0019872041  # kcal/mol/K


def maxwell_boltzmann(keys, masses, temperature: float, shape3):
    """(..., 2) keys -> (..., N, 3) thermal velocities at one temperature."""
    var = torch.full_like(masses, AKMA * KB * temperature) / masses
    return torch.sqrt(var)[..., None] * jr.normal(keys, shape3)


def decay(gamma: float, dt: float) -> float:
    """``exp(-gamma dt)`` as JAX forms it from Python floats: the
    argument rounded to float32, its exponential in float64 rounded once
    (a float32 value, as a Python float)."""
    return float(np.float32(math.exp(float(np.float32(-gamma * dt)))))


def baoab_scales(masses, temperature, dt: float, gamma: float):
    """The loop-invariant BAOAB coefficients: the O-step decay ``c1 =
    exp(-gamma dt)`` (a float32 value, as a Python float) and the
    (R, N, 1) thermal noise scale ``sqrt(1 - c1^2) * sigma(T, m)``."""
    c1 = torch.tensor(decay(gamma, dt), dtype=torch.float32)
    sigma = torch.sqrt(AKMA * KB * temperature[:, None]
                       / masses[None, :])[..., None]              # (R, N, 1)
    return float(c1), float(torch.sqrt(1 - c1 * c1)) * sigma


def baoab_step(pos, vel, rng, force_fn: Callable, masses, temperature,
               dt: float = 5e-4, gamma: float = 5.0):
    """One whole BAOAB step with two force evaluations, the unbatched
    oracle's step: ``rng`` (..., 2) keys and ``temperature`` (...,) for
    a (..., N, 3) state, leading axes batched (the vmap over replicas,
    written out).  The O-step scales are :func:`baoab_scales`' values,
    the association of ``sqrt(1 - c1^2) * sigma * noise`` included."""
    m = masses[..., None]
    f = force_fn(pos)
    vel = vel + 0.5 * dt * AKMA * f / m                      # B
    pos = pos + 0.5 * dt * vel                               # A
    c1, noise_scale = baoab_scales(masses, temperature.reshape(-1), dt,
                                   gamma)
    noise_scale = noise_scale.reshape(temperature.shape + m.shape)
    noise = jr.normal(rng, pos.shape[-2:])
    vel = c1 * vel + noise_scale * noise                     # O
    pos = pos + 0.5 * dt * vel                               # A
    f = force_fn(pos)
    vel = vel + 0.5 * dt * AKMA * f / m                      # B
    return pos, vel


def baoab_fused_iteration(i: int, pos, vel, f, noise_i, c1, noise_scale,
                          masses, n_steps, max_steps: int, dt: float,
                          box: float = 0.0):
    """ONE masked force-sharing BAOAB update given this iteration's
    force, noise block and scales.  Returns (pos, vel)."""
    # trailing half-B of step i-1: existed and was active iff i-1 < n
    trail = ((n_steps >= i) & (i >= 1))[:, None, None]
    # step i: leading half-B, A, O, A (its trailing B is the NEXT
    # iteration's force)
    lead = ((n_steps > i) & (i < max_steps))[:, None, None]
    return baoab_masked_update(pos, vel, f, noise_scale * noise_i, c1,
                               masses, trail, lead, dt, box)


def baoab_masked_update(pos, vel, f, noise, c1, masses, trail, lead,
                        dt: float, box: float = 0.0):
    """The B-A-O-A-B arithmetic of one iteration with pre-scaled noise:
    ``trail`` (R, 1, 1) applies the previous step's trailing half-B,
    ``lead`` the leading half-B + A O A of this step.  ``box > 0`` wraps
    the new positions into [0, box] (``jnp.mod``'s floor-mod, bitwise)
    before the select.  The fused kernel's plain version shares it."""
    m = masses[None, :, None]
    kick = 0.5 * dt * AKMA * f / m
    vel = torch.where(trail, vel + kick, vel)
    nvel = vel + kick                                        # B
    npos = pos + 0.5 * dt * nvel                             # A
    nvel = c1 * nvel + noise                                 # O
    npos = npos + 0.5 * dt * nvel                            # A
    if box > 0:
        npos = torch.remainder(npos, box)
    return torch.where(lead, npos, pos), torch.where(lead, nvel, vel)


def _baoab_apply(i: int, pos, vel, f, noise_i, masses, temperature,
                 n_steps, max_steps: int, dt: float, gamma: float,
                 box: float = 0.0):
    """One force-sharing BAOAB update over the whole replica stack.

    The force of a step's trailing half-B equals the force of the next
    step's leading half-B, so iteration i spends ONE force evaluation
    twice: the trailing half-B of step i-1 (masked for i == 0) and the
    leading half-B + A O A of step i (masked for i == max_steps)."""
    c1, noise_scale = baoab_scales(masses, temperature, dt, gamma)
    return baoab_fused_iteration(i, pos, vel, f, noise_i, c1, noise_scale,
                                 masses, n_steps, max_steps, dt, box)


def propagate_replica_major(state, force_fn: Callable, masses, temperature,
                            n_steps, rngs, max_steps: int,
                            dt: float = 5e-4, gamma: float = 5.0,
                            box: float = 0.0):
    """Pre-drawn noise + ``max_steps + 1`` force-sharing BAOAB iterations.
    ``state``: {"pos", "vel"} with leading replica axis; ``rngs``: (R, 2)
    per-replica keys; ``n_steps``: (R,) per-replica step counts; ``box``:
    the periodic box (0: none)."""
    out, _ = propagate_replica_major_aux(
        state, lambda pos, aux: (force_fn(pos), aux), (), masses,
        temperature, n_steps, rngs, max_steps, dt, gamma, box)
    return out


def propagate_replica_major_aux(state, force_aux_fn, aux, masses,
                                temperature, n_steps, rngs, max_steps: int,
                                dt: float = 5e-4, gamma: float = 5.0,
                                box: float = 0.0):
    """:func:`propagate_replica_major` for force fields that carry
    auxiliary state through the step loop.  Returns ({"pos", "vel"}, aux)."""
    noise = stacked_step_noise(rngs, max_steps + 1, state["pos"].shape[1:])
    pos, vel = state["pos"], state["vel"]
    for i in range(max_steps + 1):
        f, aux = force_aux_fn(pos, aux)
        pos, vel = _baoab_apply(i, pos, vel, f, noise[i], masses,
                                temperature, n_steps, max_steps, dt, gamma,
                                box)
    return {"pos": pos, "vel": vel}, aux


def propagate_replica_major_fused(state, force_aux_fn: Callable, aux,
                                  masses, temperature, n_steps, rngs,
                                  max_steps: int, dt: float = 5e-4,
                                  gamma: float = 5.0):
    """The fused-path propagate loop on plain tensors: the same
    ``max_steps + 1`` iterations and trail/lead masks as
    :func:`propagate_replica_major_aux`, with the O-step scales hoisted
    (:func:`baoab_scales`) and each iteration drawing its own noise block
    (``noise.step_noise_unrolled``, the legacy-layout stream the JAX
    fused path draws).  ``force_aux_fn(pos, aux) -> (force, aux)`` carries
    a force field's auxiliary state (the sparse path's neighbor list)
    through the loop.  Returns ({"pos", "vel"}, aux)."""
    c1, noise_scale = baoab_scales(masses, temperature, dt, gamma)
    shape = state["pos"].shape[1:]
    pos, vel = state["pos"], state["vel"]
    for i in range(max_steps + 1):
        f, aux = force_aux_fn(pos, aux)
        noise_i = NZ.step_noise_unrolled(rngs, i, shape)
        pos, vel = baoab_fused_iteration(i, pos, vel, f, noise_i, c1,
                                         noise_scale, masses, n_steps,
                                         max_steps, dt)
    return {"pos": pos, "vel": vel}, aux


def stacked_step_noise(rngs, max_steps: int, shape) -> torch.Tensor:
    """Pre-draw every step's noise: noise[t, r] = normal(fold_in(rngs[r],
    t), shape), as one wide draw -> (max_steps, R, *shape)."""
    ts = torch.arange(max_steps, dtype=torch.int64, device=rngs.device)
    keys = jr.fold_in(rngs[None, :, :], ts[:, None])            # (S, R, 2)
    return jr.normal(keys, shape)


def kinetic_temperature(vel, masses):
    ke = 0.5 * torch.sum(masses[..., None] * vel * vel, dim=(-2, -1)) / AKMA
    dof = 3 * masses.shape[-1]
    return 2.0 * ke / (dof * KB)
