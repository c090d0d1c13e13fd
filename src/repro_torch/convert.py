"""Carry state across from the JAX package into the port.

Both functions take plain host arrays (anything ``np.asarray`` accepts,
JAX arrays included), so the port imports nothing of JAX: the caller
hands over ``jax.random.key_data(ens.rng)`` for the driver key.  The
caller names the device: like every entry point of the port, nothing
here lands on the CPU unless asked.  The
tests use them to run both packages from identical state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ensemble import Ensemble
from repro_torch.md.system import MolecularSystem


def system_from_arrays(src, device) -> MolecularSystem:
    """The port's ``MolecularSystem`` from any object with the JAX
    package's ``MolecularSystem`` fields (each read with ``np.asarray``)."""
    kwargs = {}
    for f in dataclasses.fields(MolecularSystem):
        v = getattr(src, f.name)
        if f.name in ("n_atoms", "phi_quad", "psi_quad"):
            kwargs[f.name] = (int(v) if f.name == "n_atoms"
                              else tuple(int(i) for i in v))
            continue
        a = np.array(v)
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) \
            else torch.float32
        kwargs[f.name] = torch.as_tensor(a, dtype=dtype, device=device)
    return MolecularSystem(**kwargs)


def ensemble_from_arrays(ens, rng_key_data, device) -> Ensemble:
    """The port's ``Ensemble`` from a JAX ``Ensemble`` (fields read with
    ``np.asarray``; ``state`` a dict of arrays) and its driver key's raw
    data, ``jax.random.key_data(ens.rng)`` (two uint32 words)."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), device=device).to(dtype)

    return Ensemble(
        state={k: t(v, torch.float32) for k, v in ens.state.items()},
        assignment=t(ens.assignment, torch.int64),
        rng=t(np.asarray(rng_key_data).astype(np.int64), torch.int64),
        cycle=t(ens.cycle, torch.int64),
        debt=t(ens.debt, torch.float32),
        speed=t(ens.speed, torch.float32),
        alive=t(ens.alive, torch.bool),
        failures=t(ens.failures, torch.int64),
        relaunches=t(ens.relaunches, torch.int64),
    )
