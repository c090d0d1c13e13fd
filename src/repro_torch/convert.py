"""Carry state across from the JAX package into the port.

The MD functions take plain host arrays (anything ``np.asarray`` accepts,
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
from repro_torch.tree import tree_map


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


def _state_leaf(x, device) -> torch.Tensor:
    """One state leaf: integer and bool leaves keep their dtype (the
    neighbor list's int32 indices and counters), the rest is float32."""
    a = np.array(x)
    if a.dtype.kind in "iub":
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, device=device).to(torch.float32)


def ensemble_from_arrays(ens, rng_key_data, device) -> Ensemble:
    """The port's ``Ensemble`` from a JAX ``Ensemble`` (fields read with
    ``np.asarray``; ``state`` a dict of arrays, nested for the sparse
    path's ``nlist``) and its driver key's raw data,
    ``jax.random.key_data(ens.rng)`` (two uint32 words)."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), device=device).to(dtype)

    return Ensemble(
        state=tree_map(lambda x: _state_leaf(x, device), dict(ens.state)),
        assignment=t(ens.assignment, torch.int64),
        rng=t(np.asarray(rng_key_data).astype(np.int64), torch.int64),
        cycle=t(ens.cycle, torch.int64),
        debt=t(ens.debt, torch.float32),
        speed=t(ens.speed, torch.float32),
        alive=t(ens.alive, torch.bool),
        failures=t(ens.failures, torch.int64),
        relaunches=t(ens.relaunches, torch.int64),
    )


def _lm_leaf(x, device) -> torch.Tensor:
    """One leaf, same shape and dtype; bfloat16 (numpy's ml_dtypes, which
    torch cannot read) through float32, exactly."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_arrays(tree, device):
    """An LM parameter tree (nested dicts of host arrays, the JAX
    package's ``init_params`` output) as the port's, same keys, shapes
    and dtypes."""
    return tree_map(lambda x: _lm_leaf(x, device), dict(tree))


# an LM decode state (``index`` and the stacked ``cache``) and a training
# state (``{params, mu, nu, step[, err]}``, a train launcher's or
# ``LMEngine``'s stacked over replicas) convert leaf by leaf the same way
lm_state_from_arrays = lm_params_from_arrays
lm_train_state_from_arrays = lm_params_from_arrays
