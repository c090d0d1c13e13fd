"""The port's force passes against the JAX package's: the bonded and
nonbonded kernels' plain PyTorch versions against the Pallas kernels (in
interpret mode, as the JAX package's own tests run them) and against the
JAX oracles; the port's oracles against the JAX oracles.

Tolerance: float32, max |diff| <= 1e-5 x max(max |F|, 1) for forces and
1e-5 relative for energies — the same formulas in different summation
orders.  The kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chain_forces import ops as j_chain_ops
from repro.kernels.chain_forces import ref as j_chain_ref
from repro.kernels.lj_forces import ops as j_nb_ops
from repro.kernels.lj_forces import ref as j_nb_ref
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch.kernels import pad_to_block
from repro_torch.kernels.chain_forces import ops as chain_ops
from repro_torch.kernels.chain_forces import ref as chain_ref
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.kernels.lj_forces import ref as nb_ref
from repro_torch.md.system import base_positions

N_REP = 3
FORCE_TOL = 1e-5
ENERGY_RTOL = 1e-5


def _setup(n_atoms, seed=0):
    jsys = j_chain_molecule(n_atoms)
    tsys = convert.system_from_arrays(jsys, device="cpu")
    rng = np.random.default_rng(seed)
    # the JAX package's start geometry: the extended chain + 0.1 A jitter
    pos = (base_positions(tsys)[None]
           + 0.1 * rng.standard_normal((N_REP, n_atoms, 3))).astype(
               np.float32)
    return jsys, tsys, pos


def _close(got, want, what, energy=False):
    got, want = np.asarray(got), np.asarray(want)
    if energy:
        np.testing.assert_allclose(got, want, rtol=ENERGY_RTOL, atol=1e-5,
                                   err_msg=what)
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FORCE_TOL * scale, err_msg=what)


@pytest.mark.parametrize("n_atoms", [10, 22, 40])
def test_bonded_plain_matches_pallas_and_ref(n_atoms):
    jsys, tsys, pos = _setup(n_atoms)
    pack = chain_ops.build_pack(tsys)
    f_t, e_t = chain_ref.bonded_forces_sparse(torch.from_numpy(pos),
                                              pack.top, pack.slots)
    jpack = j_chain_ops.build_pack(jsys)
    f_k, e_k = j_chain_ops.bonded_forces(jnp.asarray(pos), jpack,
                                         use_kernel=True, interpret=True)
    f_r, e_r = j_chain_ref.bonded_forces(jnp.asarray(pos), jpack.top)
    for name, f_j, e_j in (("pallas", f_k, e_k), ("ref", f_r, e_r)):
        _close(f_t, f_j, f"bonded forces vs {name}")
        _close(e_t, e_j, f"bonded energy vs {name}", energy=True)


@pytest.mark.parametrize("n_atoms", [10, 22, 40])
def test_bonded_oracle_matches_ref(n_atoms):
    """The dense incidence form (the CPU path of MDEngine)."""
    jsys, tsys, pos = _setup(n_atoms, seed=1)
    f_t, e_t = chain_ops.bonded_forces(torch.from_numpy(pos),
                                       chain_ops.build_pack(tsys))
    f_r, e_r = j_chain_ref.bonded_forces(
        jnp.asarray(pos), j_chain_ref.chain_topology(jsys))
    _close(f_t, f_r, "dense bonded forces")
    _close(e_t, e_r, "dense bonded energy", energy=True)


def test_bonded_slots_match_jax():
    jsys, tsys, _ = _setup(22)
    t_slots = chain_ref.bonded_slots(chain_ref.chain_topology(tsys))
    j_slots = j_chain_ref.bonded_slots(j_chain_ref.chain_topology(jsys))
    assert t_slots.n_slots == j_slots.n_slots
    np.testing.assert_array_equal(t_slots.idx.numpy(),
                                  np.asarray(j_slots.idx))
    np.testing.assert_array_equal(t_slots.sign.numpy(),
                                  np.asarray(j_slots.sign))


def _nb_args(jsys):
    return (jsys.lj_sigma, jsys.lj_eps, jsys.charges, jsys.nb_mask)


@pytest.mark.parametrize("n_atoms", [10, 22, 40])
def test_nonbonded_plain_matches_pallas_and_ref(n_atoms):
    jsys, tsys, pos = _setup(n_atoms, seed=2)
    out_t = nb_ops.nonbonded_plain(torch.from_numpy(pos),
                                   nb_ops.build_pack(tsys))
    out_k = j_nb_ops.nonbonded_batched(jnp.asarray(pos), *_nb_args(jsys),
                                       interpret=True)
    out_r = j_nb_ref.nonbonded(jnp.asarray(pos), *_nb_args(jsys))
    names = ("f_lj", "f_el", "e_lj", "e_el")
    for name, out_j in (("pallas", out_k), ("ref", out_r)):
        for field, a, b in zip(names, out_t, out_j):
            _close(a, b, f"{field} vs {name}", energy=field.startswith("e"))


@pytest.mark.parametrize("salted", [False, True])
def test_nonbonded_oracle_and_force_match_ref(salted):
    jsys, tsys, pos = _setup(22, seed=3)
    pack = nb_ops.build_pack(tsys)
    tpos = torch.from_numpy(pos)
    for field, a, b in zip(("f_lj", "f_el", "e_lj", "e_el"),
                           nb_ref.nonbonded(tpos, pack.lj_sigma,
                                            pack.lj_eps, pack.charges,
                                            pack.nb_mask),
                           j_nb_ref.nonbonded(jnp.asarray(pos),
                                              *_nb_args(jsys))):
        _close(a, b, field, energy=field.startswith("e"))
    scale = np.linspace(0.6, 1.0, N_REP).astype(np.float32)
    f_t = nb_ops.nonbonded_force(
        tpos, pack, torch.from_numpy(scale) if salted else None)
    f_j = j_nb_ref.nonbonded_force(jnp.asarray(pos), *_nb_args(jsys),
                                   jnp.asarray(scale) if salted else None)
    _close(f_t, f_j, "combined nonbonded force")


def test_nonbonded_pack_layout():
    """The uint8 mask holds the f32 mask's 0/1 values, padded with zero
    columns to whole tiles; sqrt(eps) is the per-atom mixing row."""
    _, tsys, _ = _setup(40)
    pack = nb_ops.build_pack(tsys)
    assert pack.mask_u8.dtype == torch.uint8
    assert pack.mask_u8.shape == (40, pad_to_block(40, nb_ops.TILE))
    np.testing.assert_array_equal(pack.mask_u8[:, :40].numpy(),
                                  tsys.nb_mask.numpy().astype(np.uint8))
    assert int(pack.mask_u8[:, 40:].sum()) == 0
    np.testing.assert_array_equal(pack.sqrt_eps.numpy(),
                                  np.sqrt(tsys.lj_eps.numpy()))


def test_plain_versions_match_oracles():
    """Each kernel's plain version agrees with the port's own oracle."""
    _, tsys, pos = _setup(40, seed=4)
    tpos = torch.from_numpy(pos)
    cpack = chain_ops.build_pack(tsys)
    for a, b in zip(chain_ref.bonded_forces_sparse(tpos, cpack.top,
                                                   cpack.slots),
                    chain_ref.bonded_forces(tpos, cpack.top)):
        _close(a, b, "bonded plain vs dense")
    npack = nb_ops.build_pack(tsys)
    for a, b in zip(nb_ops.nonbonded_plain(tpos, npack),
                    nb_ref.nonbonded(tpos, npack.lj_sigma, npack.lj_eps,
                                     npack.charges, npack.nb_mask)):
        _close(a, b, "nonbonded plain vs rowsum oracle")


def test_kernels_take_no_cpu_tensor():
    """The kernel wrappers never fall back: a CPU stack raises there,
    and only the MD-facing entry points route it to the oracles."""
    _, tsys, pos = _setup(22, seed=5)
    tpos = torch.from_numpy(pos)
    with pytest.raises(ValueError, match="CUDA tensor"):
        chain_ops.chain_forces_batched(tpos, chain_ops.build_pack(tsys))
    with pytest.raises(ValueError, match="CUDA tensor"):
        nb_ops.nonbonded_batched(tpos, nb_ops.build_pack(tsys))
