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


# -- the all-pairs kernel's schedule and arithmetic (csrc/nonbonded.cu) ------
#
# The kernel runs only on the card; what can be checked here is the host's
# schedule table it walks and its pair arithmetic, emulated in float32.
# Tolerances as chip_smoke.py holds the kernel to its plain version:
# forces max |diff| / max |want| <= 1e-4, energies relative <= 1e-5.
TOL_NB_FORCE, TOL_NB_ENERGY = 1e-4, 1e-5


def _decode(table):
    """(round, I, J) of every entry of a round table."""
    out = []
    for u, row in enumerate(table.tolist()):
        out += [(u, e & 0xFFFF, e >> 16) for e in row if e >= 0]
    return out


@pytest.mark.parametrize("n_atoms", [8, 130, 257, 864, 2881, 10000])
def test_tile_schedule_visits_each_tile_pair_once(n_atoms):
    """Every unordered tile pair, the diagonal included, is in exactly one
    round; no tile is twice in a round; the blocks of any split run
    disjoint sets of whole rounds that cover the table."""
    ld = pad_to_block(n_atoms, nb_ops.TILE)
    nt = ld // nb_ops.PAIR_TILE
    table = nb_ops.tile_schedule(nt, "cpu")
    assert table.dtype == torch.int32 and table.shape == (nt, nt)
    entries = _decode(table)
    pairs = sorted((i, j) for _, i, j in entries)
    assert pairs == [(i, j) for i in range(nt) for j in range(i, nt)]
    for u in range(nt):
        tiles = [t for v, i, j in entries if v == u
                 for t in ((i,) if i == j else (i, j))]
        assert len(tiles) == len(set(tiles)) == nt
    for n_rep, waves in ((1, 1), (4, 1), (64, 1), (64, 2), (384, 1)):
        split = nb_ops.block_split(n_rep, nt, waves)
        rounds = [u for s in range(split) for u in range(s, nt, split)]
        assert sorted(rounds) == list(range(nt))
    assert nb_ops.tile_schedule(nt, "cpu") is table       # built once


def test_block_split_and_row_layout():
    """One wave of blocks at about 24 warps per SM: the main paths' splits,
    and where the chain kernel's partial rows live (no ceiling on N: above
    the shared memory they go to device memory)."""
    assert nb_ops.block_split(64, 2944 // 64) == 2       # chain, N = 2881
    assert nb_ops.block_split(384, 2944 // 64) == 1
    assert nb_ops.block_split(64, 896 // 64) == 7
    assert nb_ops.block_split(64, 896 // 64, waves=2) == 14  # fluid, N = 864
    assert nb_ops.block_split(1, 2) == 2
    assert nb_ops.rows_in_shared(2944)
    assert nb_ops.rows_in_shared(8064)
    assert not nb_ops.rows_in_shared(8192)               # N = 10000


def _each_pair_once(pos, pack, rinv_err=0.0):
    """The kernel's arithmetic in float32, each unordered pair once:
    rinv = rsqrt(r2) (times 1 + rinv_err), inv_r2 = rinv^2, tt = sig^2
    inv_r2, s6 = tt^3, u = s6^2 - s6; eps and qq times the 0/1 mask m and
    r2 + (1 - m); F_i += c d, F_j -= c d; the factors 24, 4 and COULOMB
    applied to the finished sums."""
    n = pos.shape[-2]
    i, j = torch.triu_indices(n, n, 1)
    d = pos[:, i] - pos[:, j]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    m = pack.nb_mask[i, j]
    r2 = dx * dx + dy * dy + dz * dz + (1.0 - m)
    ee = pack.sqrt_eps[i] * pack.sqrt_eps[j] * m
    qq = pack.charges[i] * pack.charges[j] * m
    rinv = torch.rsqrt(r2) * np.float32(1.0 + rinv_err)
    inv_r2 = rinv * rinv
    sig = 0.5 * pack.lj_sigma[i] + 0.5 * pack.lj_sigma[j]
    tt = sig * sig * inv_r2
    s6 = tt * (tt * tt)
    u = s6 * s6 - s6
    qr = qq * rinv
    c_lj = ee * (u + s6 * s6) * inv_r2
    c_el = qr * inv_r2

    def rows(c):
        f = torch.zeros_like(pos)
        f.index_add_(1, i, c[..., None] * d)
        f.index_add_(1, j, -c[..., None] * d)
        return f

    return (24.0 * rows(c_lj), nb_ref.COULOMB * rows(c_el),
            4.0 * torch.sum(ee * u, -1), nb_ref.COULOMB * torch.sum(qr, -1))


# rsqrt.approx is within 2^-22.9 of 1 / sqrt(x); with that error on every
# pair and of one sign (the worst case for the sums) the energies stay
# within TOL_NB_ENERGY.  Held against the JAX kernel, the kernel's plain
# version (the direct pair sums chip_smoke.py holds the kernel to) and
# that plain version in float64.  Not against the rowsum oracle
# (ref.nonbonded): its rowsum(c) x - c @ x form cancels, 1.0e-4 of
# max |F_el| from the float64 sums at N = 257, where this emulation is
# 1.7e-6 from them.
@pytest.mark.parametrize("rinv_err", [0.0, 2.0 ** -22.9, -2.0 ** -22.9])
@pytest.mark.parametrize("n_atoms", [130, 257])
def test_each_pair_once_arithmetic_matches_jax(n_atoms, rinv_err):
    jsys, tsys, pos = _setup(n_atoms, seed=6)
    pack = nb_ops.build_pack(tsys)
    tpos = torch.from_numpy(pos)
    got = _each_pair_once(tpos, pack, rinv_err)
    pack64 = nb_ops.NonbondedPack(*[
        t.double() if t.dtype == torch.float32 else t for t in pack])
    wants = {"pallas": j_nb_ops.nonbonded_batched(
                 jnp.asarray(pos), *_nb_args(jsys), interpret=True),
             "plain": nb_ops.nonbonded_plain(tpos, pack),
             "plain float64": nb_ops.nonbonded_plain(tpos.double(), pack64)}
    for name, want in wants.items():
        for field, a, b in zip(("f_lj", "f_el", "e_lj", "e_el"), got, want):
            a, b = np.asarray(a), np.asarray(b)
            if field.startswith("f"):
                err = np.abs(a - b).max() / np.abs(b).max()
                assert err <= TOL_NB_FORCE, (name, field, err)
            else:
                err = (np.abs(a - b) / np.abs(b)).max()
                assert err <= TOL_NB_ENERGY, (name, field, err)
