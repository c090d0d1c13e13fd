"""The CUDA kernels on the card: each against its plain PyTorch version,
at atom counts that are not whole tiles, plus the wrappers' contracts
(one count per launch, no fallback to a plain version, bitwise repeats)
and the main path on the card against the CPU.

Every test here needs an NVIDIA GPU and nvcc; without CUDA they skip.
This file imports nothing of JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: forces within 1e-5 x max(max |F|, 1), energies 1e-5 relative
(the same formulas summed in another order); one fused iteration within
1e-5 A and 1e-4 A/ps (its force, with those errors, enters the velocity
through dt * AKMA / m); the exchange matrix bitwise (built without FMA
contraction).  The sparse kernel is held to its plain version like the
nonbonded kernel; the neighbor-list build kernels bitwise, in both states
of its device flag (they form r2 without FMA contraction), on the chain
and on a random gas.  The fused kernel past its shared-memory rows (N =
16,384 and 20,000) within 1e-6 and 1e-4 of max |plain| in positions and
velocities, as ``chip_smoke.py`` phase 7 holds it.  The LJ fluid
kernels are held to their plain versions like the nonbonded kernel, the
gradient of ``LJEnergy`` bitwise to minus the forces kernel.  The flash
attention kernel per element within 5e-5 of max |out| of its plain
version (the online softmax sums in another order), plus in bfloat16 one
rounding step, 2^-7 of the element (each side rounds its float32 value
once), with and without the softcap; one launch per layer of a prefill
and none in decode, on the "bf16_tc" variant for bfloat16 and "f32" for
float32; a softcapped prefill on the card within 1e-4 of max |logit| of
the CPU's plain attention (float32: the same formulas summed in another
order).  The driver's sixth slice: Mode II (three waves, the last padded)
bitwise Mode I on both patterns; an asynchronous run with injected
failures resumed from a checkpoint bitwise; the same run's decisions and
failures as the CPU's; the oracle force paths ("batched", "vmap") within
1e-3 A of "pallas" after 5 steps.  The seventh slice: the cell-build
kernels bitwise their plain version (``ref.build_cells``) on the chain at
R = 1, 4 and 384, on a chain whose cells overflow their capacity and on
gases at the LJ fluid's density (6,000, 16,385 and 20,000 atoms: six,
nine and ten bin blocks), in both states of the flag; the cell path through its
kernels under the sync guard and making the CPU's decisions; telemetry on
and off bitwise on the card (the probes' launches only), its counters
the CPU's; the ``repex_run`` CLI's report.
"""
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.kernels.chain_forces import ops as chain_ops
from repro_torch.kernels.exchange_matrix import ops as x_ops
from repro_torch.kernels.exchange_matrix import ref as x_ref
from repro_torch.kernels.fused_propagate import ops as fused_ops
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.kernels.nlist_build import ops as nl_ops
from repro_torch.md import MDEngine
from repro_torch.md.system import base_positions, chain_molecule

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


def _close(got, want, energy=False):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if energy:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def _state(n_atoms, n_rep, seed=0):
    sysm = chain_molecule(n_atoms).to("cuda")
    rng = np.random.default_rng(seed)
    pos = (base_positions(sysm)[None]
           + 0.1 * rng.standard_normal((n_rep, n_atoms, 3))).astype(
               np.float32)
    return sysm, torch.from_numpy(pos).cuda()


# the main path's shape, and one N whose nonbonded partial force rows no
# longer fit in shared memory (they go to device memory: no ceiling on N)
@pytest.mark.parametrize("n_atoms,n_rep", [
    (8, 1), (8, 3), (130, 1), (130, 3), (257, 1), (257, 3), (2881, 64),
    (10000, 1)])
def test_kernels_match_plain_versions(n_atoms, n_rep):
    sysm, pos = _state(n_atoms, n_rep)
    cpack = chain_ops.build_pack(sysm)
    for a, b in zip(chain_ops.chain_forces_batched(pos, cpack),
                    chain_ops.ref.bonded_forces_sparse(pos, cpack.top,
                                                       cpack.slots)):
        _close(a, b, energy=a.ndim == 1)
    npack = nb_ops.build_pack(sysm)
    for a, b in zip(nb_ops.nonbonded_batched(pos, npack),
                    nb_ops.nonbonded_plain(pos, npack)):
        _close(a, b, energy=a.ndim == 1)


def test_each_launch_counts_once_and_repeats_bitwise():
    sysm, pos = _state(257, 2)
    cpack, npack = chain_ops.build_pack(sysm), nb_ops.build_pack(sysm)
    for lib, call in ((chain_ops.LIBRARY,
                       lambda: chain_ops.chain_forces_batched(pos, cpack)),
                      (nb_ops.LIBRARY,
                       lambda: nb_ops.nonbonded_batched(pos, npack))):
        n0 = lib.launches
        first, second = call(), call()
        assert lib.launches == n0 + 2
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take():
    sysm, pos = _state(130, 2)
    cpack, npack = chain_ops.build_pack(sysm), nb_ops.build_pack(sysm)
    for bad in (pos.double(), pos[:, :-1]):
        with pytest.raises(ValueError):
            chain_ops.chain_forces_batched(bad, cpack)
        with pytest.raises(ValueError):
            nb_ops.nonbonded_batched(bad, npack)


def _run(device, n_cycles=4, chunk=2, n_atoms=64, rungs=8):
    cfg = RepExConfig(dimensions=(("temperature", rungs),),
                      md_steps_per_cycle=5, n_cycles=n_cycles)
    drv = REMDDriver(MDEngine(chain_molecule(n_atoms), device=device), cfg,
                     device=device)
    ens = drv.run_fused(drv.init(0), chunk_cycles=chunk)
    return drv, ens


def test_main_path_never_reaches_a_plain_version(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((chain_ops.ref, "bonded_forces"),
                      (chain_ops.ref, "bonded_forces_sparse"),
                      (nb_ops.ref, "nonbonded"),
                      (nb_ops.ref, "nonbonded_force"),
                      (nb_ops, "nonbonded_plain")):
        monkeypatch.setattr(mod, name, boom)
    n0 = (chain_ops.LIBRARY.launches, nb_ops.LIBRARY.launches)
    drv, _ = _run("cuda", n_cycles=3)
    evals = 3 * (drv.cfg.md_steps_per_cycle + 1)
    assert chain_ops.LIBRARY.launches == n0[0] + evals
    assert nb_ops.LIBRARY.launches == n0[1] + evals


def test_card_and_cpu_make_the_same_decisions():
    gpu, gpu_ens = _run("cuda")
    cpu, cpu_ens = _run("cpu")
    for hg, hc in zip(gpu.history, cpu.history):
        np.testing.assert_array_equal(hg["assignment"], hc["assignment"])
    assert gpu.acceptance_ratios() == cpu.acceptance_ratios()
    np.testing.assert_allclose(gpu_ens.state["pos"].cpu().numpy(),
                               cpu_ens.state["pos"].numpy(), atol=1e-4)


def test_chunk_size_invariance_on_the_card():
    runs = {k: _run("cuda", chunk=k) for k in (1, 4)}
    for h1, h4 in zip(runs[1][0].history, runs[4][0].history):
        np.testing.assert_array_equal(h1["assignment"], h4["assignment"])
    assert torch.equal(runs[1][1].state["pos"], runs[4][1].state["pos"])


def _bias(n_rep, n_u, seed=1):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.uniform(0, 360, (n_rep, n_u)).astype(
        np.float32)).cuda()
    k = torch.full((n_rep, n_u), 0.02, device="cuda")
    return c, k


@pytest.mark.parametrize("n_u", [1, 2])
def test_bonded_bias_variant_matches_plain_version(n_u):
    sysm, pos = _state(257, 3)
    cpack = chain_ops.build_pack(sysm)
    c, k = _bias(3, n_u)
    got = chain_ops.chain_forces_batched(
        pos, cpack, chain_ops.pack_bias(c, k, 3, "cuda"))
    want = chain_ops.ref.bonded_forces_sparse(pos, cpack.top, cpack.slots,
                                              c, k)
    for a, b in zip(got, want):
        _close(a, b, energy=a.ndim == 1)
    plain = chain_ops.chain_forces_batched(pos, cpack)
    assert float((plain[0] - got[0]).abs().max()) > 1e-4


def _fused_args(n_atoms, n_rep, bias, salt, seed=0):
    sysm, pos = _state(n_atoms, n_rep, seed)
    rng = np.random.default_rng(seed + 7)
    vel = torch.from_numpy(rng.standard_normal(
        (n_rep, n_atoms, 3)).astype(np.float32)).cuda()
    noise = 0.01 * torch.from_numpy(rng.standard_normal(
        (n_rep, n_atoms, 3)).astype(np.float32)).cuda()
    n_steps = torch.tensor([2, 1, 0][:n_rep] + [2] * max(n_rep - 3, 0),
                           device="cuda")
    salt_col = (torch.from_numpy(rng.uniform(0.5, 1, n_rep).astype(
        np.float32)).cuda() if salt else torch.ones(n_rep, device="cuda"))
    b = (chain_ops.pack_bias(*_bias(n_rep, 2), n_rep, "cuda") if bias
         else None)
    return (pos, vel, noise, b, chain_ops.build_pack(sysm),
            nb_ops.build_pack(sysm), sysm.masses, n_steps, salt_col)


@pytest.mark.parametrize("i", [0, 1, 2])
@pytest.mark.parametrize("bias,salt", [(False, False), (True, False),
                                       (False, True), (True, True)])
@pytest.mark.parametrize("n_atoms", [130, 257, 700])
def test_fused_kernel_matches_plain_version(n_atoms, bias, salt, i):
    pos, vel, noise, b, cp, npk, m, n_steps, salt_col = _fused_args(
        n_atoms, 3, bias, salt)
    st = fused_ops.step_par(i, n_steps, 2, salt_col)
    args = (pos, vel, noise, st, b, cp, npk, m, 0.9975, 5e-4)
    got = fused_ops.fused_baoab_batched(*args)
    want = fused_ops.fused_iteration_plain(*args)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=0, atol=1e-4)
    # lane 2 takes no step (n_steps = 0): left exactly as it was
    assert torch.equal(got[0][2], pos[2]) and torch.equal(got[1][2], vel[2])


# (200, 130), one element, the TSU grid, and widths that end a 128-thread
# column block ragged: 131 and 385.  The staged design (on no path; its
# 16-byte stores need C % 4 == 0, else it stores floats) equals the kernel
# on each, its launches not counted.
@pytest.mark.parametrize("r,c", [(200, 130), (1, 1), (384, 384), (200, 131),
                                 (3, 385)])
@pytest.mark.parametrize("n_u,salt", [(0, False), (1, True), (2, True)])
def test_exchange_matrix_kernel_matches_plain_version_bitwise(n_u, salt, r,
                                                              c):
    rng = np.random.default_rng(n_u)
    feats = {k: torch.from_numpy(v.astype(np.float32)).cuda() for k, v in (
        ("u_base", rng.normal(-50, 30, r)), ("u_elec", rng.normal(-200, 40, r)),
        ("phi", rng.uniform(-np.pi, np.pi, r)),
        ("psi", rng.uniform(-np.pi, np.pi, r)))}
    ctrl = {"beta": torch.from_numpy(rng.uniform(1.3, 1.9, c).astype(
        np.float32)).cuda()}
    if salt:
        ctrl["salt"] = torch.rand(c, device="cuda")
    if n_u:
        ctrl["umbrella_center"] = 360 * torch.rand(c, n_u, device="cuda")
        ctrl["umbrella_k"] = torch.full((c, n_u), 0.02, device="cuda")
    n0 = x_ops.LIBRARY.launches
    got = x_ops.exchange_matrix(feats, ctrl)
    assert x_ops.LIBRARY.launches == n0 + 1
    assert torch.equal(got, x_ref.exchange_matrix(feats, ctrl))
    staged = x_ops.exchange_matrix_staged(x_ops.pack_features(feats),
                                          x_ops.pack_ctrl(ctrl))
    assert x_ops.LIBRARY.launches == n0 + 1
    assert torch.equal(staged, got)


def _tsu_run(device, scheme, n_cycles=3, chunk=3, n_atoms=64,
             path="fused"):
    cfg = RepExConfig(dimensions=(("temperature", 2), ("umbrella", 2),
                                  ("umbrella", 2)),
                      md_steps_per_cycle=4, n_cycles=n_cycles,
                      exchange_scheme=scheme)
    drv = REMDDriver(MDEngine(chain_molecule(n_atoms), force_path=path,
                              device=device), cfg, device=device)
    ens = drv.run_fused(drv.init(0), chunk_cycles=chunk)
    return drv, ens


def test_fused_path_launches_only_the_fused_and_matrix_kernels():
    libs = (chain_ops.LIBRARY, nb_ops.LIBRARY, fused_ops.LIBRARY,
            x_ops.LIBRARY)
    n0 = [lib.launches for lib in libs]
    drv, _ = _tsu_run("cuda", "matrix")
    moved = [lib.launches - n for lib, n in zip(libs, n0)]
    assert moved == [0, 0, 3 * 5, 3]


@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
def test_fused_path_card_and_cpu_make_the_same_decisions(scheme):
    gpu, gpu_ens = _tsu_run("cuda", scheme, n_cycles=4, chunk=2)
    cpu, cpu_ens = _tsu_run("cpu", scheme, n_cycles=4, chunk=2)
    for hg, hc in zip(gpu.history, cpu.history):
        np.testing.assert_array_equal(hg["assignment"], hc["assignment"])
    assert gpu.acceptance_ratios() == cpu.acceptance_ratios()
    np.testing.assert_allclose(gpu_ens.state["pos"].cpu().numpy(),
                               cpu_ens.state["pos"].numpy(), atol=1e-4)


def test_fused_path_chunk_size_invariance_on_the_card():
    runs = {k: _tsu_run("cuda", "matrix", n_cycles=3, chunk=k)
            for k in (1, 3)}
    for h1, h3 in zip(runs[1][0].history, runs[3][0].history):
        np.testing.assert_array_equal(h1["assignment"], h3["assignment"])
    assert torch.equal(runs[1][1].state["pos"], runs[3][1].state["pos"])


# -- the sparse neighbor-list path -----------------------------------------

def _sparse_engine(device, n_atoms=64, path="fused", **kw):
    return MDEngine(chain_molecule(n_atoms), force_path=path,
                    nonbonded="sparse", bonded="sparse", device=device, **kw)


def _sparse_state(n_atoms, n_rep, seed=0, **kw):
    """A real list: ``init_state``, then positions moved far enough that
    some listed pairs lie past the cutoff (padded slots occur anyway)."""
    eng = _sparse_engine("cuda", n_atoms, **kw)
    state = eng.init_state(jr.key(seed, "cuda"), n_rep)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pos = state["pos"] + 0.4 * torch.randn(state["pos"].shape, device="cuda",
                                           generator=gen)
    return eng, pos, state["nlist"]


@pytest.mark.parametrize("n_atoms", [64, 257])
@pytest.mark.parametrize("n_rep", [1, 3])
def test_sparse_kernel_matches_plain_version(n_atoms, n_rep):
    eng, pos, nl = _sparse_state(n_atoms, n_rep)
    pk = eng._nb_pack
    args = (pos, pk, nl["idx"], nl["valid"], eng.cutoff)
    n0 = nb_ops.SPARSE_LIBRARY.launches
    got = nb_ops.nonbonded_sparse_batched(*args)
    assert nb_ops.SPARSE_LIBRARY.launches == n0 + 1
    plain = nb_ops.ref.nonbonded_sparse(pos, pk.lj_sigma, pk.lj_eps,
                                        pk.charges, nl["idx"], nl["valid"],
                                        eng.cutoff)
    for a, b in zip(got, plain):
        _close(a, b, energy=a.ndim == 1)
    salt = torch.linspace(0.5, 1.0, n_rep, device="cuda")
    f_lj, f_el, _, _ = plain
    _close(nb_ops.nonbonded_force_sparse(*args, salt_scale=salt),
           f_lj + salt[:, None, None] * f_el)
    assert torch.equal(nb_ops.nonbonded_sparse_batched(*args)[0], got[0])


@pytest.mark.parametrize("k_max", [None, 4])
def test_build_kernel_equals_plain_build_bitwise(k_max):
    eng, pos, nl = _sparse_state(257, 3, k_max=k_max)
    old = (nl["idx"], nl["valid"])
    mask = eng._nb_pack.mask_bits
    flags = {"off": torch.zeros(1, dtype=torch.int32, device="cuda"),
             "on": torch.ones(1, dtype=torch.int32, device="cuda"),
             "rows": torch.tensor([1, 0, 1], dtype=torch.int32,
                                  device="cuda")}
    for name, flag in flags.items():
        got = nl_ops.nlist_build_batched(pos, flag, old, mask, eng.r_list,
                                         eng.k_max)
        want = nl_ops.build_gated_plain(pos, flag, old,
                                        eng._nb_pack.nb_mask, eng.r_list,
                                        eng.k_max)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    kept = nl_ops.nlist_build_batched(pos, flags["off"], old, mask,
                                      eng.r_list, eng.k_max)
    assert torch.equal(kept[0], old[0]) and torch.equal(kept[1], old[1])
    assert kept[0].data_ptr() != old[0].data_ptr()          # out of place
    built = nl_ops.nlist_build_batched(pos, flags["on"], old, mask,
                                       eng.r_list, eng.k_max)
    assert (int(built[2].sum()) > 0) == (k_max == 4)


def _gas(n_atoms, n_rep, box, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, box, (n_rep, n_atoms, 3)).astype(
        np.float32)).cuda()


# The chain at the TSU grid's R = 384 and at R = 4, and a random gas (no
# locality: many more candidate tiles), each with both flags and a flag
# row; every call counted once.
@pytest.mark.parametrize("kind,n_atoms,n_rep", [
    ("chain", 2881, 4), ("chain", 2881, 384), ("gas", 2881, 4),
    ("gas", 1000, 3)])
def test_build_kernels_equal_plain_build_bitwise(kind, n_atoms, n_rep):
    eng = _sparse_engine("cuda", n_atoms)
    if kind == "chain":
        pos = eng.init_state(jr.key(0, "cuda"), n_rep)["pos"]
    else:
        pos = _gas(n_atoms, n_rep, 60.0)
    pk = eng._nb_pack
    old = nl_ops.build_gated_plain(_gas(n_atoms, n_rep, 60.0, seed=1), None,
                                   None, pk.nb_mask, eng.r_list,
                                   eng.k_max)[:2]
    flags = (torch.zeros(1, dtype=torch.int32, device="cuda"),
             torch.ones(1, dtype=torch.int32, device="cuda"),
             (torch.arange(n_rep, device="cuda") % 2).to(torch.int32))
    for flag in flags:
        n0 = nl_ops.LIBRARY.launches
        got = nl_ops.build_gated(pos, flag, old, pk, eng.r_list, eng.k_max)
        assert nl_ops.LIBRARY.launches == n0 + 1
        want = nl_ops.build_gated_plain(pos, flag, old, pk.nb_mask,
                                        eng.r_list, eng.k_max)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (kind, flag.tolist())
    assert int(want[0].lt(n_atoms).sum()) > 0


def _permuted_chain(n_atoms, seed=0):
    """chain_molecule with its atoms relabelled at random: a topology with
    no locality in the atom order."""
    import dataclasses
    sysm = chain_molecule(n_atoms)
    perm = np.random.default_rng(seed).permutation(n_atoms)
    new_of = torch.from_numpy(np.argsort(perm))     # old label -> new label
    p = torch.from_numpy(perm)
    return dataclasses.replace(
        sysm, masses=sysm.masses[p], bonds=new_of[sysm.bonds],
        angles=new_of[sysm.angles], dihedrals=new_of[sysm.dihedrals],
        charges=sysm.charges[p], lj_sigma=sysm.lj_sigma[p],
        lj_eps=sysm.lj_eps[p], nb_mask=sysm.nb_mask[p][:, p],
        phi_quad=tuple(int(new_of[a]) for a in sysm.phi_quad),
        psi_quad=tuple(int(new_of[a]) for a in sysm.psi_quad)), perm


@pytest.mark.parametrize("bias", [False, True])
def test_bonded_kernel_on_a_permuted_topology(bias):
    sysm, perm = _permuted_chain(700)
    pos = _state(700, 3)[1][:, torch.from_numpy(perm).cuda()].contiguous()
    cpack = chain_ops.build_pack(sysm.to("cuda"))
    center, k = _bias(3, 2) if bias else (None, None)
    b = chain_ops.pack_bias(center, k, 3, "cuda") if bias else None
    got = chain_ops.chain_forces_batched(pos, cpack, b)
    want = chain_ops.ref.bonded_forces_sparse(pos, cpack.top, cpack.slots,
                                              center, k)
    _close(got[0], want[0])
    _close(got[1], want[1], energy=True)


@pytest.mark.parametrize("n_atoms,variant", [(2881, "rows_shared"),
                                             (16384, "rows_l2"),
                                             (20000, "rows_l2")])
def test_fused_kernel_past_its_shared_rows(n_atoms, variant):
    pos, vel, noise, b, cp, npk, m, n_steps, salt_col = _fused_args(
        n_atoms, 1, True, True)
    st = fused_ops.step_par(1, n_steps, 2, salt_col)
    args = (pos, vel, noise, st, b, cp, npk, m, 0.9975, 5e-4)
    v0 = fused_ops.LIBRARY.variants.get(variant, 0)
    got = fused_ops.fused_baoab_batched(*args)
    assert fused_ops.LIBRARY.variants[variant] == v0 + 1
    want = fused_ops.fused_iteration_plain(*args)
    for g, w, tol in zip(got, want, (1e-6, 1e-4)):
        assert float((g - w).abs().max() / w.abs().max()) <= tol
    assert torch.equal(fused_ops.fused_baoab_batched(*args)[0], got[0])


def test_sparse_path_runs_under_the_sync_guard_through_its_kernels(
        monkeypatch):
    """One sparse chunk per force path on the card: the driver runs it
    under ``set_sync_debug_mode("error")``, every force evaluation goes
    through the gated build and the sparse kernel, and no plain version
    is reached."""
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((nb_ops.ref, "nonbonded_sparse"),
                      (nb_ops.ref, "nonbonded_force_sparse"),
                      (nl_ops, "build_gated_plain")):
        monkeypatch.setattr(mod, name, boom)
    libs = (chain_ops.LIBRARY, nb_ops.LIBRARY, fused_ops.LIBRARY,
            x_ops.LIBRARY, nb_ops.SPARSE_LIBRARY, nl_ops.LIBRARY)
    for path, scheme in (("fused", "matrix"), ("pallas", "neighbor")):
        cfg = RepExConfig(dimensions=(("temperature", 2), ("umbrella", 2),
                                      ("umbrella", 2)),
                          md_steps_per_cycle=4, n_cycles=3,
                          exchange_scheme=scheme)
        drv = REMDDriver(_sparse_engine("cuda", path=path, skin=0.3), cfg,
                         device="cuda")
        ens = drv.init(0)
        n0 = [lib.launches for lib in libs]
        drv.run_fused(ens, chunk_cycles=3)
        moved = [lib.launches - n for lib, n in zip(libs, n0)]
        assert moved == [15, 0, 0, 3 if scheme == "matrix" else 0, 18, 15]
        assert drv.history[-1]["nb_rebuilds"] > 0
        assert drv.history[-1]["nb_overflow"] == 0


def _sparse_run(device, path, scheme, chunk=2, n_cycles=4, skin=0.3):
    cfg = RepExConfig(dimensions=(("temperature", 2), ("umbrella", 2),
                                  ("umbrella", 2)),
                      md_steps_per_cycle=4, n_cycles=n_cycles,
                      exchange_scheme=scheme)
    drv = REMDDriver(_sparse_engine(device, path=path, skin=skin), cfg,
                     device=device)
    return drv, drv.run_fused(drv.init(0), chunk_cycles=chunk)


@pytest.mark.parametrize("path,scheme", [("fused", "neighbor"),
                                         ("fused", "matrix"),
                                         ("pallas", "neighbor")])
def test_sparse_path_card_and_cpu_make_the_same_decisions(path, scheme):
    gpu, gpu_ens = _sparse_run("cuda", path, scheme)
    cpu, cpu_ens = _sparse_run("cpu", path, scheme)
    for hg, hc in zip(gpu.history, cpu.history):
        np.testing.assert_array_equal(hg["assignment"], hc["assignment"])
        assert hg["nb_rebuilds"] == hc["nb_rebuilds"]
    assert gpu.acceptance_ratios() == cpu.acceptance_ratios()
    np.testing.assert_allclose(gpu_ens.state["pos"].cpu().numpy(),
                               cpu_ens.state["pos"].numpy(), atol=1e-4)


def test_sparse_path_chunk_size_invariance_on_the_card():
    runs = {k: _sparse_run("cuda", "fused", "neighbor", chunk=k,
                           n_cycles=3) for k in (1, 3)}
    assert runs[1][0].history[-1]["nb_rebuilds"] > 0
    for h1, h3 in zip(runs[1][0].history, runs[3][0].history):
        np.testing.assert_array_equal(h1["assignment"], h3["assignment"])
    for key in ("pos", "vel"):
        assert torch.equal(runs[1][1].state[key], runs[3][1].state[key])
    for key, leaf in runs[1][1].state["nlist"].items():
        assert torch.equal(leaf, runs[3][1].state["nlist"][key]), key


# -- the LJ fluid (LJEngine) and the harmonic probe -------------------------

def _fluid(n_atoms, n_rep, box=12.0, seed=0):
    """Lattice + jitter positions in the box: pairs across the boundary
    (the minimum image) and atoms near the corners."""
    side = int(np.ceil(n_atoms ** (1 / 3) - 1e-9))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_atoms]
    rng = np.random.default_rng(seed)
    pos = (g + 0.5) * (box / side) + 0.3 * rng.standard_normal(
        (n_rep, n_atoms, 3))
    return torch.from_numpy(np.mod(pos, box).astype(np.float32)).cuda()


LJ_ARGS = (3.4, 0.238, 12.0)


def _fluid_box(n_atoms):
    """12 A for the small cases, else argon's density (Rahman's 864 atoms
    in 34.8 A)."""
    return 12.0 if n_atoms <= 257 else 34.8 * (n_atoms / 864) ** (1 / 3)


# The small cases in a 12 A box, the main path's shape (R = 64, N = 864)
# and a large N at R = 1 (no ceiling: the forces kernel's partial rows
# live in device memory).
@pytest.mark.parametrize("n_atoms,n_rep", [
    (27, 1), (27, 3), (64, 1), (64, 3), (130, 1), (130, 3), (257, 1),
    (257, 3), (864, 64), (17500, 1)])
def test_lj_fluid_kernels_match_plain_versions(n_atoms, n_rep):
    args = LJ_ARGS[:2] + (_fluid_box(n_atoms),)
    pos = _fluid(n_atoms, n_rep, args[2])
    lib = nb_ops.LJ_FLUID_LIBRARY
    n0 = dict(lib.variants)
    e = nb_ops.lj_energy_batched(pos, *args)
    f = nb_ops.lj_forces_batched(pos, *args)
    assert lib.variants["energy"] == n0.get("energy", 0) + 1
    assert lib.variants["forces"] == n0.get("forces", 0) + 1
    _close(f, nb_ops.ref.lj_forces(pos, *args))
    assert torch.equal(nb_ops.lj_forces_batched(pos, *args), f)
    assert torch.equal(nb_ops.lj_energy_batched(pos, *args), e)
    # the single-configuration entry points: one R = 1 launch each
    _close(nb_ops.lj_forces(pos[0], *args), f[0])
    _close(e, nb_ops.ref.lj_energy(pos, *args), energy=True)
    _close(nb_ops.lj_energy(pos[0], *args)[None], e[:1], energy=True)


# ROADMAP P8 (fixed): an earlier energy kernel summed every j of an atom in
# one float32 register and at N = 17500 landed 4.1e-5 to 7.7e-5 of the
# energy off its plain version.  The tile walk's per-entry, per-block and
# block-order sums hold it to the tolerance.
def test_lj_energy_kernel_holds_at_17500_atoms():
    args = LJ_ARGS[:2] + (_fluid_box(17500),)
    pos = _fluid(17500, 1, args[2])
    _close(nb_ops.lj_energy_batched(pos, *args),
           nb_ops.ref.lj_energy(pos, *args), energy=True)


def test_lj_energy_gradient_is_the_forces_kernel_bitwise():
    pos = _fluid(130, 3).requires_grad_(True)
    u = nb_ops.LJEnergy.apply(pos, *LJ_ARGS)
    (g,) = torch.autograd.grad(u.sum(), pos)
    assert torch.equal(g, -nb_ops.lj_forces_batched(pos.detach(), *LJ_ARGS))


def test_lj_fluid_wrappers_reject_what_the_kernels_do_not_take():
    pos = _fluid(64, 2)
    for bad in (pos.cpu(), pos.double(), pos[..., :2].contiguous()):
        with pytest.raises(ValueError):
            nb_ops.lj_energy_batched(bad, *LJ_ARGS)
        with pytest.raises(ValueError):
            nb_ops.lj_forces_batched(bad, *LJ_ARGS)


def test_lj_engine_launch_counts():
    """One propagate of 10 steps: 11 launches of the forces kernel, none
    of the energy kernel; one feature pass: one energy launch."""
    from repro_torch.core.controls import build_grid, ctrl_for_assignment
    from repro_torch.md import LJEngine
    eng = LJEngine(device="cuda")
    grid = build_grid(RepExConfig(dimensions=(("temperature", 4),)), "cuda")
    state = eng.init_state(jr.key(0, "cuda"), 4)
    ctrl = ctrl_for_assignment(grid, torch.arange(4, device="cuda"),
                               eng.ctrl_keys)
    lib = nb_ops.LJ_FLUID_LIBRARY
    lib.reset()
    out = eng.propagate(state, ctrl, torch.full((4,), 10, device="cuda"),
                        jr.split(jr.key(1, "cuda"), 4), max_steps=10)
    assert lib.variants == {"forces": 11}
    eng.replica_features(out)
    assert lib.variants == {"forces": 11, "energy": 1}
    pos = out["pos"]
    assert bool(((pos >= 0) & (pos <= eng.box)).all())


def _t_only_run(engine_cls, device, scheme, chunk=2, n_cycles=4, **kw):
    cfg = RepExConfig(dimensions=(("temperature", 8),), t_min=94.4,
                      t_max=150.0, md_steps_per_cycle=10, n_cycles=n_cycles,
                      exchange_scheme=scheme)
    drv = REMDDriver(engine_cls(device=device, **kw), cfg, device=device)
    return drv, drv.run_fused(drv.init(0), chunk_cycles=chunk)


@pytest.mark.parametrize("engine", ["lj", "harmonic"])
@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
def test_t_only_engines_card_and_cpu_make_the_same_decisions(engine,
                                                             scheme):
    from repro_torch.md import HarmonicEngine, LJEngine
    cls = LJEngine if engine == "lj" else HarmonicEngine
    gpu, gpu_ens = _t_only_run(cls, "cuda", scheme)
    cpu, cpu_ens = _t_only_run(cls, "cpu", scheme)
    for hg, hc in zip(gpu.history, cpu.history):
        np.testing.assert_array_equal(hg["assignment"], hc["assignment"])
    assert gpu.acceptance_ratios() == cpu.acceptance_ratios()
    key = "pos" if engine == "lj" else "x"
    np.testing.assert_allclose(gpu_ens.state[key].cpu().numpy(),
                               cpu_ens.state[key].numpy(), atol=1e-4)


def test_lj_run_equals_run_fused_on_the_card():
    from repro_torch.md import LJEngine
    fused, fused_ens = _t_only_run(LJEngine, "cuda", "neighbor", chunk=4)
    drv = REMDDriver(LJEngine(device="cuda"), fused.cfg, device="cuda")
    ens = drv.run(drv.init(0))
    for hf, hr in zip(fused.history, drv.history):
        np.testing.assert_array_equal(hf["assignment"], hr["assignment"])
        assert (hf["accept"], hf["attempt"], hf["failed"]) == \
            (hr["accept"], hr["attempt"], hr["failed"])
    assert torch.equal(ens.state["pos"], fused_ens.state["pos"])


# -- flash attention (LM serving) -------------------------------------------


def _qkv(dtype, b, s, h, g, d, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("s,d", [(16, 16), (100, 64), (257, 128),
                                 (130, 80), (2048, 128)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_attention_matches_plain_version(dtype, causal, window, rep,
                                               s, d, softcap):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v = _qkv(dtype, 2, s, 8, 8 // rep, d)
    if softcap:
        q = 20 * q                       # scores up to ~100: the cap bites
    got = fa_ops.flash_attention_kernel(q, k, v, causal=causal,
                                        window=window, softcap=softcap)
    want = fa_ops.ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    assert got.dtype == dtype and got.shape == q.shape
    got, want = got.float(), want.float()
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    allow = rtol * want.abs() + 5e-5 * want.abs().max()
    assert bool(((got - want).abs() <= allow).all())


def test_flash_attention_wrapper_contract():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v = _qkv(torch.bfloat16, 1, 64, 4, 2, 32)
    for x, variant in (((q, k, v), "bf16_tc"),
                       ((q.float(), k.float(), v.float()), "f32")):
        n0 = fa_ops.LIBRARY.launches
        v0 = fa_ops.LIBRARY.variants.get(variant, 0)
        first = fa_ops.flash_attention(*x)
        second = fa_ops.flash_attention(*x)
        assert fa_ops.LIBRARY.launches == n0 + 2
        assert fa_ops.LIBRARY.variants[variant] == v0 + 2
        assert torch.equal(first, second)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_kernel(q.cpu(), k.cpu(), v.cpu())
    for bad in ((q.float(), k, v), (q, k[:, :, :1].expand(-1, -1, 3, -1)
                                    .contiguous(), v),
                _qkv(torch.bfloat16, 1, 16, 2, 2, 12)):   # TMA: D % 8
        with pytest.raises(ValueError):
            fa_ops.flash_attention_kernel(*bad)


def _smoke_lm(**kw):
    import dataclasses
    from repro_torch.models import registry
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(registry.get_smoke_config("phi3_medium_14b"),
                              **kw)
    lm = registry.build(cfg)
    return cfg, lm, init_params(jr.key(0, "cuda"), lm.param_defs())


def test_prefill_launches_one_flash_kernel_per_layer():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cfg, lm, params = _smoke_lm()
    tokens = jr.randint(jr.key(1, "cuda"), (2, 20), 0, cfg.vocab_size)
    n0 = fa_ops.LIBRARY.launches
    logits, state = lm.prefill(params, {"tokens": tokens}, cache_len=24)
    assert fa_ops.LIBRARY.launches == n0 + cfg.n_layers
    lm.decode_step(params, state, tokens[:, :1])
    assert fa_ops.LIBRARY.launches == n0 + cfg.n_layers
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap_prefill_runs_through_the_kernel(dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import registry
    from repro_torch.tree import tree_map
    cfg, lm, params = _smoke_lm(logit_softcap=30.0, compute_dtype=dtype,
                                cache_dtype=dtype, reduce_dtype=dtype)
    tokens = jr.randint(jr.key(1, "cuda"), (2, 16), 0, cfg.vocab_size)
    variant = "f32" if dtype == "float32" else "bf16_tc"
    v0 = fa_ops.LIBRARY.variants.get(variant, 0)
    logits, _ = lm.prefill(params, {"tokens": tokens})
    assert fa_ops.LIBRARY.variants[variant] == v0 + cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    if dtype == "float32":
        cpu, _ = registry.build(cfg).prefill(
            tree_map(lambda t: t.cpu(), params), {"tokens": tokens.cpu()})
        scale = float(cpu.abs().max())
        assert float((logits.cpu() - cpu).abs().max()) <= 1e-4 * scale


# -- the driver's patterns, modes and fault tolerance on the card --------


def _driver(device, slots=None, ckpt_dir=None, rate=0.0, n_atoms=200,
            **cfg):
    c = RepExConfig(**dict(dict(dimensions=(("temperature", 8),),
                                md_steps_per_cycle=4, n_cycles=4), **cfg))
    return REMDDriver(MDEngine(chain_molecule(n_atoms), device=device), c,
                      slots=slots, ckpt_dir=ckpt_dir, ckpt_every=2,
                      failure_rate=rate, device=device)


@pytest.mark.parametrize("pattern", ["synchronous", "asynchronous"])
def test_mode2_is_bitwise_mode1_on_the_card(pattern):
    """Three waves (the last padded) give every replica Mode I's bits:
    the kernels' split follows the ensemble's R, not the wave's."""
    outs = []
    for slots in (None, 3):
        drv = _driver("cuda", slots=slots, pattern=pattern)
        ens = drv.run_fused(drv.init(0), chunk_cycles=2)
        outs.append(([h["assignment"].tolist() for h in drv.history], ens))
    assert outs[0][0] == outs[1][0]
    for k in ("pos", "vel"):
        assert torch.equal(outs[0][1].state[k], outs[1][1].state[k])


def test_async_faults_resume_bitwise_on_the_card(tmp_path):
    kw = dict(rate=0.2, ckpt_dir=str(tmp_path), pattern="asynchronous",
              relaunch_budget=1)
    full = _driver("cuda", **kw)
    out = full.run_fused(full.init(0), chunk_cycles=2)
    assert sum(h["failed"] for h in full.history) > 0
    again = _driver("cuda", **kw)
    res = again.resume(via="fused", chunk_cycles=2, step=1)
    assert [h["assignment"].tolist() for h in again.history] == \
        [h["assignment"].tolist() for h in full.history]
    alive = out.alive
    for k in ("pos", "vel"):
        assert torch.equal(res.state[k][alive], out.state[k][alive])


def test_async_faults_match_the_cpu():
    rows = {}
    for dev in ("cuda", "cpu"):
        drv = _driver(dev, slots=3, rate=0.2, pattern="asynchronous",
                      relaunch_budget=1)
        drv.run_fused(drv.init(0), chunk_cycles=2)
        rows[dev] = [(h["assignment"].tolist(), h["failed"],
                      h["esc_reinit"], h["ready_frac"])
                     for h in drv.history]
    assert rows["cuda"] == rows["cpu"]


def test_oracle_paths_on_the_card():
    sysm = chain_molecule(300)
    keys = jr.split(jr.key(1, "cuda"), 4)
    ctrl = {"temperature": torch.full((4,), 300.0, device="cuda"),
            "beta": torch.full((4,), 1.0, device="cuda")}
    n_steps = torch.full((4,), 5, dtype=torch.int64, device="cuda")
    out = {}
    for name, kw in (("pallas", {}), ("batched", {"force_path": "batched"}),
                     ("vmap", {"batched": False})):
        eng = MDEngine(sysm, device="cuda", **kw)
        state = eng.init_state(jr.key(0, "cuda"), 4)
        out[name] = eng.propagate(state, ctrl, n_steps, keys, max_steps=5)
    for name in ("batched", "vmap"):
        assert float((out[name]["pos"] - out["pallas"]["pos"]).abs()
                     .max()) < 1e-3


# -- the seventh slice: the cell build, observability, the CLI ---------------

def _gas_mask(n_atoms):
    """The mask bits and the dense uint8 mask of a gas: every pair kept
    but the diagonal."""
    mask = 1 - torch.eye(n_atoms, dtype=torch.uint8, device="cuda")
    ld = nb_ops.pad_to_block(n_atoms, nb_ops.TILE)
    u8 = torch.zeros((n_atoms, ld), dtype=torch.uint8, device="cuda")
    u8[:, :n_atoms] = mask
    return nb_ops.tile_flags(u8)[0], mask


# The chain (whose cells hold ~180 atoms at N = 2881) at R = 1, 4 and
# 384, a chain at a capacity that drops atoms, gases at the LJ fluid's
# density large enough that suggest_build_method picks the cell build
# (the stencil's 27 cells of ~160 slots undercut N): 6,000 atoms, 16,385
# (bin blocks of 2,048 atoms, the last holding one) and 20,000 at R = 4
# (chip_smoke.py's); and a small gas whose k_max drops pairs; each with
# both flags and a flag row, every call counted once.
@pytest.mark.parametrize("kind,n_atoms,n_rep", [
    ("chain", 2881, 4), ("chain", 2881, 1), ("chain", 2881, 384),
    ("chain_cap", 257, 3), ("gas", 6000, 2), ("gas", 16385, 2),
    ("gas", 20000, 4), ("gas_kmax", 1000, 2)])
def test_cell_build_kernel_equals_plain_build_bitwise(kind, n_atoms, n_rep):
    from repro_torch.md import neighbors as NB
    if kind.startswith("chain"):
        eng = _sparse_engine("cuda", n_atoms, nlist_build="cell",
                             cell_capacity=3 if kind == "chain_cap" else None)
        pos = eng.init_state(jr.key(0, "cuda"), n_rep)["pos"]
        bits, mask = eng._nb_pack.mask_bits, eng._nb_pack.nb_mask
        r_list, k_max = eng.r_list, eng.k_max
        cells = (eng._grid_dims, eng._cell_capacity)
    else:
        side = (n_atoms / 0.0205) ** (1 / 3)
        pos = _gas(n_atoms, n_rep, side)
        bits, mask = _gas_mask(n_atoms)
        r_list = 10.5
        host = pos[0].double().cpu().numpy()
        dims = NB.suggest_grid_dims(host.max(0) - host.min(0) + 2 * r_list,
                                    r_list)
        cap = NB.suggest_cell_capacity(host, r_list, dims)
        assert (NB.suggest_build_method(n_atoms, dims, cap) == "cell") == (
            kind == "gas")
        cells, k_max = (dims, cap), (160 if kind == "gas" else 40)
    old = nl_ops.build_gated_plain(pos + 0.7, None, None, mask, r_list,
                                   k_max, cells)[:2]
    flags = (torch.zeros(1, dtype=torch.int32, device="cuda"),
             torch.ones(1, dtype=torch.int32, device="cuda"),
             (torch.arange(n_rep, device="cuda") % 2).to(torch.int32))
    for flag in flags:
        n0 = nl_ops.CELL_LIBRARY.launches
        got = nl_ops.cell_build_batched(pos, flag, old, bits, r_list, k_max,
                                        *cells)
        assert nl_ops.CELL_LIBRARY.launches == n0 + 1
        want = nl_ops.build_gated_plain(pos, flag, old, mask, r_list, k_max,
                                        cells)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (kind, flag.tolist())
    assert int(want[0].lt(n_atoms).sum()) > 0
    assert (int(want[2].sum()) > 0) == (kind in ("chain_cap", "gas_kmax"))


def test_cell_path_runs_under_the_sync_guard_through_its_kernels(
        monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(nl_ops, "build_gated_plain", boom)
    monkeypatch.setattr(nl_ops.ref, "build_cells", boom)
    cfg = RepExConfig(dimensions=(("temperature", 8),), md_steps_per_cycle=4,
                      n_cycles=3)
    drv = REMDDriver(_sparse_engine("cuda", path="pallas", skin=0.3,
                                    nlist_build="cell"), cfg, device="cuda")
    ens = drv.init(0)
    n0 = (nl_ops.CELL_LIBRARY.launches, nl_ops.LIBRARY.launches)
    drv.run_fused(ens, chunk_cycles=3)
    assert nl_ops.CELL_LIBRARY.launches - n0[0] == 15    # 3 x 5 evaluations
    assert nl_ops.LIBRARY.launches == n0[1]
    assert drv.history[-1]["nb_rebuilds"] > 0


def test_cell_path_card_and_cpu_make_the_same_decisions():
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg = RepExConfig(dimensions=(("temperature", 8),),
                          md_steps_per_cycle=4, n_cycles=4)
        drv = REMDDriver(_sparse_engine(dev, path="pallas", skin=0.3,
                                        nlist_build="cell"), cfg,
                         device=dev)
        ens = drv.run_fused(drv.init(0), chunk_cycles=2)
        runs[dev] = (drv, ens)
    gpu, cpu = runs["cuda"][0], runs["cpu"][0]
    for hg, hc in zip(gpu.history, cpu.history):
        np.testing.assert_array_equal(hg["assignment"], hc["assignment"])
        assert hg["nb_rebuilds"] == hc["nb_rebuilds"]
    assert gpu.history[-1]["nb_rebuilds"] > 0
    np.testing.assert_allclose(runs["cuda"][1].state["pos"].cpu().numpy(),
                               runs["cpu"][1].state["pos"].numpy(),
                               atol=1e-4)


def _tel_run(device, telemetry, scheme="neighbor"):
    from repro_torch.obs import Telemetry
    cfg = RepExConfig(dimensions=(("temperature", 8),), md_steps_per_cycle=4,
                      n_cycles=6, exchange_scheme=scheme)
    drv = REMDDriver(MDEngine(chain_molecule(64), device=device), cfg,
                     device=device,
                     telemetry=Telemetry() if telemetry else None)
    ens = drv.run_fused(drv.init(0), chunk_cycles=3)
    return drv, ens


@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
def test_telemetry_on_and_off_bitwise_on_the_card(scheme):
    from repro_torch.obs import validate_report
    n0 = nb_ops.LIBRARY.launches
    off, e_off = _tel_run("cuda", False, scheme)
    n_off = nb_ops.LIBRARY.launches - n0
    on, e_on = _tel_run("cuda", True, scheme)
    n_on = nb_ops.LIBRARY.launches - n0 - n_off
    assert n_off == 6 * 5
    assert n_on > n_off                       # the propagate probes
    for a, b in zip(on.history, off.history):
        np.testing.assert_array_equal(a["assignment"], b["assignment"])
    for k in ("pos", "vel"):
        assert torch.equal(e_on.state[k], e_off.state[k])
    rep = on.last_report
    validate_report(rep.to_dict())
    assert rep.meta["backend"] == "cuda" and rep.phases["samples"] == 2
    assert (rep.exchange["pair_attempt"] is None) == (scheme == "matrix")


def test_telemetry_counters_on_the_card_equal_the_cpu():
    gpu, _ = _tel_run("cuda", True)
    cpu, _ = _tel_run("cpu", True)
    for key in ("pair_attempt", "pair_accept", "occupancy", "round_trips"):
        np.testing.assert_array_equal(gpu.last_report.exchange[key],
                                      cpu.last_report.exchange[key])


def test_repex_run_cli_on_the_card(tmp_path):
    import json

    from repro_torch.launch import repex_run
    from repro_torch.obs import validate_report
    out = tmp_path / "report.json"
    drv = repex_run.main(["--atoms", "64", "--dims", "temperature:8",
                          "--md-steps", "4", "--cycles", "4", "--chunk", "2",
                          "--report-out", str(out)])
    with open(out) as f:
        rep = validate_report(json.load(f))
    assert rep["meta"]["backend"] == "cuda" and rep["cycles"]["counted"] == 4
    assert rep["exchange"]["accepted"] == sum(
        a for a, _ in drv.acceptance.values())
