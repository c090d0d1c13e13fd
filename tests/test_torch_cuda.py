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
contraction).
"""
import numpy as np
import pytest
import torch

from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.kernels.chain_forces import ops as chain_ops
from repro_torch.kernels.exchange_matrix import ops as x_ops
from repro_torch.kernels.exchange_matrix import ref as x_ref
from repro_torch.kernels.fused_propagate import ops as fused_ops
from repro_torch.kernels.lj_forces import ops as nb_ops
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


@pytest.mark.parametrize("n_atoms", [8, 130, 257])
@pytest.mark.parametrize("n_rep", [1, 3])
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
@pytest.mark.parametrize("n_atoms", [130, 257])
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


@pytest.mark.parametrize("n_u,salt", [(0, False), (1, True), (2, True)])
def test_exchange_matrix_kernel_matches_plain_version_bitwise(n_u, salt):
    rng = np.random.default_rng(n_u)
    r, c = 200, 130
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
