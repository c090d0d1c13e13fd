"""The CUDA kernels on the card: each against its plain PyTorch version,
at atom counts that are not whole tiles, plus the wrappers' contracts
(one count per launch, no fallback to a plain version, bitwise repeats)
and the main path on the card against the CPU.

Every test here needs an NVIDIA GPU and nvcc; without CUDA they skip.
This file imports nothing of JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: forces within 1e-5 x max(max |F|, 1), energies 1e-5 relative
(the same formulas summed in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.kernels.chain_forces import ops as chain_ops
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
