"""The Gibbs (matrix) exchange of the port against the JAX package's:

  * ``random.permutation`` against ``jax.random.permutation``, bitwise;
  * the (R, C) cross-energy matrix (``kernels.exchange_matrix``): the
    plain version against the JAX oracle and against the JAX Pallas
    kernel in interpret mode, with 0, 1 and 2 umbrellas and salt, and
    the kernel's packed rows against the JAX packing;
  * ``matrix_exchange`` from one state: identical assignments over
    several sweeps;
  * ``run_fused`` with ``exchange_scheme="matrix"`` on the per-pass
    (``"pallas"``) force path with an umbrella dimension: identical
    assignment rows and acceptance.

Tolerance: the matrix equal to the JAX oracle bit for bit (the same
float32 steps in the same order), and within 1e-6 of max |u| of the
interpret-mode Pallas kernel (whose compiled body rounds some elements
1 ulp apart from the oracle); permutations, assignments and acceptance
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.core import exchange as jX
from repro.kernels.exchange_matrix import ops as jxops
from repro.kernels.exchange_matrix import ref as jxref
from repro.md import MDEngine as JEngine
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import exchange as tX
from repro_torch.kernels.exchange_matrix import ops as txops
from repro_torch.kernels.exchange_matrix import ref as txref
from repro_torch.md import MDEngine

from test_torch_fused import run_pair


def _key_data(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))


@pytest.mark.parametrize("n", [2, 7, 64, 384])
@pytest.mark.parametrize("seed", [0, 11])
def test_permutation_bitwise(n, seed):
    key = jax.random.fold_in(jax.random.key(seed), n)
    want = np.asarray(jax.random.permutation(key, n))
    got = jr.permutation(_key_data(key), n)
    np.testing.assert_array_equal(got.numpy(), want)


def _features_ctrl(n_u, salt, r=40, c=24, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    feats = {"u_base": rng.normal(-50, 30, r).astype(f32),
             "u_elec": rng.normal(-200, 40, r).astype(f32),
             "phi": rng.uniform(-np.pi, np.pi, r).astype(f32),
             "psi": rng.uniform(-np.pi, np.pi, r).astype(f32)}
    ctrl = {"beta": (1.0 / (0.0019872041 * np.geomspace(273, 373, c))
                     ).astype(f32),
            "temperature": np.geomspace(273, 373, c).astype(f32)}
    if salt:
        ctrl["salt"] = rng.uniform(0, 1, c).astype(f32)
    if n_u:
        ctrl["umbrella_center"] = rng.uniform(0, 360, (c, n_u)).astype(f32)
        ctrl["umbrella_k"] = np.full((c, n_u), 0.02, f32)
    return feats, ctrl


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("n_u", [0, 1, 2])
@pytest.mark.parametrize("salt", [False, True])
def test_matrix_matches_jax_oracle_and_pallas_kernel(n_u, salt):
    feats, ctrl = _features_ctrl(n_u, salt)
    got = txops.exchange_matrix(_t(feats), _t(ctrl)).numpy()
    assert got.shape == (40, 24)
    oracle = np.asarray(jxref.exchange_matrix(_j(feats), _j(ctrl)))
    kernel = np.asarray(jxops.exchange_matrix(
        _j(feats), _j(ctrl), use_kernel=True, block_r=8, block_c=8,
        interpret=True))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_allclose(got, kernel, rtol=0,
                               atol=1e-6 * np.abs(oracle).max())


@pytest.mark.parametrize("n_u", [0, 1, 2])
def test_packed_rows_match_jax_packing(n_u):
    feats, ctrl = _features_ctrl(n_u, True, r=8, c=8)
    f_j, g_j, _, _ = jxops._pack(_j(feats), _j(ctrl), 8, 8)
    f_t = txops.pack_features(_t(feats))
    g_t = txops.pack_ctrl(_t(ctrl))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j)[0:4])
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j)[0:6])


def test_matrix_kernel_takes_no_cpu_tensor():
    feats, ctrl = _features_ctrl(2, True, r=8, c=8)
    with pytest.raises(ValueError, match="CUDA"):
        txops.exchange_matrix_batched(txops.pack_features(_t(feats)),
                                      txops.pack_ctrl(_t(ctrl)))


class _MatrixEngine:
    """An engine whose cross-energy matrix and failure flags are given."""

    def __init__(self, u, fail, to):
        self.u, self.fail, self.to = u, fail, to

    def cross_energy(self, state, ctrl):
        return self.to(self.u)

    def is_failed(self, state):
        return self.to(self.fail)


@pytest.mark.parametrize("n_sweeps", [1, 4])
@pytest.mark.parametrize("n", [8, 9])
def test_matrix_exchange_matches_jax(n, n_sweeps):
    """Odd and even replica counts, several sweeps, one failed replica."""
    rng = np.random.default_rng(n)
    u = rng.normal(0, 2, (n, n)).astype(np.float32)
    fail = np.zeros(n, bool)
    fail[3] = True
    assignment = rng.permutation(n)
    key = jax.random.key(n_sweeps)

    class Grid:
        values = {}

    a_j, s_j = jX.matrix_exchange(_MatrixEngine(u, fail, jnp.asarray), None,
                                  Grid, jnp.asarray(assignment), key,
                                  n_sweeps=n_sweeps)
    a_t, s_t = tX.matrix_exchange(_MatrixEngine(u, fail, torch.from_numpy),
                                  None, Grid, torch.from_numpy(assignment),
                                  _key_data(key), n_sweeps=n_sweeps)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    for k in ("attempted", "accepted", "mean_delta"):
        assert float(s_t[k]) == float(s_j[k]), k
    assert 0 < float(s_t["accepted"]) < float(s_t["attempted"])


def test_cross_energy_matches_jax():
    """The engine's (R, C) matrix from one state: features, then the
    matrix, on a T x U grid's controls."""
    jsys = j_chain_molecule(10)
    cfg = dict(dimensions=(("temperature", 2), ("umbrella", 3)))
    jdrv = JDriver(JEngine(jsys), JConfig(**cfg))
    tdrv = REMDDriver(MDEngine(convert.system_from_arrays(jsys, device="cpu"),
                               device="cpu"), RepExConfig(**cfg),
                      device="cpu")
    jens = jdrv.init(0)
    tens = convert.ensemble_from_arrays(jens, jax.random.key_data(jens.rng),
                                        device="cpu")
    for k, v in jdrv.grid.values.items():
        np.testing.assert_array_equal(tdrv.grid.values[k].numpy(),
                                      np.asarray(v), err_msg=k)
    want = jdrv.engine.cross_energy(jens.state, dict(jdrv.grid.values))
    got = tdrv.engine.cross_energy(tens.state, dict(tdrv.grid.values))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), txref.exchange_matrix(
            tdrv.engine.replica_features(tens.state),
            dict(tdrv.grid.values)).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [1, 3])
def test_run_fused_matrix_scheme_pallas_path(chunk, monkeypatch):
    """The per-pass force path with the bias variant of the bonded pass
    (a T x U grid) and the matrix scheme."""
    cfg = dict(dimensions=(("temperature", 2), ("umbrella", 3)),
               md_steps_per_cycle=3, n_cycles=6, exchange_scheme="matrix")
    tdrv, tout = run_pair(j_chain_molecule(10), cfg, chunk, monkeypatch,
                          force_path="pallas")
    assert sorted(tout.assignment.tolist()) == list(range(6))
