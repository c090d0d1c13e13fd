"""The sparse neighbor-list path of the port against the JAX package's on
the paper's grid shape, at a small size (``chain_molecule`` of 24-30
atoms, a 2 x 2 x 2 temperature x umbrella(phi) x umbrella(psi) grid):

  * one sparse propagate per force path from the engines' own first
    state, with a skin small enough that the list is rebuilt;
  * ``REMDDriver.run_fused`` on both force paths and both exchange
    schemes, at chunk sizes 1 and 3, with rebuilds inside the run;
  * a run whose ``k_max`` is too small: the dropped pairs are counted,
    identically, into ``nb_overflow``.

Tolerances as in ``test_torch_sparse.py``: decisions, acceptance and the
neighbor-list counters identical, the lists identical, positions and
velocities within 1e-4 A (A/ps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ensemble import Ensemble as JEnsemble
from repro.md import MDEngine as JEngine
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch.md import MDEngine

from test_torch_sparse import run_sparse_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R = 4
TSU = (("temperature", 2), ("umbrella", 2), ("umbrella", 2))


def _as_ensemble(state):
    """A JAX ``Ensemble`` around ``state`` for the converter."""
    r = state["pos"].shape[0]
    z = jnp.zeros(r)
    return JEnsemble(state=state, assignment=jnp.arange(r),
                     rng=jax.random.key(0), cycle=jnp.zeros((), jnp.int32),
                     debt=z, speed=z + 1, alive=jnp.ones(r, bool),
                     failures=jnp.zeros((), jnp.int32),
                     relaunches=jnp.zeros(r, jnp.int32))


@pytest.mark.parametrize("path", ["fused", "pallas"])
def test_sparse_propagate_matches_jax(path):
    """One propagate of 4 steps with umbrella and salt controls from the
    JAX engine's first state (carried over by ``convert``): positions,
    velocities and the list, which the skin of 0.05 A makes rebuild."""
    jsys = j_chain_molecule(30)
    kw = dict(force_path=path, nonbonded="sparse", bonded="sparse",
              skin=0.05)
    jeng = JEngine(jsys, **kw)
    teng = MDEngine(convert.system_from_arrays(jsys, "cpu"), device="cpu",
                    **kw)
    key = jax.random.key(7)
    jstate = jeng.init_state(key, R)
    tstate = convert.ensemble_from_arrays(_as_ensemble(jstate), np.zeros(2),
                                          "cpu").state
    rng = np.random.default_rng(3)
    ctrl = {"temperature": np.geomspace(273.0, 373.0, R).astype(np.float32),
            "umbrella_center": rng.uniform(0, 360, (R, 2)).astype(
                np.float32),
            "umbrella_k": np.full((R, 2), 0.02, np.float32),
            "salt": rng.uniform(0, 1, R).astype(np.float32)}
    keys = np.asarray(jax.random.key_data(jax.random.split(key, R)))
    n_steps = np.array([4, 4, 2, 4])
    want = jeng.propagate(jstate, {k: jnp.asarray(v) for k, v in
                                   ctrl.items()}, jnp.asarray(n_steps),
                          jnp.asarray(keys), 4)
    got = teng.propagate(tstate, {k: torch.from_numpy(v) for k, v in
                                  ctrl.items()}, torch.from_numpy(n_steps),
                         torch.from_numpy(keys.astype(np.int64)), 4)
    for key_ in ("pos", "vel"):
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]),
                                   rtol=0, atol=1e-4)
    assert int(got["nlist"]["rebuilds"].max()) > 0
    for key_ in ("idx", "valid", "overflow", "rebuilds"):
        np.testing.assert_array_equal(got["nlist"][key_].numpy(),
                                      np.asarray(want["nlist"][key_]))


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
@pytest.mark.parametrize("path", ["fused", "pallas"])
def test_run_fused_tuu_matches_jax(path, scheme, chunk, monkeypatch):
    tdrv = run_sparse_pair(TSU, scheme, path, chunk, monkeypatch)
    assert tdrv.history[-1]["nb_rebuilds"] > 0
    assert tdrv.history[-1]["nb_overflow"] == 0
    assert sum(tdrv.acceptance[k][0] for k in tdrv.acceptance) > 0


@pytest.mark.parametrize("chunk", [1, 3])
def test_overflow_is_counted_as_jax_counts_it(chunk, monkeypatch):
    tdrv = run_sparse_pair(TSU, "neighbor", "fused", chunk, monkeypatch,
                           k_max=4)
    assert tdrv.history[0]["nb_overflow"] > 0
