"""The asynchronous pattern (paper Fig 1b) of the port's driver against
the JAX package's, on the CPU, from the same seed.

Configuration: a T-only ladder of 8 rungs on ``chain_molecule(10)``, 5
MD steps per cycle, ``async_window=0.6`` (a window of 3 steps, at most
6), so the lognormal speeds give 2-4 steps per replica per window and
replicas become ready in different cycles.  Checked:

  * ``init``: lognormal speeds within one float32 ulp of JAX's (the
    packages' ``exp`` may round apart), the other fields bitwise;
  * ``run_fused`` at chunk sizes 1 and 3: per-cycle assignment rows,
    ``ready_frac``, accept/attempt counts and the final ``debt``
    identical to JAX's, positions within 1e-4 A;
  * the port's ``run`` equals its ``run_fused``: rows, ``ready_frac``,
    debt and the state bitwise;
  * the readiness mask itself: a pair with an un-ready member never
    swaps, and ``debt`` banks exactly the steps not yet exchanged;
  * a T x U grid under the asynchronous pattern (the neighbor scheme
    along both dimensions) and the matrix scheme, decisions as JAX's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.md import MDEngine as JEngine
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import patterns as tP
from repro_torch.md import MDEngine

CFG = dict(dimensions=(("temperature", 8),), md_steps_per_cycle=5,
           n_cycles=6, pattern="asynchronous", async_window=0.6)
POS_TOL = 1e-4
SEED = 3


@pytest.fixture(scope="module")
def jax_system():
    return j_chain_molecule(10)


def _jax_run(jax_system, chunk, **cfg):
    drv = JDriver(JEngine(jax_system), JConfig(**dict(CFG, **cfg)))
    ens0 = drv.init(SEED)
    return ens0, drv, drv.run_fused(ens0, chunk_cycles=chunk)


@pytest.fixture(scope="module")
def jax_runs(jax_system):
    return {k: _jax_run(jax_system, k) for k in (1, 3)}


def _port_driver(jax_system, **cfg):
    eng = MDEngine(convert.system_from_arrays(jax_system, device="cpu"),
                   device="cpu")
    return REMDDriver(eng, RepExConfig(**dict(CFG, **cfg)), device="cpu")


def _col(driver, key):
    return [h[key] for h in driver.history]


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


def _same_as_jax(tdrv, tout, jdrv, jout):
    np.testing.assert_array_equal(_rows(tdrv), _rows(jdrv))
    for key in ("ready_frac", "accept", "attempt", "cycle", "dim"):
        assert _col(tdrv, key) == _col(jdrv, key), key
    assert tdrv.acceptance_ratios() == jdrv.acceptance_ratios()
    np.testing.assert_array_equal(tout.debt.numpy(), np.asarray(jout.debt))
    np.testing.assert_allclose(tout.state["pos"].numpy(),
                               np.asarray(jout.state["pos"]), atol=POS_TOL)


def test_init_draws_jax_speeds(jax_system, jax_runs):
    jens0 = jax_runs[1][0]
    tens0 = _port_driver(jax_system).init(SEED)
    np.testing.assert_allclose(tens0.speed.numpy(), np.asarray(jens0.speed),
                               rtol=2.4e-7, atol=0)
    assert not np.allclose(tens0.speed.numpy(), 1.0)     # heterogeneous
    np.testing.assert_array_equal(tens0.debt.numpy(), np.asarray(jens0.debt))
    np.testing.assert_array_equal(tens0.rng.numpy(), np.asarray(
        jax.random.key_data(jens0.rng)).astype(np.int64))
    # the speeds give 2, 3 and 4 steps per window: stragglers and racers
    n = torch.clamp(torch.round(3 * tens0.speed), 1, 6)
    assert len(set(n.tolist())) >= 2


@pytest.mark.parametrize("chunk", [1, 3])
def test_run_fused_matches_jax(chunk, jax_system, jax_runs):
    _, jdrv, jout = jax_runs[chunk]
    tdrv = _port_driver(jax_system)
    tout = tdrv.run_fused(tdrv.init(SEED), chunk_cycles=chunk)
    _same_as_jax(tdrv, tout, jdrv, jout)
    # some cycles leave replicas un-ready (the pattern is exercised)
    assert min(_col(tdrv, "ready_frac")) < 1.0


@pytest.mark.parametrize("chunk", [1, 3])
def test_converted_ensemble_matches_jax(chunk, jax_system, jax_runs):
    """The port from JAX's own initial ensemble (speeds bitwise)."""
    jens0, jdrv, jout = jax_runs[chunk]
    tens0 = convert.ensemble_from_arrays(
        jens0, jax.random.key_data(jens0.rng), device="cpu")
    tdrv = _port_driver(jax_system)
    tout = tdrv.run_fused(tens0, chunk_cycles=chunk)
    _same_as_jax(tdrv, tout, jdrv, jout)


def test_run_equals_run_fused(jax_system):
    outs = {}
    for via in ("run", "fused"):
        tdrv = _port_driver(jax_system)
        ens0 = tdrv.init(SEED)
        out = (tdrv.run(ens0) if via == "run"
               else tdrv.run_fused(ens0, chunk_cycles=3))
        outs[via] = (tdrv, out)
    (rd, ro), (fd, fo) = outs["run"], outs["fused"]
    np.testing.assert_array_equal(_rows(rd), _rows(fd))
    for key in ("ready_frac", "accept", "attempt", "failed"):
        assert _col(rd, key) == _col(fd, key), key
    assert torch.equal(ro.debt, fo.debt)
    for k in ("pos", "vel"):
        assert torch.equal(ro.state[k], fo.state[k]), k


def test_unready_pairs_never_swap_and_debt_banks(jax_system):
    """One cycle by hand: the ready mask is (debt + steps >= md_steps) &
    alive, no un-ready replica changes ctrl, and debt keeps the
    remainder."""
    tdrv = _port_driver(jax_system)
    ens = tdrv.init(SEED)
    ens = ens._replace(alive=torch.tensor([True] * 7 + [False]))
    for _ in range(3):
        n = torch.clamp(torch.round(3 * ens.speed).to(torch.int64), 1, 6)
        want_ready = (ens.debt + n >= 5) & ens.alive
        new, stats, ready = tP._cycle_core(
            tdrv.engine, tdrv.grid, ens, pattern="asynchronous",
            md_steps=5, window_steps=3, dim_index=torch.tensor(0),
            parity=ens.cycle % 2, scheme="neighbor",
            execution=tdrv.execution)
        assert torch.equal(ready, want_ready)
        moved = new.assignment != ens.assignment
        assert not bool((moved & ~ready).any())
        debt = ens.debt + n
        assert torch.equal(new.debt, torch.where(ready, debt - 5, debt))
        ens = new
    assert not bool(ready.all())


@pytest.mark.parametrize("scheme,dims", [
    ("neighbor", (("temperature", 2), ("umbrella", 4))),
    ("matrix", (("temperature", 8),)),
])
def test_grid_and_matrix_scheme_match_jax(scheme, dims, jax_system):
    cfg = dict(dimensions=dims, exchange_scheme=scheme, n_cycles=4)
    _, jdrv, jout = _jax_run(jax_system, 2, **cfg)
    tdrv = _port_driver(jax_system, **cfg)
    tout = tdrv.run_fused(tdrv.init(SEED), chunk_cycles=2)
    _same_as_jax(tdrv, tout, jdrv, jout)
