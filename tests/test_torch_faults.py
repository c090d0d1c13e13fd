"""Failure injection and the escalation ladder of the port against the
JAX package's, on the CPU.

  * ``inject_failures``: the (R,) hit mask bitwise JAX's ``bernoulli``
    over many keys and rates, NaN in every floating leaf of a hit row and
    nowhere else (integer and bool leaves untouched);
  * ``_peer_backup``: JAX's roll, row for row;
  * ``detect_recover`` with ``relaunch_budget`` 1 and 2 on a hand-made
    failure streak: masks, state, ``alive`` and the escalation stats
    identical to JAX's;
  * the driver with ``failure_rate > 0`` at budgets 0, 1 and 2 (and the
    'continue' policy): per-cycle ``failed`` / ``esc_*`` counts,
    assignment rows and ``alive`` identical to JAX's ``run_fused``, the
    port's ``run`` equal to its ``run_fused``;
  * a NaN row never reaches another replica's state (the mended run's
    healthy rows equal an injection-free run where no failure hit them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.core import failures as jF
from repro.md import MDEngine as JEngine
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import failures as tF
from repro_torch.md import MDEngine

CFG = dict(dimensions=(("temperature", 8),), md_steps_per_cycle=3,
           n_cycles=8)
SEED = 2


@pytest.fixture(scope="module")
def jax_system():
    return j_chain_molecule(10)


def _port_engine(jax_system):
    return MDEngine(convert.system_from_arrays(jax_system, device="cpu"),
                    device="cpu")


def _col(driver, key):
    return [h[key] for h in driver.history]


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


@pytest.mark.parametrize("rate", [0.05, 0.3, 0.5, 0.9])
def test_inject_hit_masks_match_jax(rate, jax_system):
    """Twenty keys per rate: the corrupted rows equal JAX's, bitwise."""
    jdrv = JDriver(JEngine(jax_system), JConfig(**CFG))
    jens = jdrv.init(SEED)
    tens = convert.ensemble_from_arrays(
        jens, jax.random.key_data(jens.rng), device="cpu")
    tens = tens._replace(state=dict(
        tens.state, flag=torch.ones(8, dtype=torch.int32),
        nest={"w": torch.zeros(8, 2)}))
    hits = 0
    for seed in range(20):
        jk = jax.random.fold_in(jax.random.key(7), seed)
        tk = jr.fold_in(jr.key(7), seed)
        jhit = np.asarray(jax.random.bernoulli(jk, rate, (8,)))
        jout = jF.inject_failures(jens, jk, rate)
        tout = tF.inject_failures(tens, tk, rate)
        for k in ("pos", "vel"):
            np.testing.assert_array_equal(tout.state[k].numpy(),
                                          np.asarray(jout.state[k]))
        thit = torch.isnan(tout.state["pos"]).all(dim=(1, 2)).numpy()
        np.testing.assert_array_equal(thit, jhit)
        assert torch.equal(torch.isnan(tout.state["nest"]["w"]).all(1),
                           torch.from_numpy(jhit.copy()))
        assert torch.equal(tout.state["flag"], tens.state["flag"])
        hits += int(jhit.sum())
    assert 0 < hits < 160


def test_peer_backup_is_jax_roll(jax_system):
    x = np.random.default_rng(0).normal(size=(8, 4, 3)).astype(np.float32)
    b = {"pos": x, "n": {"c": np.arange(8, dtype=np.int32)}}
    tp = tF._peer_backup(jax.tree.map(torch.from_numpy, b))
    jp = jF._peer_backup(jax.tree.map(jnp.asarray, b))
    np.testing.assert_array_equal(tp["pos"].numpy(), np.asarray(jp["pos"]))
    np.testing.assert_array_equal(tp["n"]["c"].numpy(),
                                  np.asarray(jp["n"]["c"]))


@pytest.mark.parametrize("budget", [1, 2])
def test_escalation_ladder_matches_jax(budget, jax_system):
    """Replica 3 fails cycle after cycle: relaunch for ``budget`` cycles,
    reinit from rung 4's backup for ``budget`` more, then dead; replica 6
    fails once and relaunches."""
    jeng = JEngine(jax_system)
    teng = _port_engine(jax_system)
    jens = JDriver(jeng, JConfig(**CFG)).init(SEED)
    tens = convert.ensemble_from_arrays(
        jens, jax.random.key_data(jens.rng), device="cpu")
    tbackup = {k: v + 0.5 for k, v in tens.state.items()}
    jbackup = {k: jnp.asarray(v.numpy()) for k, v in tbackup.items()}
    tiers = []
    for cycle in range(2 * budget + 2):
        hit = {3} | ({6} if cycle == 1 else set())
        pos = tens.state["pos"].clone()
        pos[sorted(hit)] = float("nan")
        tens = tens._replace(state=dict(tens.state, pos=pos))
        jens = jens._replace(state={k: jnp.asarray(v.numpy())
                                    for k, v in tens.state.items()})
        tens, tbackup, tst = tF.detect_recover(teng, tens, "relaunch",
                                               tbackup, budget)
        jens, jbackup, jst = jF.detect_recover(jeng, jens, "relaunch",
                                               jbackup, budget)
        assert {k: int(v) for k, v in tst.items()} == \
            {k: int(v) for k, v in jst.items()}
        for k in ("pos", "vel"):
            np.testing.assert_array_equal(tens.state[k].numpy(),
                                          np.asarray(jens.state[k]))
            np.testing.assert_array_equal(tbackup[k].numpy(),
                                          np.asarray(jbackup[k]))
        np.testing.assert_array_equal(tens.alive.numpy(),
                                      np.asarray(jens.alive))
        np.testing.assert_array_equal(tens.relaunches.numpy(),
                                      np.asarray(jens.relaunches))
        tiers.append((int(tst["esc_relaunch"]), int(tst["esc_reinit"]),
                      int(tst["esc_dead"])))
    def want(cycle):
        """(relaunch, reinit, dead): replica 3 by its streak until it
        retires, replica 6 relaunched once."""
        t, streak = [0, 0, 0], cycle + 1
        if streak <= 2 * budget + 1:
            t[(streak > budget) + (streak > 2 * budget)] += 1
        t[0] += cycle == 1
        return tuple(t)

    assert tiers == [want(c) for c in range(2 * budget + 2)]
    assert not bool(tens.alive[3]) and int(tens.alive.sum()) == 7


def _driver_pair(jax_system, chunk, rate, **cfg):
    c = dict(CFG, **cfg)
    jdrv = JDriver(JEngine(jax_system), JConfig(**c), failure_rate=rate)
    jout = jdrv.run_fused(jdrv.init(SEED), chunk_cycles=chunk)
    tdrv = REMDDriver(_port_engine(jax_system), RepExConfig(**c),
                      failure_rate=rate, device="cpu")
    tout = tdrv.run_fused(tdrv.init(SEED), chunk_cycles=chunk)
    return jdrv, jout, tdrv, tout


@pytest.mark.parametrize("budget,rate,chunk", [(0, 0.2, 4), (1, 0.35, 3),
                                               (2, 0.35, 1), (2, 0.05, 4)])
def test_driver_escalation_stats_match_jax(budget, rate, chunk, jax_system):
    jdrv, jout, tdrv, tout = _driver_pair(jax_system, chunk, rate,
                                          relaunch_budget=budget)
    for key in ("failed", "esc_relaunch", "esc_reinit", "esc_dead",
                "accept", "attempt"):
        assert _col(tdrv, key) == _col(jdrv, key), key
    np.testing.assert_array_equal(_rows(tdrv), _rows(jdrv))
    np.testing.assert_array_equal(tout.alive.numpy(), np.asarray(jout.alive))
    assert int(tout.failures) == int(jout.failures)
    ok = tout.alive.numpy()
    np.testing.assert_allclose(tout.state["pos"].numpy()[ok],
                               np.asarray(jout.state["pos"])[ok], atol=1e-4)
    if rate > 0.1:
        assert sum(_col(tdrv, "failed")) > 0


def test_continue_policy_matches_jax(jax_system):
    jdrv, jout, tdrv, tout = _driver_pair(jax_system, 4, 0.2,
                                          relaunch_failed=False)
    for key in ("failed", "esc_dead", "accept", "attempt"):
        assert _col(tdrv, key) == _col(jdrv, key), key
    np.testing.assert_array_equal(_rows(tdrv), _rows(jdrv))
    np.testing.assert_array_equal(tout.alive.numpy(), np.asarray(jout.alive))
    assert not bool(tout.alive.all())


def test_run_equals_run_fused_with_failures(jax_system):
    outs = []
    for via in ("run", "fused"):
        tdrv = REMDDriver(_port_engine(jax_system),
                          RepExConfig(**dict(CFG, relaunch_budget=1)),
                          failure_rate=0.35, device="cpu")
        ens0 = tdrv.init(SEED)
        out = (tdrv.run(ens0) if via == "run"
               else tdrv.run_fused(ens0, chunk_cycles=3))
        outs.append((tdrv, out))
    (rd, ro), (fd, fo) = outs
    np.testing.assert_array_equal(_rows(rd), _rows(fd))
    for key in ("failed", "esc_relaunch", "esc_reinit", "esc_dead"):
        assert _col(rd, key) == _col(fd, key), key
    assert sum(_col(rd, "failed")) > 0
    for k in ("pos", "vel"):
        np.testing.assert_array_equal(ro.state[k].numpy(), fo.state[k].numpy())


def test_corrupted_rows_do_not_leak(jax_system):
    """One cycle with replica 5 hit: every other replica's propagated
    state is bitwise that of the same cycle without the hit."""
    tdrv = REMDDriver(_port_engine(jax_system), RepExConfig(**CFG),
                      device="cpu")
    ens = tdrv.init(SEED)
    pos = ens.state["pos"].clone()
    pos[5] = float("nan")
    hit = ens._replace(state=dict(ens.state, pos=pos))
    clean, _, _ = tF.detect_recover(tdrv.engine, ens, "relaunch", ens.state)
    from repro_torch.core import patterns as tP
    kw = dict(pattern="synchronous", md_steps=3, window_steps=0,
              dim_index=torch.tensor(0), parity=torch.tensor(0),
              scheme="neighbor", execution=tdrv.execution)
    a, _, _ = tP._cycle_core(tdrv.engine, tdrv.grid, clean, **kw)
    b, _, _ = tP._cycle_core(tdrv.engine, tdrv.grid, hit, **kw)
    keep = torch.arange(8) != 5
    for k in ("pos", "vel"):
        assert torch.equal(a.state[k][keep], b.state[k][keep]), k
        assert bool(torch.isnan(b.state[k][5]).all())
