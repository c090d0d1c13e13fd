"""The slice as a whole: the port's ``REMDDriver.run_fused`` against the
JAX package's on the main path (T-only ladder, synchronous pattern, DEO
neighbor exchange, dense force passes), at ``chain_molecule(10)``, 4
rungs, 3 MD steps per cycle, 8 cycles, chunk sizes 1 and 4 —

  (a) each package from its own ``init(seed)``;
  (b) the port from the JAX ensemble carried across by ``convert``.

Pass: identical per-cycle ``assignment`` rows, equal
``acceptance_ratios()``, positions within 1e-4 A (float32 dynamics
through two implementations of the same forces).  When a Metropolis
decision differs, the failure message carries its margin
``|u - exp(min(-delta, 0))|``, which tells a rounding flip (tiny margin)
from a fault.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.core import failures as jF
from repro.md import MDEngine as JEngine
from repro.md.system import chain_molecule as j_chain_molecule
from repro.obs import Telemetry as JTelemetry
from repro_torch import convert
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import exchange as tX
from repro_torch.core import failures as tF
from repro_torch.core.ensemble import control_multiset_ok
from repro_torch.md import MDEngine
from repro_torch.obs import Telemetry

CFG = dict(dimensions=(("temperature", 4),), md_steps_per_cycle=3,
           n_cycles=8)
POS_TOL = 1e-4
SEED = 0


@pytest.fixture(scope="module")
def jax_system():
    return j_chain_molecule(10)


@pytest.fixture(scope="module")
def jax_runs(jax_system):
    """The JAX package's run per chunk size: (init ensemble, driver, out)."""
    runs = {}
    for k in (1, 4):
        drv = JDriver(JEngine(jax_system), JConfig(**CFG))
        ens0 = drv.init(SEED)
        out = drv.run_fused(ens0, chunk_cycles=k)
        runs[k] = (ens0, drv, out)
    return runs


def _cpu_system(jax_system):
    return convert.system_from_arrays(jax_system, device="cpu")


def _port_driver(jax_system):
    eng = MDEngine(_cpu_system(jax_system), device="cpu")
    return REMDDriver(eng, RepExConfig(**CFG), device="cpu")


def _record_metropolis(monkeypatch):
    """Record (delta, u) of every sweep the port draws."""
    seen = []
    orig = tX.metropolis

    def spy(delta, rng):
        seen.append((delta.clone(), tX.jr.uniform(rng, tuple(delta.shape))))
        return orig(delta, rng)

    monkeypatch.setattr(tX, "metropolis", spy)
    return seen


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


def _check_against_jax(tdrv, tout, jdrv, jout, seen):
    jrows, trows = _rows(jdrv), _rows(tdrv)
    if not np.array_equal(jrows, trows):
        c = int(np.nonzero((jrows != trows).any(axis=1))[0][0])
        delta, u = seen[c]
        margin = torch.abs(u - torch.exp(torch.clamp_max(-delta, 0.0)))
        pytest.fail(f"assignment differs first at cycle {c}: jax "
                    f"{jrows[c]}, port {trows[c]}; Metropolis margins "
                    f"{margin.tolist()}")
    assert tdrv.acceptance_ratios() == jdrv.acceptance_ratios()
    for k in ("pos", "vel"):
        np.testing.assert_allclose(tout.state[k].numpy(),
                                   np.asarray(jout.state[k]), atol=POS_TOL,
                                   err_msg=k)
    assert int(tout.cycle) == int(jout.cycle) == CFG["n_cycles"]
    assert control_multiset_ok(tout)


@pytest.mark.parametrize("chunk", [1, 4])
def test_run_fused_from_own_init(chunk, jax_system, jax_runs, monkeypatch):
    jens0, jdrv, jout = jax_runs[chunk]
    tdrv = _port_driver(jax_system)
    tens0 = tdrv.init(SEED)
    # the two packages' init chains draw the same numbers (normals
    # within 1 ulp; the keys bitwise)
    np.testing.assert_allclose(tens0.state["pos"].numpy(),
                               np.asarray(jens0.state["pos"]), rtol=3e-7,
                               atol=1e-7)
    np.testing.assert_array_equal(tens0.rng.numpy(), np.asarray(
        jax.random.key_data(jens0.rng)).astype(np.int64))
    seen = _record_metropolis(monkeypatch)
    tout = tdrv.run_fused(tens0, chunk_cycles=chunk)
    _check_against_jax(tdrv, tout, jdrv, jout, seen)


@pytest.mark.parametrize("chunk", [1, 4])
def test_run_fused_from_converted_ensemble(chunk, jax_system, jax_runs,
                                           monkeypatch):
    jens0, jdrv, jout = jax_runs[chunk]
    tens0 = convert.ensemble_from_arrays(jens0,
                                         jax.random.key_data(jens0.rng),
                                         device="cpu")
    tdrv = _port_driver(jax_system)
    seen = _record_metropolis(monkeypatch)
    tout = tdrv.run_fused(tens0, chunk_cycles=chunk)
    _check_against_jax(tdrv, tout, jdrv, jout, seen)


def test_history_matches_jax(jax_system, jax_runs):
    """Per-cycle history entries carry the JAX driver's keys and values
    (timings aside)."""
    _, jdrv, _ = jax_runs[4]
    tdrv = _port_driver(jax_system)
    tdrv.run_fused(tdrv.init(SEED), chunk_cycles=4)
    assert len(tdrv.history) == len(jdrv.history)
    for th, jh in zip(tdrv.history, jdrv.history):
        assert set(th) == set(jh)
        for key in ("cycle", "dim", "accept", "attempt", "failed",
                    "esc_relaunch", "esc_reinit", "esc_dead", "ready_frac",
                    "nb_overflow", "nb_rebuilds"):
            assert th[key] == jh[key], key


def test_chunk_size_invariance_bitwise(jax_system):
    """Decisions and float state do not depend on the chunk size."""
    outs = {}
    for k in (1, 3, 8):
        tdrv = _port_driver(jax_system)
        out = tdrv.run_fused(tdrv.init(SEED), chunk_cycles=k)
        outs[k] = (_rows(tdrv), out.state["pos"])
    for k in (1, 3):
        np.testing.assert_array_equal(outs[k][0], outs[8][0])
        assert torch.equal(outs[k][1], outs[8][1])


def test_energy_pair_matches_jax(jax_system, jax_runs):
    """The exchange energies (features + ctrl reduction) of one state."""
    jens0, jdrv, _ = jax_runs[1]
    jeng = jdrv.engine
    teng = MDEngine(_cpu_system(jax_system), device="cpu")
    tdrv = _port_driver(jax_system)
    ctrl_j = {k: v for k, v in jdrv.grid.values.items()}
    ctrl_t = {k: v for k, v in tdrv.grid.values.items()}
    np.testing.assert_array_equal(ctrl_t["beta"].numpy(),
                                  np.asarray(ctrl_j["beta"]))
    tens0 = convert.ensemble_from_arrays(jens0,
                                         jax.random.key_data(jens0.rng),
                                         device="cpu")
    u_t = teng.energy_pair(tens0.state, ctrl_t, ctrl_t)
    u_j = jeng.energy_pair(jens0.state, ctrl_j, ctrl_j)
    for a, b in zip(u_t, u_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    feats_t = teng.replica_features(tens0.state)
    feats_j = jeng.replica_features(jens0.state)
    for key in ("u_base", "u_elec", "phi", "psi"):
        np.testing.assert_allclose(feats_t[key].numpy(),
                                   np.asarray(feats_j[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("policy", ["relaunch", "continue"])
def test_detect_recover_matches_jax(policy, jax_system, jax_runs):
    """A NaN replica is detected and mended (or retired) as in JAX."""
    jens0, _, _ = jax_runs[1]
    teng = MDEngine(_cpu_system(jax_system), device="cpu",
                    max_bond_stretch=3.0, max_energy=1e4)
    jeng_s = JEngine(jax_system, max_bond_stretch=3.0, max_energy=1e4)
    assert teng.failure_detectors == jeng_s.failure_detectors
    tens = convert.ensemble_from_arrays(
        jens0, jax.random.key_data(jens0.rng), device="cpu")
    backup_t = {k: v + 1.0 for k, v in tens.state.items()}
    pos = tens.state["pos"].clone()
    pos[1, 3, 0] = float("nan")
    pos[2, 5] += 20.0                        # one overstretched bond
    vel = tens.state["vel"].clone()
    vel[3] *= 100.0                          # one kinetic-energy blow-up
    tens = tens._replace(state=dict(pos=pos, vel=vel))
    jens = jens0._replace(state={k: jax.numpy.asarray(v.numpy())
                                 for k, v in tens.state.items()})
    backup_j = {k: jax.numpy.asarray(v.numpy()) for k, v in backup_t.items()}
    out_t, bk_t, st_t = tF.detect_recover(teng, tens, policy, backup_t)
    out_j, bk_j, st_j = jF.detect_recover(jeng_s, jens, policy, backup_j)
    assert {k: int(v) for k, v in st_t.items()} == \
        {k: int(v) for k, v in st_j.items()}
    assert int(st_t["failed"]) == 3
    for k in ("pos", "vel"):
        np.testing.assert_array_equal(out_t.state[k].numpy(),
                                      np.asarray(out_j.state[k]))
        np.testing.assert_array_equal(bk_t[k].numpy(), np.asarray(bk_j[k]))
    np.testing.assert_array_equal(out_t.alive.numpy(),
                                  np.asarray(out_j.alive))
    np.testing.assert_array_equal(out_t.relaunches.numpy(),
                                  np.asarray(out_j.relaunches))
    # the legacy entry point applies the same mend
    failed = tF.detect(teng, tens)
    rec_t, n = tF.recover(teng, tens, failed, policy, backup_t)
    assert int(n) == 3
    np.testing.assert_array_equal(rec_t.state["pos"].numpy(),
                                  out_t.state["pos"].numpy())


def test_device_defaults_to_cuda_and_never_falls_back(jax_system,
                                                      monkeypatch):
    for obj in (MDEngine.__init__, REMDDriver.__init__):
        assert inspect.signature(obj).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MDEngine(_cpu_system(jax_system))
    eng = MDEngine(_cpu_system(jax_system), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        REMDDriver(eng, RepExConfig(**CFG))


@pytest.mark.parametrize("kwargs", [dict(mesh=object())])
def test_unported_options_raise(kwargs, jax_system):
    # meshes are ported (run_sharded): a mesh that is not a ReplicaMesh
    # is refused
    cfg = RepExConfig(**CFG)
    eng = MDEngine(_cpu_system(jax_system), device="cpu")
    with pytest.raises(TypeError, match="ReplicaMesh"):
        REMDDriver(eng, cfg, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(failure_rate=0.1), dict(ckpt_dir="ckpt", ckpt_every=2),
    dict(cfg=dict(pattern="asynchronous")), dict(slots=2),
    dict(cfg=dict(relaunch_budget=2)),
    dict(cfg=dict(execution_mode="mode2")),
    dict(cfg=dict(dimensions=(("temperature", 2), ("umbrella", 2)),
                  pattern="asynchronous")),
    dict(telemetry=True),
])
def test_ported_options_build_as_in_jax(kwargs, jax_system):
    """The options that raised before they were ported: the port's
    driver builds with each and reads it as the JAX driver does."""
    c = dict(CFG, **kwargs.pop("cfg", {}))
    if "ckpt_dir" in kwargs:
        kwargs["ckpt_dir"] = None          # nothing written here
    tkw, jkw = dict(kwargs), dict(kwargs)
    if kwargs.get("telemetry"):
        tkw["telemetry"], jkw["telemetry"] = Telemetry(), JTelemetry()
    tdrv = REMDDriver(MDEngine(_cpu_system(jax_system), device="cpu"),
                      RepExConfig(**c), device="cpu", **tkw)
    jdrv = JDriver(JEngine(jax_system), JConfig(**c), **jkw)
    assert tdrv._obs_rows == jdrv._obs_rows
    assert (tdrv._tel is None) == (jdrv._tel is None)
    assert tdrv.execution == jdrv.execution
    assert tdrv.failure_rate == jdrv.failure_rate
    assert tdrv._cfg_fingerprint() == jdrv._cfg_fingerprint()
    assert bool(tdrv.init(SEED).speed.ne(1.0).any()) == \
        (c.get("pattern") == "asynchronous")
