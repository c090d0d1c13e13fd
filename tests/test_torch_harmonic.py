"""The harmonic overhead probe: the port's ``HarmonicEngine`` against the
JAX package's, on the CPU.

  * ``init_state`` bitwise;
  * one ``propagate`` on both ``batched`` values, with masked lanes,
    within 1e-6 (the suffix product and the step sum are reduced in
    another order than XLA's: ``torch.cumprod`` differs from XLA's
    associative scan by up to 3.6e-7 on decay rows, the sum over 60
    steps by up to 3.8e-6 relative, so the positions agree to a
    tolerance and the decisions exactly);
  * ``run_fused`` over 8 cycles at chunk sizes 1 and 4, both exchange
    schemes: assignment rows and ``acceptance_ratios()`` identical to
    the JAX driver's, with the Metropolis margin
    ``|u - exp(min(-delta, 0))|`` of a flip in the failure message;
  * ``REMDDriver.run`` equal to ``run_fused``;
  * the swap acceptance of a two-rung ladder (temperature ratio 2)
    against the closed-form Gamma(d/2) integral of
    ``tests/test_statistics.py``, read from the driver's history.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.core import build_grid as j_build_grid
from repro.core import ctrl_for_assignment as j_ctrl_for_assignment
from repro.md import HarmonicEngine as JHarmonicEngine
from repro_torch import random as jr
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import exchange as tX
from repro_torch.core.controls import build_grid, ctrl_for_assignment
from repro_torch.md import HarmonicEngine
from test_statistics import p_acc_analytic

R = 4
X_ATOL = 1e-6
RUN_CFG = dict(dimensions=(("temperature", 8),), md_steps_per_cycle=10,
               n_cycles=8)


def test_init_state_bitwise():
    for n_dim in (1, 3, 5):
        j = JHarmonicEngine(n_dim=n_dim).init_state(jax.random.key(3), R)
        t = HarmonicEngine(n_dim=n_dim, device="cpu").init_state(jr.key(3),
                                                                  R)
        np.testing.assert_array_equal(t["x"].numpy(), np.asarray(j["x"]))


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("max_steps", [1, 7, 60])
def test_propagate_matches_jax(batched, max_steps):
    """Lanes with all, some and none of the steps."""
    cfg = dict(dimensions=(("temperature", R),))
    jeng = JHarmonicEngine(batched=batched)
    teng = HarmonicEngine(batched=batched, device="cpu")
    rng = np.random.default_rng(max_steps)
    x = rng.standard_normal((R, 3)).astype(np.float32) * 0.8
    n = np.array([max_steps, max_steps, max_steps // 2, 0])
    jctrl = j_ctrl_for_assignment(j_build_grid(JConfig(**cfg)),
                                  jnp.arange(R), jeng.ctrl_keys)
    tctrl = ctrl_for_assignment(build_grid(RepExConfig(**cfg), "cpu"),
                                torch.arange(R), teng.ctrl_keys)
    out_j = jeng.propagate({"x": jnp.asarray(x)}, jctrl,
                           jnp.asarray(n, jnp.int32),
                           jax.random.split(jax.random.key(5), R),
                           max_steps=max_steps)
    out_t = teng.propagate({"x": torch.from_numpy(x)}, tctrl,
                           torch.from_numpy(n), jr.split(jr.key(5), R),
                           max_steps=max_steps)
    np.testing.assert_allclose(out_t["x"].numpy(), np.asarray(out_j["x"]),
                               rtol=0, atol=X_ATOL)
    assert torch.equal(out_t["x"][3], torch.from_numpy(x[3]))
    np.testing.assert_allclose(teng.energy(out_t, tctrl).numpy(),
                               np.asarray(jeng.energy(out_j, jctrl)),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for scheme in ("neighbor", "matrix"):
        for k in (1, 4):
            drv = JDriver(JHarmonicEngine(),
                          JConfig(**RUN_CFG, exchange_scheme=scheme))
            out = drv.run_fused(drv.init(0), chunk_cycles=k)
            runs[scheme, k] = (drv, out)
    return runs


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_run_fused_decisions_match_jax(scheme, chunk, jax_runs,
                                       monkeypatch):
    seen = []
    orig = tX.metropolis

    def spy(delta, rng):
        seen.append((delta.clone(), tX.jr.uniform(rng, tuple(delta.shape))))
        return orig(delta, rng)

    monkeypatch.setattr(tX, "metropolis", spy)
    jdrv, jout = jax_runs[scheme, chunk]
    tdrv = REMDDriver(HarmonicEngine(device="cpu"),
                      RepExConfig(**RUN_CFG, exchange_scheme=scheme),
                      device="cpu")
    tout = tdrv.run_fused(tdrv.init(0), chunk_cycles=chunk)
    jrows, trows = _rows(jdrv), _rows(tdrv)
    if not np.array_equal(jrows, trows):
        c = int(np.nonzero((jrows != trows).any(axis=1))[0][0])
        delta, u = seen[c]
        margin = torch.abs(u - torch.exp(torch.clamp_max(-delta, 0.0)))
        pytest.fail(f"assignment differs first at cycle {c}: jax "
                    f"{jrows[c]}, port {trows[c]}; Metropolis margins "
                    f"{margin.tolist()}")
    assert tdrv.acceptance_ratios() == jdrv.acceptance_ratios()
    np.testing.assert_allclose(tout.state["x"].numpy(),
                               np.asarray(jout.state["x"]), rtol=0,
                               atol=1e-5)

    per_cycle = REMDDriver(HarmonicEngine(device="cpu"),
                           RepExConfig(**RUN_CFG, exchange_scheme=scheme),
                           device="cpu")
    r_out = per_cycle.run(per_cycle.init(0))
    np.testing.assert_array_equal(_rows(per_cycle), trows)
    assert per_cycle.acceptance == tdrv.acceptance
    assert torch.equal(r_out.state["x"], tout.state["x"])


def test_two_rung_acceptance_matches_the_gamma_integral():
    """Temperature ratio 2, d = 3: the analytic swap rate is 0.584.
    gamma * dt * md_steps = 15, so each cycle re-equilibrates and the
    attempts are independent; about 990 attempts after a 64-cycle
    warm-up give a binomial standard error of 0.016, so the tolerance
    0.05 is three of them."""
    cfg = RepExConfig(dimensions=(("temperature", 2),), t_min=300.0,
                      t_max=600.0, md_steps_per_cycle=60, n_cycles=2048,
                      seed=3)
    drv = REMDDriver(HarmonicEngine(n_dim=3, k_spring=1.0, dt=0.05,
                                    gamma=5.0, device="cpu"), cfg,
                     device="cpu")
    drv.run_fused(drv.init(), chunk_cycles=128)
    prod = drv.history[64:]
    accepted = sum(h["accept"] for h in prod)
    attempted = sum(h["attempt"] for h in prod)
    assert attempted == len(prod) // 2
    predicted = p_acc_analytic(2.0)
    assert abs(accepted / attempted - predicted) < 0.05, (
        accepted / attempted, predicted)
