"""``MDEngine``'s oracle force paths against the JAX package's same
paths, on the CPU, at ``chain_molecule(10)`` and R = 8:

  * ``"batched"``: ``torch.autograd.grad`` of the replica-major potential
    (``energy.batched_potential_energy``);
  * ``"vmap"`` (``batched=False``): each replica's own program — whole
    BAOAB steps, the force from autograd of ``energy.potential_energy`` —
    and per-replica exchange energies;
  * the reference's ``ValueError`` for conflicting paths (sparse passes
    on an autograd oracle, ``batched=False`` with another path).

Tolerances: forces within 2e-5 of max |F| (autodiff of the same float32
energy in two frameworks, and the port's analytic forces); one propagate
within 1e-5 A and A/ps on a T x U x salt grid with a zero-step lane
(frozen bitwise); exchange energies 1e-5 relative; a 4-cycle driver run
makes JAX's decisions, positions within 1e-4 A.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.core.controls import ctrl_for_assignment as j_ctrl
from repro.core.modes import per_replica_keys as j_keys
from repro.md import MDEngine as JEngine
from repro.md import energy as jE
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core.controls import ctrl_for_assignment as t_ctrl
from repro_torch.core.modes import per_replica_keys as t_keys
from repro_torch.md import MDEngine
from repro_torch.md import energy as tE
from repro_torch.md.engine import _autograd_force

CFG = dict(dimensions=(("temperature", 4),), md_steps_per_cycle=3,
           n_cycles=4)
POS_TOL = 1e-4
SEED = 0


@pytest.fixture(scope="module")
def jax_system():
    return j_chain_molecule(10)


def _cpu_system(jax_system):
    return convert.system_from_arrays(jax_system, device="cpu")


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


@pytest.mark.parametrize("kwargs", [
    dict(force_path="batched", bonded="sparse"),
    dict(force_path="vmap", nonbonded="sparse"),
    dict(batched=False, force_path="pallas"),
    dict(batched=False, nonbonded="sparse"),
    dict(force_path="nope"),
])
def test_engine_path_conflicts_raise_value_error_as_jax(kwargs, jax_system):
    with pytest.raises(ValueError):
        JEngine(jax_system, **kwargs)
    with pytest.raises(ValueError):
        MDEngine(_cpu_system(jax_system), device="cpu", **kwargs)


ORACLE_F_TOL, ORACLE_STATE_TOL = 2e-5, 1e-5


def _oracle_inputs(jax_system, jdrv, n_rep=8):
    jens = jdrv.init(SEED)
    tens = convert.ensemble_from_arrays(
        jens, jax.random.key_data(jens.rng), device="cpu")
    tgrid = REMDDriver(MDEngine(_cpu_system(jax_system), device="cpu"),
                       jdrv.cfg, device="cpu").grid
    return (jens, tens, j_ctrl(jdrv.grid, jens.assignment),
            t_ctrl(tgrid, tens.assignment))


@pytest.mark.parametrize("path", ["batched", "vmap"])
def test_oracle_propagate_matches_jax(path, jax_system):
    dims = (("temperature", 2), ("umbrella", 2), ("salt", 2))
    kw = dict(batched=False) if path == "vmap" else dict(force_path=path)
    jeng = JEngine(jax_system, **kw)
    teng = MDEngine(_cpu_system(jax_system), device="cpu", **kw)
    assert teng.force_path == jeng.force_path == path
    assert teng.batched == jeng.batched == (path == "batched")
    jdrv = JDriver(jeng, JConfig(dimensions=dims, md_steps_per_cycle=3))
    jens, tens, jctrl, tctrl = _oracle_inputs(jax_system, jdrv)
    n_steps = np.array([3, 3, 2, 3, 0, 3, 1, 3])
    jout = jeng.propagate(jens.state, jctrl, jax.numpy.asarray(n_steps),
                          j_keys(jens.rng, 8), max_steps=3)
    tout = teng.propagate(tens.state, tctrl, torch.as_tensor(n_steps),
                          t_keys(tens.rng, 8), max_steps=3)
    for k in ("pos", "vel"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=ORACLE_STATE_TOL, err_msg=k)
    # the zero-step lane is frozen bitwise
    assert torch.equal(tout["pos"][4], tens.state["pos"][4])
    fj = jeng.energy(jout, jctrl)
    ft = teng.energy({k: torch.as_tensor(np.array(v))
                      for k, v in jout.items()}, tctrl)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)


def test_oracle_forces_match_jax_and_the_analytic_path(jax_system):
    """The batched autograd force and the vmap per-replica force against
    jax.grad of JAX's potentials, and against the port's analytic
    ("pallas") forces."""
    dims = (("temperature", 2), ("umbrella", 2), ("salt", 2))
    jdrv = JDriver(JEngine(jax_system), JConfig(dimensions=dims))
    jens, tens, jctrl, tctrl = _oracle_inputs(jax_system, jdrv)
    teng = MDEngine(_cpu_system(jax_system), device="cpu")
    pos = tens.state["pos"]
    f_b = _autograd_force(lambda p: tE.batched_potential_energy(
        p, teng.system, tctrl), pos)
    f_j = jax.jit(jax.grad(lambda p: -jnp.sum(jE.batched_potential_energy(
        p, jax_system, jctrl))))(jens.state["pos"])
    scale = float(np.abs(np.asarray(f_j)).max())
    np.testing.assert_allclose(f_b.numpy(), np.asarray(f_j),
                               atol=ORACLE_F_TOL * scale)
    f_a = teng._analytic_force_fn(tctrl)(pos)
    np.testing.assert_allclose(f_b.numpy(), f_a.numpy(),
                               atol=ORACLE_F_TOL * scale)
    for r in (0, 5):
        row_t = {k: v[r] for k, v in tctrl.items()}
        row_j = {k: v[r] for k, v in jctrl.items()}
        f_v = _autograd_force(lambda p: tE.potential_energy(
            p, teng.system, row_t), pos[r])
        f_vj = jax.jit(jax.grad(lambda p: -jE.potential_energy(
            p, jax_system, row_j)))(jens.state["pos"][r])
        np.testing.assert_allclose(f_v.numpy(), np.asarray(f_vj),
                                   atol=ORACLE_F_TOL * scale)
        np.testing.assert_allclose(f_v.numpy(), f_b[r].numpy(),
                                   atol=ORACLE_F_TOL * scale)


@pytest.mark.parametrize("path", ["batched", "vmap"])
def test_oracle_driver_decisions_match_jax(path, jax_system):
    kw = dict(batched=False) if path == "vmap" else dict(force_path=path)
    cfg = CFG
    jdrv = JDriver(JEngine(jax_system, **kw), JConfig(**cfg))
    jout = jdrv.run_fused(jdrv.init(SEED), chunk_cycles=2)
    tdrv = REMDDriver(MDEngine(_cpu_system(jax_system), device="cpu", **kw),
                      RepExConfig(**cfg), device="cpu")
    tout = tdrv.run_fused(tdrv.init(SEED), chunk_cycles=2)
    np.testing.assert_array_equal(_rows(tdrv), _rows(jdrv))
    assert tdrv.acceptance_ratios() == jdrv.acceptance_ratios()
    np.testing.assert_allclose(tout.state["pos"].numpy(),
                               np.asarray(jout.state["pos"]), atol=POS_TOL)
