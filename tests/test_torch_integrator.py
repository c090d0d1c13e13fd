"""The port's BAOAB integrator against the JAX package's: one masked
force-sharing iteration, and the whole replica-major propagate loop with
lanes that take fewer steps than the loop length (``n_steps <
max_steps``).  Inputs are made with numpy and handed to both.

Tolerance: float32; one iteration within 2 ulp-scale (atol 1e-6 on
O(1-10) values), the propagate loop within 1e-5 A / A ps^-1 after the
forces pass through their two implementations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import MDEngine as JEngine
from repro.md import integrators as jI
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.md import MDEngine
from repro_torch.md import integrators as tI

R, N = 4, 10
N_STEPS = np.array([3, 1, 0, 2], np.int32)        # lane 2 stays frozen
MAX_STEPS = 3


def _cpu_system(jsys):
    return convert.system_from_arrays(jsys, device="cpu")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        pos=rng.standard_normal((R, N, 3)).astype(f32) * 5,
        vel=rng.standard_normal((R, N, 3)).astype(f32),
        f=rng.standard_normal((R, N, 3)).astype(f32) * 50,
        noise=rng.standard_normal((R, N, 3)).astype(f32),
        masses=np.full(N, 12.0, f32) + rng.random(N).astype(f32),
        temperature=np.geomspace(273.0, 373.0, R).astype(f32),
    )


def test_baoab_scales_match():
    d = _inputs()
    c1_t, ns_t = tI.baoab_scales(torch.from_numpy(d["masses"]),
                                 torch.from_numpy(d["temperature"]),
                                 5e-4, 5.0)
    c1_j, ns_j = jI.baoab_scales(jnp.asarray(d["masses"]),
                                 jnp.asarray(d["temperature"]), 5e-4, 5.0)
    assert np.float32(c1_t) == np.asarray(c1_j)
    np.testing.assert_allclose(ns_t.numpy(), np.asarray(ns_j), rtol=1.2e-7)


@pytest.mark.parametrize("i", range(MAX_STEPS + 1))
def test_baoab_fused_iteration_matches(i):
    """Every iteration index, so both the trail mask (i >= 1, i <= n)
    and the lead mask (i < n, i < max_steps) are exercised per lane."""
    d = _inputs(seed=i)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    c1, ns = tI.baoab_scales(t["masses"], t["temperature"], 5e-4, 5.0)
    jc1, jns = jI.baoab_scales(j["masses"], j["temperature"], 5e-4, 5.0)
    pos_t, vel_t = tI.baoab_fused_iteration(
        i, t["pos"], t["vel"], t["f"], t["noise"], c1, ns, t["masses"],
        torch.from_numpy(N_STEPS).long(), MAX_STEPS, 5e-4)
    pos_j, vel_j = jI.baoab_fused_iteration(
        i, j["pos"], j["vel"], j["f"], j["noise"], jc1, jns, j["masses"],
        jnp.asarray(N_STEPS), MAX_STEPS, 5e-4, 0.0)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), atol=1e-6)
    np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), atol=1e-6)
    # lane 2 has n_steps = 0: bitwise frozen in both
    np.testing.assert_array_equal(pos_t[2].numpy(), d["pos"][2])
    np.testing.assert_array_equal(vel_t[2].numpy(), d["vel"][2])


def test_propagate_replica_major_matches():
    """The whole loop through the engines' analytic force fields, with
    masked lanes, from the same positions, velocities and keys."""
    jsys = j_chain_molecule(N)
    jeng = JEngine(jsys)
    teng = MDEngine(_cpu_system(jsys), device="cpu")
    d = _inputs(seed=7)
    rng = np.random.default_rng(7)
    pos = (np.asarray(jax.device_get(jeng.init_state(jax.random.key(1), R)
                                     ["pos"]))
           + 0.01 * rng.standard_normal((R, N, 3))).astype(np.float32)
    vel = d["vel"]
    temp = d["temperature"]
    jkeys = jax.random.split(jax.random.key(5), R)
    tkeys = jr.split(jr.key(5), R)
    out_j = jI.propagate_replica_major(
        {"pos": jnp.asarray(pos), "vel": jnp.asarray(vel)},
        jeng._analytic_force_fn({"temperature": jnp.asarray(temp)}),
        jsys.masses, jnp.asarray(temp), jnp.asarray(N_STEPS), jkeys,
        MAX_STEPS, 5e-4, 5.0)
    ctrl = {"temperature": torch.from_numpy(temp)}
    out_t = tI.propagate_replica_major(
        {"pos": torch.from_numpy(pos), "vel": torch.from_numpy(vel)},
        teng._analytic_force_fn(ctrl), teng.system.masses, ctrl["temperature"],
        torch.from_numpy(N_STEPS).long(), tkeys, MAX_STEPS, 5e-4, 5.0)
    for k in ("pos", "vel"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out_t["pos"][2].numpy(), pos[2])


def test_engine_propagate_matches():
    """``MDEngine.propagate`` end to end (per-replica keys, ctrl rows)."""
    jsys = j_chain_molecule(N)
    jeng = JEngine(jsys)
    teng = MDEngine(_cpu_system(jsys), device="cpu")
    jstate = jeng.init_state(jax.random.key(2), R)
    tstate = teng.init_state(jr.key(2), R)
    for k in ("pos", "vel"):                 # normals within 1 ulp
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=3e-7, atol=1e-7)
    temp = np.geomspace(273.0, 373.0, R).astype(np.float32)
    n = np.full(R, 4, np.int32)
    out_j = jeng.propagate(jstate, {"temperature": jnp.asarray(temp)},
                           jnp.asarray(n), jax.random.split(
                               jax.random.key(9), R), max_steps=4)
    out_t = teng.propagate(tstate, {"temperature": torch.from_numpy(temp)},
                           torch.from_numpy(n).long(),
                           jr.split(jr.key(9), R), max_steps=4)
    for k in ("pos", "vel"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-5, err_msg=k)


def test_thermal_helpers_match():
    masses = np.full(N, 12.0, np.float32)
    v_t = tI.maxwell_boltzmann(jr.split(jr.key(4), R), torch.from_numpy(
        masses), 300.0, (N, 3))
    v_j = jax.vmap(lambda k: jI.maxwell_boltzmann(
        k, jnp.asarray(masses), 300.0, (N, 3)))(
            jax.random.split(jax.random.key(4), R))
    # normals within 1 ulp, scaled by the same float32 sigma
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=3e-7)
    np.testing.assert_allclose(
        tI.kinetic_temperature(v_t, torch.from_numpy(masses)).numpy(),
        np.asarray(jI.kinetic_temperature(v_j, jnp.asarray(masses))),
        rtol=1e-6)
