"""The port's public surface against the JAX package's, on the CPU.

  * ``repro_torch.core`` exports ``repro.core``'s 21 names and
    ``repro_torch.md`` ``MolecularSystem`` / ``chain_molecule``; the
    JAX package's XLA-sharding names map to the port's counterparts
    (``PORT_COUNTERPARTS``);
  * ``SimulationEngine`` is a runtime-checkable protocol the four
    engines satisfy;
  * a user-written engine, the ``DoubleWellEngine`` of
    ``docs/ENGINES.md`` written once for each package below, makes the
    same assignment trace and acceptance counts under both drivers'
    ``run_fused`` (chunk 16) from the same seed, the Metropolis margins
    printed on a flip;
  * ``sync_cycle`` / ``async_cycle`` on one ensemble: the same new
    assignment, stats layout, counts and pair rows, ``mean_delta``
    within float32 rounding;
  * ``load_checkpoint(verify=, fallback=, step=)`` on checkpoints
    written by either package with the newest step truncated or with a
    flipped payload byte: the port restores the step JAX restores, or
    raises where JAX raises;
  * ``to_dict`` equals JAX's on ``RepExConfig``, ``ModelConfig`` (with
    ``moe``), ``TrainConfig`` and ``MeshConfig`` built from the same
    fields.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.config as jcfg
import repro.core as jcore
import repro.md as jmd
import repro_torch.config as tcfg
import repro_torch.core as tcore
import repro_torch.md as tmd
from repro.ckpt import checkpoint as jck
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.ckpt import checkpoint as tck
from repro_torch.core import exchange as TX
from repro_torch.models.lm_engine import LMEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- exports ---------------------------------------------------------------

# Names of the JAX package's core modules with no export of the same name
# in the port, each with the port's counterpart: XLA shards one program's
# arrays over a device mesh, the port runs one process per shard.
PORT_COUNTERPARTS = {
    "repro.core.modes.replica_sharding":
        "repro_torch.sharding.ensemble_shardings (the rows a rank holds)",
    "repro.core.modes.shard_replicas":
        "repro_torch.sharding.shard_ensemble (cut the state to the block)",
    "repro.core.failures.detect_recover_sharded":
        "repro_torch.core.failures.detect_recover(mesh=...)",
}


def _public(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_core_exports_every_name_of_the_jax_package():
    want, got = _public(jcore), _public(tcore)
    assert len(want) == 21
    assert want == got, (sorted(want - got), sorted(got - want))
    ns = {}
    exec("from repro_torch.core import *", ns)
    assert want <= set(ns)


def test_md_exports():
    assert {"MolecularSystem", "chain_molecule", "MDEngine", "LJEngine",
            "HarmonicEngine"} == _public(jmd) - {"engine", "system"} \
        <= _public(tmd)
    assert tmd.chain_molecule(22).n_atoms == 22


@pytest.mark.parametrize("name", sorted(PORT_COUNTERPARTS))
def test_xla_sharding_names_have_a_port_counterpart(name):
    import importlib
    mod, _, attr = name.rpartition(".")
    assert callable(getattr(importlib.import_module(mod), attr))
    assert not hasattr(importlib.import_module(
        mod.replace("repro.", "repro_torch.", 1)), attr)
    target = PORT_COUNTERPARTS[name].split(" ")[0].split("(")[0]
    tmod, _, tattr = target.rpartition(".")
    assert callable(getattr(importlib.import_module(tmod), tattr))


def test_engines_satisfy_the_protocol():
    from repro_torch.config import ModelConfig
    engines = [tmd.MDEngine(device="cpu"), tmd.LJEngine(device="cpu"),
               tmd.HarmonicEngine(device="cpu"),
               LMEngine(ModelConfig(n_layers=1, d_model=16, n_heads=2,
                                    n_kv_heads=2, d_ff=32, vocab_size=32),
                        device="cpu"),
               TorchDoubleWell()]
    for eng in engines:
        assert isinstance(eng, tcore.SimulationEngine), type(eng).__name__
    assert not isinstance(object(), tcore.SimulationEngine)


# -- a user-written engine, once per package --------------------------------


class JaxDoubleWell:
    """``docs/ENGINES.md``'s worked engine: U(x) = (x^2 - 1)^2,
    overdamped Langevin, temperature exchange only."""

    ctrl_keys = ("temperature", "beta")
    KB = 0.0019872041

    def __init__(self, dt=1e-3):
        self.dt = dt

    def init_state(self, rng, n_replicas):
        return {"x": jax.random.normal(rng, (n_replicas,))}

    def _grad_u(self, x):
        return 4.0 * x * (x * x - 1.0)

    def propagate(self, state, ctrl, n_steps, rngs, max_steps=0):
        max_steps = max_steps or int(jnp.max(n_steps))
        sigma = jnp.sqrt(2.0 * self.KB * ctrl["temperature"] * self.dt)

        def body(t, x):
            keys = jax.vmap(lambda k: jax.random.fold_in(k, t))(rngs)
            noise = jax.vmap(lambda k: jax.random.normal(k))(keys)
            nx = x - self.dt * self._grad_u(x) + sigma * noise
            return jnp.where(t < n_steps, nx, x)

        return {"x": lax.fori_loop(0, max_steps, body, state["x"])}

    def energy(self, state, ctrl):
        x = state["x"]
        return ctrl["beta"] * (x * x - 1.0) ** 2

    def replica_features(self, state):
        x = state["x"]
        return {"u": (x * x - 1.0) ** 2}

    def energy_pair_from_features(self, f, ctrl_a, ctrl_b):
        return ctrl_a["beta"] * f["u"], ctrl_b["beta"] * f["u"]

    def cross_energy_from_features(self, f, ctrl_grid):
        return f["u"][:, None] * ctrl_grid["beta"][None, :]

    def energy_pair(self, state, ctrl_a, ctrl_b):
        return self.energy_pair_from_features(
            self.replica_features(state), ctrl_a, ctrl_b)

    def cross_energy(self, state, ctrl_grid):
        return self.cross_energy_from_features(
            self.replica_features(state), ctrl_grid)

    def is_failed(self, state):
        return ~jnp.isfinite(state["x"])


class TorchDoubleWell:
    """The same engine written against the port: the step loop a Python
    loop to ``max_steps`` (a host int), the keys folded per step."""

    ctrl_keys = ("temperature", "beta")
    KB = 0.0019872041

    def __init__(self, dt=1e-3, device="cpu"):
        self.dt = dt
        self.device = torch.device(device)

    def init_state(self, rng, n_replicas):
        return {"x": jr.normal(rng, (n_replicas,))}

    def _grad_u(self, x):
        return 4.0 * x * (x * x - 1.0)

    def propagate(self, state, ctrl, n_steps, rngs, max_steps, stack=None):
        sigma = torch.sqrt(2.0 * self.KB * ctrl["temperature"] * self.dt)
        x = state["x"]
        for t in range(max_steps):
            noise = jr.normal(jr.fold_in(rngs, t), ())
            nx = x - self.dt * self._grad_u(x) + sigma * noise
            x = torch.where(t < n_steps, nx, x)
        return {"x": x}

    def energy(self, state, ctrl):
        x = state["x"]
        return ctrl["beta"] * (x * x - 1.0) ** 2

    def replica_features(self, state):
        x = state["x"]
        return {"u": (x * x - 1.0) ** 2}

    def energy_pair_from_features(self, f, ctrl_a, ctrl_b):
        return ctrl_a["beta"] * f["u"], ctrl_b["beta"] * f["u"]

    def cross_energy_from_features(self, f, ctrl_grid):
        return f["u"][:, None] * ctrl_grid["beta"][None, :]

    def energy_pair(self, state, ctrl_a, ctrl_b):
        return self.energy_pair_from_features(
            self.replica_features(state), ctrl_a, ctrl_b)

    def cross_energy(self, state, ctrl_grid):
        return self.cross_energy_from_features(
            self.replica_features(state), ctrl_grid)

    def is_failed(self, state):
        return ~torch.isfinite(state["x"])


DW_CFG = dict(dimensions=(("temperature", 8),), t_min=200, t_max=1200,
              md_steps_per_cycle=50, n_cycles=32)


def test_user_engine_makes_the_same_trajectory_under_both_drivers():
    jd = jcore.REMDDriver(JaxDoubleWell(), jcfg.RepExConfig(**DW_CFG))
    jd.run_fused(jd.init(), chunk_cycles=16)
    seen = []

    def spy(delta, rng):
        seen.append((delta.clone(), jr.uniform(rng, tuple(delta.shape))))
        return orig(delta, rng)
    orig, TX.metropolis = TX.metropolis, spy
    try:
        td = tcore.REMDDriver(TorchDoubleWell(), tcfg.RepExConfig(**DW_CFG),
                              device="cpu")
        td.run_fused(td.init(), chunk_cycles=16)
    finally:
        TX.metropolis = orig
    assert td.capabilities == {**jcore.engine_capabilities(JaxDoubleWell()),
                               "donate": False}
    assert len(td.history) == len(jd.history) == DW_CFG["n_cycles"]
    for c, (t, j) in enumerate(zip(td.history, jd.history)):
        if not (np.array_equal(t["assignment"], j["assignment"])
                and t["accept"] == j["accept"]):
            delta, u = seen[c]
            print(f"cycle {c}: Metropolis margins |u - exp(min(-d, 0))| "
                  f"{(u - torch.exp(torch.clamp_max(-delta, 0))).abs()}")
        np.testing.assert_array_equal(t["assignment"], j["assignment"])
        assert (t["accept"], t["attempt"]) == (j["accept"], j["attempt"])
    assert td.acceptance_ratios() == jd.acceptance_ratios()
    assert 0 < sum(h["accept"] for h in td.history)


# -- sync_cycle / async_cycle -------------------------------------------------

GRID = dict(dimensions=(("temperature", 4), ("umbrella", 2)),
            t_min=200, t_max=1200)


def _ensembles(hetero: bool):
    """One JAX ensemble of the double-well engine and the port's copy."""
    jeng = JaxDoubleWell()
    jens = jcore.make_ensemble(jeng, jax.random.key(3), 8,
                               hetero_speed=hetero)
    tens = convert.ensemble_from_arrays(jens, jax.random.key_data(jens.rng),
                                        "cpu")
    return jeng, jens, TorchDoubleWell(), tens


@pytest.mark.parametrize("pattern", ["synchronous", "asynchronous"])
@pytest.mark.parametrize("dim_index,parity,scheme", [
    (0, 0, "neighbor"), (0, 1, "neighbor"), (1, 0, "neighbor"),
    (0, 0, "matrix")])
def test_host_scheduled_cycles_match_jax(pattern, dim_index, parity,
                                         scheme):
    cfg = jcfg.RepExConfig(**GRID)
    jgrid = jcore.build_grid(cfg)
    tgrid = tcore.build_grid(tcfg.RepExConfig(**GRID), "cpu")
    jeng, jens, teng, tens = _ensembles(pattern == "asynchronous")
    if pattern == "synchronous":
        jfn = functools.partial(jcore.sync_cycle, md_steps=20)
        tfn = functools.partial(tcore.sync_cycle, md_steps=20)
    else:
        jfn = functools.partial(jcore.async_cycle, md_steps=20,
                                window_steps=10)
        tfn = functools.partial(tcore.async_cycle, md_steps=20,
                                window_steps=10)
    kw = dict(dim_index=dim_index, parity=parity, scheme=scheme,
              telemetry_rows=True)
    jnew, jst = jfn(jeng, jgrid, jens, **kw)
    tnew, tst = tfn(teng, tgrid, tens, **kw)
    np.testing.assert_array_equal(tnew.assignment.numpy(),
                                  np.asarray(jnew.assignment))
    np.testing.assert_array_equal(tnew.debt.numpy(), np.asarray(jnew.debt))
    assert int(tnew.cycle) == int(jnew.cycle) == 1
    np.testing.assert_array_equal(tnew.rng.numpy(),
                                  np.asarray(jax.random.key_data(jnew.rng)))
    np.testing.assert_allclose(tnew.state["x"].numpy(),
                               np.asarray(jnew.state["x"]), rtol=0,
                               atol=1e-6)
    assert set(tst) == set(jst)
    d = f"dim{dim_index}"
    assert set(tst[d]) == set(jst[d]) == {"attempted", "accepted",
                                          "mean_delta"}
    for k in ("attempted", "accepted"):
        assert float(tst[d][k]) == float(jst[d][k])
    np.testing.assert_allclose(float(tst[d]["mean_delta"]),
                               float(jst[d]["mean_delta"]), rtol=1e-5,
                               atol=1e-6)
    if scheme == "neighbor":
        for k in ("pair_attempt", "pair_accept"):
            np.testing.assert_array_equal(tst[k].numpy(),
                                          np.asarray(jst[k]))
    if pattern == "asynchronous":
        assert float(tst["ready_frac"]) == float(jst["ready_frac"])


# -- load_checkpoint's keywords ----------------------------------------------


def _tree(step):
    rng = np.random.default_rng(step)
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": np.arange(5, dtype=np.int32) + step}


def _write(writer, directory):
    for step in (1, 2, 3):
        t = _tree(step)
        if writer == "port":
            tck.save_checkpoint(directory, step,
                                {k: torch.from_numpy(v) for k, v in
                                 t.items()})
        else:
            jck.save_checkpoint(directory, step,
                                {k: jnp.asarray(v) for k, v in t.items()})


def _damage(directory, how):
    path = directory / "step-00000003" / "arr-000000.npy"
    data = bytearray(path.read_bytes())
    if how == "truncate":
        path.write_bytes(bytes(data[:len(data) - 20]))
    else:                                   # a flipped payload byte
        data[-3] ^= 0x40
        path.write_bytes(bytes(data))


def _outcome(load, directory, like, **kw):
    try:
        tree, step, _ = load(str(directory), like, **kw)
    except jck.CheckpointCorruptError:
        return ("corrupt",)
    except tck.CheckpointCorruptError:
        return ("corrupt",)
    return ("ok", step, np.asarray(tree["a"]).tobytes())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_load_checkpoint_keywords_match_jax(writer, damage, tmp_path):
    _write(writer, tmp_path)
    _damage(tmp_path, damage)
    jlike = {k: jnp.zeros_like(v) for k, v in _tree(0).items()}
    tlike = {k: torch.from_numpy(np.zeros_like(v)) for k, v in
             _tree(0).items()}
    seen = set()
    for verify in (True, False):
        for fallback in (True, False):
            for step in (None, 3, 2):
                kw = dict(verify=verify, fallback=fallback, step=step)
                want = _outcome(jck.load_checkpoint, tmp_path, jlike, **kw)
                got = _outcome(tck.load_checkpoint, tmp_path, tlike, **kw)
                assert got == want, kw
                seen.add(want[:2])
    # every behaviour shows: walk-back, the damaged step, a raise
    assert {("ok", 2), ("corrupt",)} <= seen
    assert (("ok", 3) in seen) == (damage == "bitflip")


# -- to_dict / MeshConfig -----------------------------------------------------


def _same_fields(jtype, ttype, **kw):
    return jtype(**kw), ttype(**kw)


@pytest.mark.parametrize("name,kw", [
    ("RepExConfig", dict(dimensions=(("temperature", 6), ("umbrella", 8)),
                         pattern="asynchronous", relaunch_budget=2)),
    ("ModelConfig", dict(name="m", family="moe", n_layers=3)),
    ("TrainConfig", dict(learning_rate=1e-3, grad_compression="int8_ef")),
    ("MeshConfig", dict(shape=(2, 4), axes=("data", "model"))),
])
def test_to_dict_matches_jax(name, kw):
    if name == "ModelConfig":
        jm = jcfg.MoEConfig(num_experts=8, top_k=2, d_ff_expert=96)
        tm = tcfg.MoEConfig(num_experts=8, top_k=2, d_ff_expert=96)
        j, t = getattr(jcfg, name)(moe=jm, **kw), \
            getattr(tcfg, name)(moe=tm, **kw)
    else:
        j, t = _same_fields(getattr(jcfg, name), getattr(tcfg, name), **kw)
    assert tcfg.to_dict(t) == jcfg.to_dict(j)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert tcfg.to_dict(getattr(tcfg, name)()) == \
        jcfg.to_dict(getattr(jcfg, name)())
