"""Execution Mode II (replicas time-multiplexed in waves) in the port,
on the CPU.

  * Mode II with 2 waves (``slots=4``) and 3 waves (``slots=3``: W = 3,
    the last wave padded with one copy of replica 0 at zero steps) is
    bitwise equal to the port's Mode I — assignment rows, acceptance and
    the whole state — on ``MDEngine`` ("pallas" and "fused"),
    ``LJEngine`` and ``HarmonicEngine``, under both patterns (the
    asynchronous one gives the lanes different step counts).  That runs
    in a child process under ``ATEN_CPU_CAPABILITY=default``: PyTorch's
    SIMD CPU kernels treat the elements of a vector and those of its
    scalar tail with different arithmetic (FMA contraction), so with
    them a replica's bits follow its position in the stack; the scalar
    kernels, like the card's, give every element the same arithmetic.
    In this process (SIMD kernels) the decisions are still identical
    and the states agree within 1e-5;
  * the port's Mode II makes the JAX package's Mode II decisions;
  * ``execution_mode="mode2"`` forces at least two waves, and
    ``auto_mode`` picks what JAX's picks;
  * ``propagate_mode2`` gives each wave the ensemble's replica count
    (``stack``), and the nonbonded and LJ-fluid kernels size their split
    by it (the split, not the call's replica count, fixes the order of a
    replica's sums on the card).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.core.modes import auto_mode as j_auto_mode
from repro.md import MDEngine as JEngine
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import modes as tM
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.md import HarmonicEngine, LJEngine, MDEngine

CFG = dict(dimensions=(("temperature", 8),), md_steps_per_cycle=3,
           n_cycles=4)
SEED = 1


@pytest.fixture(scope="module")
def jax_system():
    return j_chain_molecule(10)


def _engine(kind, jax_system):
    if kind == "lj":
        return LJEngine(n_particles=27, box=10.0, device="cpu")
    if kind == "harmonic":
        return HarmonicEngine(device="cpu")
    return MDEngine(convert.system_from_arrays(jax_system, device="cpu"),
                    force_path=kind, device="cpu")


def _run(engine, slots=None, **cfg):
    drv = REMDDriver(engine, RepExConfig(**dict(CFG, **cfg)), slots=slots,
                     device="cpu")
    out = drv.run_fused(drv.init(SEED), chunk_cycles=2)
    return drv, out


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


KINDS = ("pallas", "fused", "lj", "harmonic")
PATTERNS = ("synchronous", "asynchronous")

# Mode I, then Mode II at slots 4 and 3, for every engine and pattern on
# the port's own chain; prints one JSON object of the comparisons.
_CHILD = r"""
import json, sys, torch
sys.path.insert(0, {src!r})
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.md import HarmonicEngine, LJEngine, MDEngine
from repro_torch.md.system import chain_molecule
out = {{}}
for kind in {kinds!r}:
    eng = (LJEngine(n_particles=27, box=10.0, device="cpu") if kind == "lj"
           else HarmonicEngine(device="cpu") if kind == "harmonic"
           else MDEngine(chain_molecule(10), force_path=kind, device="cpu"))
    for pattern in {patterns!r}:
        runs = []
        for slots in (None, 4, 3):
            cfg = RepExConfig(**dict({cfg!r}, pattern=pattern))
            drv = REMDDriver(eng, cfg, slots=slots, device="cpu")
            ens = drv.run_fused(drv.init({seed}), chunk_cycles=2)
            runs.append((drv, ens))
        (d1, o1), res = runs[0], []
        for d2, o2 in runs[1:]:
            res.append(dict(
                execution=d2.execution,
                rows=[h["assignment"].tolist() for h in d2.history]
                == [h["assignment"].tolist() for h in d1.history],
                ready=[h["ready_frac"] for h in d2.history]
                == [h["ready_frac"] for h in d1.history],
                acceptance=d2.acceptance_ratios() == d1.acceptance_ratios(),
                state=all(torch.equal(o2.state[k], o1.state[k])
                          for k in o1.state),
                debt=torch.equal(o2.debt, o1.debt)))
        out[kind + "-" + pattern] = res
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def scalar_kernel_runs():
    root = Path(__file__).resolve().parents[1]
    code = _CHILD.format(src=str(root / "src"), kinds=KINDS,
                         patterns=PATTERNS, cfg=CFG, seed=SEED)
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("kind", KINDS)
def test_mode2_bitwise_equals_mode1(kind, pattern, scalar_kernel_runs):
    res = scalar_kernel_runs[f"{kind}-{pattern}"]
    assert [r["execution"] for r in res] == [
        {"mode": "mode2", "n_waves": 2}, {"mode": "mode2", "n_waves": 3}]
    for r in res:
        assert all(r[k] for k in ("rows", "ready", "acceptance", "state",
                                  "debt")), r


@pytest.mark.parametrize("kind", KINDS)
def test_mode2_decisions_equal_mode1_with_simd_kernels(kind, jax_system):
    eng = _engine(kind, jax_system)
    d1, o1 = _run(eng, pattern="asynchronous")
    assert d1.execution == {"mode": "mode1", "n_waves": 1}
    for slots in (4, 3):
        d2, o2 = _run(eng, slots=slots, pattern="asynchronous")
        np.testing.assert_array_equal(_rows(d2), _rows(d1))
        assert d2.acceptance_ratios() == d1.acceptance_ratios()
        assert torch.equal(o2.debt, o1.debt)
        for k in o1.state:
            np.testing.assert_allclose(o2.state[k].numpy(),
                                       o1.state[k].numpy(), atol=1e-5)


@pytest.mark.parametrize("slots", [4, 3])
def test_mode2_decisions_match_jax(slots, jax_system):
    jdrv = JDriver(JEngine(jax_system), JConfig(**CFG), slots=slots)
    jout = jdrv.run_fused(jdrv.init(SEED), chunk_cycles=2)
    tdrv, tout = _run(_engine("pallas", jax_system), slots=slots)
    assert tdrv.execution == jdrv.execution
    np.testing.assert_array_equal(_rows(tdrv), _rows(jdrv))
    assert tdrv.acceptance_ratios() == jdrv.acceptance_ratios()
    np.testing.assert_allclose(tout.state["pos"].numpy(),
                               np.asarray(jout.state["pos"]), atol=1e-4)


def test_execution_mode_mode2_forces_two_waves(jax_system):
    eng = _engine("pallas", jax_system)
    drv = REMDDriver(eng, RepExConfig(**dict(CFG, execution_mode="mode2")),
                     device="cpu")
    jdrv = JDriver(JEngine(jax_system),
                   JConfig(**dict(CFG, execution_mode="mode2")))
    assert drv.execution == jdrv.execution == {"mode": "mode2",
                                               "n_waves": 2}
    drv1 = REMDDriver(eng, RepExConfig(**dict(CFG, execution_mode="mode1")),
                      slots=2, device="cpu")
    assert drv1.execution == {"mode": "mode1", "n_waves": 1}


def test_auto_mode_matches_jax():
    for r in (1, 2, 7, 8, 13, 64, 384):
        for slots in (0, 1, 3, 12, 24, 128, 400):
            assert tM.auto_mode(r, slots) == j_auto_mode(r, slots), (r, slots)


class _Recorder:
    """An engine that records each wave's call and returns its input
    plus each lane's step count."""

    def __init__(self):
        self.calls = []

    def propagate(self, state, ctrl, n_steps, rngs, max_steps, stack=None):
        self.calls.append((state["x"].clone(), ctrl["t"].clone(),
                           n_steps.clone(), rngs.clone(), max_steps, stack))
        return {"x": state["x"] + n_steps[:, None].to(torch.float32)}


def test_propagate_mode2_waves_pad_and_keys():
    r = 7
    x = torch.arange(r * 2, dtype=torch.float32).reshape(r, 2)
    ctrl = {"t": torch.arange(r, dtype=torch.float32) * 10}
    n_steps = torch.arange(1, r + 1)
    rng = jr.key(5)
    eng = _Recorder()
    out = tM.propagate_mode2(eng, {"x": x}, ctrl, n_steps, rng, 3,
                             max_steps=9)
    assert torch.equal(out["x"], x + n_steps[:, None])
    keys = tM.per_replica_keys(rng, r)
    assert len(eng.calls) == 3
    for i, (xs, ts, ns, ks, m, stack) in enumerate(eng.calls):
        assert (m, stack, xs.shape[0]) == (9, r, 3)
        rows = [min(3 * i + j, r) for j in range(3)]
        pad = [j >= r for j in (3 * i, 3 * i + 1, 3 * i + 2)]
        src = [0 if p else k for k, p in zip(rows, pad)]
        assert torch.equal(xs, x[src])
        assert torch.equal(ts, ctrl["t"][src])
        assert torch.equal(ks, keys[src])
        assert ns.tolist() == [0 if p else int(n_steps[k])
                               for k, p in zip(src, pad)]


def test_kernel_split_follows_the_ensemble_count():
    """The nonbonded kernel's and the fluid forces kernel's per-replica
    split is that of the ensemble's R, whatever the wave's size."""
    n_tiles = 2944 // nb_ops.PAIR_TILE              # N = 2881, ld 2944
    s64 = nb_ops.block_split(64, n_tiles)
    assert nb_ops.block_split(22, n_tiles) != s64   # a wave's own split
    assert nb_ops.block_split(nb_ops.split_replicas(22, 64), n_tiles) == s64
    assert nb_ops.split_replicas(22, None) == 22
    with pytest.raises(ValueError):
        nb_ops.split_replicas(64, 22)
    pos = torch.zeros((22, 864, 3))
    ld, split, _, _ = nb_ops._fluid_walk(pos, 34.8, 256)
    assert ld == 896
    assert split == nb_ops.block_split(256, ld // nb_ops.PAIR_TILE, 2) == 3
    assert nb_ops._fluid_walk(pos, 34.8)[1] == 14


def test_sparse_mode2_rebuilds_per_wave_as_jax(jax_system):
    """On the sparse path a tripped replica rebuilds every list of its
    engine call (``sync=True``), and under Mode II a call is one wave:
    the per-replica rebuild counters follow the waves, in the port as in
    the JAX package, while the decisions stay Mode I's."""
    cfg = dict(CFG, md_steps_per_cycle=10)
    jdrv = JDriver(JEngine(jax_system, nonbonded="sparse", skin=0.3),
                   JConfig(**cfg), slots=3)
    jout = jdrv.run_fused(jdrv.init(SEED), chunk_cycles=2)
    teng = MDEngine(convert.system_from_arrays(jax_system, device="cpu"),
                    nonbonded="sparse", skin=0.3, device="cpu")
    tdrv, tout = _run(teng, slots=3, **cfg)
    d1, _ = _run(teng, **cfg)
    np.testing.assert_array_equal(_rows(tdrv), _rows(jdrv))
    np.testing.assert_array_equal(_rows(tdrv), _rows(d1))
    rebuilds = tout.state["nlist"]["rebuilds"].numpy()
    np.testing.assert_array_equal(rebuilds,
                                  np.asarray(jout.state["nlist"]["rebuilds"]))
    assert len(set(rebuilds.tolist())) > 1       # the waves differ
