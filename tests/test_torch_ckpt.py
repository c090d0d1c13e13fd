"""Checkpoints: the port's ``ckpt`` module and the driver's checkpoint /
resume path against the JAX package's, on the CPU.  One on-disk format:
``step-<n>`` directories of ``.npy`` payloads with a JSON manifest v2
(per-array CRC32), a ``latest`` pointer, keys the JAX tree paths, dtypes
the JAX package's (a key as ``prng_key:threefry2x32`` uint32 words,
integers as int32, bfloat16 as its uint16 view).

The run: 8 rungs, asynchronous pattern, ``failure_rate=0.25`` with
``relaunch_budget=1`` (so the carry holds a lagging backup and a live
failure key), 8 cycles of ``run_fused(chunk_cycles=4)`` with a checkpoint
at each chunk (steps 3 and 7: the index of the chunk's last cycle, as the
JAX driver numbers them).  Checked:

  * either package loads the other's checkpoint leaf for leaf, and both
    write the same keys with the same dtype tags;
  * kill then resume, via ``run_fused`` and via ``run``: the stitched
    history and the final state bitwise the uninterrupted run's;
  * a JAX checkpoint resumed by the port gives JAX's next cycles, and a
    port checkpoint resumed by JAX the port's;
  * a truncated or bit-flipped payload walks back to the previous step
    (or raises ``CheckpointCorruptError`` when walk-back is off), a
    changed config raises ``CheckpointError``, ``restore`` stages the
    carry, bfloat16 leaves cross both ways, retention and a torn
    ``latest`` pointer behave as the JAX manager's.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.md import MDEngine as JEngine
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.launch.mesh import ReplicaMesh
from repro_torch.md import MDEngine

CFG = dict(dimensions=(("temperature", 8),), md_steps_per_cycle=4,
           n_cycles=8, pattern="asynchronous", async_window=0.5,
           relaunch_budget=1)
RATE = 0.25
SEED = 5
CHUNK = 4
_HIST_KEYS = ("cycle", "dim", "accept", "attempt", "failed", "esc_relaunch",
              "esc_reinit", "esc_dead")


@pytest.fixture(scope="module")
def jax_system():
    return j_chain_molecule(10)


def _port(jax_system, ckpt_dir=None, **cfg):
    eng = MDEngine(convert.system_from_arrays(jax_system, device="cpu"),
                   device="cpu")
    return REMDDriver(eng, RepExConfig(**dict(CFG, **cfg)),
                      ckpt_dir=ckpt_dir, ckpt_every=CHUNK,
                      failure_rate=RATE, device="cpu")


def _jax(jax_system, ckpt_dir=None, **cfg):
    return JDriver(JEngine(jax_system), JConfig(**dict(CFG, **cfg)),
                   ckpt_dir=ckpt_dir, ckpt_every=CHUNK, failure_rate=RATE)


@pytest.fixture(scope="module")
def port_run(jax_system, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_ckpt"))
    drv = _port(jax_system, d)
    out = drv.run_fused(drv.init(SEED), chunk_cycles=CHUNK)
    return d, drv, out


@pytest.fixture(scope="module")
def jax_run(jax_system, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    drv = _jax(jax_system, d)
    out = drv.run_fused(drv.init(SEED), chunk_cycles=CHUNK)
    return d, drv, out


def _rows(history):
    return np.stack([np.asarray(h["assignment"]) for h in history])


def _manifest(d, step):
    with open(os.path.join(d, f"step-{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _same_history(a, b):
    np.testing.assert_array_equal(_rows(a), _rows(b))
    for key in _HIST_KEYS:
        assert [h[key] for h in a] == [h[key] for h in b], key


def test_both_write_the_same_keys_and_dtypes(port_run, jax_run):
    assert sum(h["failed"] for h in port_run[1].history) > 0
    for step in (3, 7):
        pm, jm = _manifest(port_run[0], step), _manifest(jax_run[0], step)
        assert pm["manifest_version"] == jm["manifest_version"] == 2
        assert set(pm["arrays"]) == set(jm["arrays"])
        for key, meta in jm["arrays"].items():
            p = pm["arrays"][key]
            assert (p["dtype"], p["shape"], p["file"]) == \
                (meta["dtype"], meta["shape"], meta["file"]), key
        assert pm["arrays"]["fail_key"]["dtype"] == "prng_key:threefry2x32"
        assert pm["extra"]["repex"]["config"] == \
            jm["extra"]["repex"]["config"]


def test_jax_reads_the_port_checkpoint_leaf_for_leaf(port_run, jax_system):
    d, tdrv, tout = port_run
    jdrv = _jax(jax_system, d)
    tree, step, extra = jdrv._load_ckpt()
    assert step == 7
    jens = tree["ensemble"]
    for k in ("pos", "vel"):
        np.testing.assert_array_equal(np.asarray(jens["state"][k]),
                                      tout.state[k].numpy())
    for k in ("assignment", "cycle", "debt", "speed", "alive", "failures",
              "relaunches"):
        got = np.asarray(jens[k])
        assert got.dtype == np.asarray(jdrv.init(SEED)._asdict()[k]).dtype
        np.testing.assert_array_equal(got, getattr(tout, k).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jens["rng"])), tout.rng.numpy())
    assert len(extra["repex"]["history"]) == 8


def test_port_reads_the_jax_checkpoint_leaf_for_leaf(jax_run, jax_system):
    d, jdrv, jout = jax_run
    tdrv = _port(jax_system, d)
    ens, (backup, fail_key), step, extra = tdrv._load_ckpt()
    assert step == 7 and ens.assignment.dtype == torch.int64
    for k in ("pos", "vel"):
        np.testing.assert_array_equal(ens.state[k].numpy(),
                                      np.asarray(jout.state[k]))
    for k in ("assignment", "cycle", "debt", "speed", "alive", "failures",
              "relaunches"):
        np.testing.assert_array_equal(getattr(ens, k).numpy(),
                                      np.asarray(getattr(jout, k)))
    np.testing.assert_array_equal(
        ens.rng.numpy(), np.asarray(jax.random.key_data(jout.rng)))
    tree, _, _ = jdrv._load_ckpt()
    np.testing.assert_array_equal(
        fail_key.numpy(), np.asarray(jax.random.key_data(tree["fail_key"])))
    for k in ("pos", "vel"):
        np.testing.assert_array_equal(backup[k].numpy(),
                                      np.asarray(tree["backup"][k]))


@pytest.mark.parametrize("via", ["fused", "run"])
def test_kill_then_resume_is_bitwise(via, port_run, jax_system):
    d, full, fout = port_run
    drv = _port(jax_system, d)
    out = drv.resume(via=via, chunk_cycles=CHUNK, step=3)
    _same_history(drv.history, full.history)
    for k in ("pos", "vel"):
        np.testing.assert_array_equal(out.state[k].numpy(),
                                      fout.state[k].numpy())
    for k in ("debt", "alive", "relaunches", "failures", "rng"):
        assert torch.equal(getattr(out, k), getattr(fout, k)), k
    assert drv.acceptance_ratios() == full.acceptance_ratios()


def test_jax_checkpoint_resumed_by_the_port(jax_run, jax_system):
    d, jfull, _ = jax_run
    tdrv = _port(jax_system, d)
    tdrv.resume(via="fused", chunk_cycles=CHUNK, step=3)
    _same_history(tdrv.history, jfull.history)


def test_port_checkpoint_resumed_by_jax(port_run, jax_system):
    d, tfull, _ = port_run
    jdrv = _jax(jax_system, d)
    jdrv.resume(via="fused", chunk_cycles=CHUNK, step=3)
    _same_history(jdrv.history, tfull.history)


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_damaged_payload_walks_back(damage, jax_system, tmp_path):
    d = str(tmp_path)
    drv = _port(jax_system, d)
    drv.run_fused(drv.init(SEED), chunk_cycles=CHUNK)
    meta = _manifest(d, 7)["arrays"]["ensemble/state/pos"]
    path = os.path.join(d, "step-00000007", meta["file"])
    raw = open(path, "rb").read()
    if damage == "truncate":
        raw = raw[: len(raw) // 2]
    else:
        raw = raw[:-5] + bytes([raw[-5] ^ 1]) + raw[-4:]
    open(path, "wb").write(raw)
    ens, _, step, _ = _port(jax_system, d)._load_ckpt()
    assert step == 3 and int(ens.cycle) == 4
    # the JAX package walks back the same way
    assert _jax(jax_system, d)._load_ckpt()[1] == 3
    with pytest.raises(tckpt.CheckpointCorruptError):
        _port(jax_system, d)._load_ckpt(step=7)


def test_config_mismatch_raises(port_run, jax_system):
    drv = _port(jax_system, port_run[0], md_steps_per_cycle=5)
    with pytest.raises(tckpt.CheckpointError, match="md_steps_per_cycle"):
        drv.resume(via="fused")
    # the sharded resume checks the same fingerprint (a one-rank mesh;
    # nothing crosses ranks before the check)
    one = ReplicaMesh(group=None, n_shards=1, rank=0,
                      device=torch.device("cpu"))
    with pytest.raises(tckpt.CheckpointError, match="md_steps_per_cycle"):
        drv.resume(via="sharded", mesh=one)


def test_restore_stages_the_carry(port_run, jax_system):
    d, full, fout = port_run
    drv = _port(jax_system, d)
    ens = drv.restore(drv.init(SEED))
    assert int(ens.cycle) == 8 and drv._resume_carry is not None
    backup, fail_key = drv._start_carry(ens)
    assert drv._resume_carry is None
    tree, _, _ = tckpt.load_checkpoint(
        d, drv._ckpt_payload(ens, ens.state, ens.rng))
    assert torch.equal(fail_key, tree["fail_key"].data)
    assert _port(jax_system).restore(ens) is None


def test_bfloat16_and_int_leaves_cross_both_ways(tmp_path):
    x = torch.randn(3, 4).to(torch.bfloat16)
    n = torch.arange(5, dtype=torch.int64)
    tree = {"a": {"w": x, "n": n}, "k": tckpt.PRNGKey(torch.tensor([0, 9]))}
    tckpt.save_checkpoint(str(tmp_path / "p"), 1, tree)
    like = {"a": {"w": jnp.zeros((3, 4), jnp.bfloat16),
                  "n": jnp.zeros(5, jnp.int32)}, "k": jax.random.key(0)}
    got, step, _ = jckpt.load_checkpoint(str(tmp_path / "p"), like)
    assert got["a"]["w"].dtype == jnp.bfloat16 and step == 1
    np.testing.assert_array_equal(
        np.asarray(got["a"]["w"]).astype(np.float32), x.float().numpy())
    np.testing.assert_array_equal(np.asarray(got["a"]["n"]), n.numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(got["k"])),
                                  [0, 9])
    jckpt.save_checkpoint(str(tmp_path / "j"), 2, got)
    back, _, _ = tckpt.load_checkpoint(str(tmp_path / "j"), tree)
    assert back["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["w"], x) and torch.equal(back["a"]["n"], n)
    assert back["k"].data.tolist() == [0, 9]
    assert np.asarray(got["a"]["w"]).dtype == ml_dtypes.bfloat16
    with pytest.raises(ValueError):
        tckpt.save_checkpoint(str(tmp_path / "big"), 0,
                              {"n": torch.tensor([2 ** 40])})


def test_manager_retention_and_torn_pointer(tmp_path):
    d = str(tmp_path)
    mgr = tckpt.CheckpointManager(d, keep=2, every=5)
    tree = {"x": torch.zeros(2)}
    assert mgr.maybe_save(3, tree) is None
    for s in (5, 10, 15):
        assert mgr.maybe_save(s, {"x": torch.full((2,), float(s))})
    assert sorted(os.listdir(d)) == ["latest", "step-00000010",
                                     "step-00000015"]
    assert mgr.latest_step() == 15
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("step-00000099")
    assert mgr.latest_step() == 15
    assert mgr.latest_step() == jckpt.CheckpointManager(d).latest_step()
    got, step, _ = tckpt.load_checkpoint(d, tree)
    assert step == 15 and got["x"].tolist() == [15.0, 15.0]
    with pytest.raises(tckpt.CheckpointError):
        tckpt.load_checkpoint(str(tmp_path / "none"), tree)
    with pytest.raises(tckpt.CheckpointError, match="missing"):
        tckpt.load_checkpoint(d, {"x": torch.zeros(2), "y": torch.zeros(1)})
