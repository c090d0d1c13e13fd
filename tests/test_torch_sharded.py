"""Replica-sharded execution of the port (``REMDDriver.run_sharded``) on
the CPU, over ``torch.distributed`` with gloo ranks.

Every case below runs once per world size, 1, 2 and 4 ranks, each world
one launch of child processes (``init_method="file://"``) that runs all
its cases and saves what it saw; the tests compare the saved runs.  The
children run under ``ATEN_CPU_CAPABILITY=default`` with one thread: with
PyTorch's SIMD CPU kernels a replica's bits follow its position in the
stack (``test_torch_modes``), and a rank's block is another stack.

  * ``run_sharded`` at 1, 2 and 4 ranks is the port's ``run_fused``
    bitwise on the discrete trajectory (history rows, acceptance,
    failures, escalation, ``alive``, ``nb_*``) and on the state, across
    both patterns, both schemes, both wires, ``MDEngine`` dense, sparse
    and fused, ``HarmonicEngine``, ``LJEngine``, failures with relaunch,
    with ``continue`` and with a budget that fires tier 2, Mode II within
    a rank and a 2-D ladder; every rank saw the same rows;
  * the port at 2 ranks makes the JAX package's 2-shard decisions (its
    child runs under ``--xla_force_host_platform_device_count=2``), and a
    JAX checkpoint taken mid-run, resumed by the port at 4 ranks, gives
    JAX's uninterrupted history;
  * elastic resume, 4 -> 2 and 2 -> 4 ranks (a 2-rank subgroup of the
    4-rank world), gives the uninterrupted run and its report counters;
  * the wire: the halo wire issues no all-gather; every tensor on it has
    rank <= 1 and at most R elements, each hop <= 8 B bytes; the gather
    wire does gather; a sparse run sends no neighbor list; the tier-2 hop
    is one state row; the ledger fills ``RunReport.wire``;
  * ``ring_all_gather`` returns the blocks in global order in both
    directions after n - 1 hops; the mesh helpers are JAX's;
  * an indivisible mesh, an engine without the feature API and
    ``--shards 2`` without a launcher raise; ``repex_run --shards 2``
    under ``torch.distributed.run`` gives the report of ``--shards 1``,
    which makes its own one-rank group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import repex_run
from repro_torch.md import HarmonicEngine

ROOT = Path(__file__).resolve().parents[1]
R = 8
WORLDS = (1, 2, 4)
HIST_KEYS = ("cycle", "dim", "accept", "attempt", "failed", "esc_relaunch",
             "esc_reinit", "esc_dead", "ready_frac", "nb_overflow",
             "nb_rebuilds")
_T = (("temperature", 4), ("umbrella", 2))

# name -> (engine, config fields, failure rate, slots, chunk); the base
# config is 8 temperature rungs, 2 MD steps a cycle, 4 cycles, seed 1
CASES = {
    "sync_neighbor": ("pallas", {}, 0.0, None, 2),
    "async_neighbor": ("pallas", dict(pattern="asynchronous"), 0.0, None, 2),
    "sync_matrix": ("pallas", dict(exchange_scheme="matrix"), 0.0, None, 2),
    "async_matrix": ("pallas", dict(pattern="asynchronous",
                                    exchange_scheme="matrix"), 0.0, None, 3),
    "gather_neighbor": ("pallas", dict(exchange_comm="gather"), 0.0, None,
                        2),
    "gather_matrix": ("pallas", dict(exchange_comm="gather",
                                     exchange_scheme="matrix"), 0.0, None, 2),
    "sparse": ("sparse", {}, 0.0, None, 2),
    "sparse_matrix": ("sparse", dict(exchange_scheme="matrix"), 0.0, None,
                      4),
    "fused": ("fused", {}, 0.0, None, 2),
    "harmonic": ("harmonic", dict(md_steps_per_cycle=10, n_cycles=8), 0.0,
                 None, 4),
    "lj": ("lj", {}, 0.0, None, 2),
    "lj_matrix": ("lj", dict(exchange_scheme="matrix"), 0.0, None, 2),
    "faults_relaunch": ("pallas", dict(n_cycles=6), 0.3, None, 3),
    "faults_continue": ("pallas", dict(relaunch_failed=False), 0.1, None, 2),
    "faults_budget": ("harmonic", dict(relaunch_budget=1, n_cycles=8), 0.5,
                      None, 4),
    "faults_budget_md_gather": ("pallas", dict(
        relaunch_budget=1, n_cycles=6, exchange_comm="gather",
        exchange_scheme="matrix"), 0.5, None, 3),
    "mode2": ("pallas", dict(pattern="asynchronous"), 0.0, 4, 2),
    "mode2_padded": ("fused", {}, 0.0, 3, 2),
    "ladder_2d": ("pallas", dict(dimensions=_T, n_cycles=8), 0.0, None, 4),
    "ladder_2d_matrix_faults": ("pallas", dict(
        dimensions=_T, exchange_scheme="matrix", n_cycles=6), 0.3, None, 3),
}
HALO_CASES = [c for c, (_, cfg, _, _, _) in CASES.items()
              if cfg.get("exchange_comm") != "gather"
              and not cfg.get("relaunch_budget")]

# the JAX comparison: the configuration of test_torch_modes, and the
# checkpoint run of test_torch_ckpt (asynchronous, faults, a budget)
JAX_CFG = dict(dimensions=(("temperature", R),), md_steps_per_cycle=3,
               n_cycles=4)
JAX_SCHEMES = ("neighbor", "matrix")
CKPT_CFG = dict(dimensions=(("temperature", R),), md_steps_per_cycle=4,
                n_cycles=8, pattern="asynchronous", async_window=0.5,
                relaunch_budget=1)
CKPT_RATE, CKPT_SEED = 0.25, 5

_JAX_CHILD = r"""
import json, shutil, sys
import numpy as np
from repro.config import RepExConfig
from repro.core import REMDDriver
from repro.launch.mesh import make_replica_mesh
from repro.md import MDEngine
from repro.md.system import chain_molecule
out = {}
for scheme in SCHEMES:
    d = REMDDriver(MDEngine(chain_molecule(10)),
                   RepExConfig(exchange_scheme=scheme, **JAX_CFG))
    d.run_sharded(d.init(1), mesh=make_replica_mesh(2), chunk_cycles=2)
    out[scheme] = [np.asarray(h["assignment"]).tolist() for h in d.history]
d = REMDDriver(MDEngine(chain_molecule(10)), RepExConfig(**CKPT_CFG),
               ckpt_dir=CKPT_DIR, ckpt_every=4, failure_rate=RATE)
d.run_fused(d.init(SEED), chunk_cycles=4)
shutil.rmtree(CKPT_DIR + "/step-00000007")       # killed after cycle 3
out["ckpt_rows"] = [np.asarray(h["assignment"]).tolist() for h in d.history]
out["ckpt_hist"] = [[h[k] for k in ("cycle", "dim", "accept", "attempt",
                                    "failed", "esc_relaunch", "esc_reinit",
                                    "esc_dead")] for h in d.history]
print(json.dumps(out))
"""

_WORKER = r"""
import json, os, sys
sys.path.insert(0, SRC)
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.md import HarmonicEngine, LJEngine, MDEngine
from repro_torch.md.system import chain_molecule
from repro_torch.obs import Telemetry
from repro_torch import sharding as S

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="file://" + INIT, rank=rank,
                        world_size=world)


def engine(kind):
    if kind == "harmonic":
        return HarmonicEngine(device="cpu")
    if kind == "lj":
        return LJEngine(n_particles=27, box=10.0, device="cpu")
    if kind == "sparse":
        return MDEngine(chain_molecule(24), nonbonded="sparse", skin=0.05,
                        device="cpu")
    return MDEngine(chain_molecule(10), force_path=kind, device="cpu")


def driver(kind, cfg, rate=0.0, slots=None, **kw):
    base = dict(dimensions=(("temperature", R),), md_steps_per_cycle=2,
                n_cycles=4)
    return REMDDriver(engine(kind), RepExConfig(**dict(base, **cfg)),
                      slots=slots, failure_rate=rate, device="cpu", **kw)


def seen(d, ens):
    return {"hist": [[h[k] for k in HIST_KEYS] for h in d.history],
            "rows": [h["assignment"].tolist() for h in d.history],
            "acceptance": d.acceptance,
            "ens": {f: getattr(ens, f) for f in ens._fields
                    if f not in ("state", "rng")},
            "state": ens.state, "execution": d.execution,
            "wire": d.last_wire.calls if d.last_wire else None,
            "report": d.last_report.to_dict()}


out = {}
mesh = make_replica_mesh(world, device="cpu")
for name, (kind, cfg, rate, slots, chunk) in CASES.items():
    if world == 1:
        d = driver(kind, cfg, rate, slots)
        out[name + "/fused"] = seen(d, d.run_fused(d.init(1),
                                                   chunk_cycles=chunk))
    d = driver(kind, cfg, rate, slots,
               telemetry=Telemetry(phase_probe_every=0))
    out[name] = seen(d, d.run_sharded(d.init(1), mesh=mesh,
                                      chunk_cycles=chunk))

# elastic resume and the reference runs it is held to
ELASTIC = ("harmonic", dict(n_cycles=8), 0.3)
if world == 1:
    for tag, chunk, n in (("4to2", 2, 8), ("2to4", 3, 6)):
        d = driver(*ELASTIC, telemetry=Telemetry())
        out["elastic_" + tag + "/fused"] = seen(
            d, d.run_fused(d.init(1), n_cycles=n, chunk_cycles=chunk))
if world == 4:
    ck = os.path.join(OUT, "elastic_4to2")
    d = driver(*ELASTIC, ckpt_dir=ck, ckpt_every=1, telemetry=Telemetry())
    d.run_sharded(d.init(1), mesh=mesh, n_cycles=4, chunk_cycles=2)
    mesh2 = make_replica_mesh(2, device="cpu")
    if mesh2.is_member:
        d = driver(*ELASTIC, ckpt_dir=ck, ckpt_every=1,
                   telemetry=Telemetry())
        out["elastic_4to2"] = seen(d, d.resume(via="sharded", mesh=mesh2,
                                               chunk_cycles=2))
    ck = os.path.join(OUT, "elastic_2to4")
    if mesh2.is_member:
        d = driver(*ELASTIC, ckpt_dir=ck, ckpt_every=1,
                   telemetry=Telemetry())
        d.run_sharded(d.init(1), mesh=mesh2, n_cycles=3, chunk_cycles=3)
    dist.barrier()
    d = driver(*ELASTIC, ckpt_dir=ck, ckpt_every=1, telemetry=Telemetry())
    out["elastic_2to4"] = seen(d, d.resume(via="sharded", n_cycles=6,
                                           chunk_cycles=3))
    # a JAX checkpoint (cycle 3 of 8) resumed on 4 ranks
    d = REMDDriver(MDEngine(chain_molecule(10), device="cpu"),
                   RepExConfig(**CKPT_CFG), ckpt_dir=JAX_CKPT, ckpt_every=0,
                   failure_rate=CKPT_RATE, device="cpu")
    out["jax_resume"] = seen(d, d.resume(via="sharded", mesh=mesh,
                                         chunk_cycles=4))
if world == 2:
    for scheme in JAX_SCHEMES:
        d = REMDDriver(MDEngine(chain_molecule(10), device="cpu"),
                       RepExConfig(exchange_scheme=scheme, **JAX_CFG),
                       device="cpu")
        out["jax_" + scheme] = seen(d, d.run_sharded(d.init(1), mesh=mesh,
                                                     chunk_cycles=2))
    # the ring by itself, both directions
    x = torch.arange(3, dtype=torch.float32) + 10 * rank
    with S.wire_census() as c:
        out["ring"] = [S.ring_all_gather(x, mesh),
                       S.ring_all_gather(x, mesh, reverse=True), c.calls]
torch.save(out, os.path.join(OUT, f"{world}-{rank}.pt"))
dist.destroy_process_group()
"""


def _launch(world, out, jax_ckpt):
    consts = dict(SRC=str(ROOT / "src"), INIT=str(out / f"init-{world}"),
                  OUT=str(out), R=R, CASES=CASES, HIST_KEYS=HIST_KEYS,
                  CKPT_CFG=CKPT_CFG, CKPT_RATE=CKPT_RATE, JAX_CFG=JAX_CFG,
                  JAX_SCHEMES=JAX_SCHEMES, JAX_CKPT=str(jax_ckpt))
    code = "".join(f"{k} = {v!r}\n" for k, v in consts.items()) + _WORKER
    procs = []
    for rank in range(world):
        env = dict(os.environ, ATEN_CPU_CAPABILITY="default",
                   OMP_NUM_THREADS="1", RANK=str(rank),
                   WORLD_SIZE=str(world))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs, what):
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"{what}: {err[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's runs, and the JAX child's: {world: [rank's dict]},
    plus "jax"."""
    out = tmp_path_factory.mktemp("sharded")
    jax_ckpt = out / "jax_ckpt"
    consts = dict(SCHEMES=JAX_SCHEMES, JAX_CFG=JAX_CFG, CKPT_CFG=CKPT_CFG,
                  CKPT_DIR=str(jax_ckpt), RATE=CKPT_RATE, SEED=CKPT_SEED)
    code = "".join(f"{k} = {v!r}\n" for k, v in consts.items()) + _JAX_CHILD
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    procs = [jax_proc]
    try:
        early = {w: _launch(w, out, jax_ckpt) for w in (1, 2)}
        procs += [p for ps in early.values() for p in ps]
        jout, jerr = jax_proc.communicate(timeout=240)
        assert jax_proc.returncode == 0, jerr[-3000:]
        late = _launch(4, out, jax_ckpt)    # resumes the JAX checkpoint
        procs += late
        for w, ps in early.items():
            _wait(ps, f"world {w}")
        _wait(late, "world 4")
    finally:
        for p in procs:                     # a failed launch leaves none
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {w: [torch.load(out / f"{w}-{r}.pt", weights_only=False)
               for r in range(w)] for w in WORLDS}
    res["jax"] = json.loads(jout.strip().splitlines()[-1])
    return res


def _same_run(a, b):
    """The discrete trajectory and the state bitwise (NaN rows of retired
    replicas compared as NaN)."""
    assert a["rows"] == b["rows"]
    assert a["hist"] == b["hist"]
    assert a["acceptance"] == b["acceptance"]
    for f, v in a["ens"].items():
        assert torch.equal(v, b["ens"][f]), f
    for k, v in a["state"].items():
        for kk, vv in (v.items() if isinstance(v, dict) else [("", v)]):
            got = b["state"][k][kk] if kk else b["state"][k]
            torch.testing.assert_close(got, vv, rtol=0, atol=0,
                                       equal_nan=True, msg=f"{k} {kk}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_run_sharded_bitwise_run_fused(case, world, runs):
    ref = runs[1][0][case + "/fused"]
    for rank_runs in runs[world]:              # every rank saw the same
        _same_run(ref, rank_runs[case])
    got = runs[world][0][case]
    assert got["report"]["path"] == "sharded"
    assert got["execution"] == ref["execution"]


def test_cases_exercise_what_they_claim(runs):
    ref = {c: runs[1][0][c + "/fused"] for c in CASES}

    def total(case, col):
        return sum(h[HIST_KEYS.index(col)] for h in ref[case]["hist"])
    for case in ("faults_relaunch", "faults_continue", "faults_budget",
                 "ladder_2d_matrix_faults"):
        assert total(case, "failed") > 0, case
    assert total("faults_budget", "esc_reinit") > 0
    assert total("faults_budget_md_gather", "esc_reinit") > 0
    assert total("faults_continue", "esc_dead") > 0
    assert max(h[HIST_KEYS.index("nb_rebuilds")]
               for h in ref["sparse"]["hist"]) > 0
    assert ref["mode2"]["execution"] == {"mode": "mode2", "n_waves": 2}
    assert ref["mode2_padded"]["execution"] == {"mode": "mode2",
                                                "n_waves": 3}
    assert {h[1] for h in ref["ladder_2d"]["hist"]} == {0, 1}
    for case in CASES:
        assert total(case, "accept") > 0, case


@pytest.mark.parametrize("scheme", JAX_SCHEMES)
def test_two_ranks_make_jax_two_shard_decisions(scheme, runs):
    from repro.md.system import chain_molecule as j_chain
    from repro_torch.md.system import chain_molecule
    a, b = j_chain(10), chain_molecule(10)
    assert np.array_equal(np.asarray(a.bonds), b.bonds.numpy())
    assert runs[2][0]["jax_" + scheme]["rows"] == runs["jax"][scheme]


def test_jax_checkpoint_resumed_on_four_ranks(runs):
    got = runs[4][0]["jax_resume"]
    assert got["rows"] == runs["jax"]["ckpt_rows"]
    n = len(runs["jax"]["ckpt_hist"][0])
    assert [h[:n] for h in got["hist"]] == runs["jax"]["ckpt_hist"]
    assert sum(h[4] for h in got["hist"][4:]) > 0   # faults after resume


_REPORT_COUNTERS = ("attempted", "accepted", "pair_attempt", "pair_accept",
                    "occupancy", "round_trips")


@pytest.mark.parametrize("tag,world,ranks", [("4to2", 4, 2),
                                             ("2to4", 4, 4)])
def test_elastic_resume(tag, world, ranks, runs):
    ref = runs[1][0][f"elastic_{tag}/fused"]
    for r in range(ranks):
        got = runs[world][r][f"elastic_{tag}"]
        _same_run(ref, got)
        rep_r, rep_s = ref["report"], got["report"]
        for k in _REPORT_COUNTERS:
            assert rep_r["exchange"][k] == rep_s["exchange"][k], k
        assert rep_r["failures"] == rep_s["failures"]
        assert rep_s["cycles"]["total"] == rep_r["cycles"]["total"]
    assert sum(h[4] for h in ref["hist"]) > 0


# -- the wire ----------------------------------------------------------------


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_census(case, world, runs):
    got = runs[world][0][case]
    b = R // world
    assert got["wire"], "a sharded chunk issued no collective"
    for op, shape, nbytes in got["wire"]:
        assert op != "all-gather", (op, shape)
        assert len(shape) <= 1 and int(np.prod(shape)) <= R, (op, shape)
        if op == "collective-permute":
            assert nbytes <= 8 * b, (op, shape, nbytes)
        else:
            assert op == "all-reduce" and nbytes <= 8, (op, shape)
    wire = got["report"]["wire"]
    assert set(wire["per_chunk"]) == {str(k) for k in
                                      wire["invocations"]}
    assert "collective-permute" in wire["totals"]


@pytest.mark.parametrize("world", WORLDS)
def test_gather_wire_gathers(world, runs):
    for case in ("gather_neighbor", "gather_matrix"):
        ops = {c[0] for c in runs[world][0][case]["wire"]}
        assert ops == {"all-gather"}, ops


@pytest.mark.parametrize("world", (2, 4))
def test_sparse_run_sends_no_neighbor_list(world, runs):
    wire = runs[world][0]["sparse"]["wire"]
    assert {c[0] for c in wire} == {"collective-permute", "all-reduce"}
    assert all(len(c[1]) <= 1 for c in wire)


@pytest.mark.parametrize("world", (2, 4))
def test_tier2_hop_is_one_state_row(world, runs):
    wire = runs[world][0]["faults_budget"]["wire"]
    rows = [c for c in wire if len(c[1]) > 1]
    assert rows and all(c[1][0] == 1 for c in rows), rows


def test_one_rank_halo_is_silent(runs):
    assert runs[1][0]["sync_neighbor"]["wire"] == []
    assert runs[1][0]["sync_neighbor"]["report"]["wire"]["totals"] == {}


def test_ring_all_gather_blocks_in_global_order(runs):
    for rank, got in enumerate(runs[2]):
        fwd, rev, calls = got["ring"]
        want = torch.stack([torch.arange(3, dtype=torch.float32) + 10 * s
                            for s in range(2)])
        assert torch.equal(fwd, want) and torch.equal(rev, want)
        assert [c[0] for c in calls] == ["collective-permute"] * 2


def test_ring_all_gather_four_ranks_n_minus_one_hops(runs):
    got = runs[4][0]["sync_neighbor"]["wire"]
    # per cycle: the failure ring and the exchange-scalar ring, 3 hops each
    assert len(got) == 2 * 3 * CASES["sync_neighbor"][4]


def test_kernel_split_follows_the_ensemble_in_scope():
    """A rank's block of 96 of 384 fluid replicas (864 atoms: 14 tiles)
    splits its sums as the whole stack does only inside the scope."""
    from repro_torch import sharding
    from repro_torch.kernels.lj_forces import ops as nb_ops

    def split(rows):
        return nb_ops.block_split(nb_ops.split_replicas(rows, None), 14,
                                  waves=2)
    assert split(96) != split(384)
    with sharding.ensemble_scope(None, 384):
        assert sharding.ensemble_rows() == 384
        assert split(96) == split(384)
        assert nb_ops.split_replicas(96, 192) == 192   # an explicit stack
    assert sharding.ensemble_rows() is None
    flag = torch.tensor([True])
    assert sharding.ensemble_any(flag) is flag         # no mesh in scope


def test_mesh_helpers_match_jax():
    from repro.launch import mesh as jmesh
    for n in (1, 2, 3, 4, 8):
        for rev in (False, True):
            assert tmesh.ladder_neighbor_perms(n, rev) == \
                jmesh.ladder_neighbor_perms(n, rev)
    for n, s in ((8, 1), (8, 2), (8, 4), (384, 4), (64, 8)):
        assert tmesh.ladder_shard_blocks(n, s) == \
            jmesh.ladder_shard_blocks(n, s)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.ladder_shard_blocks(6, 4)
    for r in (1, 5, 6, 8, 256):
        for cap in (0, 1, 3):
            assert tmesh.best_replica_shards(r, cap) == \
                jmesh.best_replica_shards(r, cap)


# -- the raising cases --------------------------------------------------------


def _harmonic_driver(**cfg):
    return REMDDriver(HarmonicEngine(device="cpu"),
                      RepExConfig(**dict(dict(dimensions=(("temperature",
                                                           6),)), **cfg)),
                      device="cpu")


def test_rejects_an_indivisible_mesh():
    d = _harmonic_driver()
    four = tmesh.ReplicaMesh(group=None, n_shards=4, rank=0,
                             device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        d.run_sharded(d.init(), mesh=four)
    with pytest.raises(TypeError, match="ReplicaMesh"):
        d.run_sharded(d.init(), mesh=object())


def test_requires_the_feature_api():
    class Minimal(HarmonicEngine):
        energy_pair_from_features = None

    d = REMDDriver(Minimal(device="cpu"),
                   RepExConfig(dimensions=(("temperature", 4),)),
                   device="cpu")
    with pytest.raises(TypeError, match="energy_pair_from_features"):
        d.run_sharded(d.init())


def test_make_replica_mesh_needs_the_ranks():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tmesh.make_replica_mesh(2, device="cpu")


def test_shards_without_a_launcher_say_how_to_launch(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        repex_run.main(["--shards", "2", "--device", "cpu"])


def test_cli_shards_under_torch_distributed_run(tmp_path):
    flags = ["--dims", "temperature:4", "--cycles", "4", "--md-steps", "2",
             "--chunk", "2", "--atoms", "8", "--pattern", "async",
             "--failure-rate", "0.25", "--device", "cpu"]
    reports = {}
    for n in (1, 2):
        rep = tmp_path / f"report-{n}.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   ATEN_CPU_CAPABILITY="default", OMP_NUM_THREADS="1")
        env.pop("WORLD_SIZE", None)
        # one shard makes its own one-rank group; two need the launcher
        launch = ([] if n == 1 else
                  ["-m", "torch.distributed.run", "--nproc-per-node", "2",
                   "--master-port", str(tmesh._free_port())])
        cmd = [sys.executable] + launch + [
            "-m", "repro_torch.launch.repex_run", "--shards", str(n),
            "--report-out", str(rep)] + flags
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=120, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.count("multiset ok: True") == 1
        with open(rep) as f:
            reports[n] = json.load(f)
    for k in ("path", "n_replicas", "cycles", "exchange", "failures",
              "neighbor"):
        assert reports[1][k] == reports[2][k], k
    assert reports[2]["wire"]["totals"]["collective-permute"]["count"] > 0
