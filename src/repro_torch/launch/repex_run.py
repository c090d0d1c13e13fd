"""RepEx simulation launcher: the paper's user-facing entry point.

    PYTHONPATH=src python3 -m repro_torch.launch.repex_run --engine md \\
        --atoms 2881 --dims temperature:64 --md-steps 10 --cycles 8 \\
        --chunk 4 --report-out report.json
    PYTHONPATH=src python3 -m repro_torch.launch.repex_run \\
        --dims temperature:6,umbrella:8,umbrella:8 --chunk 3 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.launch.repex_run --shards 4 --dims temperature:64 \\
        --atoms 2881 --md-steps 10 --cycles 8 --chunk 4

The port of the JAX package's ``repro/launch/repex_run.py``: the same
flags and the same printed lines, plus ``--device`` (``cuda`` unless
asked).  A run is ``REMDDriver.run`` (no ``--chunk``), ``run_fused``
(``--chunk K``) or ``run_sharded`` (``--shards N``, one process per
shard: under ``torchrun --nproc-per-node N`` the world must be N; without
a launcher only ``--shards 1`` runs, on a one-rank group of its own;
rank 0 prints the lines for every rank).  ``--resume CKPT_DIR`` continues a killed
run from its newest intact checkpoint (either package's, any shard
count); ``--report-out PATH`` switches telemetry on, writes the
``RunReport`` JSON there (rank 0 on a sharded run) and prints the
Eq. (1) split.  ``--engine lm`` runs RE-SGLD (``LMEngine`` on the olmo
smoke config, as the JAX launcher builds it).
"""
from __future__ import annotations

import argparse
import os

from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core.ensemble import control_multiset_ok
from repro_torch.device import resolve_device
from repro_torch.md import LJEngine, MDEngine
from repro_torch.md.system import chain_molecule


def parse_dims(text: str):
    dims = []
    for part in text.split(","):
        kind, _, n = part.partition(":")
        dims.append((kind.strip(), int(n)))
    return tuple(dims)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="md", choices=["md", "lj", "lm"])
    ap.add_argument("--dims", default="temperature:8")
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--md-steps", type=int, default=100)
    ap.add_argument("--pattern", default="sync", choices=["sync", "async"])
    ap.add_argument("--scheme", default="neighbor",
                    choices=["neighbor", "matrix"])
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "mode1", "mode2"])
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--atoms", type=int, default=22)
    ap.add_argument("--failure-rate", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", default=None, metavar="CKPT_DIR",
                    help="continue a killed run from its newest intact "
                         "checkpoint in CKPT_DIR (bitwise the "
                         "uninterrupted run; --cycles is the total of the "
                         "stitched run; pass the original run's flags: a "
                         "config mismatch is refused)")
    ap.add_argument("--relaunch-budget", type=int, default=0,
                    help="relaunch a replica at most B consecutive times, "
                         "then reinit from the peer rung, then continue "
                         "degraded (0 = unlimited relaunches)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=0,
                    help="fuse K cycles per chunk (run_fused)")
    ap.add_argument("--shards", type=int, default=0,
                    help="replica-shard over N processes (run_sharded; "
                         "launch with torchrun --nproc-per-node N)")
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="write the RunReport JSON here (switches "
                         "telemetry on: per-pair counters, phase probes)")
    ap.add_argument("--phase-probe-every", type=int, default=1,
                    help="sample phase timings every Nth chunk boundary "
                         "(0 = off; only with --report-out)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> REMDDriver:
    """Run the flags' configuration; returns the driver (its
    ``history``, ``acceptance`` and ``last_report``)."""
    args = _parser().parse_args(argv)
    mesh = _mesh(args.shards, args.device) if args.shards else None
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = RepExConfig(
        engine=args.engine,
        dimensions=parse_dims(args.dims),
        md_steps_per_cycle=args.md_steps,
        n_cycles=args.cycles,
        pattern="asynchronous" if args.pattern == "async" else "synchronous",
        exchange_scheme=args.scheme,
        execution_mode=args.mode,
        seed=args.seed,
        relaunch_budget=args.relaunch_budget,
    )
    if args.engine == "lj":
        engine = LJEngine(device=dev)
    elif args.engine == "lm":
        from repro_torch.models import registry
        from repro_torch.models.lm_engine import LMEngine
        engine = LMEngine(registry.get_smoke_config("olmo_1b"), device=dev)
    else:
        engine = MDEngine(system=chain_molecule(args.atoms), device=dev)

    telemetry = None
    if args.report_out:
        from repro_torch.obs import Telemetry
        telemetry = Telemetry(phase_probe_every=args.phase_probe_every)
    ckpt_dir = args.resume or args.ckpt_dir
    driver = REMDDriver(engine, cfg, slots=args.slots, ckpt_dir=ckpt_dir,
                        ckpt_every=1 if ckpt_dir else 0,
                        failure_rate=args.failure_rate, telemetry=telemetry,
                        device=dev)
    # a sharded run's ranks make the same run: rank 0 speaks for them
    loud = mesh is None or mesh.rank == 0
    say = print if loud else (lambda *a, **k: None)
    say(f"replicas={driver.grid.n_ctrl} execution={driver.execution} "
        f"pattern={cfg.pattern} scheme={cfg.exchange_scheme}")
    if args.resume:
        via = "sharded" if mesh else ("fused" if args.chunk else "run")
        ens = driver.resume(via=via, n_cycles=args.cycles,
                            chunk_cycles=args.chunk or 16, mesh=mesh,
                            verbose=loud)
    elif mesh is not None:
        ens = driver.run_sharded(driver.init(), mesh=mesh,
                                 chunk_cycles=args.chunk or 16, verbose=loud)
    elif args.chunk:
        ens = driver.run_fused(driver.init(), chunk_cycles=args.chunk,
                               verbose=True)
    else:
        ens = driver.run(driver.init(), verbose=True)
    say("\nmultiset ok:", control_multiset_ok(ens))
    say("acceptance:", {k: f"{v*100:.1f}%"
                        for k, v in driver.acceptance_ratios().items()})
    say("failures recovered:", sum(h["failed"] for h in driver.history))
    if args.report_out and loud:
        driver.last_report.save(args.report_out)
        eq1 = driver.last_report.phases["eq1"]
        say(f"report -> {args.report_out}")
        if eq1:
            say("Eq.(1) split:",
                {k: f"{v*1e3:.3f} ms" for k, v in eq1.items()})
    return driver


def _mesh(n_shards: int, device):
    """The replica mesh of ``--shards N``: a launcher's world must hold
    exactly N ranks; without one only N = 1 runs."""
    from repro_torch.launch.mesh import make_replica_mesh
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "WORLD_SIZE" in os.environ and world != n_shards:
        raise ValueError(f"--shards {n_shards} under a launcher of {world} "
                         f"processes: launch --nproc-per-node {n_shards}")
    if n_shards > world:
        raise ValueError(
            f"--shards {n_shards} runs one process per shard: launch it "
            f"as `torchrun --nproc-per-node {n_shards} -m "
            f"repro_torch.launch.repex_run --shards {n_shards} ...`")
    return make_replica_mesh(n_shards, device=device)


if __name__ == "__main__":
    main()
