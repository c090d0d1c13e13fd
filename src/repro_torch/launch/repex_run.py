"""RepEx simulation launcher: the paper's user-facing entry point.

    PYTHONPATH=src python3 -m repro_torch.launch.repex_run --engine md \\
        --atoms 2881 --dims temperature:64 --md-steps 10 --cycles 8 \\
        --chunk 4 --report-out report.json
    PYTHONPATH=src python3 -m repro_torch.launch.repex_run \\
        --dims temperature:6,umbrella:8,umbrella:8 --chunk 3 --device cpu

The port of the JAX package's ``repro/launch/repex_run.py``: the same
flags and the same printed lines, plus ``--device`` (``cuda`` unless
asked).  A run is ``REMDDriver.run`` (no ``--chunk``) or ``run_fused``
(``--chunk K``); ``--resume CKPT_DIR`` continues a killed run from its
newest intact checkpoint (either package's); ``--report-out PATH``
switches telemetry on, writes the ``RunReport`` JSON there and prints
the Eq. (1) split.  Not ported yet: ``--engine lm`` (ROADMAP queue 1
item 8) and ``--shards`` (item 6) raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse

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
                    help="replica-shard over N devices (run_sharded; not "
                         "ported yet)")
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
    if args.engine == "lm":
        raise NotImplementedError(
            "--engine lm (the LM engine, RE-SGLD) is not ported yet: "
            "ROADMAP queue 1 item 8")
    if args.shards:
        raise NotImplementedError(
            "--shards (run_sharded) is not ported yet: ROADMAP queue 1 "
            "item 6")
    dev = resolve_device(args.device)
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
    print(f"replicas={driver.grid.n_ctrl} execution={driver.execution} "
          f"pattern={cfg.pattern} scheme={cfg.exchange_scheme}")
    if args.resume:
        ens = driver.resume(via="fused" if args.chunk else "run",
                            n_cycles=args.cycles,
                            chunk_cycles=args.chunk or 16, verbose=True)
    elif args.chunk:
        ens = driver.run_fused(driver.init(), chunk_cycles=args.chunk,
                               verbose=True)
    else:
        ens = driver.run(driver.init(), verbose=True)
    print("\nmultiset ok:", control_multiset_ok(ens))
    print("acceptance:", {k: f"{v*100:.1f}%"
                          for k, v in driver.acceptance_ratios().items()})
    print("failures recovered:", sum(h["failed"] for h in driver.history))
    if args.report_out:
        driver.last_report.save(args.report_out)
        eq1 = driver.last_report.phases["eq1"]
        print(f"report -> {args.report_out}")
        if eq1:
            print("Eq.(1) split:",
                  {k: f"{v*1e3:.3f} ms" for k, v in eq1.items()})
    return driver


if __name__ == "__main__":
    main()
