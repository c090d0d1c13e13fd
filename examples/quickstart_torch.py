"""Quickstart on the PyTorch port: 1D temperature replica exchange on a
toy peptide, the port's counterpart of ``quickstart.py``.

The minimal RepEx workflow — build an engine, describe the simulation in
a config, run fused device-resident cycles, read acceptance statistics.
``--device cpu`` runs on the CPU (default: the card, which the script
needs unless asked).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver, control_multiset_ok
from repro_torch.md import MDEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # The engine: a 22-atom chain molecule under BAOAB Langevin dynamics,
    # propagated replica-major.  Any object satisfying the
    # SimulationEngine protocol works here (repro_torch.core).
    engine = MDEngine(device=args.device)

    # The simulation, fully described by configuration: one temperature
    # dimension = an 8-window geometric ladder 273..373 K; each cycle
    # propagates every replica 10 MD steps and then runs one DEO
    # neighbor-exchange sweep.
    cfg = RepExConfig(
        engine="md",
        dimensions=(("temperature", 8),),
        md_steps_per_cycle=10,
        n_cycles=48,
        pattern="synchronous",
    )
    driver = REMDDriver(engine, cfg, device=args.device)
    ens = driver.init()

    # run_fused(chunk_cycles=K) queues K complete propagate -> exchange
    # -> detect -> recover cycles with no host read between them and
    # fetches the stats once per chunk.  The discrete trajectory
    # (assignments, acceptance, failures) matches the per-cycle run()
    # exactly and does not depend on K.
    ens = driver.run_fused(ens, chunk_cycles=16, verbose=True)

    # Exchanges swap control parameters, never configurations, so the
    # ctrl multiset must survive any run — the core RE invariant.
    print("\ncontrol multiset preserved:", control_multiset_ok(ens))
    print("acceptance ratios:", driver.acceptance_ratios())
    # which ladder rung (ctrl index) each replica ended up holding
    assignment = ens.assignment.cpu().numpy()
    print("final assignment:", assignment)
    temps = driver.grid.values["temperature"].cpu().numpy()
    print("final replica temperatures:",
          np.round(temps[assignment], 1))


if __name__ == "__main__":
    main()
