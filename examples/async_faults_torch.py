"""Asynchronous RE + replica failures + checkpoint/restart on the PyTorch
port, the port's counterpart of ``async_faults.py``.

Demonstrates the fault-tolerance story end to end:
  1. async pattern with heterogeneous replica speeds (stragglers),
  2. random replica corruption each cycle (NaN injection) with automatic
     relaunch-from-backup,
  3. an ensemble checkpoint written every cycle, then a simulated node
     failure: the driver restarts from the latest checkpoint and finishes.

``--device cpu`` runs on the CPU (default: the card).

    PYTHONPATH=src python examples/async_faults_torch.py [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver, control_multiset_ok
from repro_torch.md import MDEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt_dir = tempfile.mkdtemp(prefix="repex_ckpt_")
    cfg = RepExConfig(
        engine="md",
        dimensions=(("temperature", 8),),
        md_steps_per_cycle=20,
        n_cycles=6,
        pattern="asynchronous",            # stragglers don't barrier
        async_window=0.5,
        relaunch_failed=True,
    )
    engine = MDEngine(device=args.device)
    driver = REMDDriver(engine, cfg, ckpt_dir=ckpt_dir, ckpt_every=1,
                        failure_rate=0.15,  # ~1 replica corrupted per cycle
                        device=args.device)
    ens = driver.init()
    ens = driver.run(ens, n_cycles=4, verbose=True)
    n_failed = sum(h["failed"] for h in driver.history)
    print(f"\nreplica failures recovered so far: {n_failed}")
    print("ready fractions per cycle:",
          [f"{h['accept']:.0f}/{h['attempt']:.0f}" for h in driver.history])

    # --- simulated node failure: lose the ensemble, restart from disk ---
    print("\n-- simulating node failure: dropping in-memory state --")
    restored = driver.restore(ens)
    assert restored is not None
    np.testing.assert_array_equal(restored.assignment.cpu().numpy(),
                                  ens.assignment.cpu().numpy())
    print("restart OK; continuing 2 more cycles from checkpoint")
    ens2 = driver.run(restored, n_cycles=2, verbose=True)
    print("multiset ok after restart:", control_multiset_ok(ens2))
    print("total failures recovered:",
          sum(h["failed"] for h in driver.history))
    shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
