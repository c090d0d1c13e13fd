"""3D TSU-REMD on the PyTorch port — the paper's validation experiment,
the port's counterpart of ``multidim_tsu.py``.

Temperature x (phi, psi) umbrella sampling on the toy peptide with
round-robin dimension scheduling (the paper used T x U x U, 6x8x8 = 384
replicas on Stampede; the default is 4x4x4 = 64, and ``--full`` switches
to the paper's 384).  Prints per-dimension acceptance ratios and a
(phi, psi) histogram — the free-energy-surface ingredient of the paper's
Fig 4.  ``--device cpu`` runs on the CPU (default: the card).

    PYTHONPATH=src python examples/multidim_tsu_torch.py [--full] \\
        [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver, control_multiset_ok
from repro_torch.md import MDEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's 6x8x8 = 384 grid")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dims = ((("temperature", 6), ("umbrella", 8), ("umbrella", 8))
            if args.full else
            (("temperature", 4), ("umbrella", 4), ("umbrella", 4)))
    cfg = RepExConfig(
        engine="md",
        dimensions=dims,
        md_steps_per_cycle=25,
        n_cycles=9,                       # 3 sweeps over 3 dimensions
        pattern="synchronous",
    )
    engine = MDEngine(device=args.device)
    driver = REMDDriver(engine, cfg, device=args.device)
    print(f"replicas: {driver.grid.n_ctrl} "
          f"(grid {'x'.join(str(w) for _, w in dims)})")
    ens = driver.init()
    ens = driver.run(ens, verbose=True)

    print("\nmultiset ok:", control_multiset_ok(ens))
    for dim, ratio in driver.acceptance_ratios().items():
        kind = driver.grid.dims[int(dim[3:])].kind
        print(f"  acceptance {dim} ({kind}): {ratio * 100:.1f} %")

    # (phi, psi) occupancy — the free-energy-surface raw data
    feats = engine.replica_features(ens.state)
    phi = np.rad2deg(feats["phi"].cpu().numpy())
    psi = np.rad2deg(feats["psi"].cpu().numpy())
    hist, _, _ = np.histogram2d(phi, psi, bins=6,
                                range=[[-180, 180], [-180, 180]])
    print("\n(phi, psi) occupancy histogram (6x6):")
    print(hist.astype(int))


if __name__ == "__main__":
    main()
