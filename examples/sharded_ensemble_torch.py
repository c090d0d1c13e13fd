"""Scaling out on the PyTorch port: replica-sharded REMD over a replica
mesh, the port's counterpart of ``sharded_ensemble.py``.

``REMDDriver.run_sharded`` runs the fused cycle loop on a replica mesh,
one process per shard under ``torch.distributed``: each process
propagates its own block of replicas; at exchange time only per-replica
exchange scalars and failure flags cross processes — positions never do
— and the swap decisions are computed from identical inputs on every
rank, so the discrete trajectory is bitwise the single-process
``run_fused``'s.

    # one process per GPU (NCCL), or per CPU shard with --device cpu
    # (gloo):
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/sharded_ensemble_torch.py

    # one process: a one-rank group, the sharded code path end to end
    PYTHONPATH=src python examples/sharded_ensemble_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch.distributed as dist

from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver, control_multiset_ok
from repro_torch.launch.mesh import make_replica_mesh, world_size
from repro_torch.md import MDEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_replicas = 8
    # the replica mesh: as many shards as the running ranks allow, each
    # owning a contiguous block of R / n_shards replicas
    n_shards = world_size()
    while n_replicas % n_shards:
        n_shards -= 1
    mesh = make_replica_mesh(n_shards, device=args.device)
    lead = dist.get_rank() == 0
    if lead:
        print(f"ranks: {world_size()}  ->  mesh {dict(mesh.shape)} "
              f"({n_replicas // n_shards} replicas per shard)")

    cfg = RepExConfig(
        dimensions=(("temperature", n_replicas),),
        md_steps_per_cycle=10,
        n_cycles=48,
    )
    if mesh.is_member:
        driver = REMDDriver(MDEngine(device=mesh.device), cfg,
                            device=mesh.device)
        ens = driver.init()
        # Same chunked execution as run_fused — K complete cycles per
        # host fetch — but propagate runs on every rank's own block and
        # the exchange moves only O(R / n_shards) scalars per sweep.
        ens = driver.run_sharded(ens, mesh=mesh, chunk_cycles=16,
                                 verbose=lead)
    if lead:
        print("\ncontrol multiset preserved:", control_multiset_ok(ens))
        print("acceptance ratios:", driver.acceptance_ratios())
        print("final assignment:", ens.assignment.cpu().numpy())

        # the discrete trajectory is bitwise the one of run_fused in one
        # process — verify right here with a fresh driver
        ref = REMDDriver(MDEngine(device=mesh.device), cfg,
                         device=mesh.device)
        ref.run_fused(ref.init(), chunk_cycles=16)
        same = all(
            np.array_equal(h_s["assignment"], h_f["assignment"])
            for h_s, h_f in zip(driver.history, ref.history))
        print("assignment trace identical to run_fused:", same)
        assert same and control_multiset_ok(ens)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
