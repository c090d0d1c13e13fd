"""Replica meshes: the process layout of replica-sharded REMD
(``REMDDriver.run_sharded``).

The port of the replica part of the JAX package's ``launch/mesh.py``.
JAX's ``("replica",)`` mesh is one program over devices; here it is one
process per shard under ``torch.distributed``, each process holding one
contiguous block of ``B = R / n_shards`` replicas on its own device:

  * on the card, NCCL, one rank per GPU (``cuda:{LOCAL_RANK}``), launched
    by ``torchrun --nproc-per-node N``;
  * on the CPU, gloo (``device="cpu"``), as the tests run it.

Without a launcher (no ``WORLD_SIZE`` in the environment) a one-shard
mesh makes its own one-rank group on ``127.0.0.1``.  A mesh makes its
first collectives when it is created (a barrier, a gather, a reduction
and, across ranks, one ring hop), so that communicator set-up never
falls inside a chunk, where the driver forbids host synchronisation.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ReplicaMesh:
    """One process's view of a replica mesh: its process ``group`` (None
    is the default group), ``n_shards``, its own shard index ``rank``
    (-1 on a rank of the world outside the mesh) and its ``device``."""
    group: Any
    n_shards: int
    rank: int
    device: torch.device

    @property
    def shape(self):
        """The mesh shape, keyed as the JAX package's mesh is."""
        return {"replica": self.n_shards}

    @property
    def is_member(self) -> bool:
        return self.rank >= 0

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def world_size() -> int:
    """Ranks available to a mesh: the initialised group's size, else the
    launcher's ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for a CUDA request, the
    CPU when asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_world(dev: torch.device) -> None:
    """The default process group: the launcher's (``env://``) when there
    is one, else a one-rank group on a free local port."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
            world_size=1, rank=0, **kw)


def make_replica_mesh(n_shards: int = 0, device="cuda") -> ReplicaMesh:
    """A ``("replica",)`` mesh of ``n_shards`` ranks (0: every rank of
    the world).  Raises ``ValueError`` when the world is smaller than
    ``n_shards``, as the JAX package's does for too few devices.  Every
    rank of the world calls it; on a world larger than the mesh the
    ranks past ``n_shards`` get a mesh with ``rank == -1``."""
    world = world_size()
    n = n_shards or world
    if not 1 <= n <= world:
        raise ValueError(
            f"make_replica_mesh({n}) needs {n} ranks but only {world} "
            f"{'is' if world == 1 else 'are'} running: launch one process "
            f"per shard, e.g. `torchrun --nproc-per-node {n} ...`")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)      # NCCL's point-to-point ops need it
    if not dist.is_initialized():
        _init_world(dev)
    group = None if n == dist.get_world_size() else dist.new_group(
        ranks=list(range(n)))
    rank = dist.get_rank()
    mesh = ReplicaMesh(group=group, n_shards=n,
                       rank=rank if rank < n else -1, device=dev)
    if mesh.is_member:
        _warm(mesh)
    return mesh


def _warm(mesh: ReplicaMesh) -> None:
    """The mesh's first collectives, one of each kind the driver issues,
    then a barrier: communicators are set up here, not inside a chunk."""
    from repro_torch import sharding
    x = torch.zeros(1, device=mesh.device)
    sharding.all_gather_rows(x, mesh)
    sharding.all_reduce_max(x, mesh)
    sharding.ring_all_gather(x, mesh)
    mesh.barrier()


def best_replica_shards(n_replicas: int, max_devices: int = 0) -> int:
    """The largest usable shard count for ``n_replicas`` on the running
    world: the biggest divisor of the replica count that does not exceed
    the world's (or ``max_devices``-capped) rank count.  The
    elastic-restart resource map: a run checkpointed on one mesh resumes
    on whatever ranks are running, with the same trajectory."""
    n = world_size()
    if max_devices:
        n = min(n, max_devices)
    n = max(min(n, n_replicas), 1)
    while n_replicas % n:
        n -= 1
    return n


# --- the replica-ladder ring ------------------------------------------------
#
# Shard s holds the contiguous replica block [s*B, (s+1)*B).  The control
# grid flattens row-major, so those blocks are contiguous runs of flat
# ctrl indices, and the ring in ladder order carries every dimension's
# halo (``repro_torch.sharding.ring_all_gather`` hops blocks along it).


def ladder_neighbor_perms(n_shards: int,
                          reverse: bool = False) -> List[Tuple[int, int]]:
    """The ring's (source, destination) edges: each shard sends to its
    upper ladder neighbor (``reverse=True``: its lower one)."""
    if n_shards < 2:
        return []
    if reverse:
        return [(s, (s - 1) % n_shards) for s in range(n_shards)]
    return [(s, (s + 1) % n_shards) for s in range(n_shards)]


def ladder_shard_blocks(n_ctrl: int, n_shards: int) -> List[Tuple[int, int]]:
    """The contiguous ``[lo, hi)`` replica block each shard owns."""
    if n_ctrl % n_shards:
        raise ValueError(f"replica count {n_ctrl} is not divisible by "
                         f"{n_shards} shards")
    b = n_ctrl // n_shards
    return [(s * b, (s + 1) * b) for s in range(n_shards)]
