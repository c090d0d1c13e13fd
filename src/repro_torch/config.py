"""Configuration of one replica-exchange simulation.

The port keeps its own copy of the JAX package's ``RepExConfig`` (same
fields, same defaults) so that it imports nothing of that package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class RepExConfig:
    """Configuration of one replica-exchange simulation (the paper's input)."""
    engine: str = "md"                # md | lj | lm
    # Exchange dimensions, in exchange order.  Each entry: (type, n_windows)
    # type in {"temperature", "umbrella", "salt"} — the paper's T/U/S.
    dimensions: Tuple[Tuple[str, int], ...] = (("temperature", 8),)
    t_min: float = 273.0
    t_max: float = 373.0
    umbrella_k: float = 0.02          # kcal/mol/deg^2, paper's force constant
    salt_min: float = 0.0
    salt_max: float = 1.0
    md_steps_per_cycle: int = 100     # paper: 6000 (sander), we scale down
    n_cycles: int = 10
    pattern: str = "synchronous"      # synchronous | asynchronous
    execution_mode: str = "auto"      # auto | mode1 | mode2
    cores_per_replica: int = 1        # model-axis shard per replica
    exchange_scheme: str = "neighbor" # neighbor (DEO) | matrix (Gibbs)
    # Sharded-exchange wire protocol (run_sharded only): halo | gather
    exchange_comm: str = "halo"
    async_window: float = 0.5         # fraction of replicas ready per window
    seed: int = 0
    # failure handling
    detect_failures: bool = True
    relaunch_failed: bool = True
    # Escalation budget for the relaunch policy: 0 = unlimited relaunches
    # (the default); B > 0 escalates a replica failing B consecutive
    # cycles to reinit-from-peer-rung, and after 2B to continue-degraded.
    relaunch_budget: int = 0

    @property
    def n_replicas(self) -> int:
        n = 1
        for _, w in self.dimensions:
            n *= w
        return n
