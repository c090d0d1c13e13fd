"""RepEx core of the port, the counterpart of the JAX package's
``repro.core``, with the same 21 public names.

Exchange patterns (sync/async), execution modes (I/II), multi-dimensional
control grids (T/U/S, any order), Metropolis exchange (neighbor DEO /
full-matrix Gibbs), replica-level fault tolerance, and the REMDDriver that
runs them over any SimulationEngine.  The JAX package's XLA-sharding
forms have their counterparts elsewhere: ``modes.replica_sharding`` /
``shard_replicas`` are ``repro_torch.sharding.ensemble_shardings`` /
``shard_ensemble``, ``failures.detect_recover_sharded`` is
``detect_recover(mesh=...)``.
"""
from repro_torch.core.controls import (ControlGrid, PairTable, build_grid,
                                       ctrl_for_assignment)
from repro_torch.core.engine import SimulationEngine, engine_capabilities
from repro_torch.core.ensemble import (Ensemble, control_multiset_ok,
                                       make_ensemble)
from repro_torch.core.exchange import (matrix_exchange, metropolis,
                                       neighbor_exchange, pair_energies)
from repro_torch.core.failures import detect_recover
from repro_torch.core.modes import (auto_mode, propagate_mode1,
                                    propagate_mode2)
from repro_torch.core.patterns import async_cycle, fused_cycle, sync_cycle
from repro_torch.core.repex import REMDDriver
