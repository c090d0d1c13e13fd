"""REMDDriver — the top-level RepEx runtime of the port.

``run_fused(ens, chunk_cycles=K)`` runs K complete propagate -> exchange
-> detect -> recover cycles per chunk, with the contract of the JAX
package's ``core/repex.py``:

  * no host synchronisation inside a chunk — every cycle is device work
    queued on the current stream (sweep scheduling is a device gather,
    the recovery backup rides the carry); on CUDA each chunk runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host read there
    raises instead of stalling silently;
  * per-cycle stats are stacked on the device and fetched ONCE per
    chunk, then unpacked into ``history`` and ``acceptance`` exactly as
    the JAX driver's ``_chunk_loop`` does;
  * decisions do not depend on the chunk size: a chunk is the same
    sequence of launches cycle after cycle, and the kernels use no
    atomics, so the trajectory is bitwise identical for any K.

The per-cycle legacy path (``run``), telemetry, checkpoints, failure
injection and ``run_sharded`` are not ported yet; asking for them
raises ``NotImplementedError``.  ``last_report`` stays ``None``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

from repro_torch import random as jr
from repro_torch.config import RepExConfig
from repro_torch.core import failures as F
from repro_torch.core import patterns
from repro_torch.core.controls import ControlGrid, build_grid
from repro_torch.core.engine import engine_capabilities
from repro_torch.core.ensemble import Ensemble, make_ensemble
from repro_torch.core.modes import auto_mode
from repro_torch.device import resolve_device

# the scalar fields of one cycle's stats row, in packing order; the
# post-cycle assignment row follows them
_FIELDS = ("cycle", "dim", "accepted", "attempted",
           "ready_frac") + F.ESC_STAT_KEYS
_INT_FIELDS = ("cycle", "dim") + F.ESC_STAT_KEYS


class REMDDriver:
    def __init__(self, engine, cfg: RepExConfig, mesh=None,
                 slots: Optional[int] = None, ckpt_dir: Optional[str] = None,
                 failure_rate: float = 0.0,
                 telemetry=None, device="cuda"):
        unported = {"mesh": mesh is not None, "ckpt_dir": bool(ckpt_dir),
                    "failure_rate": failure_rate > 0,
                    "telemetry": telemetry is not None,
                    "cfg.pattern": cfg.pattern != "synchronous",
                    "cfg.relaunch_budget": cfg.relaunch_budget != 0}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported yet: {asked}")
        self.device = resolve_device(device)
        if getattr(engine, "device", self.device) != self.device:
            raise ValueError(f"engine lives on {engine.device}, the driver "
                             f"on {self.device}")
        self.engine = engine
        self.capabilities = engine_capabilities(engine)
        self.cfg = cfg
        self.grid: ControlGrid = build_grid(cfg, self.device)
        n = self.grid.n_ctrl
        if slots is None:
            slots = n * cfg.cores_per_replica
        eff_slots = max(slots // max(cfg.cores_per_replica, 1), 1)
        if cfg.execution_mode == "mode1":
            self.execution = {"mode": "mode1", "n_waves": 1}
        else:
            self.execution = auto_mode(n, eff_slots)
        if cfg.execution_mode == "mode2" or self.execution["mode"] != "mode1":
            raise NotImplementedError("execution mode2 is not ported yet")
        self.history: List[Dict] = []
        self.acceptance = {f"dim{d.index}": [0.0, 0.0]
                           for d in self.grid.dims}
        self.last_report = None

    # -- public API --------------------------------------------------------

    def init(self, seed: Optional[int] = None) -> Ensemble:
        rng = jr.key(self.cfg.seed if seed is None else seed, self.device)
        return make_ensemble(self.engine, rng, self.grid.n_ctrl,
                             hetero_speed=False)

    def run_fused(self, ens: Ensemble, n_cycles: Optional[int] = None,
                  chunk_cycles: int = 16, verbose: bool = False) -> Ensemble:
        """K cycles per chunk, one host fetch per chunk (module docstring).
        Same ``history`` / ``acceptance`` bookkeeping as the JAX driver."""
        if chunk_cycles < 1:
            raise ValueError(f"chunk_cycles must be >= 1, got {chunk_cycles}")
        return self._chunk_loop(ens, self._start_carry(ens),
                                n_cycles or self.cfg.n_cycles, chunk_cycles,
                                verbose)

    def acceptance_ratios(self) -> Dict[str, float]:
        return {k: (a / max(n, 1.0))
                for k, (a, n) in self.acceptance.items()}

    # -- the chunk ---------------------------------------------------------

    def _no_host_sync(self):
        """Inside a chunk on CUDA, any host synchronisation raises."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def guard():
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return guard()

    def _chunk(self, ens: Ensemble, backup, k: int):
        """``k`` complete cycles, queued on the device with no host read.
        Returns (ens, backup, rows) with rows a (k, F) float64
        device tensor of per-cycle stats (``_FIELDS``, then the
        assignment row)."""
        cfg = self.cfg
        policy = "relaunch" if cfg.relaunch_failed else "continue"
        rows = []
        for _ in range(k):
            cyc = ens.cycle
            ens, stats = patterns.fused_cycle(
                self.engine, self.grid, ens, pattern=cfg.pattern,
                md_steps=cfg.md_steps_per_cycle, scheme=cfg.exchange_scheme,
                execution=self.execution)
            ens, backup, esc = F.detect_recover(
                self.engine, ens, policy, backup,
                relaunch_budget=cfg.relaunch_budget)
            stats = dict(stats, cycle=cyc, **esc)
            scalars = torch.stack([stats[f].to(torch.float64)
                                   for f in _FIELDS])
            rows.append(torch.cat([scalars,
                                   stats["assignment"].to(torch.float64)]))
        return ens, backup, torch.stack(rows)

    def _chunk_loop(self, ens: Ensemble, backup, n_cycles: int,
                    chunk_cycles: int, verbose: bool) -> Ensemble:
        c0 = int(ens.cycle)
        done = 0
        while done < n_cycles:
            k = min(chunk_cycles, n_cycles - done)
            t0 = time.perf_counter()
            with self._no_host_sync():
                ens, backup, rows = self._chunk(ens, backup, k)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            t_chunk = time.perf_counter() - t0      # K x (T_MD + T_EX)

            t1 = time.perf_counter()
            host = rows.cpu().numpy()               # ONE fetch per chunk
            t_data = time.perf_counter() - t1

            cols = {f: host[:, j].tolist() for j, f in enumerate(_FIELDS)}
            for f in _INT_FIELDS:
                cols[f] = [int(v) for v in cols[f]]
            assignment = host[:, len(_FIELDS):].astype("int64")
            t_step, t_d = t_chunk / k, t_data / k
            for i in range(k):
                bucket = self.acceptance[f"dim{cols['dim'][i]}"]
                bucket[0] += cols["accepted"][i]
                bucket[1] += cols["attempted"][i]
                self.history.append({
                    "cycle": cols["cycle"][i], "dim": cols["dim"][i],
                    "t_step": t_step, "t_prep": 0.0,
                    "t_recover": 0.0, "t_data": t_d,
                    "accept": cols["accepted"][i],
                    "attempt": cols["attempted"][i],
                    "failed": cols["failed"][i],
                    "esc_relaunch": cols["esc_relaunch"][i],
                    "esc_reinit": cols["esc_reinit"][i],
                    "esc_dead": cols["esc_dead"][i],
                    "ready_frac": cols["ready_frac"][i],
                    "assignment": assignment[i],
                    "nb_overflow": 0.0, "nb_rebuilds": 0.0,
                })
            done += k
            if verbose:
                acc = sum(cols["accepted"])
                att = max(sum(cols["attempted"]), 1.0)
                print(f"chunk @cycle {c0 + done:4d} K={k} "
                      f"acc {acc / att * 100:5.1f}%  "
                      f"t {t_chunk / k * 1e3:7.2f} ms/cycle")
        return ens

    def _start_carry(self, ens: Ensemble):
        """The recovery backup a fresh run starts from: the ensemble's own
        state.  (The failure-injection key joins the carry with injection.)"""
        return ens.state
