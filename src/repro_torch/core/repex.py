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

``run(ens)`` is the per-cycle path, the semantics oracle of
``run_fused``: one cycle per call, the cycle count read on the host to
schedule the sweep, then ``detect_recover``, with Eq. (1)'s host terms
timed as in the JAX package (``t_prep``, ``t_step``, ``t_recover``,
``t_data``).  It synchronises with the host by design, so it runs
outside the no-sync guard; its cycles are the same launches as
``run_fused``'s, so its history rows equal ``run_fused``'s.

Both patterns (``cfg.pattern``: synchronous, asynchronous) and both
execution modes (Mode II by ``slots`` or ``cfg.execution_mode``) run on
either path.  ``failure_rate > 0`` corrupts replicas before each cycle
(the failure key rides the carry beside the recovery backup);
``cfg.relaunch_budget`` sets the escalation ladder.  With ``ckpt_dir``
the driver checkpoints the ensemble, the carry and its host bookkeeping
(``run`` by ``CheckpointManager`` cadence, ``run_fused`` at the chunk
that crosses a multiple of ``ckpt_every``), in the JAX package's format;
``restore`` and ``resume`` continue a killed run bit-exactly.

Under the "continue" recovery policy (``cfg.relaunch_failed`` off)
nothing reads a cycle's pre-propagate state, so the driver hands
``donate=True`` to an engine whose ``propagate`` takes it: the engine
may step the state in place, and ``run``, ``run_fused`` and
``run_sharded`` then consume the ensemble they are given.  Under the
relaunch policy the pre-cycle state is the recovery backup, and every
engine returns a new state.  Phase probes never donate.

Every ``run``, ``run_fused`` and ``resume`` leaves a
:class:`~repro_torch.obs.RunReport` in ``last_report``, with or without
telemetry.  ``telemetry=Telemetry()`` (``repro_torch.obs``) adds the
per-pair exchange counters as extra columns of the chunk's stats rows
(still one fetch per chunk), rung occupancy and round trips folded on the
host, and phase probes at chunk boundaries (each phase alone on the
current ensemble, CUDA events on the card): the Eq. (1) split of the
report.  Telemetry on leaves the trajectory bitwise unchanged; telemetry
off (``None``) dispatches exactly the operations of a driver without it.
Its accumulators ride the checkpoint, so a resumed run reports what an
uninterrupted one does.

``run_sharded(ens, mesh)`` is ``run_fused`` over a replica mesh
(``repro_torch.launch.mesh``), one process per shard under
``torch.distributed``: the paper's spatial Execution-Mode dimension made
a process layout.  Each rank holds one contiguous block of R / n_shards
replicas and runs the same ``_chunk``; the control plane is computed in
full on every rank, and per sweep only O(R / n_shards) exchange scalars
and failure flags cross ranks (``cfg.exchange_comm``: the halo ring, or
the gather of the feature rows).  Positions never do, except the tier-2
reinit hop of one boundary backup row.  The discrete trajectory is
``run_fused``'s bitwise on any shard count; the host fetches once per
chunk, and on the card the collectives are stream-ordered, so a chunk
stays free of host syncs.  Checkpoints gather the blocks and rank 0
writes them in the shared format; ``resume(via="sharded")`` restarts
on any shard count.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import sharding as S
from repro_torch.ckpt import (CheckpointError, CheckpointManager, PRNGKey,
                              load_checkpoint)
from repro_torch.config import RepExConfig
from repro_torch.core import failures as F
from repro_torch.core import patterns
from repro_torch.core.controls import ControlGrid, build_grid
from repro_torch.core.engine import NB_STAT_KEYS, engine_capabilities
from repro_torch.core.ensemble import Ensemble, make_ensemble
from repro_torch.core.modes import auto_mode
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (ReplicaMesh, best_replica_shards,
                                     make_replica_mesh)
from repro_torch.obs import build_report

# the scalar fields of one cycle's stats row, in packing order; the
# post-cycle assignment row follows them
_FIELDS = ("cycle", "dim", "accepted", "attempted",
           "ready_frac") + F.ESC_STAT_KEYS + NB_STAT_KEYS
_INT_FIELDS = ("cycle", "dim") + F.ESC_STAT_KEYS

# checkpoint 'extra' schema carried alongside the ensemble payload (the
# host-side driver state resume() restores), the JAX package's
CKPT_DRIVER_SCHEMA = 1

# config fields that do not affect the per-cycle trajectory: a resume may
# differ in these without invalidating the bitwise-resume contract
_CFG_RESUME_EXEMPT = ("n_cycles",)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Equal devices, an unindexed CUDA device read as the current one."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


class REMDDriver:
    def __init__(self, engine, cfg: RepExConfig, mesh=None,
                 slots: Optional[int] = None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, failure_rate: float = 0.0,
                 telemetry=None, device="cuda"):
        self.device = resolve_device(device)
        if not _same_device(getattr(engine, "device", self.device),
                            self.device):
            raise ValueError(f"engine lives on {engine.device}, the driver "
                             f"on {self.device}")
        self.engine = engine
        self.capabilities = engine_capabilities(engine)
        # the relaunch policy's backup is the pre-cycle state: only
        # without it may the engine write into the state it is handed
        self._donate = (self.capabilities["donate"]
                        and not cfg.relaunch_failed)
        # can nb_stats ever be nonzero?  (no list, or a dense nonbonded
        # path: ``run`` skips the read)
        self._nb_live = patterns.nb_live(engine)
        self.cfg = cfg
        self.grid: ControlGrid = build_grid(cfg, self.device)
        n = self.grid.n_ctrl
        # the default mesh of run_sharded / resume(via="sharded"); run and
        # run_fused ignore it (JAX's mesh there moves placement, not values)
        self.mesh = self._check_mesh(mesh)
        if slots is None:
            slots = n * cfg.cores_per_replica
        eff_slots = max(slots // max(cfg.cores_per_replica, 1), 1)
        if cfg.execution_mode == "mode1":
            self.execution = {"mode": "mode1", "n_waves": 1}
        elif cfg.execution_mode == "mode2":
            self.execution = auto_mode(n, eff_slots)
            if self.execution["mode"] != "mode2":      # at least 2 waves
                self.execution = {"mode": "mode2", "n_waves": min(2, n)}
        else:
            self.execution = auto_mode(n, eff_slots)
        self.failure_rate = failure_rate
        self.ckpt = (CheckpointManager(ckpt_dir, every=ckpt_every)
                     if ckpt_dir else None)
        self.history: List[Dict] = []
        self.acceptance = {f"dim{d.index}": [0.0, 0.0]
                           for d in self.grid.dims}
        # observability (repro_torch.obs): an optional Telemetry
        # accumulator; None changes no operation of a chunk
        self.telemetry = telemetry
        self.last_report = None
        # the collectives of the last sharded chunk (sharding.WireCensus)
        self.last_wire = None
        self._phase_probes = None
        self._probe_warmed: set = set()
        # (backup, fail_key) restored by resume()/restore(), consumed by
        # the next run*() call so the carry continues bit-exactly
        self._resume_carry = None

    # -- telemetry plumbing ------------------------------------------------

    @property
    def _tel(self):
        """The live telemetry accumulator, or None when observability is
        off (absent or disabled)."""
        t = self.telemetry
        return t if (t is not None and t.enabled) else None

    @property
    def _obs_rows(self) -> bool:
        """Carry the per-pair attempt/accept rows in the cycle stats?"""
        t = self._tel
        return bool(t is not None and t.exchange_counters)

    def _maybe_phase_sample(self, ens: Ensemble, cyc: int,
                            mesh=None) -> None:
        """A phase probe at a chunk boundary: each cycle phase timed alone
        on the current ensemble, which the probes read and never write
        (sharded: on the rank's block, every rank at the same boundary)."""
        tel = self._tel
        if tel is None or not tel.want_phase_sample():
            return
        from repro_torch.obs import make_phase_probes, sample_phases
        if self._phase_probes is None or self._phase_probes[0] is not mesh:
            self._phase_probes = (mesh, make_phase_probes(self, mesh))
            self._probe_warmed = set()
        times = sample_phases(self._phase_probes[1], ens,
                              self._probe_warmed)
        tel.note_phase_sample(cyc, times)

    @property
    def _window_steps(self) -> int:
        """The asynchronous pattern's real-time window in MD steps."""
        cfg = self.cfg
        return max(int(cfg.md_steps_per_cycle * cfg.async_window), 1)

    # -- public API --------------------------------------------------------

    def init(self, seed: Optional[int] = None) -> Ensemble:
        rng = jr.key(self.cfg.seed if seed is None else seed, self.device)
        return make_ensemble(self.engine, rng, self.grid.n_ctrl,
                             hetero_speed=self.cfg.pattern == "asynchronous")

    def run(self, ens: Ensemble, n_cycles: Optional[int] = None,
            verbose: bool = False) -> Ensemble:
        """The per-cycle path: one cycle per iteration, with the host
        reading the cycle count (T_RepEx_over), waiting for the cycle
        (T_MD + T_EX), for detect + recover, and fetching the stats
        (T_data), every cycle.  Failures are injected between cycles;
        checkpoints follow the manager's cadence, cycle by cycle."""
        cfg = self.cfg
        policy = "relaunch" if cfg.relaunch_failed else "continue"
        n_dims = len(self.grid.dims)
        backup, fail_key = self._start_carry(ens)
        for _ in range(n_cycles or cfg.n_cycles):
            t0 = time.perf_counter()
            cyc = int(ens.cycle)
            dim_index = cyc % n_dims
            parity = (cyc // n_dims) % 2
            dev = ens.cycle.device
            t_prep = time.perf_counter() - t0            # T_RepEx_over

            if self.failure_rate > 0:
                fail_key, ens = self._inject(fail_key, ens)

            t1 = time.perf_counter()
            new_ens, stats, ready = patterns._cycle_core(
                self.engine, self.grid, ens, pattern=cfg.pattern,
                md_steps=cfg.md_steps_per_cycle,
                window_steps=self._window_steps,
                dim_index=torch.tensor(dim_index, device=dev),
                parity=torch.tensor(parity, device=dev),
                scheme=cfg.exchange_scheme, execution=self.execution,
                donate=self._donate)
            pa, pc = patterns._pop_pair_rows(stats, self._obs_rows)
            self._sync()
            t_step = time.perf_counter() - t1            # T_MD + T_EX
            # the health counters of the pre-recovery state, as the fused
            # path reads them
            nb_state = new_ens.state

            t2 = time.perf_counter()
            new_ens, backup, esc = F.detect_recover(
                self.engine, new_ens, policy, backup,
                relaunch_budget=cfg.relaunch_budget)
            esc = {k: int(v) for k, v in esc.items()}
            t_recover = time.perf_counter() - t2

            t3 = time.perf_counter()
            accepted = float(stats["accepted"])
            attempted = float(stats["attempted"])
            ready_frac = float(torch.mean(ready.to(torch.float32)))
            if self._nb_live:
                nb = {k: float(v) for k, v in patterns.nb_health(
                    self.engine, nb_state, dev).items()}
            else:
                nb = dict.fromkeys(NB_STAT_KEYS, 0.0)
            assignment = new_ens.assignment.cpu().numpy()
            pair_rows = ((pa.cpu().numpy(), pc.cpu().numpy())
                         if pa is not None else (None, None))
            t_data = time.perf_counter() - t3            # T_data

            bucket = self.acceptance[f"dim{dim_index}"]
            bucket[0] += accepted
            bucket[1] += attempted
            self.history.append({
                "cycle": cyc, "dim": dim_index,
                "t_step": t_step, "t_prep": t_prep,
                "t_recover": t_recover, "t_data": t_data,
                "accept": accepted, "attempt": attempted,
                "failed": esc["failed"],
                "esc_relaunch": esc["esc_relaunch"],
                "esc_reinit": esc["esc_reinit"],
                "esc_dead": esc["esc_dead"],
                "ready_frac": ready_frac,
                "assignment": assignment,
                "nb_overflow": nb["nb_overflow"],
                "nb_rebuilds": nb["nb_rebuilds"],
            })
            ens = new_ens
            tel = self._tel
            if tel is not None:
                self._maybe_phase_sample(ens, cyc)
                tel.note_cycles(
                    cycles=[cyc], dims=[dim_index],
                    assignments=assignment[None], n_dims=n_dims,
                    n_ctrl=self.grid.n_ctrl, pair_attempt=pair_rows[0],
                    pair_accept=pair_rows[1], t_cycle=t_step,
                    t_data=t_data, t_prep=t_prep)
            if self.ckpt is not None:
                self._save_ckpt(cyc, ens, backup, fail_key)
            if verbose:
                print(f"cycle {cyc:4d} dim {dim_index} "
                      f"acc {accepted / max(attempted, 1.0) * 100:5.1f}%  "
                      f"t {t_step * 1e3:7.1f} ms")
        self.last_report = build_report(self, "run")
        return ens

    def run_fused(self, ens: Ensemble, n_cycles: Optional[int] = None,
                  chunk_cycles: int = 16, verbose: bool = False) -> Ensemble:
        """K cycles per chunk, one host fetch per chunk (module docstring).
        Same ``history`` / ``acceptance`` bookkeeping as the JAX driver."""
        if chunk_cycles < 1:
            raise ValueError(f"chunk_cycles must be >= 1, got {chunk_cycles}")
        backup, fail_key = self._start_carry(ens)
        ens = self._chunk_loop(ens, backup, fail_key,
                               n_cycles or self.cfg.n_cycles, chunk_cycles,
                               verbose)
        self.last_report = build_report(self, "fused", chunk_cycles)
        return ens

    def run_sharded(self, ens: Ensemble, mesh=None,
                    n_cycles: Optional[int] = None, chunk_cycles: int = 16,
                    verbose: bool = False) -> Ensemble:
        """``run_fused`` with the replicas sharded over a replica mesh
        (module docstring), called by every rank of the mesh.

        ``ens``: the whole ensemble (every rank makes the same one with
        ``init``) or this rank's block of it; the returned ensemble is
        the whole one, its state gathered from the blocks at the end.
        ``mesh``: default the driver's, else the best mesh of the running
        world (``best_replica_shards``; a one-rank group when nothing
        launched more).  Its shard count must divide R (``ValueError``),
        and the engine must have the split feature API
        (``replica_features``, ``energy_pair_from_features``; for the
        matrix scheme ``cross_energy_from_features``; ``TypeError``).
        Mode II's waves run within each rank's block."""
        if chunk_cycles < 1:
            raise ValueError(f"chunk_cycles must be >= 1, got {chunk_cycles}")
        caps = self.capabilities
        needed = ["replica_features", "energy_pair_from_features"]
        if self.cfg.exchange_scheme == "matrix":
            needed.append("cross_energy_from_features")
        missing = [c for c in needed if not caps[c]]
        if missing:
            raise TypeError(
                f"engine {type(self.engine).__name__} lacks the feature "
                f"API required by run_sharded: {missing} (see "
                f"repro_torch.core.engine)")
        mesh = self._sharded_mesh(mesh)
        ens = S.shard_ensemble(ens, mesh)
        backup, fail_key = self._start_carry(ens)
        backup = S.shard_state(backup, mesh, self.grid.n_ctrl)
        ens = self._chunk_loop(ens, backup, fail_key,
                               n_cycles or self.cfg.n_cycles, chunk_cycles,
                               verbose, mesh=mesh)
        self.last_report = build_report(self, "sharded", chunk_cycles)
        return S.gather_ensemble(ens, mesh)

    def _check_mesh(self, mesh):
        """A mesh for this driver: a member's ``ReplicaMesh`` on the
        driver's device whose shard count divides R (None passes)."""
        if mesh is None:
            return None
        if not isinstance(mesh, ReplicaMesh):
            raise TypeError(f"mesh must be a ReplicaMesh "
                            f"(repro_torch.launch.mesh.make_replica_mesh), "
                            f"got {type(mesh).__name__}")
        if not mesh.is_member:
            raise ValueError("this rank is not a member of the mesh")
        if not _same_device(mesh.device, self.device):
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the "
                             f"driver on {self.device}")
        n = self.grid.n_ctrl
        if n % mesh.n_shards:
            raise ValueError(f"replica count {n} is not divisible by the "
                             f"mesh's {mesh.n_shards} shards")
        return mesh

    def _sharded_mesh(self, mesh):
        """The mesh of a sharded run: ``mesh``, the driver's, or the best
        one of the running world."""
        if mesh is None:
            mesh = self.mesh or make_replica_mesh(
                best_replica_shards(self.grid.n_ctrl), device=self.device)
        return self._check_mesh(mesh)

    def acceptance_ratios(self) -> Dict[str, float]:
        return {k: (a / max(n, 1.0))
                for k, (a, n) in self.acceptance.items()}

    # -- the chunk ---------------------------------------------------------

    def _sync(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

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

    def _inject(self, fail_key, ens: Ensemble, mesh=None):
        """Advance the failure key and corrupt this cycle's hits."""
        fail_key, k = jr.split(fail_key, 2)
        return fail_key, F.inject_failures(ens, k, self.failure_rate, mesh)

    def _chunk(self, ens: Ensemble, backup, fail_key, k: int, mesh=None):
        """``k`` complete inject -> cycle -> detect/recover steps, queued
        on the device with no host read.  Returns (ens, backup, fail_key,
        rows) with rows a (k, F) float64 device tensor of per-cycle stats
        (``_FIELDS``, then the assignment row, then with telemetry's
        counters the pair_attempt and pair_accept rows).  With ``mesh``
        the same steps run on this rank's block (``ens.state`` and
        ``backup`` hold it), the exchange's failure row handed on to the
        recovery; the rows are the same on every rank."""
        cfg = self.cfg
        policy = "relaunch" if cfg.relaunch_failed else "continue"
        obs_rows = self._obs_rows
        rows = []
        for _ in range(k):
            if self.failure_rate > 0:
                fail_key, ens = self._inject(fail_key, ens, mesh)
            cyc = ens.cycle
            ens, stats = patterns.fused_cycle(
                self.engine, self.grid, ens, pattern=cfg.pattern,
                md_steps=cfg.md_steps_per_cycle,
                window_steps=self._window_steps, scheme=cfg.exchange_scheme,
                execution=self.execution, telemetry_rows=obs_rows,
                mesh=mesh, exchange_comm=cfg.exchange_comm,
                donate=self._donate)
            ens, backup, esc = F.detect_recover(
                self.engine, ens, policy, backup,
                relaunch_budget=cfg.relaunch_budget, mesh=mesh,
                fail_row=stats.pop("_fail_row", None))
            stats = dict(stats, cycle=cyc, **esc)
            scalars = torch.stack([stats[f].to(torch.float64)
                                   for f in _FIELDS])
            parts = [scalars, stats["assignment"].to(torch.float64)]
            if "pair_attempt" in stats:
                parts += [stats["pair_attempt"].to(torch.float64),
                          stats["pair_accept"].to(torch.float64)]
            rows.append(torch.cat(parts))
        return ens, backup, fail_key, torch.stack(rows)

    def _chunk_loop(self, ens: Ensemble, backup, fail_key, n_cycles: int,
                    chunk_cycles: int, verbose: bool,
                    mesh=None) -> Ensemble:
        """Drive chunks to ``n_cycles``, one stats fetch per chunk, with
        the ``history`` / ``acceptance`` / telemetry / checkpoint
        bookkeeping of both ``run_fused`` and ``run_sharded`` (``mesh``:
        each chunk's collectives go to a census, the wire ledger)."""
        c0 = int(ens.cycle)
        done = 0
        census = (S.wire_census if mesh is not None
                  else contextlib.nullcontext)
        while done < n_cycles:
            k = min(chunk_cycles, n_cycles - done)
            t0 = time.perf_counter()
            with self._no_host_sync(), census() as wire:
                ens, backup, fail_key, rows = self._chunk(ens, backup,
                                                          fail_key, k, mesh)
            self._sync()
            t_chunk = time.perf_counter() - t0      # K x (T_MD + T_EX)

            t1 = time.perf_counter()
            host = rows.cpu().numpy()               # ONE fetch per chunk
            t_data = time.perf_counter() - t1

            cols = {f: host[:, j].tolist() for j, f in enumerate(_FIELDS)}
            for f in _INT_FIELDS:
                cols[f] = [int(v) for v in cols[f]]
            a0 = len(_FIELDS)
            a1 = a0 + self.grid.n_ctrl
            assignment = host[:, a0:a1].astype("int64")
            pair = host[:, a1:]                     # (k, 2 W) or (k, 0)
            w = pair.shape[1] // 2
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
                    "nb_overflow": cols["nb_overflow"][i],
                    "nb_rebuilds": cols["nb_rebuilds"][i],
                })
            done += k
            if wire is not None:
                self.last_wire = wire
            tel = self._tel
            if tel is not None:
                # the probe first: want_phase_sample reads the chunk count
                # before note_cycles advances it, so every Nth boundary
                # (the first included) samples
                self._maybe_phase_sample(ens, c0 + done - 1, mesh)
                if wire is not None and tel.wire_ledger:
                    tel.note_wire_budget(k, wire.budget())
                    tel.note_wire_invocation(k)
                tel.note_cycles(
                    cycles=cols["cycle"], dims=cols["dim"],
                    assignments=assignment, n_dims=len(self.grid.dims),
                    n_ctrl=self.grid.n_ctrl,
                    pair_attempt=pair[:, :w] if w else None,
                    pair_accept=pair[:, w:] if w else None,
                    t_cycle=t_chunk, t_data=t_data)
            if self.ckpt is not None and self.ckpt.every > 0:
                lo, hi = c0 + done - k, c0 + done - 1
                if hi // self.ckpt.every > (lo - 1) // self.ckpt.every:
                    self._save_ckpt(hi, ens, backup, fail_key, force=True,
                                    mesh=mesh)
            if verbose:
                acc = sum(cols["accepted"])
                att = max(sum(cols["attempted"]), 1.0)
                print(f"chunk @cycle {c0 + done:4d} K={k} "
                      f"acc {acc / att * 100:5.1f}%  "
                      f"t {t_chunk / k * 1e3:7.2f} ms/cycle")
        return ens

    def _start_carry(self, ens: Ensemble):
        """The carry's (backup, fail_key) start values: the pair that
        resume()/restore() loaded from a checkpoint (consumed exactly
        once), or a fresh run's: the ensemble's own state and the key of
        ``seed + 999``."""
        carry, self._resume_carry = self._resume_carry, None
        if carry is not None:
            return carry
        return ens.state, jr.key(self.cfg.seed + 999, self.device)

    # -- checkpoint payload / driver-state extra ---------------------------

    def _ckpt_payload(self, ens: Ensemble, backup, fail_key):
        """The full device-side restart state, keyed as the JAX driver
        keys it: the ensemble plus the carry (the recovery backup, which
        lags the ensemble whenever a failure froze it, and the failure
        key chain)."""
        e = ens._asdict()
        e["rng"] = PRNGKey(ens.rng)
        return {"ensemble": e, "backup": backup,
                "fail_key": PRNGKey(fail_key)}

    def _cfg_fingerprint(self) -> Dict[str, Any]:
        """The config as the JAX driver fingerprints it (JSON round trip,
        ``n_cycles`` exempt, the failure rate added), so that either
        package resumes the other's checkpoint of the same run."""
        d = dataclasses.asdict(self.cfg)
        for k in _CFG_RESUME_EXEMPT:
            d.pop(k, None)
        d["_failure_rate"] = float(self.failure_rate)
        return json.loads(json.dumps(d))

    def _ckpt_extra(self) -> Dict[str, Any]:
        """Host-side driver state riding the manifest: cycle history
        (with assignment rows), per-dim acceptance, the telemetry
        accumulators and the config fingerprint resume() validates."""
        tel = self._tel
        hist = []
        for h in self.history:
            h2 = dict(h)
            if h2.get("assignment") is not None:
                h2["assignment"] = np.asarray(h2["assignment"]).tolist()
            hist.append(h2)
        return {"repex": {
            "schema": CKPT_DRIVER_SCHEMA,
            "config": self._cfg_fingerprint(),
            "acceptance": {k: [float(v[0]), float(v[1])]
                           for k, v in self.acceptance.items()},
            "history": hist,
            "telemetry": tel.state_dict() if tel is not None else None,
        }}

    def _save_ckpt(self, step: int, ens: Ensemble, backup, fail_key,
                   force: bool = False, mesh=None):
        """Save the restart state.  Sharded: the blocks of the state and
        the backup are gathered, rank 0 writes, and the ranks meet at a
        barrier before any of them goes on."""
        if mesh is not None:
            ens = S.gather_ensemble(ens, mesh)
            backup = S.gather_state(backup, mesh)
            if mesh.rank != 0:
                mesh.barrier()
                return
        self.ckpt.maybe_save(step, self._ckpt_payload(ens, backup, fail_key),
                             extra=self._ckpt_extra(), force=force)
        if mesh is not None:
            mesh.barrier()

    # -- restart paths -----------------------------------------------------

    def _load_ckpt(self, step: Optional[int] = None, mesh=None):
        """The newest intact checkpoint (or ``step``), in a template
        payload on this driver's device; with ``mesh`` the state and the
        backup hold only this rank's rows.  Returns (ensemble, carry,
        step, extra)."""
        ens_like = self.init()
        like = self._ckpt_payload(ens_like, ens_like.state, ens_like.rng)
        shardings = None
        if mesh is not None:
            sh = S.ensemble_shardings(mesh, ens_like)
            shardings = {"ensemble": sh._asdict(), "backup": sh.state,
                         "fail_key": None}
        tree, step_no, extra = load_checkpoint(self.ckpt.directory, like,
                                               step=step,
                                               shardings=shardings)
        e = dict(tree["ensemble"], rng=tree["ensemble"]["rng"].data)
        carry = (tree["backup"], tree["fail_key"].data)
        return Ensemble(**e), carry, step_no, extra

    def restore(self, ens_like: Ensemble) -> Optional[Ensemble]:
        """Restart from the latest checkpoint (the node-failure path).
        Returns just the ensemble; the recovery backup and the failure
        key are staged so that the next ``run*`` call continues
        bit-exactly.  :meth:`resume` also restores the history."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return None
        ens, self._resume_carry, _, _ = self._load_ckpt()
        return ens

    def resume(self, via: str = "fused", n_cycles: Optional[int] = None,
               chunk_cycles: int = 16, mesh=None,
               step: Optional[int] = None,
               verbose: bool = False) -> Ensemble:
        """Continue a killed run from its newest intact checkpoint (or
        ``step``): the ensemble, the carry (backup + failure key) and the
        host bookkeeping (history, acceptance, telemetry), then the
        remaining ``n_cycles - cycle`` cycles via ``run`` or
        ``run_fused`` or ``run_sharded``.  The stitched run equals an
        uninterrupted one bitwise.  With ``via="sharded"`` each rank
        loads its own rows onto ``mesh`` (default: the driver's, else the
        best mesh of the running world), whatever shard count wrote the
        checkpoint (the elastic restart).  The checkpoint's config
        fingerprint must match this driver's (``n_cycles`` exempt), else
        :class:`CheckpointError`."""
        if self.ckpt is None:
            raise ValueError("resume() needs a driver constructed with "
                             "ckpt_dir")
        if via not in ("run", "fused", "sharded"):
            raise ValueError(f"via must be run|fused|sharded, got {via!r}")
        if via == "sharded":
            mesh = self._sharded_mesh(mesh)
        ens, carry, step_no, extra = self._load_ckpt(
            step=step, mesh=mesh if via == "sharded" else None)
        meta = (extra or {}).get("repex")
        if not meta:
            raise CheckpointError(
                f"checkpoint step {step_no} carries no driver state "
                f"('repex' extra missing); use restore()")
        saved_cfg = meta.get("config", {})
        cur_cfg = self._cfg_fingerprint()
        if saved_cfg != cur_cfg:
            diff = sorted(k for k in set(saved_cfg) | set(cur_cfg)
                          if saved_cfg.get(k) != cur_cfg.get(k))
            raise CheckpointError(
                f"checkpoint config does not match this driver "
                f"(differing fields: {diff}) — resume with the original "
                f"configuration")
        self.history = [
            dict(h, assignment=np.asarray(h["assignment"], np.int64))
            if h.get("assignment") is not None else dict(h)
            for h in meta.get("history", [])]
        self.acceptance = {k: [float(v[0]), float(v[1])]
                           for k, v in meta.get("acceptance", {}).items()}
        if self.telemetry is not None and meta.get("telemetry") is not None:
            self.telemetry.load_state_dict(meta["telemetry"])
        remaining = (n_cycles or self.cfg.n_cycles) - int(ens.cycle)
        if remaining <= 0:
            self.last_report = build_report(
                self, via, None if via == "run" else chunk_cycles)
            return S.gather_ensemble(ens, mesh) if via == "sharded" else ens
        self._resume_carry = carry
        if via == "run":
            return self.run(ens, n_cycles=remaining, verbose=verbose)
        if via == "sharded":
            return self.run_sharded(ens, mesh=mesh, n_cycles=remaining,
                                    chunk_cycles=chunk_cycles,
                                    verbose=verbose)
        return self.run_fused(ens, n_cycles=remaining,
                              chunk_cycles=chunk_cycles, verbose=verbose)
