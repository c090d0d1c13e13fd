"""Observability for REMD runs: the Eq. (1) instrumentation of the port.

The paper splits a cycle's time as

    T_c = T_MD + T_EX + T_data + T_RepEx_over + T_runtime_over     (Eq. 1)

and a ``run_fused`` chunk shows the host only their sum.  This module,
the port of the JAX package's ``obs/telemetry.py``, splits it back apart
without moving the run:

  * **Per-pair exchange counters** ride the chunk as extra columns of the
    per-cycle stats rows (``pair_attempt`` / ``pair_accept``, one row per
    DEO sweep, from ``exchange._decide_sweep`` through
    ``patterns.fused_cycle`` to ``repex._chunk``), fetched with the rows
    once per chunk.  With telemetry off they are never computed: the
    chunk dispatches the same operations as an uninstrumented driver.
  * **Phase probes** run at chunk boundaries: each phase (propagate,
    features, exchange, detect + recover) alone on the current ensemble,
    timed with CUDA events on the card and ``perf_counter`` on the CPU.
    A probe reads the ensemble and returns fresh tensors; it neither
    mutates nor advances it, so the trajectory is bitwise unchanged.
  * **Rung occupancy and round trips** are folded on the host from the
    per-cycle assignment rows the driver fetches anyway.
  * The **wire ledger** (``wire``, ``note_wire_*``): on a sharded run
    the driver opens a census around each chunk
    (``repro_torch.sharding.wire_census``) and notes its collectives, op
    by op with their count and bytes, per chunk length, in the JAX
    package's format.  The census is host bookkeeping only: with the
    ledger off the chunk issues the same collectives.

A :class:`Telemetry` is the configuration and the host accumulator
(:meth:`Telemetry.reset` clears it, e.g. after a warm-up).
``REMDDriver(..., telemetry=Telemetry())`` switches it on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

PHASES = ("propagate", "features", "exchange", "detect_recover")


def accumulate_occupancy(trace: np.ndarray, n_ctrl: int,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
    """Fold a (C, R) assignment trace into (R, n_ctrl) occupancy counts:
    ``out[r, c]`` cycles replica r held ctrl c.  Pass ``out`` to
    accumulate chunk by chunk (the same as one fold of the whole trace)."""
    trace = np.asarray(trace)
    if trace.ndim == 1:
        trace = trace[None, :]
    n_rep = trace.shape[1]
    if out is None:
        out = np.zeros((n_rep, n_ctrl), np.int64)
    np.add.at(out, (np.arange(n_rep)[None, :], trace), 1)
    return out


def round_trip_fold(trace: np.ndarray, n_ctrl: int,
                    phase: Optional[np.ndarray] = None,
                    counts: Optional[np.ndarray] = None):
    """Fold a (C, R) assignment trace into per-replica round-trip counts.
    A replica completes a round trip when it returns to the bottom rung
    (ctrl 0) after touching the top one (ctrl n_ctrl - 1) since its last
    bottom visit.  ``phase`` per replica: 0 never at the bottom, 1 heading
    up, 2 heading down.  Returns (phase, counts); pass them back to fold
    chunk by chunk."""
    trace = np.asarray(trace)
    if trace.ndim == 1:
        trace = trace[None, :]
    n_rep = trace.shape[1]
    if phase is None:
        phase = np.zeros(n_rep, np.int8)
    if counts is None:
        counts = np.zeros(n_rep, np.int64)
    for row in trace:
        bottom = row == 0
        top = row == (n_ctrl - 1)
        counts = counts + ((phase == 2) & bottom)
        phase = np.where(bottom, 1, phase)
        phase = np.where(top & (phase == 1), 2, phase)
    return phase, counts


@dataclass
class Telemetry:
    """Observability configuration and host-side accumulator (over one
    run or several: the driver accumulates across ``run*`` calls as it
    does ``history``; :meth:`reset` clears).  ``enabled=False`` (or
    ``telemetry=None``) is a true off switch."""
    enabled: bool = True
    # per-pair attempt/accept rows in the chunk's stats (the neighbor/DEO
    # scheme only: the Gibbs matrix scheme redraws its pairs every sweep,
    # so it has no static pair-slot axis)
    exchange_counters: bool = True
    # sample the phase probes every Nth chunk boundary (0 = off); ``run``
    # samples every Nth cycle
    phase_probe_every: int = 1
    # note a sharded chunk's collectives (run_sharded)
    wire_ledger: bool = True

    pair_attempt: Optional[np.ndarray] = field(default=None, repr=False)
    pair_accept: Optional[np.ndarray] = field(default=None, repr=False)
    occupancy: Optional[np.ndarray] = field(default=None, repr=False)
    rt_phase: Optional[np.ndarray] = field(default=None, repr=False)
    round_trips: Optional[np.ndarray] = field(default=None, repr=False)
    phase_samples: List[Dict[str, float]] = field(default_factory=list,
                                                  repr=False)
    wire: Dict[int, Dict[str, Any]] = field(default_factory=dict,
                                            repr=False)
    n_cycles_seen: int = field(default=0, repr=False)
    t_cycle_total: float = field(default=0.0, repr=False)
    t_data_total: float = field(default=0.0, repr=False)
    t_prep_total: float = field(default=0.0, repr=False)
    _chunks_seen: int = field(default=0, repr=False)

    def reset(self) -> None:
        """Clear every accumulator (the configuration stays), e.g. after
        a warm-up, so the report covers only the cycles after it."""
        self.pair_attempt = None
        self.pair_accept = None
        self.occupancy = None
        self.rt_phase = None
        self.round_trips = None
        self.phase_samples = []
        self.wire = {}
        self.n_cycles_seen = 0
        self.t_cycle_total = 0.0
        self.t_data_total = 0.0
        self.t_prep_total = 0.0
        self._chunks_seen = 0

    def note_cycles(self, *, cycles, dims, assignments, n_dims: int,
                    n_ctrl: int, pair_attempt=None, pair_accept=None,
                    t_cycle: float = 0.0, t_data: float = 0.0,
                    t_prep: float = 0.0) -> None:
        """Fold one chunk's fetched stats (K cycles) into the counters.
        ``assignments``: (K, R) post-cycle rows; ``cycles``: (K,) cycle
        indices (the sweep parity is (cycle // n_dims) % 2, as
        ``patterns.fused_cycle`` derives it); ``pair_attempt`` /
        ``pair_accept``: (K, W) rows, or None (counters off, or the matrix
        scheme).  The times are totals over the K cycles."""
        cycles = np.asarray(cycles).reshape(-1)
        dims = np.asarray(dims).reshape(-1)
        assignments = np.asarray(assignments)
        if assignments.ndim == 1:
            assignments = assignments[None, :]
        k = assignments.shape[0]
        self.occupancy = accumulate_occupancy(assignments, n_ctrl,
                                              self.occupancy)
        self.rt_phase, self.round_trips = round_trip_fold(
            assignments, n_ctrl, self.rt_phase, self.round_trips)
        if pair_attempt is not None:
            att = np.asarray(pair_attempt, np.float64)
            acc = np.asarray(pair_accept, np.float64)
            if att.ndim == 1:
                att, acc = att[None, :], acc[None, :]
            parity = (cycles // n_dims) % 2
            if self.pair_attempt is None:
                w = att.shape[-1]
                self.pair_attempt = np.zeros((n_dims, 2, w), np.float64)
                self.pair_accept = np.zeros((n_dims, 2, w), np.float64)
            np.add.at(self.pair_attempt, (dims, parity), att)
            np.add.at(self.pair_accept, (dims, parity), acc)
        self.n_cycles_seen += k
        self.t_cycle_total += t_cycle
        self.t_data_total += t_data
        self.t_prep_total += t_prep
        self._chunks_seen += 1

    def want_phase_sample(self) -> bool:
        e = self.phase_probe_every
        return bool(e) and (self._chunks_seen % e == 0)

    def note_phase_sample(self, cycle: int, times: Dict[str, float]) -> None:
        self.phase_samples.append({"cycle": int(cycle), **times})

    def note_wire_budget(self, chunk_cycles: int,
                         budget: Dict[str, Dict[str, int]]) -> None:
        """Record a sharded chunk's per-collective budget (one entry per
        chunk length)."""
        self.wire.setdefault(int(chunk_cycles),
                             {"per_chunk": budget, "invocations": 0})

    def note_wire_invocation(self, chunk_cycles: int) -> None:
        entry = self.wire.get(int(chunk_cycles))
        if entry is not None:
            entry["invocations"] += 1

    _ARRAY_FIELDS = ("pair_attempt", "pair_accept", "occupancy",
                     "rt_phase", "round_trips")

    def state_dict(self) -> Dict[str, Any]:
        """A JSON snapshot of every accumulator (not the configuration), in
        the JAX package's format: it rides the driver's checkpoint, so a
        resumed run's counters equal an uninterrupted run's, whichever
        package wrote the checkpoint."""
        out: Dict[str, Any] = {}
        for f in self._ARRAY_FIELDS:
            a = getattr(self, f)
            out[f] = (None if a is None
                      else {"dtype": str(a.dtype), "data": a.tolist()})
        out["phase_samples"] = list(self.phase_samples)
        out["wire"] = {str(k): v for k, v in self.wire.items()}
        out["n_cycles_seen"] = self.n_cycles_seen
        out["t_cycle_total"] = self.t_cycle_total
        out["t_data_total"] = self.t_data_total
        out["t_prep_total"] = self.t_prep_total
        out["chunks_seen"] = self._chunks_seen
        return out

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """Inverse of :meth:`state_dict` (the configuration untouched)."""
        for f in self._ARRAY_FIELDS:
            v = d.get(f)
            setattr(self, f, None if v is None
                    else np.asarray(v["data"], dtype=np.dtype(v["dtype"])))
        self.phase_samples = list(d.get("phase_samples", []))
        self.wire = {int(k): v for k, v in d.get("wire", {}).items()}
        self.n_cycles_seen = int(d.get("n_cycles_seen", 0))
        self.t_cycle_total = float(d.get("t_cycle_total", 0.0))
        self.t_data_total = float(d.get("t_data_total", 0.0))
        self.t_prep_total = float(d.get("t_prep_total", 0.0))
        self._chunks_seen = int(d.get("chunks_seen", 0))

    def phase_means(self) -> Dict[str, float]:
        """Mean seconds per phase over the probe samples."""
        if not self.phase_samples:
            return {}
        out: Dict[str, float] = {}
        for ph in PHASES:
            vals = [s[ph] for s in self.phase_samples if ph in s]
            if vals:
                out[ph] = float(np.mean(vals))
        return out

    def wire_totals(self) -> Dict[str, Dict[str, float]]:
        """Bytes per collective over the run: each chunk length's budget
        times its invocations (empty unless a sharded run noted some)."""
        totals: Dict[str, Dict[str, float]] = {}
        for entry in self.wire.values():
            inv = entry["invocations"]
            for op, b in entry["per_chunk"].items():
                t = totals.setdefault(op, {"count": 0.0, "bytes": 0.0})
                t["count"] += b["count"] * inv
                t["bytes"] += b["bytes"] * inv
        return totals


# -- phase probes (chunk-boundary timing brackets) ----------------------------


def make_phase_probes(driver, mesh=None) -> Dict[str, Any]:
    """The four phase probes of a driver's configuration.  Each runs one
    phase of a cycle on an ensemble, the code the chunk's cycle runs (the
    same propagate mode, exchange scheme and sweep gather), alone, so a
    timing bracket holds that phase only.  A probe takes the ensemble and
    returns fresh tensors: the driver key is split without writing back,
    and no operation writes to a tensor of the ensemble.  With ``mesh``
    the probes run the sharded phases on the rank's block, collectives
    included, so every rank of the mesh samples together."""
    from repro_torch import random as jr
    from repro_torch.core import failures as F
    from repro_torch.core import patterns
    from repro_torch.core.controls import ctrl_for_assignment

    engine, grid, cfg = driver.engine, driver.grid, driver.cfg
    execution = driver.execution
    md_steps = cfg.md_steps_per_cycle
    window_steps = max(int(md_steps * cfg.async_window), 1)
    policy = "relaunch" if cfg.relaunch_failed else "continue"
    has_features = driver.capabilities["replica_features"]
    n_dims = len(grid.dims)

    def _steps(ens):
        if cfg.pattern == "asynchronous":
            max_steps = 2 * window_steps
            n_steps = torch.clamp(torch.round(window_steps * ens.speed)
                                  .to(torch.int64), 1, max_steps)
        else:
            max_steps = md_steps
            n_steps = torch.full(ens.assignment.shape, md_steps,
                                 dtype=torch.int64,
                                 device=ens.assignment.device)
        return n_steps, max_steps

    def probe_propagate(ens):
        k_md = jr.split(ens.rng, 3)[0]
        n_steps, max_steps = _steps(ens)
        if mesh is not None:
            return patterns._propagate_sharded(engine, ens, grid, n_steps,
                                               k_md, execution, max_steps,
                                               mesh)
        return patterns._propagate(engine, ens, grid, n_steps, k_md,
                                   execution, max_steps)

    def probe_features(ens):
        if has_features:
            return engine.replica_features(ens.state)
        ctrl = ctrl_for_assignment(grid, ens.assignment,
                                   getattr(engine, "ctrl_keys", None))
        return engine.energy(ens.state, ctrl)

    def probe_exchange(ens):
        k_ex = jr.split(ens.rng, 3)[1]
        dim_index = torch.remainder(ens.cycle, n_dims)
        parity = torch.remainder(torch.div(ens.cycle, n_dims,
                                           rounding_mode="floor"), 2)
        features, fail, halo = patterns.exchange_inputs(
            engine, ens.state, mesh, cfg.exchange_comm,
            ens.assignment.shape[0])
        return patterns._exchange(engine, ens.state, grid, ens.assignment,
                                  dim_index, parity, k_ex,
                                  cfg.exchange_scheme, ready=ens.alive,
                                  features=features, fail=fail, mesh=halo)

    def probe_detect_recover(ens):
        return F.detect_recover(engine, ens, policy, ens.state,
                                relaunch_budget=cfg.relaunch_budget,
                                mesh=mesh)

    return {"propagate": probe_propagate, "features": probe_features,
            "exchange": probe_exchange,
            "detect_recover": probe_detect_recover}


def _timed(fn, ens, device: torch.device) -> float:
    """Seconds of one call of ``fn(ens)``: CUDA events around it on the
    card (the device time of its queued work, host launch gaps included),
    ``perf_counter`` on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(ens)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn(ens)
    return time.perf_counter() - t0


def sample_phases(probes: Dict[str, Any], ens,
                  warmed: set) -> Dict[str, float]:
    """Run each probe on ``ens``; seconds per phase.  A probe's first call
    is its warm-up (kernel builds, allocator growth) and a second call is
    the one timed; ``warmed`` records which probes have run (pass the same
    set across samples)."""
    device = ens.assignment.device
    out: Dict[str, float] = {}
    for name in PHASES:
        fn = probes[name]
        if name not in warmed:
            fn(ens)
            warmed.add(name)
        out[name] = _timed(fn, ens, device)
    return out
