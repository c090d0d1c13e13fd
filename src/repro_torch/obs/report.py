"""RunReport: the structured summary every driver path leaves.

The port of the JAX package's ``obs/report.py``: one dataclass,
JSON-serializable, built by :func:`build_report` from a driver (and its
optional :class:`~repro_torch.obs.telemetry.Telemetry`) at the end of
``run``, ``run_fused``, ``run_sharded`` and ``resume``, and stored as
``driver.last_report``.  Its schema is the JAX package's, version
``REPORT_VERSION``, so either package's :func:`validate_report` accepts
either's reports:

  version, path, engine, force_path, pattern, scheme, exchange_comm,
  n_replicas, n_dims, chunk_cycles,
  cycles      {total, counted}            total = driver history rows;
                                          counted = cycles the telemetry
                                          covers (since its last reset)
  phases      {samples, means{...}, t_cycle_mean, t_data_mean,
               t_prep_mean, eq1{T_MD, T_EX, T_data, T_RepEx_over,
               T_runtime_over}}           seconds; the Eq. (1) split
  exchange    {attempted, accepted, rate, per_dim{...}, pair_attempt,
               pair_accept, occupancy, round_trips}
                                          (D, 2, W) nested lists or null
                                          (matrix scheme, telemetry off)
  failures    {total, relaunched, reinit_peer, degraded}
  neighbor    {nb_overflow, nb_rebuilds}  end-of-run cumulative max
  wire        {per_chunk{K: {op: {count, bytes}}}, invocations{K: n},
               totals{op: ...}}           a sharded run's collectives per
                                          chunk length (the wire ledger);
                                          {} on the other paths
  meta        {backend ("cuda" or "cpu", the ensemble's device),
               n_devices (torch.cuda.device_count())}

Building a report reads the driver's host bookkeeping only; it touches
no device state.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np
import torch

# v2: the failures section carries the escalation counters (relaunched,
# reinit_peer, degraded)
REPORT_VERSION = 2

# the top-level keys every report carries
_REQUIRED = ("version", "path", "engine", "pattern", "scheme",
             "n_replicas", "n_dims", "cycles", "phases", "exchange",
             "failures", "neighbor", "wire", "meta")

EQ1_TERMS = ("T_MD", "T_EX", "T_data", "T_RepEx_over", "T_runtime_over")


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return _jsonable(x.tolist())
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


@dataclasses.dataclass
class RunReport:
    """Structured summary of one driver run (module docstring)."""
    version: int
    path: str                       # "run" | "fused" | "sharded"
    engine: str
    force_path: Optional[str]
    pattern: str
    scheme: str
    exchange_comm: str
    n_replicas: int
    n_dims: int
    chunk_cycles: Optional[int]
    cycles: Dict[str, int]
    phases: Dict[str, Any]
    exchange: Dict[str, Any]
    failures: Dict[str, Any]
    neighbor: Dict[str, float]
    wire: Dict[str, Any]
    meta: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return _jsonable(dataclasses.asdict(self))

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path


def validate_report(d: Dict[str, Any]) -> Dict[str, Any]:
    """Schema check of a report dict; raises ``ValueError`` naming every
    problem found."""
    problems = []
    for k in _REQUIRED:
        if k not in d:
            problems.append(f"missing key {k!r}")
    if not problems:
        if d["version"] != REPORT_VERSION:
            problems.append(f"version {d['version']} != {REPORT_VERSION}")
        if d["path"] not in ("run", "fused", "sharded"):
            problems.append(f"bad path {d['path']!r}")
        cyc = d["cycles"]
        if not (isinstance(cyc, dict) and "total" in cyc
                and "counted" in cyc):
            problems.append("cycles must carry total/counted")
        ex = d["exchange"]
        for k in ("attempted", "accepted", "rate", "per_dim"):
            if k not in ex:
                problems.append(f"exchange missing {k!r}")
        if not problems and ex["accepted"] > ex["attempted"]:
            problems.append("accepted > attempted")
        ph = d["phases"]
        if "eq1" in ph and ph["eq1"] is not None:
            for term in EQ1_TERMS:
                if term not in ph["eq1"]:
                    problems.append(f"phases.eq1 missing {term!r}")
        for k in ("nb_overflow", "nb_rebuilds"):
            if k not in d["neighbor"]:
                problems.append(f"neighbor missing {k!r}")
        for k in ("total", "relaunched", "reinit_peer", "degraded"):
            if k not in d["failures"]:
                problems.append(f"failures missing {k!r}")
    if problems:
        raise ValueError("invalid RunReport: " + "; ".join(problems))
    return d


def _eq1(phase_means: Dict[str, float], t_cycle: float, t_data: float,
         t_prep: float) -> Optional[Dict[str, float]]:
    """The phase brackets as the paper's Eq. (1) terms: T_MD = propagate;
    T_EX = features + exchange; T_data = the host fetch; T_RepEx_over =
    host task preparation; T_runtime_over = what of the measured cycle
    the brackets do not explain (launch and host overhead), clamped at 0
    because the probes and the cycle mean are different executions."""
    if not phase_means:
        return None
    t_md = phase_means.get("propagate", 0.0)
    t_ex = (phase_means.get("features", 0.0)
            + phase_means.get("exchange", 0.0))
    t_rec = phase_means.get("detect_recover", 0.0)
    t_over = max(t_cycle - (t_md + t_ex + t_rec), 0.0)
    return {"T_MD": t_md, "T_EX": t_ex, "T_data": t_data,
            "T_RepEx_over": t_prep, "T_runtime_over": t_over}


def build_report(driver, path: str,
                 chunk_cycles: Optional[int] = None) -> RunReport:
    """Assemble a :class:`RunReport` from a driver's bookkeeping, with or
    without a live telemetry accumulator: what only telemetry collects
    (pair rows, occupancy, round trips, phase brackets) is null or empty
    without it, the rest comes from ``driver.history`` and
    ``driver.acceptance``."""
    tel = getattr(driver, "telemetry", None)
    if tel is not None and not tel.enabled:
        tel = None
    hist = driver.history
    caps = driver.capabilities
    cfg = driver.cfg

    per_dim = {}
    att_tot = acc_tot = 0.0
    for k, (a, n) in driver.acceptance.items():
        per_dim[k] = {"attempted": n, "accepted": a,
                      "rate": a / max(n, 1.0)}
        att_tot += n
        acc_tot += a
    exchange: Dict[str, Any] = {
        "attempted": att_tot, "accepted": acc_tot,
        "rate": acc_tot / max(att_tot, 1.0), "per_dim": per_dim,
        "pair_attempt": None, "pair_accept": None,
        "occupancy": None, "round_trips": None,
    }
    counted = 0
    if tel is not None:
        counted = tel.n_cycles_seen
        if tel.pair_attempt is not None:
            exchange["pair_attempt"] = tel.pair_attempt
            exchange["pair_accept"] = tel.pair_accept
        if tel.occupancy is not None:
            exchange["occupancy"] = tel.occupancy
            exchange["round_trips"] = tel.round_trips

    if tel is not None and tel.n_cycles_seen:
        t_cycle = tel.t_cycle_total / tel.n_cycles_seen
        t_data = tel.t_data_total / tel.n_cycles_seen
        t_prep = tel.t_prep_total / tel.n_cycles_seen
    elif hist:
        t_cycle = float(np.mean([h["t_step"] for h in hist]))
        t_data = float(np.mean([h["t_data"] for h in hist]))
        t_prep = float(np.mean([h["t_prep"] for h in hist]))
    else:
        t_cycle = t_data = t_prep = 0.0
    means = tel.phase_means() if tel is not None else {}
    phases = {
        "samples": len(tel.phase_samples) if tel is not None else 0,
        "means": means,
        "t_cycle_mean": t_cycle, "t_data_mean": t_data,
        "t_prep_mean": t_prep,
        "eq1": _eq1(means, t_cycle, t_data, t_prep),
    }
    failures = {
        "total": int(sum(h["failed"] for h in hist)),
        "relaunched": int(sum(h.get("esc_relaunch", 0) for h in hist)),
        "reinit_peer": int(sum(h.get("esc_reinit", 0) for h in hist)),
        "degraded": int(sum(h.get("esc_dead", 0) for h in hist)),
    }
    neighbor = {
        "nb_overflow": float(max((h["nb_overflow"] for h in hist),
                                 default=0.0)),
        "nb_rebuilds": float(max((h["nb_rebuilds"] for h in hist),
                                 default=0.0)),
    }
    wire: Dict[str, Any] = {}
    if tel is not None and tel.wire:
        wire = {"per_chunk": {str(k): v["per_chunk"]
                              for k, v in tel.wire.items()},
                "invocations": {str(k): v["invocations"]
                                for k, v in tel.wire.items()},
                "totals": tel.wire_totals()}
    return RunReport(
        version=REPORT_VERSION,
        path=path,
        engine=type(driver.engine).__name__,
        force_path=caps.get("force_path"),
        pattern=cfg.pattern,
        scheme=cfg.exchange_scheme,
        exchange_comm=cfg.exchange_comm,
        n_replicas=driver.grid.n_ctrl,
        n_dims=len(driver.grid.dims),
        chunk_cycles=chunk_cycles,
        cycles={"total": len(hist), "counted": counted},
        phases=phases,
        exchange=exchange,
        failures=failures,
        neighbor=neighbor,
        wire=wire,
        meta={"backend": driver.device.type,
              "n_devices": torch.cuda.device_count()},
    )
