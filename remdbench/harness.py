"""One run of one cell: set-up, the measured window, the traced window,
the per-layer readers and the reference's verdict.

A cell names a configuration (``configs/<config>.json``), a traffic mix
(``workloads/<traffic>.json``) and its limits (``limits/<cell>.json``).
Nothing here knows a configuration's keys; each block is handed on whole:

  system     to the reference's ``system_<kind>`` module, which builds it
             as host arrays and names them as the program's system class
             takes them (``program_fields``)
  program    the program's classes by dotted name: ``system`` (optional:
             an engine that takes none is built from ``md`` alone),
             ``engine``, ``config``, ``driver``, ``telemetry``
  md         keyword arguments of the engine
  exchange   keyword arguments of the run's configuration, the traffic's
             ``exchange`` block merged over it, with the seed
  driver     keyword arguments of the driver (optional)
  reference  the reference model's name and parameters (``checks``)

and the traffic's ``chunk_cycles`` is the cycles a chunk of
``run_fused``.  Set-up builds the system, hands it to the program and
makes the ensemble from the seed on the device; one chunk warms every
shape the cell uses, a second one times a chunk.  The window then runs as
many whole chunks as fill ``--seconds``, in three calls split around the
chunk that the reference checks, drawn from the seed.  With
``--trace 1`` an untraced stretch of the same length runs first, timed,
for a cycle's time as the window runs it; the window (at most
``TRACE_WINDOW_S``) runs under the profiler, and after it a few chunks
with the telemetry's phase probes on.
"""
from __future__ import annotations

import copy
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checks, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_WINDOW_S = 5.0      # the longest traced window
PROBE_CHUNKS = 3          # phase-probe samples after a traced window
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The cell's entry, resolved configuration, traffic, limits and
    metrics."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in manifest["workloads"] if w["name"] == name)
    entry = next(c for c in manifest["configs"]
                 if c["name"] == cell["config"])
    traffic = json.loads((BENCH / "workloads"
                          / f"{cell['traffic']}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return {
        "cell": cell,
        "config": resolve(json.loads((root / entry["file"]).read_text()),
                          traffic),
        "traffic": traffic,
        "limits": json.loads((BENCH / "limits" / f"{name}.json")
                             .read_text())["limits"],
        "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
        "per_layer": [m for m in manifest["per_layer"] if mine(m)],
    }


def resolve(config: Dict, traffic: Dict) -> Dict:
    """The configuration as a cell runs it: the traffic's ``exchange``
    block merged over the configuration's."""
    out = copy.deepcopy(config)
    out["exchange"] = dict(out["exchange"], **traffic.get("exchange", {}))
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _named(path: str):
    mod, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


def _tuples(v):
    """JSON lists as the tuples the program's configuration takes."""
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    if isinstance(v, dict):
        return {k: _tuples(x) for k, x in v.items()}
    return v


def _driver(config: Dict, sysm, sysmod, seed: int, device):
    """The program's driver of the configuration, every block forwarded
    whole (module docstring)."""
    prog = config["program"]
    args = []
    if "system" in prog:
        fields = {k: torch.as_tensor(v, device=device)
                  if isinstance(v, np.ndarray) else v
                  for k, v in sysmod.program_fields(sysm).items()}
        args.append(_named(prog["system"])(**fields))
    engine = _named(prog["engine"])(*args, device=device,
                                    **_tuples(config["md"]))
    cfg = _named(prog["config"])(seed=int(seed),
                                 **_tuples(config["exchange"]))
    tel = _named(prog["telemetry"])(enabled=False, exchange_counters=False,
                                    phase_probe_every=1)
    return _named(prog["driver"])(engine, cfg, telemetry=tel, device=device,
                                  **_tuples(config.get("driver", {})))


def _chunks(driver, ens, n_chunks: int, k: int):
    if n_chunks <= 0:
        return ens
    return driver.run_fused(ens, n_cycles=n_chunks * k, chunk_cycles=k)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"remdbench_metric_{name.replace('.', '_').replace('-', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _quantile90(vals: List[float]) -> float:
    if len(vals) < 2:
        return vals[0]
    return statistics.quantiles(vals, n=10, method="inclusive")[-1]


def _timed(driver, ens, n_chunks: int, k: int, device):
    _sync(device)
    t0 = time.perf_counter()
    ens = _chunks(driver, ens, n_chunks, k)
    _sync(device)
    return ens, time.perf_counter() - t0


def run_cell(spec: Dict, seed: int, seconds: float, trace_on: bool,
             device, t_start: Optional[float] = None) -> Dict:
    """One run; the result dict.  ``spec``: :func:`load_cell`'s dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    on_card = device.type == "cuda"
    k = int(traffic["chunk_cycles"])
    sysm, sysmod = checks.system(config)
    driver = _driver(config, sysm, sysmod, seed, device)
    n_rep = int(driver.grid.n_ctrl)

    ens = driver.init()
    init = (ens.state["pos"].clone(), ens.state["vel"].clone())
    ens = _chunks(driver, ens, 1, k)                    # builds, warms
    ens, t_chunk = _timed(driver, ens, 1, k, device)    # times a chunk
    window = min(seconds, TRACE_WINDOW_S) if trace_on else seconds
    n_chunks = max(1, round(window / t_chunk))
    j = int(np.random.default_rng(int(seed)).integers(n_chunks))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    untraced_s = None
    if trace_on:               # a cycle's time as the window runs it
        ens, untraced_s = _timed(driver, ens, n_chunks, k, device)
    h0 = len(driver.history)
    with trace.Window(trace_on) as tw:
        t0 = time.perf_counter()
        ens = _chunks(driver, ens, j, k)
        snap = {"pos": ens.state["pos"].clone(),
                "vel": ens.state["vel"].clone(),
                "assignment": ens.assignment.clone(),
                "rng": ens.rng.clone(), "cycle": ens.cycle.clone()}
        ens = _chunks(driver, ens, 1, k)
        post = {"pos": ens.state["pos"].clone(),
                "vel": ens.state["vel"].clone()}
        ens = _chunks(driver, ens, n_chunks - j - 1, k)
        _sync(device)
        t1 = time.perf_counter()
    window_s = t1 - t0
    n_cycles = n_chunks * k
    hist = driver.history[h0:h0 + n_cycles]
    chunk_ms = [k * (h["t_step"] + h["t_data"]) * 1e3 for h in hist[::k]]
    peak = float(torch.cuda.max_memory_allocated(device)) if on_card else 0.0

    probes: Dict[str, float] = {}
    if trace_on:
        driver.telemetry.enabled = True
        ens = _chunks(driver, ens, PROBE_CHUNKS, k)
        probes = driver.telemetry.phase_means()
        driver.telemetry.enabled = False
    tr = tw.trace
    rows = [(int(h["cycle"]), np.asarray(h["assignment"]),
             float(h["accept"])) for h in driver.history]
    failed = int(sum(h["failed"] for h in hist))
    lib_launches = _launches()
    del driver, ens
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    result: Dict = {"correct": False, "attempted": n_rep * n_cycles,
                    "failed": failed}
    host = {"cycle_ms": window_s / n_cycles * 1e3,
            "chunk_ms_p90": _quantile90(chunk_ms), "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    metrics: Dict[str, Dict] = {}
    if not trace_on:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": host[m["name"]] if on_card
                                  else None, "unit": m["unit"]}
    else:
        counts = importlib.import_module(
            f"remdbench.counts.{config['system']['kind']}")
        ctx = {"trace": tr, "window_s": window_s, "cycles": n_cycles,
               "cycle_s": untraced_s / n_cycles, "phase_s": probes,
               "counts": counts, "topology": counts.topology(sysm),
               "replicas_per_chip": n_rep // int(cell["chips"]),
               "config": config}
        for m in spec["per_layer"]:
            v = _reader(m["name"])(ctx) if on_card else None
            if v is not None or not on_card:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    if not on_card:
        for v in metrics.values():
            v["not_measured"] = "no device: a CPU run"
    result["metrics"] = metrics
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell["chips"]) if on_card else 1,
           "memory_peak_bytes": int(peak)}
    if trace_on and on_card:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = window_s
    result["device"] = dev
    if tr is not None and on_card and tr.device:
        result["breakdown"] = trace.breakdown(tr)
    result["launches"] = lib_launches
    if trace_on:               # what the profiler costs a cycle
        result["trace_cost"] = {
            "untraced_cycle_ms": untraced_s / n_cycles * 1e3,
            "traced_cycle_ms": window_s / n_cycles * 1e3}
    if not on_card:
        result["host_seconds"] = host

    t_check = time.perf_counter()
    ref = checks.reference(config, device, built=sysm)
    numbers = checks.judge(ref, seed, {
        "init": init, "rows": rows, "snap": snap, "post": post, "k": k,
        "md_steps": config["exchange"]["md_steps_per_cycle"]})
    limits = spec["limits"]
    result["correct"] = checks.verdict(numbers, limits)
    result["check_seconds"] = time.perf_counter() - t_check
    result["unjudged"] = {n: v for n, v in numbers.items()
                          if n not in limits}
    result["checks"] = {name: {"value": numbers[name],
                               "limit": limits[name]} for name in limits}
    return result


def _launches() -> Dict[str, int]:
    """Launches of each of the program's kernel libraries so far: the
    path a cell ran (printed, not judged)."""
    out = {}
    for modname, mod in list(sys.modules.items()):
        if not (modname.startswith("repro_torch.kernels.")
                and modname.endswith(".ops")) or mod is None:
            continue
        for attr in dir(mod):
            lib = getattr(mod, attr)
            if type(lib).__name__ == "KernelLibrary" and lib.launches:
                out[lib.name] = lib.launches
    return out
