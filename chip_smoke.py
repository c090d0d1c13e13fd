#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

The quickest proof that the port still starts on the GPU.  Phases, each
printed on its own lines:

  1. environment  card name and power limit, CUDA, nvcc, triton
  2. build        the four kernels from ``src/repro_torch/kernels/*/csrc``,
                  one ``nvcc`` per source, all started together
  3. kernels      the bonded and nonbonded kernels against their plain
                  PyTorch versions at N = 2881, R = 4 and R = 64, within
                  a stated tolerance
  4. timing       each of them and its plain version at the main path's
                  shape (R = 64, N = 2881): the kernel's device time from
                  CUDA-graph replays, its wrapper's host time beside it,
                  the plain version's synchronised wall time; the bound
                  worked out for the function from this run's data
  5. slice        the main path: T-REMD, 64 rungs, 2881 atoms,
                  ``run_fused(chunk_cycles=4)`` for 8 cycles, every chunk
                  under ``set_sync_debug_mode("error")``; each kernel must
                  have launched 8 cycles x 11 force evaluations = 88 times;
                  5b: where a cycle's time goes (each part timed alone, and
                  the device's busy share from a profiled chunk); then the
                  same run at a small size on the card and on the CPU (the
                  PyTorch oracles) must make the same exchange decisions
  6. invariance   R = 8, N = 2881, 4 cycles at chunk sizes 1 and 4:
                  identical assignment rows, bitwise equal positions
  7. kernels      the fused BAOAB kernel (bias off, bias on, salt on), the
                  bonded kernel's bias variant and the exchange-matrix
                  kernel against their plain versions at N = 2881, R = 4
                  and R = 384; then each timed at R = 384 as in phase 4
  8. TSU slice    the paper's grid, temperature x umbrella(phi) x
                  umbrella(psi) = 6 x 8 x 8 = 384 replicas at 2881 atoms,
                  ``force_path="fused"``, 10 MD steps per cycle,
                  ``run_fused(chunk_cycles=3)``: 6 cycles of the DEO
                  neighbor scheme (two round-robin sweeps of the three
                  dimensions), then 3 of the matrix (Gibbs) scheme.  The
                  fused kernel must launch cycles x 11 times, the per-pass
                  kernels never, the exchange matrix once per matrix cycle;
                  8b: where a fused TSU cycle's time goes
  9. TSU per-pass the same grid on ``force_path="pallas"`` for 3 cycles
                  (the bonded kernel's bias variant and the nonbonded
                  kernel, 33 launches each)
 10. invariance   the fused path at R = 8 (2 x 2 x 2 T x U x U), N = 2881,
                  3 cycles at chunk sizes 1 and 3: bitwise equal positions;
                  then a small fused matrix-scheme run on the card and on
                  the CPU must make the same decisions

Any failed check raises and the script exits non-zero.  The next to last
line is the kernels' JSON record, the last line the device record.
Without CUDA, or without the repository around it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
N_ATOMS = 2881            # the paper's solvated alanine dipeptide
R_MAIN = 64               # rungs of the main path's temperature ladder
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# Operations per term, counted from the kernels' source (one per add,
# multiply, divide, square root or transcendental).
BOND_OPS, ANGLE_OPS, TORSION_OPS = 21, 76, 116
SLOT_OPS = 6              # one signed 3-vector accumulate per slot
# The nonbonded bound counts what the function needs, not what the TPU
# body does: each unordered pair the exclusion mask keeps, once (forces
# are antisymmetric), in its cheapest form, with the per-atom constants
# hoisted (sigma/2, 2 sqrt(eps), sqrt(COULOMB) q) and a fused
# multiply-add counted as two operations, as the fp32 peak counts it:
#   displacement 3, r^2 5, mixing 3 (sum, two products), 1/r^2 and
#   1/r 2, (sigma^2/r^2)^3 4, LJ energy 3 + accumulate 1, LJ force
#   coefficient 4, Coulomb energy 1 + accumulate 1, its coefficient 1,
#   two force rows (LJ, elec) x 3 components x both atoms as FMAs 24.
PAIR_OPS = 52
# The TPU body (nonbonded_pair_rows) instead spends 52 operations on
# every ordered pair, the diagonal included; printed for comparison only.
TPU_BODY_PAIR_OPS = 52

# Tolerances of kernel vs plain version, as max |diff| / max |plain| for
# forces and relative error for energies.  Both compute the same
# formulas; they differ only in summation order (slot sums, per-thread
# pair sums vs tensor reductions, FMA contraction), which in float32 at
# N = 2881 leaves errors near 1e-6 of the largest force.
TOL_BONDED_FORCE, TOL_BONDED_ENERGY = 2e-5, 1e-5
TOL_NB_FORCE, TOL_NB_ENERGY = 1e-4, 1e-5
# The small end-to-end run: CUDA kernels vs the CPU oracles (the dense
# incidence and rowsum forms) after 4 cycles, Angstrom.
TOL_SMALL_POS = 1e-3

# The second slice: the paper's T x U x U grid.
TSU_DIMS = (("temperature", 6), ("umbrella", 8), ("umbrella", 8))
R_TSU = 384
# One fused iteration vs its plain version, as max |diff| / max |plain|:
# the force errors above (summation order, FMA contraction) reach the
# velocity through dt * AKMA / m, the positions through dt / 2 more.
TOL_FUSED_POS, TOL_FUSED_VEL = 1e-6, 1e-4
# The fused pass counts each kept pair once for its two force rows (the
# energy terms of PAIR_OPS dropped: 3 + 1 and 1 + 1), and per atom the
# salt-scaled sum (9) and the B-A-O-A-B update (27).
PAIR_FORCE_OPS = PAIR_OPS - 6
ATOM_UPDATE_OPS = 9 + 27
BIAS_OPS = 2 * 8          # two bias torques per replica: wrap + 4 products
# The exchange matrix per element: salt scale 2, elec term 2, two wraps
# 5 each, two bias terms 3 each, beta 1.
XMAT_OPS = 21


def reset(libs) -> None:
    """Every launch count to 0, just before a path is driven."""
    torch.cuda.synchronize()
    for lib in libs:
        lib.reset()


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def graph_ms(fn, calls: int = 20, reps: int = 9) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a
    CUDA graph, the graph replayed between two events (median of
    ``reps`` replays, divided by ``calls``).  No Python runs between the
    kernels of a replay, so the events see device time, not the host
    cost of the wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_ms(fn, n: int = 50) -> float:
    """Host time of one call of ``fn``: ``n`` calls issued back to back,
    timed on the host clock before the device catches up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e3


def median_ms(fn, n: int, warmup: int = 3) -> float:
    """Wall time of one call, host included: CUDA events around each of
    ``n`` synchronised calls, median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def environment() -> str:
    phase("1 environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"nvcc: {nvcc.splitlines()[-1]}")
    try:                       # a probe of the toolchain, reported as found
        import triton
        print(f"triton imports: {triton.__version__}")
    except ImportError as e:
        print(f"triton does not import: {e}")
    return smi


def build(libs) -> None:
    """One ``nvcc`` per source, all started together (each ``load``
    waits on its own compiler in a thread)."""
    phase("2 build")
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))
    for lib in libs:
        regs = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        took = ("cached" if lib.build_seconds is None
                else f"nvcc {lib.build_seconds:.1f} s")
        print(f"{lib.name}: {took} -> {lib.path.name}")
        for ln in regs:
            print(f"  {ln}")
    print(f"build seconds {time.perf_counter() - t0:.2f}")


def compare(engine, n_rep: int, tag: str):
    """Each kernel vs its plain version on one state; returns the max
    absolute force errors (bonded, nonbonded)."""
    from repro_torch import random as jr
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.lj_forces import ops as nb_ops
    pos = engine.init_state(jr.key(SEED, engine.device), n_rep)["pos"]
    f_k, e_k = chain_ops.chain_forces_batched(pos, engine._pack)
    f_p, e_p = chain_ops.ref.bonded_forces_sparse(pos, engine._pack.top,
                                                  engine._pack.slots)
    ef, ee = rel(f_k, f_p), rel(e_k, e_p)
    print(f"{tag} bonded: force {ef:.2e} (tol {TOL_BONDED_FORCE}), energy "
          f"{ee:.2e} (tol {TOL_BONDED_ENERGY})")
    check(ef <= TOL_BONDED_FORCE and ee <= TOL_BONDED_ENERGY,
          f"bonded kernel vs plain at R={n_rep}")
    out_k = nb_ops.nonbonded_batched(pos, engine._nb_pack)
    out_p = nb_ops.nonbonded_plain(pos, engine._nb_pack)
    errs = {n: rel(a, b) for n, a, b in zip(("f_lj", "f_el", "e_lj", "e_el"),
                                            out_k, out_p)}
    print(f"{tag} nonbonded: " + ", ".join(f"{k} {v:.2e}"
                                           for k, v in errs.items())
          + f" (tol forces {TOL_NB_FORCE}, energies {TOL_NB_ENERGY})")
    check(max(errs["f_lj"], errs["f_el"]) <= TOL_NB_FORCE
          and max(errs["e_lj"], errs["e_el"]) <= TOL_NB_ENERGY,
          f"nonbonded kernel vs plain at R={n_rep}")
    abs_nb = max(float((a - b).abs().max())
                 for a, b in zip(out_k[:2], out_p[:2]))
    return float((f_k - f_p).abs().max()), abs_nb, pos


def bounds(engine, n_rep: int):
    """(bound_ms, bound_by) of each kernel for this run's shapes: the
    larger of bytes over HBM bandwidth and operations over fp32 rate."""
    pk, nb = engine._pack, engine._nb_pack
    n = engine.system.n_atoms
    n_b, n_a, n_q = (pk.bonds.shape[0], pk.angles.shape[0],
                     pk.quads.shape[0])
    io = 2 * n_rep * n * 3 * 4                       # positions in, forces out
    tables = sum(t.numel() * t.element_size()
                 for t in (pk.bonds, pk.angles, pk.quads, pk.bond_par,
                           pk.ang_par, pk.quad_par, pk.slot_idx,
                           pk.slot_sign))
    b_bytes = io + tables + n_rep * 4
    b_ops = n_rep * (n_b * BOND_OPS + n_a * ANGLE_OPS + n_q * TORSION_OPS
                     + n * pk.slots.n_slots * SLOT_OPS + n_b + n_a + n_q)
    n_bytes = (n_rep * n * 3 * 4 + 3 * n * 4 + nb.mask_u8.numel()
               + 2 * n_rep * n * 3 * 4 + 2 * n_rep * 4)
    # the mask is symmetric with a zero diagonal: kept unordered pairs
    n_pairs = int(nb.mask_u8.to(torch.int64).sum()) // 2
    n_ops = n_rep * n_pairs * PAIR_OPS
    tpu_ops = n_rep * n * n * TPU_BODY_PAIR_OPS
    print(f"nonbonded: {n_pairs} unordered pairs kept of "
          f"{n * (n - 1) // 2}; the TPU body's count (every ordered pair) "
          f"{tpu_ops / 1e9:.3f} GFLOP -> "
          f"{tpu_ops / FP32_FLOPS_PER_S * 1e3:.4f} ms, not the bound")
    out = {}
    for name, nbytes, ops in (("chain_forces", b_bytes, b_ops),
                              ("nonbonded", n_bytes, n_ops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
        print(f"{name} bound: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP "
              f"-> {out[name][0]:.4f} ms ({out[name][1]})")
    return out


def timing(engine, pos, smi: str):
    """Kernel: device time per call from CUDA-graph replays; beside it
    the wrapper's host time per call.  Plain version: wall time of one
    synchronised call (its host cost is part of it)."""
    phase(f"4 timing at R={R_MAIN}, N={N_ATOMS}")
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.lj_forces import ops as nb_ops
    pk, nbp = engine._pack, engine._nb_pack
    kernels = {
        "chain_forces": (lambda: chain_ops.chain_forces_batched(pos, pk),
                         lambda: chain_ops.ref.bonded_forces_sparse(
                             pos, pk.top, pk.slots), 20),
        "nonbonded": (lambda: nb_ops.nonbonded_batched(pos, nbp),
                      lambda: nb_ops.nonbonded_plain(pos, nbp), 5),
    }
    res = {}
    for name, (kernel, plain, n_plain) in kernels.items():
        k_ms = graph_ms(kernel)
        h_ms = host_ms(kernel)
        p_ms = median_ms(plain, n_plain, 1)
        res[name] = (k_ms, p_ms)
        print(f"{name}: kernel {k_ms:.4f} ms device (graph replay), "
              f"wrapper host {h_ms:.4f} ms/call, plain {p_ms:.4f} ms "
              f"[{smi}]")
    return res


def run_slice(libs, smi: str):
    phase(f"5 slice: T-REMD {R_MAIN} rungs x {N_ATOMS} atoms, run_fused")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.core.ensemble import control_multiset_ok
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    cfg = RepExConfig(dimensions=(("temperature", R_MAIN),),
                      md_steps_per_cycle=10, n_cycles=8)
    engine = MDEngine(chain_molecule(N_ATOMS), device="cuda")
    driver = REMDDriver(engine, cfg, device="cuda")
    ens = driver.init(SEED)
    torch.cuda.synchronize()
    reset(libs)
    t0 = time.perf_counter()
    ens = driver.run_fused(ens, chunk_cycles=4)
    wall = time.perf_counter() - t0
    launches = {lib.name: lib.launches for lib in libs}
    variants = {lib.name: dict(lib.variants) for lib in libs}
    per_chunk = [h["t_step"] * 1e3 for h in driver.history[::4]]
    ms_cycle = per_chunk[-1]                  # steady state: the last chunk
    failed = sum(h["failed"] for h in driver.history)
    ok_perm = control_multiset_ok(ens)
    print(f"ms/cycle {ms_cycle:.2f} (last chunk of 4 cycles; per chunk "
          f"{[round(t, 2) for t in per_chunk]}, the first includes warm-up; "
          f"whole run {wall / cfg.n_cycles * 1e3:.2f}) [{smi}]")
    steps_per_s = R_MAIN * cfg.md_steps_per_cycle / ms_cycle * 1e3
    print(f"replica-steps/s {steps_per_s:.0f}")
    print(f"acceptance_ratios {driver.acceptance_ratios()}")
    print(f"control_multiset_ok {ok_perm}, failures {failed}")
    print(f"launches {launches}, by variant {variants} (want "
          f"{cfg.n_cycles * 11} of the bonded bias=False variant and of the "
          f"nonbonded kernel, 0 of the others)")
    check(launches == {"chain_forces": cfg.n_cycles * 11,
                       "nonbonded": cfg.n_cycles * 11,
                       "fused_baoab": 0, "exchange_matrix": 0}
          and variants["chain_forces"] == {"plain": cfg.n_cycles * 11},
          "each per-pass kernel launched 8 cycles x 11 evaluations")
    check(ok_perm, "assignment is a permutation")
    check(failed == 0, "no replica failed")
    pos = ens.state["pos"]
    check(tuple(pos.shape) == (R_MAIN, N_ATOMS, 3)
          and bool(torch.isfinite(pos).all())
          and bool(torch.isfinite(ens.state["vel"]).all()),
          "finite state of the expected shape")
    acc = driver.acceptance_ratios()["dim0"]
    check(0.0 < acc <= 1.0, "some exchanges accepted")
    return launches, ms_cycle, driver, ens


def breakdown(driver, ens, ms_cycle: float, smi: str) -> None:
    """Where a main-path cycle's time goes: each part timed alone with
    CUDA events (medians), then the device's busy share from a profiled
    chunk (kernel time over the unprofiled ms/cycle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.core import exchange as X
    from repro_torch.core import failures as F
    from repro_torch.core.controls import ctrl_for_assignment
    from repro_torch.md import integrators as I
    phase("5b where a cycle's time goes")
    eng, cfg = driver.engine, driver.cfg
    state, n_rep = ens.state, ens.assignment.shape[0]
    ctrl = ctrl_for_assignment(driver.grid, ens.assignment)
    keys = jr.split(ens.rng, n_rep)
    n_it = cfg.md_steps_per_cycle + 1          # force evaluations per cycle
    n_steps = torch.full((n_rep,), cfg.md_steps_per_cycle,
                         dtype=torch.int64, device="cuda")
    force = eng._analytic_force_fn(ctrl)
    noise = I.stacked_step_noise(keys, n_it, (N_ATOMS, 3))
    f = force(state["pos"])
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    parts = {
        "noise draw (threefry + erf_inv)": (lambda: I.stacked_step_noise(
            keys, n_it, (N_ATOMS, 3)), 1),
        "force evaluation (both kernels)": (lambda: force(state["pos"]),
                                            n_it),
        "BAOAB update": (lambda: I._baoab_apply(
            1, state["pos"], state["vel"], f, noise[1], eng.system.masses,
            ctrl["temperature"], n_steps, cfg.md_steps_per_cycle, eng.dt,
            eng.gamma), n_it),
        "exchange (feature pass + sweep)": (lambda: X.neighbor_exchange(
            eng, state, driver.grid, ens.assignment, zero, zero, keys[0],
            ens.alive), 1),
        "detect + recover": (lambda: F.detect_recover(
            eng, ens, "relaunch", state), 1),
    }
    total = 0.0
    for name, (fn, times) in parts.items():
        ms = median_ms(fn, 10)
        total += ms * times
        print(f"{name}: {ms:.3f} ms x {times} = {ms * times:.3f} ms/cycle")
    print(f"sum of parts {total:.2f} ms/cycle vs measured {ms_cycle:.2f} "
          f"[{smi}]")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.run_fused(ens, n_cycles=2, chunk_cycles=2)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / 2
    print(f"profiled chunk: device kernel time {busy:.2f} ms/cycle, busy "
          f"share of the measured ms/cycle {busy / ms_cycle:.3f}")
    calls = 2 * n_it
    # kernel names as the trace gives them, mangled or not
    for name, pattern in (
            ("chain_forces", r"(?<!non)bonded_(edges|gather|energy)_kernel"),
            ("nonbonded", r"nonbonded_(tile|energy)_kernel")):
        dev = sum(e.device_time_total for e in kernels
                  if re.search(pattern, e.name)) / 1e3
        print(f"profiled chunk: {name} kernels {dev / calls:.4f} ms device "
              f"per call ({calls} calls)")


def small_against_cpu():
    """The main path at a small size on the card (kernels) and on the CPU
    (the PyTorch oracles): the same exchange decisions."""
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    cfg = RepExConfig(dimensions=(("temperature", 8),),
                      md_steps_per_cycle=10, n_cycles=4)
    runs = {}
    for dev in ("cuda", "cpu"):
        driver = REMDDriver(MDEngine(chain_molecule(64), device=dev), cfg,
                            device=dev)
        ens = driver.run_fused(driver.init(SEED), chunk_cycles=2)
        runs[dev] = ([h["assignment"].tolist() for h in driver.history],
                     ens.state["pos"].cpu())
    same = runs["cuda"][0] == runs["cpu"][0]
    dpos = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
    print(f"small run (R=8, N=64, 4 cycles) cuda vs cpu: assignments "
          f"identical {same}, max |dpos| {dpos:.2e} A (tol {TOL_SMALL_POS})")
    check(same and dpos <= TOL_SMALL_POS, "cuda run agrees with the CPU run")


def invariance():
    phase(f"6 chunk-size invariance: R=8, N={N_ATOMS}, 4 cycles")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    cfg = RepExConfig(dimensions=(("temperature", 8),),
                      md_steps_per_cycle=10, n_cycles=4)
    engine = MDEngine(chain_molecule(N_ATOMS), device="cuda")
    out = {}
    for k in (1, 4):
        driver = REMDDriver(engine, cfg, device="cuda")
        ens = driver.run_fused(driver.init(SEED), chunk_cycles=k)
        out[k] = ([h["assignment"].tolist() for h in driver.history],
                  ens.state["pos"])
    same_rows = out[1][0] == out[4][0]
    same_pos = bool(torch.equal(out[1][1], out[4][1]))
    print(f"assignment rows identical {same_rows}, positions bitwise equal "
          f"{same_pos}")
    check(same_rows and same_pos, "decisions independent of chunk size")


def tsu_engine(path: str = "fused", n_atoms: int = N_ATOMS):
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    return MDEngine(chain_molecule(n_atoms), force_path=path, device="cuda")


def tsu_grid():
    from repro_torch.config import RepExConfig
    from repro_torch.core.controls import build_grid
    return build_grid(RepExConfig(dimensions=TSU_DIMS), "cuda")


def second_slice_inputs(engine, grid, n_rep: int):
    """Inputs of the second slice's kernels at the TSU grid's first
    ``n_rep`` controls: a state from ``init_state``, iteration 1's
    pre-scaled noise and step rows (trail and lead on), bias rows, a salt
    column, the feature rows and the ctrl rows."""
    from repro_torch import random as jr
    from repro_torch.core.controls import ctrl_for_assignment
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    from repro_torch.md import integrators as I
    from repro_torch.md import noise as NZ
    key = jr.key(SEED, "cuda")
    state = engine.init_state(key, n_rep)
    idx = torch.arange(n_rep, device="cuda")
    ctrl = ctrl_for_assignment(grid, idx)
    c1, noise_scale = I.baoab_scales(engine.system.masses,
                                     ctrl["temperature"], engine.dt,
                                     engine.gamma)
    nz = noise_scale * NZ.step_noise_unrolled(jr.split(key, n_rep), 1,
                                              (N_ATOMS, 3))
    n_steps = torch.full((n_rep,), 10, dtype=torch.int64, device="cuda")
    bias = chain_ops.pack_bias(ctrl["umbrella_center"], ctrl["umbrella_k"],
                               n_rep, "cuda")
    ones = torch.ones(n_rep, device="cuda")
    salt = torch.linspace(0.5, 1.0, n_rep, device="cuda")
    tail = (engine._pack, engine._nb_pack, engine.system.masses, c1,
            engine.dt)
    fused = {name: (state["pos"], state["vel"], nz,
                    fused_ops.step_par(1, n_steps, 10, col), b) + tail
             for name, col, b in (("bias off", ones, None),
                                  ("bias on", ones, bias),
                                  ("salt on", salt, None))}
    cvals = {k: v[:n_rep] for k, v in grid.values.items()}
    feats = engine.replica_features(state)
    return dict(state=state, ctrl=ctrl, bias=bias, fused=fused,
                feats=feats, cvals=cvals)


def compare_second(engine, grid, n_rep: int, tag: str):
    """The fused iteration (three variants), the bonded bias variant and
    the exchange matrix vs their plain versions; returns the max absolute
    errors and the inputs."""
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.exchange_matrix import ops as x_ops
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    d = second_slice_inputs(engine, grid, n_rep)
    errs = {}
    abs_fused = 0.0
    for name, args in d["fused"].items():
        got = fused_ops.fused_baoab_batched(*args)
        want = fused_ops.fused_iteration_plain(*args)
        ep, ev = rel(got[0], want[0]), rel(got[1], want[1])
        abs_fused = max(abs_fused, float((got[0] - want[0]).abs().max()),
                        float((got[1] - want[1]).abs().max()))
        print(f"{tag} fused iteration, {name}: pos {ep:.2e} (tol "
              f"{TOL_FUSED_POS}), vel {ev:.2e} (tol {TOL_FUSED_VEL})")
        check(ep <= TOL_FUSED_POS and ev <= TOL_FUSED_VEL
              and bool(torch.isfinite(got[1]).all()),
              f"fused kernel vs plain ({name}) at R={n_rep}")
    errs["fused_baoab"] = abs_fused
    pos = d["state"]["pos"]
    pk = engine._pack
    ctrl = d["ctrl"]
    f_k, e_k = chain_ops.chain_forces_batched(pos, pk, d["bias"])
    f_p, e_p = chain_ops.ref.bonded_forces_sparse(
        pos, pk.top, pk.slots, ctrl["umbrella_center"], ctrl["umbrella_k"])
    f_0, _ = chain_ops.ref.bonded_forces_sparse(pos, pk.top, pk.slots)
    ef, ee = rel(f_k, f_p), rel(e_k, e_p)
    print(f"{tag} bonded bias variant: force {ef:.2e} (tol "
          f"{TOL_BONDED_FORCE}), energy {ee:.2e} (tol {TOL_BONDED_ENERGY}); "
          f"the torque moves forces by {float((f_p - f_0).abs().max()):.3e}")
    check(ef <= TOL_BONDED_FORCE and ee <= TOL_BONDED_ENERGY,
          f"bonded bias kernel vs plain at R={n_rep}")
    errs["chain_forces_bias"] = float((f_k - f_p).abs().max())
    u_k = x_ops.exchange_matrix_batched(x_ops.pack_features(d["feats"]),
                                        x_ops.pack_ctrl(d["cvals"]))
    u_p = x_ops.ref.exchange_matrix(d["feats"], d["cvals"])
    errs["exchange_matrix"] = float((u_k - u_p).abs().max())
    print(f"{tag} exchange matrix {tuple(u_k.shape)}: bitwise equal "
          f"{torch.equal(u_k, u_p)} (tol: bitwise, built with -fmad=false)")
    check(torch.equal(u_k, u_p), f"exchange matrix kernel vs plain at "
                                 f"R={n_rep}")
    return errs, d


def timing_second(engine, d, smi: str):
    """Phase 4's timing for the second slice's kernels at R = 384."""
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.exchange_matrix import ops as x_ops
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    phase(f"7 timing at R={R_TSU}, N={N_ATOMS}")
    args = d["fused"]["bias on"]
    pos, pk, ctrl = d["state"]["pos"], engine._pack, d["ctrl"]
    featp, ctrlp = (x_ops.pack_features(d["feats"]),
                    x_ops.pack_ctrl(d["cvals"]))
    kernels = {
        "fused_baoab": (lambda: fused_ops.fused_baoab_batched(*args),
                        lambda: fused_ops.fused_iteration_plain(*args), 3),
        "chain_forces_bias": (
            lambda: chain_ops.chain_forces_batched(pos, pk, d["bias"]),
            lambda: chain_ops.ref.bonded_forces_sparse(
                pos, pk.top, pk.slots, ctrl["umbrella_center"],
                ctrl["umbrella_k"]), 10),
        "exchange_matrix": (
            lambda: x_ops.exchange_matrix_batched(featp, ctrlp),
            lambda: x_ops.ref.exchange_matrix(d["feats"], d["cvals"]), 20),
    }
    res = {}
    for name, (kernel, plain, n_plain) in kernels.items():
        k_ms = graph_ms(kernel, calls=5 if name == "fused_baoab" else 20)
        h_ms = host_ms(kernel, n=10 if name == "fused_baoab" else 50)
        p_ms = median_ms(plain, n_plain, 1)
        res[name] = (k_ms, p_ms)
        print(f"{name}: kernel {k_ms:.4f} ms device (graph replay), "
              f"wrapper host {h_ms:.4f} ms/call, plain {p_ms:.4f} ms "
              f"[{smi}]")
    return res


def bounds_second(engine, n_rep: int):
    """(bound_ms, bound_by) of the second slice's kernels at R = C =
    ``n_rep``, from this run's data, as in ``bounds``."""
    pk, nb = engine._pack, engine._nb_pack
    n = engine.system.n_atoms
    n_b, n_a, n_q = (pk.bonds.shape[0], pk.angles.shape[0],
                     pk.quads.shape[0])
    tables = sum(t.numel() * t.element_size()
                 for t in (pk.bonds, pk.angles, pk.quads, pk.bond_par,
                           pk.ang_par, pk.quad_par, pk.slot_idx,
                           pk.slot_sign))
    bonded_ops = (n_b * BOND_OPS + n_a * ANGLE_OPS + n_q * TORSION_OPS
                  + n * pk.slots.n_slots * SLOT_OPS)
    stack = n_rep * n * 3 * 4
    rows = n_rep * 8 * 4
    n_pairs = int(nb.mask_u8.to(torch.int64).sum()) // 2
    work = {
        # pos, vel, noise in; step and bias rows; tables, atom rows, mask,
        # masses; new pos and vel out
        "fused_baoab": (3 * stack + 2 * rows + tables + 4 * n * 4
                        + nb.mask_u8.numel() + 2 * stack,
                        n_rep * (n_pairs * PAIR_FORCE_OPS + bonded_ops
                                 + BIAS_OPS + n * ATOM_UPDATE_OPS)),
        "chain_forces_bias": (2 * stack + rows + tables + n_rep * 4,
                              n_rep * (bonded_ops + n_b + n_a + n_q
                                       + BIAS_OPS)),
        "exchange_matrix": ((4 * n_rep + 6 * n_rep + n_rep * n_rep) * 4,
                            n_rep * n_rep * XMAT_OPS),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
        print(f"{name} bound: {nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP "
              f"-> {out[name][0]:.5f} ms ({out[name][1]})")
    return out


def run_tsu(libs, smi: str):
    """The second slice: the 384-replica T x U x U grid on the fused path,
    6 neighbor cycles, then 3 matrix cycles, each run from ``init``."""
    phase(f"8 TSU slice: {TSU_DIMS} = {R_TSU} replicas x {N_ATOMS} atoms, "
          f"force_path='fused', run_fused(chunk_cycles=3)")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.core.ensemble import control_multiset_ok
    engine = tsu_engine("fused")
    out = {}
    for scheme, n_cycles in (("neighbor", 6), ("matrix", 3)):
        cfg = RepExConfig(dimensions=TSU_DIMS, md_steps_per_cycle=10,
                          n_cycles=n_cycles, exchange_scheme=scheme)
        driver = REMDDriver(engine, cfg, device="cuda")
        ens = driver.init(SEED)
        reset(libs)
        t0 = time.perf_counter()
        ens = driver.run_fused(ens, chunk_cycles=3)
        wall = time.perf_counter() - t0
        launches = {lib.name: lib.launches for lib in libs}
        want = {"chain_forces": 0, "nonbonded": 0,
                "fused_baoab": n_cycles * 11,
                "exchange_matrix": n_cycles if scheme == "matrix" else 0}
        per_chunk = [h["t_step"] * 1e3 for h in driver.history[::3]]
        ms_cycle = per_chunk[-1]
        failed = sum(h["failed"] for h in driver.history)
        acc = driver.acceptance_ratios()
        print(f"{scheme}: ms/cycle {ms_cycle:.2f} (last chunk of 3 cycles; "
              f"per chunk {[round(t, 2) for t in per_chunk]}; whole run "
              f"{wall / n_cycles * 1e3:.2f}) [{smi}]")
        print(f"{scheme}: replica-steps/s "
              f"{R_TSU * 10 / ms_cycle * 1e3:.0f}")
        print(f"{scheme}: acceptance by dimension {acc}")
        print(f"{scheme}: launches {launches} (want {want})")
        check(launches == want, f"{scheme}: fused kernel cycles x 11, no "
              f"per-pass kernel, exchange matrix once per matrix cycle")
        check(control_multiset_ok(ens), f"{scheme}: assignment is a "
                                        f"permutation")
        check(failed == 0, f"{scheme}: no replica failed")
        check(bool(torch.isfinite(ens.state["pos"]).all()
                   and torch.isfinite(ens.state["vel"]).all())
              and tuple(ens.state["pos"].shape) == (R_TSU, N_ATOMS, 3),
              f"{scheme}: finite state of the expected shape")
        check(sum(a for a, _ in driver.acceptance.values()) > 0,
              f"{scheme}: some exchanges accepted")
        out[scheme] = dict(ms=ms_cycle, launches=launches, driver=driver,
                           ens=ens)
    return out


def breakdown_tsu(runs, smi: str) -> None:
    """Where a fused TSU cycle's time goes: each part timed alone at
    R = 384 (CUDA-event medians) times its calls per cycle, then the busy
    share and the two kernels' device time from a profiled matrix cycle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.core import exchange as X
    from repro_torch.core import failures as F
    from repro_torch.core.controls import ctrl_for_assignment
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    from repro_torch.md import integrators as I
    from repro_torch.md import noise as NZ
    phase("8b where a fused TSU cycle's time goes")
    driver, ens = runs["matrix"]["driver"], runs["matrix"]["ens"]
    eng, grid = driver.engine, driver.grid
    state = ens.state
    ctrl = ctrl_for_assignment(grid, ens.assignment)
    keys = jr.split(ens.rng, R_TSU)
    n_steps = torch.full((R_TSU,), 10, dtype=torch.int64, device="cuda")
    c1, noise_scale = I.baoab_scales(eng.system.masses, ctrl["temperature"],
                                     eng.dt, eng.gamma)
    bias = chain_ops.pack_bias(ctrl["umbrella_center"], ctrl["umbrella_k"],
                               R_TSU, "cuda")
    ones = torch.ones(R_TSU, device="cuda")
    nz = noise_scale * NZ.step_noise_unrolled(keys, 1, (N_ATOMS, 3))
    st = fused_ops.step_par(1, n_steps, 10, ones)
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    parts = {
        "fused iteration (kernel)": (lambda: fused_ops.fused_baoab_batched(
            state["pos"], state["vel"], nz, st, bias, eng._pack,
            eng._nb_pack, eng.system.masses, c1, eng.dt), 11),
        "noise draw (step_noise_unrolled, scaled)": (
            lambda: noise_scale * NZ.step_noise_unrolled(keys, 1,
                                                         (N_ATOMS, 3)), 11),
        "step rows": (lambda: fused_ops.step_par(1, n_steps, 10, ones), 11),
        "feature pass (replica_features)": (
            lambda: eng.replica_features(state), 1),
        "neighbor exchange (features + DEO sweep)": (
            lambda: X.neighbor_exchange(eng, state, grid, ens.assignment,
                                        zero, zero, keys[0], ens.alive), 1),
        "matrix exchange (features + matrix + Gibbs sweep)": (
            lambda: X.matrix_exchange(eng, state, grid, ens.assignment,
                                      keys[0]), 1),
        "detect + recover": (lambda: F.detect_recover(
            eng, ens, "relaunch", state), 1),
    }
    times = {}
    for name, (fn, calls) in parts.items():
        ms = median_ms(fn, 5, 1)
        times[name] = ms * calls
        print(f"{name}: {ms:.3f} ms x {calls} = {ms * calls:.3f} ms/cycle")
    md = sum(times[k] for k in list(times)[:3])
    for scheme, ex in (("neighbor", "neighbor exchange (features + DEO "
                                    "sweep)"),
                       ("matrix", "matrix exchange (features + matrix + "
                                  "Gibbs sweep)")):
        total = md + times[ex] + times["detect + recover"]
        print(f"{scheme}: sum of parts {total:.2f} ms/cycle vs measured "
              f"{runs[scheme]['ms']:.2f} [{smi}]")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.run_fused(ens, n_cycles=1, chunk_cycles=1)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    ms = runs["matrix"]["ms"]
    print(f"profiled matrix cycle: device kernel time {busy:.2f} ms, busy "
          f"share of the measured ms/cycle {busy / ms:.3f}")
    for name, pattern, calls in (
            ("fused_baoab", r"fused_baoab_kernel", 11),
            ("exchange_matrix", r"exchange_matrix_kernel", 1)):
        dev = sum(e.device_time_total for e in kernels
                  if re.search(pattern, e.name)) / 1e3
        print(f"profiled matrix cycle: {name} {dev / calls:.4f} ms device "
              f"per call ({calls} calls)")


def run_tsu_pallas(libs, smi: str) -> float:
    """The TSU grid on the per-pass path: the bonded kernel's bias variant
    and the nonbonded kernel, 11 launches each per cycle."""
    phase(f"9 TSU on force_path='pallas': {R_TSU} replicas, 3 cycles")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.core.ensemble import control_multiset_ok
    cfg = RepExConfig(dimensions=TSU_DIMS, md_steps_per_cycle=10,
                      n_cycles=3)
    driver = REMDDriver(tsu_engine("pallas"), cfg, device="cuda")
    ens = driver.init(SEED)
    reset(libs)
    ens = driver.run_fused(ens, chunk_cycles=3)
    launches = {lib.name: lib.launches for lib in libs}
    variants = dict(libs[0].variants)
    ms_cycle = driver.history[-1]["t_step"] * 1e3
    print(f"pallas: ms/cycle {ms_cycle:.2f} (one chunk of 3 cycles) "
          f"[{smi}]")
    print(f"pallas: acceptance by dimension {driver.acceptance_ratios()}")
    print(f"pallas: launches {launches}, bonded variants {variants}")
    check(launches == {"chain_forces": 33, "nonbonded": 33,
                       "fused_baoab": 0, "exchange_matrix": 0}
          and variants == {"bias": 33},
          "per-pass TSU: bias variant and nonbonded 3 x 11, nothing else")
    check(control_multiset_ok(ens)
          and sum(h["failed"] for h in driver.history) == 0
          and bool(torch.isfinite(ens.state["pos"]).all()),
          "per-pass TSU: permutation, no failure, finite state")
    return ms_cycle, launches["chain_forces"]


def invariance_fused():
    phase(f"10 fused path: chunk-size invariance (R=8, N={N_ATOMS}) and "
          f"card vs CPU")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    dims = (("temperature", 2), ("umbrella", 2), ("umbrella", 2))
    cfg = RepExConfig(dimensions=dims, md_steps_per_cycle=10, n_cycles=3)
    engine = tsu_engine("fused")
    out = {}
    for k in (1, 3):
        driver = REMDDriver(engine, cfg, device="cuda")
        ens = driver.run_fused(driver.init(SEED), chunk_cycles=k)
        out[k] = ([h["assignment"].tolist() for h in driver.history],
                  ens.state["pos"])
    same_rows = out[1][0] == out[3][0]
    same_pos = bool(torch.equal(out[1][1], out[3][1]))
    print(f"assignment rows identical {same_rows}, positions bitwise equal "
          f"{same_pos}")
    check(same_rows and same_pos, "fused decisions independent of chunk "
                                  "size")
    cfg = RepExConfig(dimensions=dims, md_steps_per_cycle=10, n_cycles=4,
                      exchange_scheme="matrix")
    runs = {}
    for dev in ("cuda", "cpu"):
        driver = REMDDriver(MDEngine(chain_molecule(64), force_path="fused",
                                     device=dev), cfg, device=dev)
        ens = driver.run_fused(driver.init(SEED), chunk_cycles=2)
        runs[dev] = ([h["assignment"].tolist() for h in driver.history],
                     driver.acceptance_ratios(), ens.state["pos"].cpu())
    same = runs["cuda"][:2] == runs["cpu"][:2]
    dpos = float((runs["cuda"][2] - runs["cpu"][2]).abs().max())
    print(f"small fused matrix run (R=8, N=64, 4 cycles) cuda vs cpu: "
          f"decisions identical {same}, max |dpos| {dpos:.2e} A (tol "
          f"{TOL_SMALL_POS})")
    check(same and dpos <= TOL_SMALL_POS, "fused cuda run agrees with the "
                                          "CPU run")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.exchange_matrix import ops as x_ops
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    from repro_torch.kernels.lj_forces import ops as nb_ops
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = environment()
    libs = [chain_ops.LIBRARY, nb_ops.LIBRARY, fused_ops.LIBRARY,
            x_ops.LIBRARY]
    build(libs)

    phase(f"3 kernels vs plain versions at N={N_ATOMS}, R=4 and R={R_MAIN}")
    engine = MDEngine(chain_molecule(N_ATOMS), device="cuda")
    compare(engine, 4, "R=4")
    abs_b, abs_nb, pos = compare(engine, R_MAIN, f"R={R_MAIN}")
    times = timing(engine, pos, smi)
    bound = bounds(engine, R_MAIN)

    launches, ms_cycle, driver, ens = run_slice(libs, smi)
    breakdown(driver, ens, ms_cycle, smi)
    small_against_cpu()
    invariance()
    del driver, ens, pos

    phase(f"7 second-slice kernels vs plain versions at N={N_ATOMS}, R=4 "
          f"and R={R_TSU}")
    tsu = tsu_engine("fused")
    grid = tsu_grid()
    compare_second(tsu, grid, 4, "R=4")
    errs2, inputs = compare_second(tsu, grid, R_TSU, f"R={R_TSU}")
    times.update(timing_second(tsu, inputs, smi))
    bound.update(bounds_second(tsu, R_TSU))
    del inputs

    runs = run_tsu(libs, smi)
    breakdown_tsu(runs, smi)
    ms_pallas, bias_launches = run_tsu_pallas(libs, smi)
    print(f"TSU ms/cycle: fused neighbor {runs['neighbor']['ms']:.2f}, fused "
          f"matrix {runs['matrix']['ms']:.2f}, per-pass (pallas) neighbor "
          f"{ms_pallas:.2f} [{smi}]")
    invariance_fused()

    names = ("chain_forces", "chain_forces_bias", "nonbonded", "fused_baoab",
             "exchange_matrix")
    src_of = {
        "chain_forces": "src/repro_torch/kernels/chain_forces/csrc/"
                        "chain_forces.cu",
        "chain_forces_bias": "src/repro_torch/kernels/chain_forces/csrc/"
                             "chain_forces.cu",
        "nonbonded": "src/repro_torch/kernels/lj_forces/csrc/nonbonded.cu",
        "fused_baoab": "src/repro_torch/kernels/fused_propagate/csrc/"
                       "fused_baoab.cu",
        "exchange_matrix": "src/repro_torch/kernels/exchange_matrix/csrc/"
                           "exchange_matrix.cu"}
    replaces = {
        "chain_forces": "src/repro/kernels/chain_forces/kernel.py:190",
        "chain_forces_bias": "src/repro/kernels/chain_forces/kernel.py:190",
        "nonbonded": "src/repro/kernels/lj_forces/kernel.py:284",
        "fused_baoab": "src/repro/kernels/fused_propagate/kernel.py:80",
        "exchange_matrix": "src/repro/kernels/exchange_matrix/kernel.py:42"}
    counts = {"chain_forces": launches["chain_forces"],
              "nonbonded": launches["nonbonded"],
              "chain_forces_bias": bias_launches,
              "fused_baoab": sum(r["launches"]["fused_baoab"]
                                 for r in runs.values()),
              "exchange_matrix": runs["matrix"]["launches"]["exchange_matrix"]}
    errs = dict(errs2, chain_forces=abs_b, nonbonded=abs_nb)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src_of[name],
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bound[name][0],
         "bound_by": bound[name][1], "library_ms": None}
        for name in names]}
    print(f"total seconds {time.perf_counter() - t_start:.1f}")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
