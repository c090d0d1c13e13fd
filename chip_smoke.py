#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

The quickest proof that the port still starts on the GPU.  Phases, each
printed on its own lines:

  1. environment  card name and power limit, CUDA, nvcc, triton
  2. build        the eight sources of ``src/repro_torch/kernels/*/csrc``,
                  one ``nvcc`` per source, all started together
  3. kernels      the bonded and nonbonded kernels against their plain
                  PyTorch versions at N = 2881, R = 4 and R = 64, within
                  a stated tolerance; then at N = 10,000, R = 1, where the
                  nonbonded kernel's partial force rows leave shared
                  memory for device memory (no ceiling on N)
  4. timing       each of them and its plain version at the main path's
                  shape (R = 64, N = 2881): the kernel's device time from
                  CUDA-graph replays, its wrapper's host time beside it,
                  the plain version's synchronised wall time; the bound
                  worked out for the function from this run's data; the
                  nonbonded kernel beside its time before the each-pair-
                  once design (BEFORE_MS), and at N = 10,000, R = 1
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
                  and R = 384; then each timed at R = 384 as in phase 4,
                  the fused kernel beside its time before the Newton's
                  third law design (BEFORE_MS) and its bound
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
 11. kernels      the third slice, the sparse neighbor-list path: on a real
                  list (``init_state`` and 10 MD steps) at R = 4 and 384,
                  N = 2881, the sparse nonbonded kernel (with and without
                  salt) against its plain version within a stated
                  tolerance, and the device-gated list build against the
                  plain build bitwise, with its flag 0, 1 and a per-replica
                  row, and with a k_max that drops pairs
 12. timing       both at R = 384 as in phase 4, the build in both flag
                  states, with the bounds of this run's list
 13. TSU sparse   the grid with ``nonbonded="sparse", bonded="sparse"``:
                  on ``force_path="fused"`` 6 neighbor and 3 matrix cycles,
                  on ``"pallas"`` 3 cycles.  Per cycle the bonded bias
                  variant and the build launch 11 times, the sparse kernel
                  11 + 1 (the feature pass), the dense and fused kernels
                  never; the build must have rebuilt the list inside a
                  chunk and dropped no pair; 13b: where a sparse fused
                  cycle's time goes
 14. invariance   the sparse fused path at R = 8, N = 2881, across a
                  rebuild: bitwise equal state for chunk sizes 1 and 3;
                  then a small sparse run on the card and on the CPU must
                  make the same decisions (margins printed if not)
 15. kernels      the fourth slice, ``LJEngine``'s fluid at Rahman's liquid
                  argon (864 atoms, box 34.8 A): the energy and forces
                  kernels against their plain versions at R = 4 and 64, on
                  ``init_state`` positions and after 10 MD steps; the
                  gradient of ``LJEnergy`` bitwise minus the forces kernel;
                  the single-configuration (R = 1) entry points; the same
                  at R = 1 and argon's density for N = 4,000 and N =
                  17,500 (no ceiling on N: the forces kernel's partial
                  rows live in device memory)
 16. timing       both at R = 64 as in phase 4, with their bounds, the
                  forces kernel beside its time before the each-pair-once
                  design (BEFORE_MS)
 17. LJ slice     64 rungs (94.4-150 K) x 864 atoms: ``run_fused(
                  chunk_cycles=4)``, 8 DEO cycles then 3 matrix cycles,
                  then 4 cycles of the per-cycle ``run`` from the same
                  seed, whose rows must equal the first 4 ``run_fused``
                  rows; per cycle 11 forces and 1 energy launch, nothing
                  else; no failure, permutation rows, positions in the box;
                  17b: where an LJ cycle's time goes; the HarmonicEngine
                  driver-overhead probe (64 rungs, 1 MD step) on
                  ``run_fused`` and on ``run``
 18. invariance   LJ at R = 8, N = 864, 4 cycles at chunk sizes 1 and 4:
                  bitwise equal state; then the small default LJEngine
                  (64 atoms, R = 8) on the card and on the CPU must make
                  the same decisions (margins printed if not)
 19. kernel       the fifth slice, LM serving: the flash attention kernel
                  against its plain version on 217 cases (float32 and
                  bfloat16; causal, non-causal, causal with a window of
                  64; 1, 2, 4 and 8 query heads per kv head; S = T = 16,
                  100, 2048; D = 16, 64, 128) and at OLMo-1B's prefill
                  shape (4, 2048, 16, 128) in bfloat16, then 32 softcap
                  cases (c = 30, scores scaled up so the cap bites; float32
                  and bfloat16; causal and windowed); the launches by
                  variant ("bf16_tc" on the tensor cores, "f32")
 20. timing       the kernel at that shape as in phase 4, with PyTorch's
                  ``scaled_dot_product_attention`` on the same tensors as
                  the yardstick call (and the share of phase 19's
                  allowance its output uses, printed only), the bound and
                  the kernel's time before the tensor-core design
 21. serve        ``repro_torch.launch.serve.main`` on OLMo-1B at full
                  width (seeded weights): 4 prompts of 2048 tokens, 32
                  greedy tokens; init, prefill and decode times, peak
                  memory; exactly 16 flash launches (one per layer of the
                  prefill, none in decode); a second run from the same
                  weights bitwise equal; prefill(2048) + one decode step
                  against prefill(2049); 21b: where a prefill's time goes
 22. card vs CPU  the olmo and phi3 smoke configs at float32 dtypes served
                  on the card and on the CPU: identical tokens

Any failed check raises and the script exits non-zero.  The next to last
line is the kernels' JSON record, the last line the device record.
Without CUDA, or without the repository around it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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

# The third slice: the sparse neighbor-list path (nonbonded="sparse",
# bonded="sparse") on the same grid.  The sparse kernel vs its plain version
# as the nonbonded kernel (the same slot formulas; summation order and FMA
# contraction differ); the neighbor-list build bitwise (r2 unfused on both
# sides, integer compaction).
TOL_SPARSE_FORCE, TOL_SPARSE_ENERGY = 1e-4, 1e-5
# The distance test of one pair: displacement 3, r^2 5, compare 1.
DIST_TEST_OPS = 9
K_LOW = 6                 # a k_max below the true counts: dropped > 0

# The fourth slice: LJEngine's fluid at Rahman's liquid argon (A. Rahman,
# Phys. Rev. 136, A405, 1964): 864 atoms in a cubic box of 10.229 sigma =
# 34.8 A; the T-REMD 64 ladder's 64 rungs from his 94.4 K to 150 K (about
# argon's critical temperature).
LJ_ATOMS, LJ_BOX = 864, 34.8
LJ_LADDER = dict(t_min=94.4, t_max=150.0)
# Kernel vs plain version as for the nonbonded kernel: the same pair
# formulas, the kernel summing each atom's row in ascending j and the
# energy per block then block by block, PyTorch by its own reductions;
# FMA contraction in the kernel.
TOL_LJ_FORCE, TOL_LJ_ENERGY = 1e-4, 1e-5
# Operations per unordered pair of the LJ fluid in its cheapest form,
# counted as PAIR_OPS is (an FMA as two): displacement 3; the minimum
# image 3 x (multiply by 1/box, rint, FMA) = 12; r^2 5; 1/r^2 1;
# sigma^2/r^2 1 and its cube 2; the force coefficient 24 eps (2 s6 - 1) s6
# / r^2 5; both atoms' force rows as FMAs 12.  The energy keeps the first
# six and adds 4 eps s6 (s6 - 1) 3 and its accumulation 1.
LJ_FORCE_PAIR_OPS = 3 + 12 + 5 + 1 + 3 + 5 + 12
LJ_ENERGY_PAIR_OPS = 3 + 12 + 5 + 1 + 3 + 3 + 1


# The fifth slice: LM serving (prefill + greedy decode) of OLMo-1B
# (arXiv:2402.00838) at full width on the package's seeded weights:
# 4 prompts of 2048 tokens, 32 new tokens.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_TOKENS = "olmo_1b", 4, 2048, 32
# The flash attention kernel against its plain version, per element:
# |got - plain| <= RTOL_FA * |plain| + TOL_FA_F32 * max |plain|.  Both
# sides sum float32 FMAs in another order (the online softmax's
# rescaling, tile sums): the absolute part.  In bfloat16 each side then
# rounds its float32 value once, so two outputs may sit one bf16 step
# apart, and a step is at most 2^-7 of the value: the relative part.  A
# global bound (max |diff| / max |plain|) would let the late causal rows,
# whose outputs average many keys and are ~1/100 of the first rows', be
# wrong by their own size.
TOL_FA_F32 = 5e-5
RTOL_FA = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
# prefill(S) + one decode step against prefill(S + 1), of max |logit|:
# the kernel on bf16 k, v against the plain decode attention on the bf16
# cache.  The seeded OLMo-1B turns a rounding difference into a different
# argmax key: its (d, h, hd) projections wq, wk draw with fan-in
# shape[-2] = n_heads = 16 (``params._std_for``, as the JAX package), std
# 0.25, so on unit-variance normed inputs q and k elements have std ~11
# and the scores std ~128 (printed by phase 21): each softmax row is near
# one-hot.  A difference grows about tenfold every two layers (measured
# on the card: float32 2e-5 at 2 layers, 2e-4 to 6e-3 at 4, 0.6-0.9 at
# 16, the plain attention as much as the kernel), so the check holds the
# full-width model cut to its first CONSIST_LAYERS layers; the 16-layer
# figure is printed.  Phase 19's random inputs, not these near-one-hot
# rows, are the test of the kernel's arithmetic.
TOL_LM_CONSIST = 2e-2
CONSIST_LAYERS = 2
# The smoke configs at float32 dtypes, card (kernel) vs CPU (plain), of
# max |logit|: the same float32 formulas, summed in another order.
TOL_LM_CPU = 1e-4
# The softcap of phase 19's added cases, and the factor on q that takes
# the scores (std ~1 on unit normals) to where the cap bites.
FA_SOFTCAP, FA_SOFTCAP_Q = 30.0, 20.0
# Kernel times before the current designs, at the same shapes: kernel 3
# (fused BAOAB, R = 384, N = 2881; every ordered pair, divisions),
# kernel 8 (flash attention, OLMo-1B prefill shape, bf16 on the CUDA
# cores), kernel 2 (nonbonded, R = 64, N = 2881) and kernel 6 (LJ fluid
# forces, R = 64, N = 864), the last two with every ordered pair and
# divisions, measured by this script on an NVIDIA H100 80GB HBM3 at
# 700 W as PERF.md section 6 records them; printed beside this run's
# times.
BEFORE_MS = {"fused_baoab": 9.3263, "flash_attention": 5.3706,
             "nonbonded": 2.1584, "lj_forces": 0.2866}
# The "no ceiling" sizes, at R = 1: N where the nonbonded kernel's partial
# force rows no longer fit in shared memory; two fluids far above the main
# path's 864 atoms.
N_NB_BIG = 10000
LJ_BIG = (4000, 17500)
# The H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the
# attention's products take bf16 operands.
BF16_TC_FLOPS_PER_S = 989e12

def reset(libs) -> None:
    """Every launch count to 0, just before a path is driven."""
    torch.cuda.synchronize()
    for lib in libs:
        lib.reset()


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name}  [{time.perf_counter() - _T0:.1f} s]", flush=True)


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
                if "registers" in ln or "spill" in ln
                or "warning" in ln.lower() or "Performance" in ln]
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
    # positions, atom rows, the pack's mask bits and tile flags and the
    # schedule table in; two force stacks and two energies out
    n_t = nb.tile_kept.shape[0]
    n_bytes = (n_rep * n * 3 * 4 + 3 * n * 4 + nb.mask_bits.numel() * 4
               + nb.tile_kept.numel() + n_t * n_t * 4
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


def no_ceiling_nonbonded(smi: str) -> None:
    """The nonbonded kernel at N = N_NB_BIG, R = 1, where its partial
    force rows live in device memory (variant "rows_l2"): against its
    plain version with phase 3's tolerances, then its device time."""
    from repro_torch.kernels.lj_forces import ops as nb_ops
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    engine = MDEngine(chain_molecule(N_NB_BIG), device="cuda")
    v0 = nb_ops.LIBRARY.variants.get("rows_l2", 0)
    _, _, pos = compare(engine, 1, f"N={N_NB_BIG} R=1")
    check(nb_ops.LIBRARY.variants.get("rows_l2", 0) == v0 + 1,
          f"N={N_NB_BIG}: the partial rows in device memory")
    k_ms = graph_ms(lambda: nb_ops.nonbonded_batched(pos, engine._nb_pack),
                    calls=5)
    print(f"nonbonded at N={N_NB_BIG}, R=1 (partial rows in device "
          f"memory): kernel {k_ms:.4f} ms device (graph replay) [{smi}]")


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
    want = dict.fromkeys(launches, 0)
    want.update(chain_forces=cfg.n_cycles * 11, nonbonded=cfg.n_cycles * 11)
    check(launches == want
          and variants["chain_forces"] == {"plain": cfg.n_cycles * 11}
          and variants["nonbonded"] == {"rows_shared": cfg.n_cycles * 11},
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
            ("nonbonded", r"nonbonded_(pairs|combine)_kernel")):
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


def before_and_bound(name: str, k_ms: float, bound) -> None:
    """A redesigned kernel's time beside its time before and its bound."""
    print(f"{name}: {k_ms:.4f} ms now, {BEFORE_MS[name]:.4f} ms before "
          f"(PERF.md), bound {bound[name][0]:.5f} ms: "
          f"{BEFORE_MS[name] / k_ms:.2f}x faster, {k_ms / bound[name][0]:.2f}"
          f"x the bound")


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
        # pos, vel, noise in; step and bias rows; tables, atom rows, the
        # mask (as the pack's bits and per-tile flags), masses; new pos and
        # vel out
        "fused_baoab": (3 * stack + 2 * rows + tables + 4 * n * 4
                        + nb.mask_bits.numel() * 4 + nb.tile_kept.numel()
                        + 2 * stack,
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
                "exchange_matrix": n_cycles if scheme == "matrix" else 0,
                "nonbonded_sparse": 0, "nlist_build": 0, "lj_fluid": 0,
                "flash_attention": 0}
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
                       "fused_baoab": 0, "exchange_matrix": 0,
                       "nonbonded_sparse": 0, "nlist_build": 0,
                       "lj_fluid": 0, "flash_attention": 0}
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


def sparse_engine(path: str = "fused", n_atoms: int = N_ATOMS, **kw):
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    return MDEngine(chain_molecule(n_atoms), force_path=path,
                    nonbonded="sparse", bonded="sparse", device="cuda", **kw)


def sparse_state(engine, grid, n_rep: int):
    """A real list at the TSU grid's first ``n_rep`` controls:
    ``init_state``, then one propagate of 10 MD steps through the sparse
    path (which keeps the list fresh), so the list holds slots past the
    cutoff and padded slots."""
    from repro_torch import random as jr
    from repro_torch.core.controls import ctrl_for_assignment
    key = jr.key(SEED, "cuda")
    state = engine.init_state(key, n_rep)
    ctrl = ctrl_for_assignment(grid, torch.arange(n_rep, device="cuda"))
    n_steps = torch.full((n_rep,), 10, dtype=torch.int64, device="cuda")
    return engine.propagate(state, ctrl, n_steps, jr.split(key, n_rep),
                            max_steps=10)


def sparse_plain(pos, pk, idx, valid, cutoff: float):
    """The sparse kernel's plain version: the oracle's slot sums on the
    same list (eps as sqrt(eps_i eps_j), a rounding from the kernel's
    sqrt(eps_i) sqrt(eps_j))."""
    from repro_torch.kernels.lj_forces import ref
    return ref.nonbonded_sparse(pos, pk.lj_sigma, pk.lj_eps, pk.charges, idx,
                                valid, cutoff)


def slot_census(engine, state) -> dict:
    """Slots of the list: valid ones, those within the cutoff, padding."""
    pos, nl = state["pos"], state["nlist"]
    r, n, k = nl["idx"].shape
    j = nl["idx"].clamp(max=n - 1).to(torch.int64).reshape(r, -1)
    pj = torch.stack([torch.gather(pos[..., c], 1, j).reshape(r, n, k)
                      for c in range(3)], dim=-1)
    r2 = ((pos[:, :, None, :] - pj) ** 2).sum(-1)
    valid = nl["valid"] > 0
    within = valid & (r2 <= engine.cutoff ** 2)
    return {"slots": valid.numel(), "valid": int(valid.sum()),
            "within": int(within.sum()),
            "padding": int(valid.numel() - valid.sum())}


def compare_third(engine, grid, n_rep: int, tag: str):
    """The sparse kernel (with and without salt) and the neighbor-list
    build (both flag states, a per-replica flag row, and a k_max low
    enough to drop pairs) against their plain versions on a real list;
    returns the max absolute errors, the state and its slot census."""
    from repro_torch.kernels.lj_forces import ops as nb_ops
    from repro_torch.kernels.nlist_build import ops as nl_ops
    state = sparse_state(engine, grid, n_rep)
    census = slot_census(engine, state)
    print(f"{tag} list (K={engine.k_max}): {census}; rebuilds in the 10 "
          f"steps {int(state['nlist']['rebuilds'].max())}")
    check(census["valid"] > census["within"] > 0 and census["padding"] > 0,
          "the list holds slots past the cutoff and padded slots")
    pos, nl, pk = state["pos"], state["nlist"], engine._nb_pack
    args = (pos, pk, nl["idx"], nl["valid"], engine.cutoff)
    got = nb_ops.nonbonded_sparse_batched(*args)
    want = sparse_plain(*args)
    errs = {name: rel(a, b) for name, a, b in
            zip(("f_lj", "f_el", "e_lj", "e_el"), got, want)}
    salt = torch.linspace(0.5, 1.0, n_rep, device="cuda")
    errs["f salt"] = rel(nb_ops.nonbonded_force_sparse(*args, salt),
                         want[0] + salt[:, None, None] * want[1])
    print(f"{tag} sparse kernel: " + ", ".join(f"{k} {v:.2e}"
                                               for k, v in errs.items())
          + f" (tol forces {TOL_SPARSE_FORCE}, energies "
            f"{TOL_SPARSE_ENERGY})")
    check(max(errs["f_lj"], errs["f_el"], errs["f salt"]) <= TOL_SPARSE_FORCE
          and max(errs["e_lj"], errs["e_el"]) <= TOL_SPARSE_ENERGY
          and all(bool(torch.isfinite(t).all()) for t in got),
          f"sparse kernel vs plain at R={n_rep}")
    out = {"nonbonded_sparse": max(float((a - b).abs().max())
                                   for a, b in zip(got[:2], want[:2]))}
    old = (nl["idx"], nl["valid"])
    flags = {"flag 0": torch.zeros(1, dtype=torch.int32, device="cuda"),
             "flag 1": torch.ones(1, dtype=torch.int32, device="cuda"),
             "flag row": (torch.arange(n_rep, device="cuda") % 2).to(
                 torch.int32)}
    build_err = 0
    for name, flag in flags.items():
        got_b = nl_ops.nlist_build_batched(pos, flag, old, pk.mask_u8,
                                           engine.r_list, engine.k_max)
        want_b = nl_ops.build_gated_plain(pos, flag, old, pk.nb_mask,
                                          engine.r_list, engine.k_max)
        same = all(torch.equal(a, b) for a, b in zip(got_b, want_b))
        build_err = max([build_err] + [int((a - b).abs().max())
                                       for a, b in zip(got_b, want_b)])
        print(f"{tag} build, {name}: bitwise equal {same}, dropped "
              f"{int(got_b[2].sum())}")
        check(same, f"build kernel vs plain ({name}) at R={n_rep}")
        if name == "flag 0":
            check(torch.equal(got_b[0], old[0])
                  and torch.equal(got_b[1], old[1])
                  and int(got_b[2].abs().sum()) == 0,
                  "flag 0 leaves the list unchanged")
    got_b = nl_ops.nlist_build_batched(pos, None, None, pk.mask_u8,
                                       engine.r_list, K_LOW)
    want_b = nl_ops.build_gated_plain(pos, None, None, pk.nb_mask,
                                      engine.r_list, K_LOW)
    same = all(torch.equal(a, b) for a, b in zip(got_b, want_b))
    print(f"{tag} build with k_max={K_LOW}: bitwise equal {same}, dropped "
          f"{int(got_b[2].sum())} pairs")
    check(same and int(got_b[2].min()) > 0,
          f"build kernel vs plain with dropped pairs at R={n_rep}")
    out["nlist_build"] = float(build_err)
    return out, state, census


def timing_third(engine, state, smi: str):
    """Phase 4's timing for the sparse kernel and the build kernel (both
    flag states) at R = 384."""
    from repro_torch.kernels.lj_forces import ops as nb_ops
    from repro_torch.kernels.nlist_build import ops as nl_ops
    phase(f"12 timing at R={R_TSU}, N={N_ATOMS}")
    pos, nl, pk = state["pos"], state["nlist"], engine._nb_pack
    args = (pos, pk, nl["idx"], nl["valid"], engine.cutoff)
    old = (nl["idx"], nl["valid"])
    on = torch.ones(1, dtype=torch.int32, device="cuda")
    off = torch.zeros(1, dtype=torch.int32, device="cuda")
    b = (engine.r_list, engine.k_max)
    kernels = {
        "nonbonded_sparse": (
            lambda: nb_ops.nonbonded_sparse_batched(*args),
            lambda: sparse_plain(*args), 10),
        "nlist_build": (
            lambda: nl_ops.nlist_build_batched(pos, on, old, pk.mask_u8, *b),
            lambda: nl_ops.build_gated_plain(pos, on, old, pk.nb_mask, *b),
            3),
        "nlist_build (flag 0)": (
            lambda: nl_ops.nlist_build_batched(pos, off, old, pk.mask_u8,
                                               *b),
            lambda: nl_ops.build_gated_plain(pos, off, old, pk.nb_mask, *b),
            3),
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


def bounds_third(engine, n_rep: int, census: dict):
    """(bound_ms, bound_by) of the sparse kernel and the build kernel at
    this run's list: the sparse pass needs each unordered pair within the
    cutoff once (PAIR_OPS) and a distance test of each listed pair past
    it; the build a distance test of each unexcluded unordered pair; the
    build with flag 0 only reads and writes the list."""
    nb = engine._nb_pack
    n, k = engine.system.n_atoms, engine.k_max
    table = n_rep * n * k * (4 + 4)                 # idx int32 + valid f32
    stack = n_rep * n * 3 * 4
    n_pairs = int(nb.mask_u8.to(torch.int64).sum()) // 2
    work = {
        # pos, atom rows and list in; both force rows and energies out
        "nonbonded_sparse": (
            stack + 3 * n * 4 + table + 2 * stack + 2 * n_rep * 4,
            census["within"] // 2 * PAIR_OPS
            + (census["valid"] - census["within"]) // 2 * DIST_TEST_OPS),
        # pos, mask and flag in; the list and dropped out
        "nlist_build": (stack + nb.mask_u8.numel() + 4 + table + n_rep * 4,
                        n_rep * n_pairs * DIST_TEST_OPS),
        "nlist_build (flag 0)": (4 + 2 * table + n_rep * 4, 0),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
        print(f"{name} bound: {nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP "
              f"-> {out[name][0]:.5f} ms ({out[name][1]})")
    return out


SPARSE_RUNS = (("fused", "neighbor", 6), ("fused", "matrix", 3),
               ("pallas", "neighbor", 3))


def run_tsu_sparse(libs, smi: str):
    """The third slice: the TSU grid on the sparse path, both force paths,
    each run from ``init`` with every launch count set to 0 just before."""
    phase(f"13 TSU sparse slice: {TSU_DIMS} = {R_TSU} replicas x {N_ATOMS} "
          f"atoms, nonbonded='sparse', bonded='sparse', "
          f"run_fused(chunk_cycles=3)")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.core.ensemble import control_multiset_ok
    engines = {path: sparse_engine(path) for path in ("fused", "pallas")}
    eng = engines["fused"]
    print(f"cutoff {eng.cutoff}, skin {eng.skin}, r_list {eng.r_list}, "
          f"k_max {eng.k_max}, build {eng.nlist_build}, pair planes "
          f"{eng._pair_params is not None}")
    out = {}
    for path, scheme, n_cycles in SPARSE_RUNS:
        tag = f"{path}/{scheme}"
        cfg = RepExConfig(dimensions=TSU_DIMS, md_steps_per_cycle=10,
                          n_cycles=n_cycles, exchange_scheme=scheme)
        driver = REMDDriver(engines[path], cfg, device="cuda")
        ens = driver.init(SEED)
        reset(libs)
        t0 = time.perf_counter()
        ens = driver.run_fused(ens, chunk_cycles=3)
        wall = time.perf_counter() - t0
        launches = {lib.name: lib.launches for lib in libs}
        variants = dict(libs[0].variants)
        evals = n_cycles * 11
        want = {"chain_forces": evals, "nonbonded": 0, "fused_baoab": 0,
                "exchange_matrix": n_cycles if scheme == "matrix" else 0,
                "nonbonded_sparse": evals + n_cycles, "nlist_build": evals,
                "lj_fluid": 0, "flash_attention": 0}
        per_chunk = [h["t_step"] * 1e3 for h in driver.history[::3]]
        ms_cycle = per_chunk[-1]
        last = driver.history[-1]
        failed = sum(h["failed"] for h in driver.history)
        print(f"{tag}: ms/cycle {ms_cycle:.2f} (last chunk of 3 cycles; per "
              f"chunk {[round(t, 2) for t in per_chunk]}; whole run "
              f"{wall / n_cycles * 1e3:.2f}) [{smi}]")
        print(f"{tag}: replica-steps/s {R_TSU * 10 / ms_cycle * 1e3:.0f}")
        print(f"{tag}: acceptance by dimension {driver.acceptance_ratios()}")
        print(f"{tag}: nb_rebuilds by cycle "
              f"{[h['nb_rebuilds'] for h in driver.history]}, nb_overflow "
              f"{last['nb_overflow']}")
        print(f"{tag}: launches {launches}, bonded variants {variants} "
              f"(want {want})")
        check(launches == want and variants == {"bias": evals},
              f"{tag}: bonded bias variant, build and sparse force cycles x "
              f"11, sparse feature pass once per cycle, nothing dense")
        check(last["nb_overflow"] == 0, f"{tag}: no pair dropped")
        check(control_multiset_ok(ens), f"{tag}: assignment is a permutation")
        check(all(sorted(h["assignment"].tolist()) == list(range(R_TSU))
                  for h in driver.history),
              f"{tag}: every assignment row a permutation")
        check(failed == 0, f"{tag}: no replica failed")
        check(bool(torch.isfinite(ens.state["pos"]).all()
                   and torch.isfinite(ens.state["vel"]).all())
              and tuple(ens.state["pos"].shape) == (R_TSU, N_ATOMS, 3),
              f"{tag}: finite state of the expected shape")
        check(sum(a for a, _ in driver.acceptance.values()) > 0,
              f"{tag}: some exchanges accepted")
        out[tag] = dict(ms=ms_cycle, launches=launches, driver=driver,
                        ens=ens, rebuilds=last["nb_rebuilds"])
    check(out["fused/neighbor"]["rebuilds"] > 0,
          "the gated build fired inside a chunk on the card")
    return out


def breakdown_sparse(runs, smi: str) -> None:
    """Where a sparse fused TSU cycle's time goes: each part timed alone
    at R = 384 times its calls per cycle, then the busy share and the two
    new kernels' device time from a profiled matrix cycle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.core import exchange as X
    from repro_torch.core import failures as F
    from repro_torch.core.controls import ctrl_for_assignment
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.lj_forces import ops as nb_ops
    from repro_torch.md import integrators as I
    from repro_torch.md import noise as NZ
    phase("13b where a sparse fused TSU cycle's time goes")
    driver, ens = runs["fused/matrix"]["driver"], runs["fused/matrix"]["ens"]
    eng, grid = driver.engine, driver.grid
    state, nl = ens.state, ens.state["nlist"]
    pos = state["pos"]
    ctrl = ctrl_for_assignment(grid, ens.assignment)
    keys = jr.split(ens.rng, R_TSU)
    n_steps = torch.full((R_TSU,), 10, dtype=torch.int64, device="cuda")
    c1, noise_scale = I.baoab_scales(eng.system.masses, ctrl["temperature"],
                                     eng.dt, eng.gamma)
    nz = noise_scale * NZ.step_noise_unrolled(keys, 1, (N_ATOMS, 3))
    f = eng._sparse_force_aux(ctrl)(pos, nl)[0]
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    parts = {
        "list refresh (skin check + gated build)": (
            lambda: eng._refresh_nlist(pos, nl), 11),
        "bonded kernel (bias variant)": (
            lambda: chain_ops.bonded_forces(pos, eng._pack,
                                            ctrl["umbrella_center"],
                                            ctrl["umbrella_k"]), 11),
        "sparse force (kernel + salt sum)": (
            lambda: nb_ops.nonbonded_force_sparse(
                pos, eng._nb_pack, nl["idx"], nl["valid"], eng.cutoff), 11),
        "noise draw (step_noise_unrolled)": (
            lambda: NZ.step_noise_unrolled(keys, 1, (N_ATOMS, 3)), 11),
        "BAOAB update": (lambda: I.baoab_fused_iteration(
            1, pos, state["vel"], f, nz, c1, noise_scale, eng.system.masses,
            n_steps, 10, eng.dt), 11),
        "feature pass (replica_features, sparse)": (
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
    md = sum(times[k] for k in list(times)[:5])
    for tag, ex in (("fused/neighbor", "neighbor exchange (features + DEO "
                                        "sweep)"),
                    ("fused/matrix", "matrix exchange (features + matrix + "
                                     "Gibbs sweep)")):
        total = md + times[ex] + times["detect + recover"]
        print(f"{tag}: sum of parts {total:.2f} ms/cycle vs measured "
              f"{runs[tag]['ms']:.2f} [{smi}]")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.run_fused(ens, n_cycles=1, chunk_cycles=1)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    ms = runs["fused/matrix"]["ms"]
    print(f"profiled sparse matrix cycle: device kernel time {busy:.2f} ms, "
          f"busy share of the measured ms/cycle {busy / ms:.3f}")
    for name, pattern, calls in (
            ("nonbonded_sparse", r"nonbonded_sparse_kernel", 12),
            ("nlist_build", r"nlist_build_kernel", 11),
            ("chain_forces (bias)", r"bonded_(edges|gather|energy)_kernel",
             11)):
        dev = sum(e.device_time_total for e in kernels
                  if re.search(pattern, e.name)) / 1e3
        print(f"profiled sparse matrix cycle: {name} {dev / calls:.4f} ms "
              f"device per call ({calls} calls)")


def invariance_sparse():
    phase(f"14 sparse path: chunk-size invariance across a rebuild (R=8, "
          f"N={N_ATOMS}) and card vs CPU")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.core import exchange as X
    dims = (("temperature", 2), ("umbrella", 2), ("umbrella", 2))
    # a skin of 0.5 A trips within the 3 cycles, so a rebuild falls inside
    # the chunk of 3
    engine = sparse_engine("fused", skin=0.5)
    cfg = RepExConfig(dimensions=dims, md_steps_per_cycle=10, n_cycles=3)
    out = {}
    for k in (1, 3):
        driver = REMDDriver(engine, cfg, device="cuda")
        ens = driver.run_fused(driver.init(SEED), chunk_cycles=k)
        out[k] = ([h["assignment"].tolist() for h in driver.history],
                  [h["nb_rebuilds"] for h in driver.history], ens.state)
    same_rows = out[1][0] == out[3][0] and out[1][1] == out[3][1]
    s1, s3 = out[1][2], out[3][2]
    same_state = (torch.equal(s1["pos"], s3["pos"])
                  and torch.equal(s1["vel"], s3["vel"])
                  and all(torch.equal(v, s3["nlist"][key])
                          for key, v in s1["nlist"].items()))
    print(f"rebuilds by cycle {out[3][1]}; assignment rows identical "
          f"{same_rows}, positions, velocities and lists bitwise equal "
          f"{same_state}")
    check(out[3][1][-1] > 0, "a rebuild inside the run")
    check(same_rows and same_state, "sparse decisions independent of chunk "
                                    "size")

    runs = {}
    orig = X.metropolis
    for dev in ("cuda", "cpu"):
        seen = []

        def spy(delta, rng):
            seen.append((delta.clone(), X.jr.uniform(rng, tuple(delta.shape))))
            return orig(delta, rng)

        X.metropolis = spy
        try:
            from repro_torch.md import MDEngine
            from repro_torch.md.system import chain_molecule
            eng = MDEngine(chain_molecule(64), force_path="fused",
                           nonbonded="sparse", bonded="sparse", skin=0.3,
                           device=dev)
            cfg = RepExConfig(dimensions=dims, md_steps_per_cycle=10,
                              n_cycles=4, exchange_scheme="matrix")
            driver = REMDDriver(eng, cfg, device=dev)
            ens = driver.run_fused(driver.init(SEED), chunk_cycles=2)
        finally:
            X.metropolis = orig
        runs[dev] = ([h["assignment"].tolist() for h in driver.history],
                     driver.acceptance_ratios(),
                     [h["nb_rebuilds"] for h in driver.history],
                     ens.state["pos"].cpu(), seen)
    same = runs["cuda"][:3] == runs["cpu"][:3]
    dpos = float((runs["cuda"][3] - runs["cpu"][3]).abs().max())
    print(f"small sparse matrix run (R=8, N=64, 4 cycles, skin 0.3) cuda vs "
          f"cpu: decisions and rebuilds identical {same} (rebuilds "
          f"{runs['cuda'][2]}), max |dpos| {dpos:.2e} A (tol "
          f"{TOL_SMALL_POS})")
    if not same:
        for c, (a, b) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
            if a != b:
                for dev in ("cuda", "cpu"):
                    delta, u = runs[dev][4][c]
                    margin = (u - torch.exp(torch.clamp_max(-delta, 0.0))
                              ).abs().cpu()
                    print(f"cycle {c} {dev}: Metropolis margins "
                          f"{margin.tolist()}")
                break
    check(same and dpos <= TOL_SMALL_POS, "sparse cuda run makes the CPU "
                                          "run's decisions")


def lj_engine(n_atoms: int = LJ_ATOMS, box: float = LJ_BOX,
              device: str = "cuda"):
    from repro_torch.md import LJEngine
    return LJEngine(n_particles=n_atoms, box=box, use_pallas=True,
                    device=device)


def lj_cfg(n_rungs: int, n_cycles: int, scheme: str = "neighbor",
           md_steps: int = 10):
    from repro_torch.config import RepExConfig
    return RepExConfig(dimensions=(("temperature", n_rungs),),
                       md_steps_per_cycle=md_steps, n_cycles=n_cycles,
                       exchange_scheme=scheme, **LJ_LADDER)


def lj_states(engine, n_rep: int):
    """Positions from ``init_state`` and after 10 MD steps of the
    ladder's first ``n_rep`` rungs."""
    from repro_torch import random as jr
    from repro_torch.core.controls import build_grid, ctrl_for_assignment
    key = jr.key(SEED, "cuda")
    s0 = engine.init_state(key, n_rep)
    grid = build_grid(lj_cfg(R_MAIN, 1), "cuda")
    ctrl = ctrl_for_assignment(grid, torch.arange(n_rep, device="cuda"),
                               engine.ctrl_keys)
    n_steps = torch.full((n_rep,), 10, dtype=torch.int64, device="cuda")
    s10 = engine.propagate(s0, ctrl, n_steps, jr.split(key, n_rep),
                           max_steps=10)
    return {"init_state": s0["pos"], "after 10 steps": s10["pos"]}


def in_box(pos, box: float) -> bool:
    return bool(((pos >= 0) & (pos <= box)).all()
                and torch.isfinite(pos).all())


def compare_fourth(engine, n_rep: int, tag: str):
    """The LJ fluid's energy and forces kernels against their plain
    versions on ``init_state`` positions and after 10 MD steps, the
    gradient of ``LJEnergy`` against minus the forces kernel (bitwise),
    and the single-configuration entry points; returns the max absolute
    errors and the positions after 10 steps."""
    from repro_torch.kernels.lj_forces import ops as nb_ops
    args = (engine.sigma, engine.eps, engine.box)
    errs = {"lj_energy": 0.0, "lj_forces": 0.0}
    for name, pos in lj_states(engine, n_rep).items():
        check(in_box(pos, engine.box), f"{tag} {name}: positions in the box")
        e_k = nb_ops.lj_energy_batched(pos, *args)
        e_p = nb_ops.ref.lj_energy(pos, *args)
        f_k = nb_ops.lj_forces_batched(pos, *args)
        f_p = nb_ops.ref.lj_forces(pos, *args)
        ee, ef = rel(e_k, e_p), rel(f_k, f_p)
        errs["lj_energy"] = max(errs["lj_energy"],
                                float((e_k - e_p).abs().max()))
        errs["lj_forces"] = max(errs["lj_forces"],
                                float((f_k - f_p).abs().max()))
        p = pos.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(
            nb_ops.LJEnergy.apply(p, *args).sum(), p)
        grad_ok = torch.equal(g, -f_k)
        e1 = rel(nb_ops.lj_energy(pos[0], *args)[None], e_p[:1])
        f1 = rel(nb_ops.lj_forces(pos[0], *args), f_p[0])
        print(f"{tag} {name}: energy {ee:.2e} (tol {TOL_LJ_ENERGY}; "
              f"U/N {float(e_p.mean()) / engine.n:.4f} kcal/mol), forces "
              f"{ef:.2e} (tol {TOL_LJ_FORCE}; max |F| "
              f"{float(f_p.abs().max()):.2f}); autograd backward == -F "
              f"bitwise {grad_ok}; R = 1 entry points: energy {e1:.2e}, "
              f"forces {f1:.2e}")
        check(ee <= TOL_LJ_ENERGY and e1 <= TOL_LJ_ENERGY,
              f"{tag} {name}: energy kernel vs plain")
        check(ef <= TOL_LJ_FORCE and f1 <= TOL_LJ_FORCE
              and bool(torch.isfinite(f_k).all()),
              f"{tag} {name}: forces kernel vs plain")
        check(grad_ok, f"{tag} {name}: LJEnergy backward is -F bitwise")
    return errs, pos


def no_ceiling_lj() -> None:
    """The forces kernel at R = 1 and argon's density (Rahman's 864
    atoms in 34.8 A) for each N of LJ_BIG, after 10 MD steps, against its
    plain version within TOL_LJ_FORCE (its partial rows live in device
    memory at every N)."""
    from repro_torch.kernels.lj_forces import ops as nb_ops
    for n in LJ_BIG:
        engine = lj_engine(n, LJ_BOX * (n / LJ_ATOMS) ** (1 / 3))
        pos = lj_states(engine, 1)["after 10 steps"]
        args = (engine.sigma, engine.eps, engine.box)
        f_k = nb_ops.lj_forces_batched(pos, *args)
        f_p = nb_ops.ref.lj_forces(pos, *args)
        ef = rel(f_k, f_p)
        print(f"N={n} R=1, box {engine.box:.3f} A: forces {ef:.2e} (tol "
              f"{TOL_LJ_FORCE}; max |F| {float(f_p.abs().max()):.2f})")
        check(ef <= TOL_LJ_FORCE and bool(torch.isfinite(f_k).all()),
              f"N={n}: forces kernel vs plain")
        del f_p
        # the energy kernel, not redesigned: printed only (ROADMAP P8)
        ee = rel(nb_ops.lj_energy_batched(pos, *args),
                 nb_ops.ref.lj_energy(pos, *args))
        print(f"N={n} R=1: energy kernel vs plain {ee:.2e} (printed; "
              f"TOL_LJ_ENERGY {TOL_LJ_ENERGY} holds at N={LJ_ATOMS})")


def timing_fourth(engine, pos, smi: str):
    """Phase 4's timing for the LJ fluid kernels at R = 64."""
    from repro_torch.kernels.lj_forces import ops as nb_ops
    phase(f"16 timing at R={R_MAIN}, N={LJ_ATOMS}")
    args = (engine.sigma, engine.eps, engine.box)
    kernels = {
        "lj_energy": (lambda: nb_ops.lj_energy_batched(pos, *args),
                      lambda: nb_ops.ref.lj_energy(pos, *args), 5),
        "lj_forces": (lambda: nb_ops.lj_forces_batched(pos, *args),
                      lambda: nb_ops.ref.lj_forces(pos, *args), 5),
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


def bounds_fourth(n_rep: int, n_atoms: int):
    """(bound_ms, bound_by) of the LJ fluid kernels: every unordered pair
    once (no cutoff: the function needs them all) at the operations of
    its cheapest form; positions read once, forces or energies written
    once."""
    n_pairs = n_rep * n_atoms * (n_atoms - 1) // 2
    stack = n_rep * n_atoms * 3 * 4
    work = {"lj_energy": (stack + n_rep * 4, n_pairs * LJ_ENERGY_PAIR_OPS),
            "lj_forces": (2 * stack, n_pairs * LJ_FORCE_PAIR_OPS)}
    print(f"LJ fluid: {n_pairs} unordered pairs at R={n_rep}, "
          f"N={n_atoms}")
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
        print(f"{name} bound: {nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP "
              f"-> {out[name][0]:.5f} ms ({out[name][1]})")
    return out


def lj_checks(driver, ens, tag: str) -> None:
    """No failure, every row a permutation, a finite state in the box."""
    from repro_torch.core.ensemble import control_multiset_ok
    n_rep = ens.assignment.shape[0]
    check(sum(h["failed"] for h in driver.history) == 0,
          f"{tag}: no replica failed")
    check(control_multiset_ok(ens)
          and all(sorted(h["assignment"].tolist()) == list(range(n_rep))
                  for h in driver.history),
          f"{tag}: every assignment row a permutation")
    check(in_box(ens.state["pos"], driver.engine.box)
          and bool(torch.isfinite(ens.state["vel"]).all()),
          f"{tag}: finite positions in [0, box]")


def lj_lib(libs):
    return next(lib for lib in libs if lib.name == "lj_fluid")


def run_lj(libs, smi: str):
    """The fourth slice: LJEngine at 64 rungs x 864 atoms through
    ``run_fused`` (8 DEO cycles, then 3 matrix cycles, each from
    ``init``) and ``run`` (4 cycles from the same seed); every launch
    count set to 0 just before each run."""
    phase(f"17 LJ slice: {R_MAIN} rungs x {LJ_ATOMS} atoms, box {LJ_BOX} A, "
          f"T {LJ_LADDER['t_min']}-{LJ_LADDER['t_max']} K, "
          f"run_fused(chunk_cycles=4), then run")
    from repro_torch.core import REMDDriver
    engine = lj_engine()
    out = {}
    for scheme, n_cycles in (("neighbor", 8), ("matrix", 3)):
        driver = REMDDriver(engine, lj_cfg(R_MAIN, n_cycles, scheme),
                            device="cuda")
        ens = driver.init(SEED)
        reset(libs)
        t0 = time.perf_counter()
        ens = driver.run_fused(ens, chunk_cycles=4)
        wall = time.perf_counter() - t0
        launches = {lib.name: lib.launches for lib in libs}
        variants = dict(lj_lib(libs).variants)
        want = dict.fromkeys(launches, 0)
        want["lj_fluid"] = n_cycles * 12
        per_chunk = [h["t_step"] * 1e3 for h in driver.history[::4]]
        ms_cycle = per_chunk[-1]
        print(f"{scheme}: ms/cycle {ms_cycle:.2f} (last chunk; per chunk "
              f"{[round(t, 2) for t in per_chunk]}; whole run "
              f"{wall / n_cycles * 1e3:.2f}) [{smi}]")
        print(f"{scheme}: replica-steps/s "
              f"{R_MAIN * 10 / ms_cycle * 1e3:.0f}, acceptance "
              f"{driver.acceptance_ratios()}")
        print(f"{scheme}: launches {launches}, LJ variants {variants} (want "
              f"{n_cycles * 11} forces, {n_cycles} energy, nothing else)")
        check(launches == want and variants == {"forces": n_cycles * 11,
                                                "energy": n_cycles},
              f"{scheme}: forces kernel 11 x cycles, energy kernel once "
              f"per cycle, no other kernel")
        lj_checks(driver, ens, scheme)
        check(sum(a for a, _ in driver.acceptance.values()) > 0,
              f"{scheme}: some exchanges accepted")
        out[scheme] = dict(ms=ms_cycle, launches=launches,
                           variants=variants, driver=driver, ens=ens)
    driver = REMDDriver(engine, lj_cfg(R_MAIN, 4), device="cuda")
    ens = driver.init(SEED)
    reset(libs)
    t0 = time.perf_counter()
    ens = driver.run(ens)
    wall = time.perf_counter() - t0
    launches = {lib.name: lib.launches for lib in libs}
    variants = dict(lj_lib(libs).variants)
    fused = out["neighbor"]["driver"].history[:4]
    keys = ("assignment", "accept", "attempt", "failed")
    same = all(all(np.array_equal(hf[k], hr[k]) for k in keys)
               for hf, hr in zip(fused, driver.history))
    parts = {k: statistics.median(h[k] * 1e3 for h in driver.history[1:])
             for k in ("t_prep", "t_step", "t_recover", "t_data")}
    print(f"run: {wall / 4 * 1e3:.2f} ms/cycle (4 cycles, the first warm), "
          f"medians of the last 3: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in parts.items()) + f" [{smi}]")
    print(f"run: history rows (assignment, accept, attempt, failed) equal "
          f"to run_fused's first 4: {same}; launches {launches}, LJ "
          f"variants {variants}")
    check(same, "run makes run_fused's decisions")
    want = dict.fromkeys(launches, 0)
    want["lj_fluid"] = 4 * 12
    check(launches == want and variants == {"forces": 44, "energy": 4},
          "run: 11 forces and 1 energy launch per cycle")
    lj_checks(driver, ens, "run")
    out["run"] = dict(ms=wall / 4 * 1e3, launches=launches,
                      variants=variants, driver=driver, ens=ens, parts=parts)
    return out


def breakdown_lj(runs, smi: str) -> None:
    """Where an LJ cycle's time goes: each part timed alone at R = 64
    times its calls per cycle, then the busy share and the two kernels'
    device time from a profiled chunk of 2 DEO cycles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.core import exchange as X
    from repro_torch.core import failures as F
    from repro_torch.core.controls import ctrl_for_assignment
    from repro_torch.md import integrators as I
    phase("17b where an LJ cycle's time goes")
    driver, ens = runs["neighbor"]["driver"], runs["neighbor"]["ens"]
    eng, grid = driver.engine, driver.grid
    state = ens.state
    pos, vel = state["pos"], state["vel"]
    ctrl = ctrl_for_assignment(grid, ens.assignment, eng.ctrl_keys)
    keys = jr.split(ens.rng, R_MAIN)
    n_steps = torch.full((R_MAIN,), 10, dtype=torch.int64, device="cuda")
    noise = I.stacked_step_noise(keys, 11, (LJ_ATOMS, 3))
    f = eng._force_stack(pos)
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    parts = {
        "noise draw (threefry + erf_inv, 11 steps)": (
            lambda: I.stacked_step_noise(keys, 11, (LJ_ATOMS, 3)), 1),
        "force evaluation (lj_forces kernel)": (
            lambda: eng._force_stack(pos), 11),
        "BAOAB update with the wrap": (lambda: I._baoab_apply(
            1, pos, vel, f, noise[1], eng.masses, ctrl["temperature"],
            n_steps, 10, eng.dt, eng.gamma, eng.box), 11),
        "neighbor exchange (lj_energy kernel + DEO sweep)": (
            lambda: X.neighbor_exchange(eng, state, grid, ens.assignment,
                                        zero, zero, keys[0], ens.alive), 1),
        "matrix exchange (lj_energy kernel + outer product + Gibbs)": (
            lambda: X.matrix_exchange(eng, state, grid, ens.assignment,
                                      keys[0]), 1),
        "feature pass alone (lj_energy kernel)": (
            lambda: eng.replica_features(state), 1),
        "detect + recover": (lambda: F.detect_recover(
            eng, ens, "relaunch", state), 1),
    }
    times = {}
    for name, (fn, calls) in parts.items():
        ms = median_ms(fn, 5, 1)
        times[name] = ms * calls
        print(f"{name}: {ms:.3f} ms x {calls} = {ms * calls:.3f} ms/cycle")
    names = list(times)
    md = sum(times[k] for k in names[:3])
    for scheme, ex in (("neighbor", names[3]), ("matrix", names[4])):
        total = md + times[ex] + times["detect + recover"]
        print(f"{scheme}: sum of parts {total:.2f} ms/cycle vs measured "
              f"{runs[scheme]['ms']:.2f} [{smi}]")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.run_fused(ens, n_cycles=2, chunk_cycles=2)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / 2
    ms = runs["neighbor"]["ms"]
    print(f"profiled DEO chunk: device kernel time {busy:.2f} ms/cycle, "
          f"busy share of the measured ms/cycle {busy / ms:.3f}")
    for name, pattern, calls in (
            ("lj_forces", r"lj_forces_(pairs|combine)_kernel", 22),
            ("lj_energy", r"lj_energy_kernel|block_energy_kernel", 2)):
        dev = sum(e.device_time_total for e in kernels
                  if re.search(pattern, e.name)) / 1e3
        print(f"profiled DEO chunk: {name} {dev / calls:.4f} ms device per "
              f"call ({calls} calls)")


def harmonic_probe(smi: str):
    """The driver-overhead probe: HarmonicEngine at 64 rungs and one MD
    step per cycle (no kernel; T_MD ~ 0), ms per cycle on ``run_fused``
    (chunks of 16, after one warm chunk) and on ``run``."""
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.core.ensemble import control_multiset_ok
    from repro_torch.md import HarmonicEngine
    cfg = RepExConfig(dimensions=(("temperature", R_MAIN),),
                      md_steps_per_cycle=1, n_cycles=32)
    driver = REMDDriver(HarmonicEngine(device="cuda"), cfg, device="cuda")
    ens = driver.run_fused(driver.init(SEED), n_cycles=16, chunk_cycles=16)
    t0 = time.perf_counter()
    ens = driver.run_fused(ens, n_cycles=32, chunk_cycles=16)
    fused = (time.perf_counter() - t0) / 32 * 1e3
    t0 = time.perf_counter()
    ens = driver.run(ens, n_cycles=16)
    per_cycle = (time.perf_counter() - t0) / 16 * 1e3
    print(f"HarmonicEngine {R_MAIN} rungs, 1 MD step per cycle (driver "
          f"overhead): run_fused {fused:.3f} ms/cycle (chunks of 16), run "
          f"{per_cycle:.3f} ms/cycle [{smi}]")
    # what the no-sync guard of run_fused costs: one chunk of 16 cycles
    # queued with and without it (the chunk alone, no stats fetch)
    chunk_ms = {}
    for guarded in (True, False, True, False):
        guard = (driver._no_host_sync() if guarded
                 else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with guard:
            driver._chunk(ens, ens.state, 16)
        torch.cuda.synchronize()
        chunk_ms.setdefault(guarded, []).append(
            (time.perf_counter() - t0) / 16 * 1e3)
    print(f"one chunk of 16 cycles, ms/cycle: under the no-sync guard "
          f"{chunk_ms[True]}, without it {chunk_ms[False]} [{smi}]")
    check(control_multiset_ok(ens) and bool(torch.isfinite(
        ens.state["x"]).all()) and sum(h["failed"]
                                       for h in driver.history) == 0,
          "harmonic probe: permutation, finite state, no failure")
    return fused, per_cycle


def invariance_lj():
    phase(f"18 LJ: chunk-size invariance (R=8, N={LJ_ATOMS}) and card vs "
          f"CPU")
    from repro_torch.core import REMDDriver
    from repro_torch.core import exchange as X
    engine = lj_engine()
    out = {}
    for k in (1, 4):
        driver = REMDDriver(engine, lj_cfg(8, 4), device="cuda")
        ens = driver.run_fused(driver.init(SEED), chunk_cycles=k)
        out[k] = ([h["assignment"].tolist() for h in driver.history],
                  ens.state)
    same_rows = out[1][0] == out[4][0]
    same_state = all(torch.equal(out[1][1][key], out[4][1][key])
                     for key in ("pos", "vel"))
    print(f"assignment rows identical {same_rows}, positions and "
          f"velocities bitwise equal {same_state}")
    check(same_rows and same_state, "LJ decisions independent of chunk "
                                    "size")
    runs = {}
    orig = X.metropolis
    for dev in ("cuda", "cpu"):
        seen = []

        def spy(delta, rng):
            seen.append((delta.clone(), X.jr.uniform(rng, tuple(delta.shape))))
            return orig(delta, rng)

        X.metropolis = spy
        try:
            small = lj_engine(64, 12.0, dev)
            driver = REMDDriver(small, lj_cfg(8, 4), device=dev)
            ens = driver.run_fused(driver.init(SEED), chunk_cycles=2)
        finally:
            X.metropolis = orig
        runs[dev] = ([h["assignment"].tolist() for h in driver.history],
                     driver.acceptance_ratios(), ens.state["pos"].cpu(),
                     seen)
    same = runs["cuda"][:2] == runs["cpu"][:2]
    dpos = float((runs["cuda"][2] - runs["cpu"][2]).abs().max())
    print(f"small LJ run (R=8, N=64, box 12 A, 4 cycles) cuda vs cpu: "
          f"decisions identical {same}, max |dpos| {dpos:.2e} A (tol "
          f"{TOL_SMALL_POS})")
    if not same:
        for c, (a, b) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
            if a != b:
                for dev in ("cuda", "cpu"):
                    delta, u = runs[dev][3][c]
                    margin = (u - torch.exp(torch.clamp_max(-delta, 0.0))
                              ).abs().cpu()
                    print(f"cycle {c} {dev}: Metropolis margins "
                          f"{margin.tolist()}")
                break
    check(same and dpos <= TOL_SMALL_POS, "LJ cuda run makes the CPU run's "
                                          "decisions")



def fa_cases():
    """Phase 19's cases: (dtype, mask, H / G, S = T, D, B, H, softcap)."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window in ((True, 0), (False, 0), (True, 64)):
            for rep in (1, 2, 4, 8):
                for s in (16, 100, 2048):
                    for d in (16, 64, 128):
                        cases.append((dtype, causal, window, rep, s, d, 1, 8,
                                      0.0))
    # the OLMo-1B prefill shape
    cases.append((torch.bfloat16, True, 0, 1, LM_PROMPT, 128, LM_BATCH, 16,
                  0.0))
    for dtype in (torch.float32, torch.bfloat16):
        for window in (0, 64):
            for rep in (1, 4):
                for s in (100, 2048):
                    for d in (64, 128):
                        cases.append((dtype, True, window, rep, s, d, 1, 8,
                                      FA_SOFTCAP))
    return cases


def fa_inputs(dtype, rep, s, d, b, h, seed=SEED):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, h // rep, d), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((b, s, h // rep, d), generator=gen,
                    device="cuda").to(dtype)
    return q, k, v


def fa_allowance_used(got, want, dtype) -> float:
    """max |got - plain| / (RTOL_FA |plain| + TOL_FA_F32 max |plain|):
    at most 1 when the kernel meets its plain version."""
    got, want = got.float(), want.float()
    allow = RTOL_FA[dtype] * want.abs() + TOL_FA_F32 * want.abs().max()
    return float(((got - want).abs() / allow).max())


def compare_fifth():
    """Kernel 8 against its plain version on every case; returns the max
    absolute error at the OLMo-1B prefill shape."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    worst, used = {}, {}
    err_olmo = None
    fa_ops.LIBRARY.reset()
    for dtype, causal, window, rep, s, d, b, h, cap in fa_cases():
        q, k, v = fa_inputs(dtype, rep, s, d, b, h)
        if cap:
            q = FA_SOFTCAP_Q * q
        got = fa_ops.flash_attention_kernel(q, k, v, causal=causal,
                                            window=window, softcap=cap)
        want = fa_ops.ref.attention(q, k, v, causal=causal, window=window,
                                    softcap=cap)
        e = rel(got.float(), want.float())
        u = fa_allowance_used(got, want, dtype)
        tag = (f"{str(dtype)[6:]} causal={causal} window={window} H/G={rep} "
               f"S=T={s} D={d} B={b} H={h} softcap={cap}")
        check(got.dtype == dtype and bool(torch.isfinite(got).all())
              and u <= 1.0, f"flash_attention vs plain: {tag}: {u:.3f} of "
                            f"the allowance (max |diff| / max |plain| "
                            f"{e:.2e})")
        key = str(dtype)[6:] + (f" softcap {cap}" if cap else "")
        worst[key] = max(worst.get(key, 0.0), e)
        used[key] = max(used.get(key, 0.0), u)
        if (b, s, h, d) == (LM_BATCH, LM_PROMPT, 16, 128):
            err_olmo = float((got.float() - want.float()).abs().max())
            late = (got.float() - want.float())[:, s // 2:].abs() / \
                want.float()[:, s // 2:].abs().clamp_min(1e-30)
            print(f"OLMo-1B prefill shape {tag}: max |diff| / max |plain| "
                  f"{e:.2e}, max |diff| {err_olmo:.3e}, {u:.3f} of the "
                  f"allowance; rows S/2..S: mean |plain| "
                  f"{float(want.float()[:, s // 2:].abs().mean()):.4f}, "
                  f"median |diff| / |plain| {float(late.median()):.2e}")
    print(f"{len(fa_cases())} cases: worst max |diff| / max |plain| {worst}; "
          f"worst share of the per-element allowance {used} (|diff| <= "
          f"{RTOL_FA[torch.bfloat16]:.4g} |plain| in bfloat16, 0 in "
          f"float32, + {TOL_FA_F32} max |plain|)")
    n = len(fa_cases())
    n_bf16 = sum(c[0] == torch.bfloat16 for c in fa_cases())
    print(f"launches by variant {fa_ops.LIBRARY.variants} (want bf16_tc "
          f"{n_bf16}, f32 {n - n_bf16})")
    check(fa_ops.LIBRARY.variants == {"bf16_tc": n_bf16, "f32": n - n_bf16},
          "flash_attention: bfloat16 on the tensor-core variant, float32 "
          "on the f32 variant")
    return err_olmo


def bounds_fifth(b: int, s: int, h: int, g: int, d: int, elem: int):
    """(bound_ms, bound_by) of causal attention at these shapes: 4 B H D
    x the kept (query, key) pairs S (S + 1) / 2 operations at the bf16
    tensor-core rate; q, k, v, out read or written once."""
    kept = s * (s + 1) // 2
    ops = 4 * b * h * d * kept
    nbytes = (2 * b * s * h * d + 2 * b * s * g * d) * elem
    t_ops, t_bytes = ops / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound = (max(t_ops, t_bytes) * 1e3,
             "operations" if t_ops >= t_bytes else "bytes")
    print(f"flash_attention bound: {ops:.4e} operations, "
          f"{nbytes / 1e6:.1f} MB -> {t_ops * 1e3:.4f} ms (bf16 tensor "
          f"cores, 989 TFLOP/s) vs {t_bytes * 1e3:.4f} ms (bytes): "
          f"{bound[0]:.4f} ms ({bound[1]}); at the fp32 CUDA-core rate "
          f"{ops / FP32_FLOPS_PER_S * 1e3:.4f} ms")
    return {"flash_attention": bound}


def timing_fifth(smi: str):
    """Phase 4's timing for kernel 8 at the OLMo-1B prefill shape, with
    PyTorch's scaled_dot_product_attention on the same tensors as the
    yardstick (timed here, never called by the port)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    phase(f"20 timing at the OLMo-1B prefill shape (B={LM_BATCH}, "
          f"S={LM_PROMPT}, H=G=16, D=128, bfloat16, causal)")
    q, k, v = fa_inputs(torch.bfloat16, 1, LM_PROMPT, 128, LM_BATCH, 16)
    k_ms = graph_ms(lambda: fa_ops.flash_attention_kernel(q, k, v),
                    calls=5)
    h_ms = host_ms(lambda: fa_ops.flash_attention_kernel(q, k, v), n=20)
    p_ms = median_ms(lambda: fa_ops.ref.attention(q, k, v), 5, 1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib_ms = graph_ms(sdpa, calls=5)
    want = fa_ops.ref.attention(q, k, v)
    lib_out = sdpa().transpose(1, 2)
    e_lib = rel(lib_out.float(), want.float())
    u_lib = fa_allowance_used(lib_out, want, torch.bfloat16)
    u_k = fa_allowance_used(fa_ops.flash_attention_kernel(q, k, v), want,
                            torch.bfloat16)
    print(f"flash_attention: kernel {k_ms:.4f} ms device (graph replay), "
          f"wrapper host {h_ms:.4f} ms/call, plain {p_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms device (graph "
          f"replay; vs plain {e_lib:.2e}) [{smi}]")
    print(f"share of phase 19's per-element allowance used at this shape: "
          f"kernel {u_k:.3f}, scaled_dot_product_attention {u_lib:.3f} "
          f"(printed, not checked)")
    bound = bounds_fifth(LM_BATCH, LM_PROMPT, 16, 16, 128, 2)
    print(f"flash_attention: {bound['flash_attention'][0] / k_ms:.4f} of "
          f"its bound, {lib_ms / k_ms:.3f} x the library call's time")
    before_and_bound("flash_attention", k_ms, bound)
    return {"flash_attention": (k_ms, p_ms)}, bound, lib_ms


def serve_argv(*extra):
    return ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--tokens", str(LM_TOKENS), *extra]


def score_spread(params, cfg, toks, n: int = 256) -> None:
    """Layer 0's attention scores on the seeded weights, float32, over the
    first ``n`` positions of one prompt: their std and the mean largest
    softmax weight of the causal rows past the first 16."""
    from repro_torch.models import layers as L
    x = L.apply_norm({}, cfg, params["embed"][toks[0, :n]][None].float())
    pos = torch.arange(n, device="cuda")
    q, k = (L.apply_rope(L._project(x, params["layers"]["attn"][w][0]),
                         pos, cfg.rope_theta)[0] for w in ("wq", "wk"))
    sc = torch.einsum("shd,thd->hst", q, k) / math.sqrt(q.shape[-1])
    keep = L._mask(pos, pos, True, 0)
    top = torch.softmax(sc.masked_fill(~keep, float("-inf")), -1).amax(-1)
    print(f"{cfg.name} layer 0 on the seeded weights (wq std "
          f"{float(params['layers']['attn']['wq'][0].std()):.4f}): "
          f"attention scores std {float(sc[:, keep].std()):.1f}, mean "
          f"largest softmax weight of rows 16..{n - 1} "
          f"{float(top[:, 16:].mean()):.3f}")


def run_serve(libs, smi: str):
    """The fifth slice: ``serve.main`` on OLMo-1B at full width, twice
    from the same weights, then prefill(S) + decode against
    prefill(S + 1); every launch count set to 0 just before each run.
    Returns the second run's report (with the weights) and the first
    run's launch counts."""
    from repro_torch import random as jr
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import registry
    phase(f"21 LM serving: {LM_ARCH} at full width, {LM_BATCH} prompts x "
          f"{LM_PROMPT} tokens, {LM_TOKENS} new tokens (seeded weights)")
    cfg = registry.get_config(LM_ARCH)
    reset(libs)
    rep = {}
    gen = serve.main(serve_argv(), report=rep)
    launches = {lib.name: lib.launches for lib in libs}
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.n_layers
    variants = dict(fa_ops.LIBRARY.variants)
    dec = statistics.median(rep["decode_ms"])
    peak = rep["peak_bytes"] / 2 ** 30
    print(f"params {registry.param_count(cfg)} ({cfg.param_dtype}); init "
          f"{rep['init_s']:.2f} s; prefill {rep['prefill_ms']:.2f} ms; "
          f"decode {dec:.3f} ms/token (median of {len(rep['decode_ms'])}; "
          f"min {min(rep['decode_ms']):.3f}, max "
          f"{max(rep['decode_ms']):.3f}), {LM_BATCH / dec * 1e3:.1f} "
          f"tokens/s; peak memory {peak:.2f} GiB [{smi}]")
    print(f"launches {launches}, flash by variant {variants} (want "
          f"{cfg.n_layers} flash on bf16_tc, one per layer of the one "
          f"prefill, none in decode)")
    check(launches == want and variants == {"bf16_tc": cfg.n_layers},
          "serve: 16 flash launches on the tensor cores, nothing else")
    check(gen.shape == (LM_BATCH, LM_TOKENS) and all(
        bool(torch.isfinite(x).all()) for x in rep["logits"]),
          "serve: tokens of the right shape, finite logits")
    params = rep.pop("params")
    reset(libs)
    rep2 = {}
    gen2 = serve.main(serve_argv(), params=params, report=rep2)
    same = torch.equal(gen, gen2)
    print(f"second run, same weights: tokens bitwise equal {same}; prefill "
          f"{rep2['prefill_ms']:.2f} ms, decode "
          f"{statistics.median(rep2['decode_ms']):.3f} ms/token [{smi}]")
    check(same and fa_ops.LIBRARY.launches == cfg.n_layers,
          "serve: bitwise reproducible tokens")
    rep2["params"] = params
    score_spread(params, cfg, jr.randint(jr.key(1, "cuda"), (1, 256), 0,
                                         cfg.vocab_size))

    # prefill(S) then decode_step(token S) against prefill(S + 1): held at
    # full width on the first CONSIST_LAYERS layers; all 16 printed
    toks = jr.randint(jr.key(2, "cuda"), (LM_BATCH, LM_PROMPT + 1), 0,
                      cfg.vocab_size)
    for depth in (CONSIST_LAYERS, cfg.n_layers):
        lm = registry.build(dataclasses.replace(cfg, n_layers=depth))
        stacks = params["layers"]
        cut = dict(params, layers={
            blk: {name: w[:depth] for name, w in leaves.items()}
            for blk, leaves in stacks.items()})
        reset(libs)
        _, state = lm.prefill(cut, {"tokens": toks[:, :-1]},
                              cache_len=LM_PROMPT + 1)
        n_pre = fa_ops.LIBRARY.launches
        dec_logits, _ = lm.decode_step(cut, state, toks[:, -1:])
        n_dec = fa_ops.LIBRARY.launches - n_pre
        del state
        full_logits, _ = lm.prefill(cut, {"tokens": toks})
        e = rel(dec_logits, full_logits)
        agree = float((dec_logits.argmax(-1) == full_logits.argmax(-1))
                      .float().mean())
        held = depth == CONSIST_LAYERS
        print(f"{depth} layers: prefill({LM_PROMPT}) + decode vs "
              f"prefill({LM_PROMPT + 1}): max |diff| / max |logit| {e:.2e}"
              + (f" (tol {TOL_LM_CONSIST})" if held else " (not held: the "
                 "seeded network's depth amplifies rounding)")
              + f", argmax agreement {agree:.2f}; flash launches {n_pre} in "
              f"prefill, {n_dec} in decode")
        check(n_pre == depth and n_dec == 0,
              "flash: one launch per layer per prefill, none in decode")
        check(e <= TOL_LM_CONSIST or not held,
              "prefill + decode agrees with prefill(S+1)")
    return rep2, launches


def breakdown_serve(rep, smi: str) -> None:
    """Where a full-width prefill's time goes, from one profiled call:
    the flash kernel, the matmuls, the rest; the busy share against the
    unprofiled prefill time of the second (warm) serve run, ``rep``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.models import registry
    phase("21b where a prefill's time goes")
    cfg = registry.get_config(LM_ARCH)
    lm, params = registry.build(cfg), rep["params"]
    toks = jr.randint(jr.key(1, "cuda"), (LM_BATCH, LM_PROMPT), 0,
                      cfg.vocab_size)
    lm.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm.prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    groups = {"flash_attention kernel": 0.0, "matmuls (cuBLAS)": 0.0,
              "the rest": 0.0}
    for e in kernels:
        name = e.name.lower()
        if "flash_attention_kernel" in name:
            key = "flash_attention kernel"
        elif re.search(r"gemm|nvjet|xmma|cutlass|sm90_", name):
            key = "matmuls (cuBLAS)"
        else:
            key = "the rest"
        groups[key] += e.device_time_total / 1e3
    busy = sum(groups.values())
    for key, ms in groups.items():
        print(f"{key}: {ms:.3f} ms device ({ms / busy:.3f} of kernel time)")
    print(f"device kernel time {busy:.3f} ms of a {rep['prefill_ms']:.3f} ms "
          f"prefill: busy share {busy / rep['prefill_ms']:.3f} [{smi}]")
    norm_cost(cfg, smi)


def norm_cost(cfg, smi: str) -> None:
    """``apply_norm`` (float32 statistics) against the float64-statistics
    form the port first used for bitwise bf16 parity with XLA on the CPU
    (each mean summed in float64, rsqrt through float64, each rounded
    once), at the prefill and the decode shape: device time from graph
    replays and host time per call, times the 2 L + 1 norms of a pass."""
    from repro_torch.models import layers as L

    def f64_stats(x):
        x32 = x.float()
        d = x32 - x32.double().mean(-1, keepdim=True).float()
        var = (d * d).double().mean(-1, keepdim=True).float()
        return (d * torch.rsqrt((var + 1e-5).double()).float()).to(x.dtype)
    n = 2 * cfg.n_layers + 1
    for s in (LM_PROMPT, 1):
        x = torch.randn((LM_BATCH, s, cfg.d_model), device="cuda").to(
            torch.bfloat16)
        got = {}
        for tag, fn in (("float32", lambda: L.apply_norm({}, cfg, x)),
                        ("float64", lambda: f64_stats(x))):
            got[tag] = (graph_ms(fn, calls=10), host_ms(fn, n=200))
        print(f"norm statistics at ({LM_BATCH}, {s}, {cfg.d_model}) x {n} "
              "per pass: " + ", ".join(
                  f"{tag} {dev * n:.3f} ms device, {host * n:.3f} ms host"
                  for tag, (dev, host) in got.items()) + f" [{smi}]")


def serve_against_cpu():
    """The smoke configs at float32 dtypes on the card (kernel) and on
    the CPU (plain): identical tokens, logits within TOL_LM_CPU."""
    phase("22 LM serving: card vs CPU (olmo-smoke, phi3-smoke, float32)")
    from repro_torch.launch import serve
    for arch in ("olmo_1b", "phi3_medium_14b"):
        argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "16", "--tokens", "8", "--override", "compute_dtype=float32",
                "cache_dtype=float32", "reduce_dtype=float32"]
        runs = {}
        for dev in ("cuda", "cpu"):
            rep = {}
            gen = serve.main(argv + ["--device", dev], report=rep)
            runs[dev] = (gen.cpu(), torch.stack(rep["logits"]).cpu())
        same = torch.equal(runs["cuda"][0], runs["cpu"][0])
        e = rel(runs["cuda"][1], runs["cpu"][1])
        print(f"{arch} smoke: tokens identical {same}, logits max |diff| / "
              f"max |logit| {e:.2e} (tol {TOL_LM_CPU})")
        if not same:
            top2 = runs["cpu"][1].topk(2, dim=-1).values
            print(f"{arch} smoke: top-2 logit margins on the CPU "
                  f"{(top2[..., 0] - top2[..., 1]).tolist()}")
        check(same and e <= TOL_LM_CPU, f"{arch} smoke: the card makes the "
                                        f"CPU's tokens")


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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    from repro_torch.kernels.lj_forces import ops as nb_ops
    from repro_torch.kernels.nlist_build import ops as nl_ops
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = environment()
    libs = [chain_ops.LIBRARY, nb_ops.LIBRARY, fused_ops.LIBRARY,
            x_ops.LIBRARY, nb_ops.SPARSE_LIBRARY, nl_ops.LIBRARY,
            nb_ops.LJ_FLUID_LIBRARY, fa_ops.LIBRARY]
    build(libs)

    phase(f"3 kernels vs plain versions at N={N_ATOMS}, R=4 and R={R_MAIN}")
    engine = MDEngine(chain_molecule(N_ATOMS), device="cuda")
    compare(engine, 4, "R=4")
    abs_b, abs_nb, pos = compare(engine, R_MAIN, f"R={R_MAIN}")
    times = timing(engine, pos, smi)
    bound = bounds(engine, R_MAIN)
    before_and_bound("nonbonded", times["nonbonded"][0], bound)
    no_ceiling_nonbonded(smi)

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
    before_and_bound("fused_baoab", times["fused_baoab"][0], bound)
    del inputs

    runs = run_tsu(libs, smi)
    breakdown_tsu(runs, smi)
    ms_pallas, bias_launches = run_tsu_pallas(libs, smi)
    print(f"TSU ms/cycle: fused neighbor {runs['neighbor']['ms']:.2f}, fused "
          f"matrix {runs['matrix']['ms']:.2f}, per-pass (pallas) neighbor "
          f"{ms_pallas:.2f} [{smi}]")
    invariance_fused()

    phase(f"11 third-slice kernels vs plain versions at N={N_ATOMS}, R=4 "
          f"and R={R_TSU}")
    sp = sparse_engine("fused")
    compare_third(sp, grid, 4, "R=4")
    errs3, sp_state, census = compare_third(sp, grid, R_TSU, f"R={R_TSU}")
    times3 = timing_third(sp, sp_state, smi)
    bound3 = bounds_third(sp, R_TSU, census)
    times.update(times3)
    bound.update(bound3)
    del sp_state
    sparse_runs = run_tsu_sparse(libs, smi)
    breakdown_sparse(sparse_runs, smi)
    print("TSU sparse ms/cycle: " + ", ".join(
        f"{tag} {r['ms']:.2f}" for tag, r in sparse_runs.items())
        + f" [{smi}]")
    invariance_sparse()

    phase(f"15 fourth-slice kernels vs plain versions at N={LJ_ATOMS}, R=4 "
          f"and R={R_MAIN}")
    lj = lj_engine()
    compare_fourth(lj, 4, "R=4")
    errs4, lj_pos = compare_fourth(lj, R_MAIN, f"R={R_MAIN}")
    no_ceiling_lj()
    times.update(timing_fourth(lj, lj_pos, smi))
    bound.update(bounds_fourth(R_MAIN, LJ_ATOMS))
    before_and_bound("lj_forces", times["lj_forces"][0], bound)
    del lj_pos
    lj_runs = run_lj(libs, smi)
    breakdown_lj(lj_runs, smi)
    harmonic_probe(smi)
    print(f"LJ ms/cycle: run_fused neighbor {lj_runs['neighbor']['ms']:.2f}, "
          f"matrix {lj_runs['matrix']['ms']:.2f}, run "
          f"{lj_runs['run']['ms']:.2f} [{smi}]")
    invariance_lj()

    phase("19 fifth-slice kernel vs its plain version: flash attention, "
          f"{len(fa_cases())} cases")
    err5 = compare_fifth()
    times5, bound5, lib_ms = timing_fifth(smi)
    times.update(times5)
    bound.update(bound5)
    serve_rep, serve_launches = run_serve(libs, smi)
    breakdown_serve(serve_rep, smi)
    del serve_rep
    serve_against_cpu()

    names = ("chain_forces", "chain_forces_bias", "nonbonded", "fused_baoab",
             "exchange_matrix", "nonbonded_sparse", "nlist_build",
             "lj_energy", "lj_forces", "flash_attention")
    src_of = {
        "chain_forces": "src/repro_torch/kernels/chain_forces/csrc/"
                        "chain_forces.cu",
        "chain_forces_bias": "src/repro_torch/kernels/chain_forces/csrc/"
                             "chain_forces.cu",
        "nonbonded": "src/repro_torch/kernels/lj_forces/csrc/nonbonded.cu",
        "fused_baoab": "src/repro_torch/kernels/fused_propagate/csrc/"
                       "fused_baoab.cu",
        "exchange_matrix": "src/repro_torch/kernels/exchange_matrix/csrc/"
                           "exchange_matrix.cu",
        "nonbonded_sparse": "src/repro_torch/kernels/lj_forces/csrc/"
                            "nonbonded_sparse.cu",
        "nlist_build": "src/repro_torch/kernels/nlist_build/csrc/"
                       "nlist_build.cu",
        "lj_energy": "src/repro_torch/kernels/lj_forces/csrc/lj_fluid.cu",
        "lj_forces": "src/repro_torch/kernels/lj_forces/csrc/lj_fluid.cu",
        "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention.cu"}
    replaces = {
        "chain_forces": "src/repro/kernels/chain_forces/kernel.py:190",
        "chain_forces_bias": "src/repro/kernels/chain_forces/kernel.py:190",
        "nonbonded": "src/repro/kernels/lj_forces/kernel.py:284",
        "fused_baoab": "src/repro/kernels/fused_propagate/kernel.py:80",
        "exchange_matrix": "src/repro/kernels/exchange_matrix/kernel.py:42",
        "nonbonded_sparse": "src/repro/kernels/lj_forces/kernel.py:257",
        # not a TPU kernel: the port's form of the lax.cond around the jnp
        # build (maybe_rebuild)
        "nlist_build": "src/repro/md/neighbors.py:346",
        "lj_energy": "src/repro/kernels/lj_forces/kernel.py:94",
        "lj_forces": "src/repro/kernels/lj_forces/kernel.py:116",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85"}
    counts = {"chain_forces": launches["chain_forces"],
              "nonbonded": launches["nonbonded"],
              "chain_forces_bias": bias_launches,
              "fused_baoab": sum(r["launches"]["fused_baoab"]
                                 for r in runs.values()),
              "exchange_matrix": runs["matrix"]["launches"]["exchange_matrix"],
              "nonbonded_sparse": sum(r["launches"]["nonbonded_sparse"]
                                      for r in sparse_runs.values()),
              "nlist_build": sum(r["launches"]["nlist_build"]
                                 for r in sparse_runs.values()),
              "lj_energy": sum(r["variants"]["energy"]
                               for r in lj_runs.values()),
              "lj_forces": sum(r["variants"]["forces"]
                               for r in lj_runs.values()),
              "flash_attention": serve_launches["flash_attention"]}
    errs = dict(errs2, chain_forces=abs_b, nonbonded=abs_nb, **errs3,
                **errs4, flash_attention=err5)
    library = {"flash_attention": lib_ms}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src_of[name],
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bound[name][0],
         "bound_by": bound[name][1], "library_ms": library.get(name)}
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
