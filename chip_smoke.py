#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

The quickest proof that the port still starts on the GPU.  Phases, each
printed on its own lines:

  1. environment  card name and power limit, CUDA, nvcc, triton
  2. build        the ten sources of ``src/repro_torch/kernels/*/csrc``,
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
                  worked out for the function from this run's data; each
                  beside its time before its current design (BEFORE_MS),
                  the nonbonded kernel also at N = 10,000, R = 1; the
                  CUDA launches behind one count of the bonded wrapper and
                  of the list build's, each flag (2 each, profiled);
                  kernel 4 at R = C = 384 in turns with its staged design
                  (on no path; bitwise checked) and its launch floors,
                  timed the same way: an empty kernel on its (C / 128, R)
                  grid, on the staged design's grid, and one block
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
                  the fused and bonded kernels beside their times before
                  their current designs (BEFORE_MS) and their bounds;
                  then the fused kernel at R = 1 for N = 16,384 and
                  20,000, where its force rows leave shared memory for
                  device memory (variant "rows_l2"), against its plain
                  version with the same tolerances, and its time
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
                  row, with a k_max that drops pairs, and on a random gas
 12. timing       both at R = 384 as in phase 4, the build in both flag
                  states, with the bounds of this run's list (the build's:
                  the bytes of positions in and the list out; the O(N^2)
                  distance tests of every pair printed as "all pairs")
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
                  rows live in device memory; the energy's sums are per
                  tile entry and per block, in a fixed order)
 16. timing       both at R = 64 as in phase 4, with their bounds, each
                  beside its time before the each-pair-once design
                  (BEFORE_MS)
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
                  and bfloat16; causal and windowed); then the fifteenth
                  slice's 52: MLA's prefill (D 192, Dv 128, H = G = 16)
                  and RecurrentGemma's local attention (D = Dv = 256, one
                  kv head, window 2048, softcap 30) at the served shape,
                  and (D, Dv) = (192, 128), (256, 256), (24, 16), (64,
                  128) at S = 16, 100, 300 with a window and the softcap,
                  G = H and G = 1, float32 and bfloat16; the launches by
                  variant ("bf16_tc" on the tensor cores, "f32")
 20. timing       the kernel at that shape as in phase 4, with PyTorch's
                  ``scaled_dot_product_attention`` on the same tensors as
                  the yardstick call (and the share of phase 19's
                  allowance its output uses, printed only), the bound and
                  the kernel's time before the tensor-core design; 20b:
                  the same at the MLA and RecurrentGemma prefill shapes
                  (SDPA where it computes the function: not with the
                  softcap)
 21. serve        ``repro_torch.launch.serve.main`` on OLMo-1B at full
                  width (seeded weights): 4 prompts of 2048 tokens, 32
                  greedy tokens; init, prefill and decode times, peak
                  memory; exactly 16 flash launches (one per layer of the
                  prefill, none in decode); a second run from the same
                  weights bitwise equal; prefill(2048) + one decode step
                  against prefill(2049); 21b: where a prefill's time goes
 22. card vs CPU  the olmo and phi3 smoke configs at float32 dtypes served
                  on the card and on the CPU: identical tokens
 23. oracles      the sixth slice, the driver's patterns, modes and fault
                  tolerance: ``MDEngine``'s oracle force paths
                  (``force_path="batched"``, autograd of the replica-major
                  potential, and ``"vmap"``, each replica's own program)
                  at R = 4, N = 2881: one propagate of 10 steps of each
                  against ``"pallas"`` from the same state and keys, within
                  TOL_ORACLE; time and peak memory of each
 24. async+faults T-REMD 64 x 2881 on ``"pallas"`` under the asynchronous
                  pattern (window 5 steps, at most 10), failure_rate 0.05,
                  relaunch_budget 2, ``run_fused(chunk_cycles=4)`` for 8
                  cycles with a checkpoint each chunk: launch counts (8 x
                  11), stragglers, failures detected; then a new driver
                  resumes from the checkpoint after cycle 4 and must give
                  the last 4 history rows and the final state bitwise;
                  ms/cycle, mean ready_frac, failures and escalations,
                  save and load ms, bytes per checkpoint, the busy share
 25. Mode II      T-REMD 64 x 2881 ("pallas", slots 24), TSU 384 x 2881
                  ("fused", slots 128) and LJ 64 x 864 (slots 24): three
                  waves each, 4 cycles, history rows and positions and
                  velocities bitwise Mode I's; each wave launches the
                  path's kernels; ms/cycle of both modes and the device
                  kernel time of one profiled cycle of each
 26. card vs CPU  R = 8, N = 2881, asynchronous, faults with escalation,
                  Mode II with 3 waves, 6 cycles: the card makes the CPU's
                  decisions, failures and escalations (margins printed for
                  a Metropolis flip)
 27. telemetry    the seventh slice, the cell build, observability and the
                  CLI: T-REMD 64 x 2881 (8 cycles, chunks of 4) and TSU 384
                  fused with the matrix scheme (4 cycles, chunks of 2), each
                  with ``Telemetry(phase_probe_every=1)`` and without:
                  assignment rows and final state bitwise equal, the
                  launches per chunk with telemetry off phase 5's (T-REMD)
                  or 11 fused + 1 matrix a cycle (TSU), the launches the
                  probes add printed, one fetch per chunk either way, the
                  report valid (pair rows only on the neighbor scheme) and
                  its Eq. (1) split printed beside the measured ms/cycle
 28. cell build   the cell-build kernels (``cell_build.cu``) against their
                  plain version, bitwise, with flag 0, flag 1 and a flag
                  row, on the chain at R = 384 (the TSU sparse positions)
                  and on a random gas of 20,000 atoms at the LJ fluid's
                  density (R = 4), where ``suggest_build_method`` picks
                  "cell"; the lists as sets the dense build's; each timed
                  beside the dense build, its time before (BEFORE_MS) and
                  its bound (flag 1: the larger of the bytes, with the
                  mask words of the pairs within r_list, and those pairs'
                  distance tests; the stencil's candidates printed beside
                  it), flag 1's split between its bin and row kernels
                  from profiled calls
 29. card vs CPU  R = 8, N = 2881, ``nonbonded="sparse",
                  nlist_build="cell"``, skin 0.5 A (the lists rebuilt),
                  telemetry's counters on: the card makes the CPU's
                  decisions, rebuilds and per-pair counters; launches 11 a
                  cycle of the cell build; before and after the card's run
                  the cell-build kernels bitwise their plain version on its
                  own positions, grid, capacity and k_max (flag 0, flag 1,
                  a flag row), and timed there (as in 28) for the
                  kernels' record
 30. CLI          ``python -m repro_torch.launch.repex_run`` on phase 27's
                  T-REMD configuration as a subprocess: exit 0, its
                  ``--report-out`` valid and its counters phase 27's
 31. sharded      the eighth slice, replica-sharded execution:
                  ``run_sharded`` on a one-rank NCCL group (made here on
                  127.0.0.1; NCCL's version and availability printed)
                  against ``run_fused`` from the same seed: T-REMD 64 x
                  2881 (8 cycles, chunks of 4) on the halo and the gather
                  wire, TSU 384 dense fused with the matrix scheme (3
                  cycles, one chunk), T-REMD 64 asynchronous with failure
                  rate 0.05 and relaunch budget 2, and a
                  ``resume(via="sharded")`` of a ``run_fused`` checkpoint:
                  history rows, acceptance, failures, escalations,
                  ``alive`` and the state bitwise, every chunk under
                  ``set_sync_debug_mode("error")``; ms/cycle of both, the
                  kernel launches per chunk (equal) and the collectives and
                  bytes per chunk from the wire ledger
 32. blocks       the per-shard functions on blocks of R/2 and R/4 rows
                  against the full stack, for T-REMD 64, TSU 384 dense
                  fused, TSU 384 sparse fused and LJ 384 x 864, called as
                  a rank calls them (``sharding.ensemble_scope``: the
                  kernels' splits sized by R): one cycle's propagate
                  (``stack=R``; the sparse list's collective rebuild flag
                  the full stack's, as the ranks' reduction makes it),
                  ``replica_features``, ``energy_pair_from_features`` on
                  the sliced ctrl rows, ``cross_energy_from_features``
                  (the tile) and ``is_failed``, all bitwise (else the
                  function and its largest ulp distance); the features
                  once more without the scope, a split sized by the
                  block (printed, not checked)
 34. RE-SGLD      the twelfth slice, LM training: ``LMEngine`` (in place)
                  on OLMo-1B at full width through ``REMDDriver.run_fused
                  (chunk_cycles=2)``, 4 temperature rungs, synchronous
                  DEO, 2 cycles of 1 optimizer step, every chunk under
                  ``set_sync_debug_mode("error")``: the flash kernel
                  launched 16 times per replica per energy evaluation,
                  all bf16_tc, and nothing under autograd; finite losses,
                  a permutation of the rungs; ms per cycle, init_state s,
                  peak memory, and one replica-step split into fwd + bwd,
                  AdamW, SGLD noise and an energy evaluation, each timed
                  alone; the flash kernel on the q, k, v an energy
                  evaluation hands it, against its plain version, and
                  the held-out loss through it against the plain route
                  within TOL_LM_LOSS (a non-causal kernel as the control);
                  34b: the float32 smoke preset of
                  ``examples/lm_parallel_tempering_torch.py`` at R = 4, 3
                  cycles of 2 steps: ``run`` and ``run_fused`` on the card
                  make the same decisions, the card makes the CPU's
                  (margins printed if not); on one seeded state the same
                  kernel checks (its f32 variant), the losses card vs
                  CPU within TOL_LM_CPU, and one replica-step's gradient
                  of every leaf on the card the CPU's within TOL_LM_GRAD
                  (TF32 matmuls as the control)
 35. train        ``repro_torch.launch.train.main`` on OLMo-1B at full
                  width, B = 8, S = 128, remat per block, 5 steps: ms per
                  step, tokens/s, peak memory, each step's loss (finite),
                  no kernel launched; then the smoke config with a
                  checkpoint per step, killed after step 3 (its later
                  checkpoints removed) and resumed: bitwise the
                  uninterrupted run
 36. examples     the fourteenth slice, the public surface: the port's
                  four MD examples (``examples/quickstart_torch.py``,
                  ``multidim_tsu_torch.py --full``, ``async_faults_torch.py``,
                  ``sharded_ensemble_torch.py`` as a one-rank NCCL group),
                  each in its own process on the card: exit 0, its
                  closing check (multiset, and the sharded trace identical
                  to run_fused), wall time, launches of kernels 1, 1b, 2
 37. MoE serving  ``serve.main`` on DeepSeek-MoE-16B at full width
                  (float32 parameters, bf16 compute), 4 prompts x 2048
                  tokens, 32 new tokens, twice on the same weights: 28
                  flash launches per prefill on bf16_tc, none in decode,
                  bitwise tokens, finite logits; init, prefill, decode
                  ms/token, peak memory; the share of routed choices
                  dropped at capacity; prefill(S) + decode vs
                  prefill(S + 1) printed, not held; 37a: the device time
                  of a warm prefill and of a decode step by kernel
                  group, and their busy shares; 37c: one full-width
                  MoE layer (B 4, S 2048, E 64, top 6, capacity 240) on
                  the seeded weights at float32, card vs CPU: the same
                  routing, y within TOL_MOE_LAYER; 37b: the deepseek-moe
                  smoke config at float32 card vs CPU
 38. MLA serving  the fifteenth slice: ``serve.main`` on DeepSeek-V2-Lite
                  16B at full width (float32 parameters, bf16 compute), 4
                  prompts x 2048 tokens, 32 new tokens, twice on the same
                  weights, once the earlier LM phases' memory is freed: 27
                  flash launches per prefill on bf16_tc (MLA's D 192, Dv
                  128), none in decode, bitwise tokens, finite logits;
                  init, cold and warm prefill, decode ms/token, peak
                  memory; 38a: a warm prefill and a decode step by kernel
                  group; 38b: deepseek-v2-lite-smoke at float32 card vs
                  CPU
 39. hybrid       the same for RecurrentGemma-9B, after phase 38's state
                  is freed: 12 flash launches per prefill (its attention
                  blocks: D 256, one kv head, window 2048, softcap 30),
                  none in decode; 39a, and 39b on recurrentgemma-smoke
                  (its ring buffer wrapping)
 40. ssm serving  the sixteenth slice: the same for xLSTM-1.3B (6 units of
                  7 mLSTM + 1 sLSTM blocks, no attention), after phase
                  39's state is freed: no kernel launch at all, bitwise
                  tokens, the phase's seconds; 40a by kernel group
                  (matmuls, copies, reductions, elementwise), 40b
                  xlstm-smoke at float32 card vs CPU
 41. training     card vs CPU on the smoke configs of DeepSeek-V2-Lite
                  (MLA), RecurrentGemma (hybrid) and xLSTM (ssm), float32,
                  TF32 off: 3 ``make_train_step`` steps with remat from
                  one seeded state, step 1's loss within
                  TOL_LM_LOSS[float32] and its gradient within
                  TOL_LM_GRAD in every leaf, no kernel launch
 45. dry run     the LM dry run (``launch/dryrun.py``) against the card:
                  OLMo-1B at full width on a one-rank NCCL test mesh
                  (1, 1), train at phase 35's cell (B 8, S 128, remat),
                  prefill and decode at phase 21's (B 4, S 2048; cache
                  2080).  Each step's prediction, traced on the host
                  (fake tensors, in a child process started with the
                  script), against the real step on the card: argument
                  and output bytes equal; for train and decode, where no
                  kernel runs, ``op_analysis`` FLOPs equal and
                  ``max_memory_allocated`` above the bytes held within
                  TOL_DRY_PEAK of ``temp_size_in_bytes`` (prefill's
                  printed only: the card runs kernel 8, which holds no
                  scores); then olmo_1b's train_4k, prefill_32k and
                  decode_32k on 16x16 and decode_32k on 2x16x16, traced
                  on the host, each with its status line, all OK
 46. op budgets   the counterpart of ``tests/test_op_budget.py``: the
                  CUDA launches of one propagate (R = 8, 10 steps) of the
                  "pallas" path dense and all-sparse, the "fused" path
                  dense, bonded-sparse and all-sparse and "batched"
                  (autodiff), the kernel nodes of a CUDA graph captured
                  around one call, each as pinned (MEASURED_LAUNCHES; the
                  memcpy, memset and other nodes apart) and within
                  LAUNCH_BUDGET; the noise draws read the same way as 1
                  (the "pallas" path's stacked draw) and 11 (the fused
                  path's blocks), the wrappers' counts beside; fused <
                  pallas (dense and all-sparse) in all and besides the
                  noise draws, and pallas < batched
 47. noise        the noise kernel (``kernels/noise``, the port's form of
                  XLA's fusion of the threefry hash and erf_inv) bitwise
                  its plain version on the card and on the CPU, the
                  differing elements printed (0): the fused path's
                  legacy-layout block and the stacked draw for R = 1, 8
                  and 384, N = 2881, t = 0, 5, 10; the SGLD update on an
                  OLMo-1B-sized leaf in one launch and across the 2^26
                  slice border through its offset; the bits -> normal map
                  alone on all 2^23 mantissas against the plain map; the
                  library's SASS census per kernel (``cuobjdump``); each
                  entry point timed beside its bound and its plain
                  version.  Phases 5, 8, 9, 13 and 34
                  check its launches on their paths (one stacked draw a
                  per-pass propagate, 11 blocks a fused one, one SGLD
                  update a leaf and replica-step)
 33. GPUs        only under ``python3 -m torch.distributed.run
                  --nproc-per-node N chip_smoke.py``, N > 1 GPUs of one
                  host (without a launcher the script runs phases 1-41 on
                  one card): ``run_sharded`` on N and on N/2 NCCL ranks
                  for T-REMD 64 (halo, gather, asynchronous + faults) and
                  TSU 384 (fused neighbor and matrix, sparse fused), each
                  bitwise ``run_fused`` on rank 0's GPU; ms/cycle on 1,
                  N/2 and N GPUs in turns, the wire per chunk, and rank
                  0's device time in a profiled chunk on N GPUs, its
                  kernels apart from NCCL's (which wait for the ranks)

Any failed check raises and the script exits non-zero.  The next to last
line is the kernels' JSON record, the last line the device record.
Without CUDA, or without the repository around it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
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
# One full-width MoE layer at float32, card against CPU (phase 37c), of
# max |y|: the same formulas summed in another order, as TOL_LM_CPU.  A
# routing choice may differ only where the CPU's k-th and (k+1)-th
# probabilities lie within MOE_FLIP_MARGIN (float32 router logits summed
# in another order); a wrong dispatch or combine moves y by its own size.
TOL_MOE_LAYER = 1e-4
MOE_FLIP_MARGIN = 1e-5
# The softcap of phase 19's added cases, and the factor on q that takes
# the scores (std ~1 on unit normals) to where the cap bites.
FA_SOFTCAP, FA_SOFTCAP_Q = 30.0, 20.0
# Kernel 8's (D, Dv) past its first 128-dim design (phase 19): MLA's
# prefill, RecurrentGemma's local attention, and q/k and v head dims apart
# either way (the tensor-core variant's zero halves past D or Dv)
FA_WIDE_DIMS = ((192, 128), (256, 256), (24, 16), (64, 128))
# Kernel times before the current designs, at the same shapes: kernel 3
# (fused BAOAB, R = 384, N = 2881; every ordered pair, divisions),
# kernel 8 (flash attention, OLMo-1B prefill shape, bf16 on the CUDA
# cores), kernel 2 (nonbonded, R = 64, N = 2881), kernels 6 and 7 (LJ
# fluid forces and energy, R = 64, N = 864), the last three with every
# ordered pair and divisions; kernels 1 and 1b (bonded, R = 64 and 384,
# N = 2881; an (R, 6W, 3) edge scratch between two launches) and the
# list build (R = 384, N = 2881; every pair tested, flag 1, and the
# kept list copied with 4-byte words, flag 0); the cell build with one
# bin block per replica and one warp per row (both flags) on phase
# 28's gas and chain at R = 384 and phase 29's chain at R = 8; kernel 4
# (R = C = 384, the design it still has): measured
# by this script on an NVIDIA H100 80GB HBM3 at 700 W as PERF.md section
# 6 records them; printed beside this run's times.
BEFORE_MS = {"fused_baoab": 9.3263, "flash_attention": 5.3706,
             "nonbonded": 2.1584, "lj_forces": 0.2866, "lj_energy": 0.2449,
             "chain_forces": 0.0227, "chain_forces_bias": 0.1076,
             "nlist_build": 5.2438, "nlist_build (flag 0)": 0.1435,
             "cell_build gas": 0.6889, "cell_build gas (flag 0)": 0.0742,
             "cell_build chain R=384": 2.8118,
             "cell_build chain R=384 (flag 0)": 0.0977,
             "cell_build chain R=8": 0.0910,
             "cell_build chain R=8 (flag 0)": 0.0075,
             "exchange_matrix": 0.0024}
# CUDA launches one call of a wrapper makes (its count goes up by one per
# call): the bonded kernel's block pass and its energy sum; the list
# build's box-or-copy pass and its build pass; the cell build's
# bin-or-copy pass (up to 16 bin blocks a replica) and its row
# pass, whichever the flag.
LAUNCHES_PER_CALL = {"chain_forces": 2, "nlist_build": 2, "cell_build": 2}
# Kernel 3 past its shared-memory rows, R = 1: just above the last N whose
# rows fit (16,256) and a larger chain.
N_FUSED_BIG = (16384, 20000)
# The "no ceiling" sizes, at R = 1: N where the nonbonded kernel's partial
# force rows no longer fit in shared memory; two fluids far above the main
# path's 864 atoms.
N_NB_BIG = 10000
LJ_BIG = (4000, 17500)
# The H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the
# attention's products take bf16 operands.
BF16_TC_FLOPS_PER_S = 989e12

# The twelfth slice: RE-SGLD at OLMo-1B's full width on one card.  Four
# replicas' params, mu and nu are 56.5 GB; eight would be 113 GB.  A
# second copy of the state does not fit, so the driver runs the
# "continue" recovery policy, under which it donates the state to the
# engine to step in place.  Then the train launcher at full width.
RSGLD_RUNGS, RSGLD_CYCLES = 4, 2
TRAIN_STEPS = 5
# One replica-step's gradient, card against CPU, per leaf as max |diff| /
# max |cpu|, on the float32 smoke preset: the same formulas, the matmuls
# and reductions summed in another order, which the seeded weights'
# near one-hot attention (fan-in 4 for wq, wk: scores std ~30) amplifies.
# Seen on an H100 at 700 W: card vs CPU 2.5e-6 to 1.35e-4; on the CPU,
# JAX against the port on this preset up to 6.6e-5
# (tests/test_torch_lm_engine.py); the card with TF32 matmuls (10-bit
# mantissas, the control the limit must see) 8.0e-3 to 0.34, checked
# above the limit in every leaf.  A missing or cut gradient is off by 1.
TOL_LM_GRAD = 1e-3
# The held-out loss of one replica through the flash kernel against the
# plain attention on the same card, |diff| / |plain|, by dtype: phase 34
# at OLMo-1B (bfloat16 through 16 layers; seen 1.1e-3, the plain route's
# float32 compute printed beside it), phase 34b on the float32 preset
# (seen 1.2e-7; the kernel without its causal mask 4.7e-5, checked above
# the limit).  At OLMo-1B the seeded weights' near one-hot rows make the
# loss all but blind to the attention (no causal mask moved it 4.7e-5):
# there the kernel is held layer by layer on the engine's own inputs.
TOL_LM_LOSS = {torch.bfloat16: 1e-2, torch.float32: 1e-5}

def reset(libs) -> None:
    """Every launch count to 0, just before a path is driven: ``libs``'
    and the noise kernel's, which every MD and RE-SGLD path launches and
    each phase checks apart (``noise_launches``)."""
    from repro_torch.kernels.noise import ops as nz_ops
    torch.cuda.synchronize()
    for lib in libs + [nz_ops.LIBRARY]:
        lib.reset()


# the noise kernel's launches in each run that checks them, by run
NOISE_RUNS: dict = {}


def noise_launches(want: dict, tag: str) -> None:
    """The noise kernel's launches since the last ``reset``, by variant,
    checked against ``want`` and kept in ``NOISE_RUNS``."""
    from repro_torch.kernels.noise import ops as nz_ops
    got = dict(nz_ops.LIBRARY.variants)
    print(f"{tag}: noise kernel launches {got} (want {want})")
    check(got == want, f"{tag}: the noise kernel's launches")
    NOISE_RUNS[tag] = nz_ops.LIBRARY.launches


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name}  [{time.perf_counter() - _T0:.1f} s]", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def metropolis_spy():
    """(seen, restore): records (delta, u) of every sweep the port draws
    until ``restore()`` puts ``metropolis`` back."""
    from repro_torch.core import exchange as X
    orig, seen = X.metropolis, []

    def spy(delta, rng):
        seen.append((delta.clone(), X.jr.uniform(rng, tuple(delta.shape))))
        return orig(delta, rng)

    X.metropolis = spy
    return seen, lambda: setattr(X, "metropolis", orig)


def print_margins(runs, rows_at: int, seen_at: int) -> None:
    """At the first cycle whose rows differ, each device's Metropolis
    margins |u - exp(min(-delta, 0))|: a rounding flip shows a tiny one."""
    for c, (a, b) in enumerate(zip(runs["cuda"][rows_at],
                                   runs["cpu"][rows_at])):
        if a != b:
            for dev in ("cuda", "cpu"):
                delta, u = runs[dev][seen_at][c]
                margin = (u - torch.exp(torch.clamp_max(-delta, 0.0))
                          ).abs().cpu()
                print(f"cycle {c} {dev}: Metropolis margins "
                      f"{margin.tolist()}")
            return


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


def xmat_inputs(r: int, c: int):
    """Packed (4, R) feature and (6, C) control rows for kernel 4: seeded
    energies, angles, salts and two umbrellas."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def u(*shape):
        return torch.rand(shape, device="cuda", generator=gen)
    feat = torch.stack([u(r) * 60 - 80, u(r) * 80 - 240, u(r) * 360 - 180,
                        u(r) * 360 - 180])
    ctrl = torch.stack([1.3 + 0.6 * u(c), u(c), 360 * u(c), 360 * u(c),
                        0.02 * u(c), 0.02 * u(c)])
    return feat.contiguous(), ctrl.contiguous()


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
    xmat_turns(smi)
    return res


def xmat_turns(smi: str) -> None:
    """Kernel 4 at R = C = R_TSU in turns with its staged design, bitwise
    checked, beside its three launch floors."""
    from repro_torch.kernels.exchange_matrix import ops as x_ops
    feat, ctrl = xmat_inputs(R_TSU, R_TSU)
    same = torch.equal(x_ops.exchange_matrix_staged(feat, ctrl),
                       x_ops.exchange_matrix_batched(feat, ctrl))
    check(same, "kernel 4's staged design bitwise the kernel")
    turns = [graph_ms(lambda f=f: f(feat, ctrl)) for f in (
        x_ops.exchange_matrix_batched, x_ops.exchange_matrix_staged,
        x_ops.exchange_matrix_staged, x_ops.exchange_matrix_batched)]
    floors = {grid: graph_ms(lambda grid=grid: x_ops.empty_launch(
        R_TSU, R_TSU, grid)) for grid in x_ops.EMPTY_GRIDS}
    print(f"kernel 4 at R = C = {R_TSU}: {turns[0]:.4f} {turns[3]:.4f} ms, "
          f"its staged design {turns[1]:.4f} {turns[2]:.4f} ms (in turns, "
          f"bitwise equal {same}); launch floors, an empty kernel on the "
          f"kernel's grid ({R_TSU // 128} x {R_TSU} blocks of 128) "
          f"{floors['kernel']:.4f} ms, on the staged design's "
          f"{floors['staged']:.4f} ms, one block {floors['one']:.4f} ms "
          f"(device, graph replay) [{smi}]")


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
    noise_launches({"stacked": cfg.n_cycles}, "T-REMD 64")
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
            ("chain_forces", r"(?<!non)bonded_(block|energy)_kernel"),
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
    nz = noise_scale * NZ.step_noise_unrolled(
        jr.split(key, n_rep), 1, (engine.system.n_atoms, 3))
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


def profiled_split(fn, pattern: str, calls: int = 10) -> dict:
    """Device ms per call of ``fn`` by CUDA kernel (names matching
    ``pattern``), from a profiled session of ``calls`` calls; the session
    with the most kernel events of three counts (the profiler can lose
    events, never invent them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best, most = {}, -1
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        sums, seen = {}, 0
        for e in prof.events():
            m = re.search(pattern, e.name)
            if e.device_type == DeviceType.CUDA and m:
                seen += 1
                sums[m.group(0)] = (sums.get(m.group(0), 0.0)
                                    + e.time_range.elapsed_us() / 1e3 / calls)
        if seen > most:
            best, most = sums, seen
    return best


def before_and_bound(name: str, k_ms: float, bound) -> None:
    """A redesigned kernel's time beside its time before and its bound."""
    print(f"{name}: {k_ms:.4f} ms now, {BEFORE_MS[name]:.4f} ms before "
          f"(PERF.md), bound {bound[name][0]:.5f} ms: "
          f"{BEFORE_MS[name] / k_ms:.2f}x faster, {k_ms / bound[name][0]:.2f}"
          f"x the bound")


def cuda_launches(fn, pattern: str, calls: int = 3) -> float:
    """CUDA kernels whose name matches ``pattern`` per call of ``fn`` (the
    launches behind one count of its wrapper), from a profiled session of
    ``calls`` calls after a warm-up session.  A short session has been
    seen to report no device events at all late in a long process, so the
    fullest of three sessions counts (the profiler can lose events, never
    invent them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for n in (1,) + (calls,) * 3:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and re.search(pattern, e.name)))
    return max(counts[1:]) / calls


def launches_per_call(engine, pos) -> None:
    """The CUDA launches behind one count of the bonded wrapper and of the
    list build's (each flag state), profiled at R = 8 here, before any
    long profiled run: LAUNCHES_PER_CALL."""
    from repro_torch import random as jr
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.nlist_build import ops as nl_ops
    sp = sparse_engine("fused")
    st = sp.init_state(jr.key(SEED, "cuda"), 8)
    old = (st["nlist"]["idx"], st["nlist"]["valid"])
    cells = (sp._grid_dims, sp._cell_capacity)
    calls = {
        "chain_forces": (lambda: chain_ops.chain_forces_batched(
            pos, engine._pack), r"(?<!non)bonded_(block|energy)_kernel"),
        "nlist_build": (lambda: nl_ops.nlist_build_batched(
            st["pos"], torch.ones(1, dtype=torch.int32, device="cuda"), old,
            sp._nb_pack.mask_bits, sp.r_list, sp.k_max),
            r"nlist_(prep|build)_kernel"),
        "nlist_build (flag 0)": (lambda: nl_ops.nlist_build_batched(
            st["pos"], torch.zeros(1, dtype=torch.int32, device="cuda"),
            old, sp._nb_pack.mask_bits, sp.r_list, sp.k_max),
            r"nlist_(prep|build)_kernel"),
        "cell_build": (lambda: nl_ops.cell_build_batched(
            st["pos"], torch.ones(1, dtype=torch.int32, device="cuda"), old,
            sp._nb_pack.mask_bits, sp.r_list, sp.k_max, *cells),
            r"cell_(bin|rows)_kernel"),
        "cell_build (flag 0)": (lambda: nl_ops.cell_build_batched(
            st["pos"], torch.zeros(1, dtype=torch.int32, device="cuda"),
            old, sp._nb_pack.mask_bits, sp.r_list, sp.k_max, *cells),
            r"cell_(bin|rows)_kernel")}
    for name, (fn, pattern) in calls.items():
        want = LAUNCHES_PER_CALL[name.split(" ")[0]]
        n_k = cuda_launches(fn, pattern)
        print(f"{name}: {n_k} CUDA launches per call, the wrapper's count "
              f"+1 (want {want})")
        check(n_k == want, f"{name}: CUDA launches per call")


def no_ceiling_fused(smi: str) -> None:
    """Kernel 3 at R = 1 for each N of N_FUSED_BIG, where its force rows
    live in device memory (variant "rows_l2"): one fused iteration (bias
    on, salt on) against its plain version with phase 7's tolerances,
    then its device time."""
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    grid = tsu_grid()
    for n in N_FUSED_BIG:
        engine = tsu_engine("fused", n)
        d = second_slice_inputs(engine, grid, 1)
        for name in ("bias on", "salt on"):
            args = d["fused"][name]
            v0 = dict(fused_ops.LIBRARY.variants)
            got = fused_ops.fused_baoab_batched(*args)
            moved = {k: v - v0.get(k, 0)
                     for k, v in fused_ops.LIBRARY.variants.items()
                     if v != v0.get(k, 0)}
            want = fused_ops.fused_iteration_plain(*args)
            ep, ev = rel(got[0], want[0]), rel(got[1], want[1])
            print(f"N={n} R=1 fused iteration, {name}: pos {ep:.2e} (tol "
                  f"{TOL_FUSED_POS}), vel {ev:.2e} (tol {TOL_FUSED_VEL}); "
                  f"variant {moved}")
            check(moved == {"rows_l2": 1}, f"N={n}: the force rows in "
                                           f"device memory")
            check(ep <= TOL_FUSED_POS and ev <= TOL_FUSED_VEL
                  and bool(torch.isfinite(got[1]).all()),
                  f"N={n}: fused kernel vs plain ({name})")
            del want
        k_ms = graph_ms(lambda: fused_ops.fused_baoab_batched(
            *d["fused"]["bias on"]), calls=2, reps=3)
        print(f"fused_baoab at N={n}, R=1 (rows in device memory): kernel "
              f"{k_ms:.4f} ms device (graph replay) [{smi}]")
        del engine, d


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
        rows = dict(next(lib for lib in libs
                         if lib.name == "fused_baoab").variants)
        noise_launches({"unrolled": n_cycles * 11}, f"TSU fused {scheme}")
        want = {"chain_forces": 0, "nonbonded": 0,
                "fused_baoab": n_cycles * 11,
                "exchange_matrix": n_cycles if scheme == "matrix" else 0,
                "nonbonded_sparse": 0, "nlist_build": 0, "lj_fluid": 0,
                "flash_attention": 0, "cell_build": 0}
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
        print(f"{scheme}: launches {launches} (want {want}); fused kernel "
              f"variants {rows}")
        check(launches == want, f"{scheme}: fused kernel cycles x 11, no "
              f"per-pass kernel, exchange matrix once per matrix cycle")
        check(rows == {"rows_shared": n_cycles * 11},
              f"{scheme}: the fused kernel's rows in shared memory at "
              f"N={N_ATOMS}")
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
    noise_launches({"stacked": 3}, "TSU pallas")
    ms_cycle = driver.history[-1]["t_step"] * 1e3
    print(f"pallas: ms/cycle {ms_cycle:.2f} (one chunk of 3 cycles) "
          f"[{smi}]")
    print(f"pallas: acceptance by dimension {driver.acceptance_ratios()}")
    print(f"pallas: launches {launches}, bonded variants {variants}")
    check(launches == {"chain_forces": 33, "nonbonded": 33,
                       "fused_baoab": 0, "exchange_matrix": 0,
                       "nonbonded_sparse": 0, "nlist_build": 0,
                       "lj_fluid": 0, "flash_attention": 0,
                       "cell_build": 0}
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
        got_b = nl_ops.nlist_build_batched(pos, flag, old, pk.mask_bits,
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
    got_b = nl_ops.nlist_build_batched(pos, None, None, pk.mask_bits,
                                       engine.r_list, K_LOW)
    want_b = nl_ops.build_gated_plain(pos, None, None, pk.nb_mask,
                                      engine.r_list, K_LOW)
    same = all(torch.equal(a, b) for a, b in zip(got_b, want_b))
    print(f"{tag} build with k_max={K_LOW}: bitwise equal {same}, dropped "
          f"{int(got_b[2].sum())} pairs")
    check(same and int(got_b[2].min()) > 0,
          f"build kernel vs plain with dropped pairs at R={n_rep}")
    # a random gas in a 60 A box: no locality in the atom order, so the
    # cull keeps many more tiles; the lists must not change
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gas = 60.0 * torch.rand(pos.shape, device="cuda", generator=gen)
    for name, flag in flags.items():
        got_b = nl_ops.nlist_build_batched(gas, flag, old, pk.mask_bits,
                                           engine.r_list, engine.k_max)
        want_b = nl_ops.build_gated_plain(gas, flag, old, pk.nb_mask,
                                          engine.r_list, engine.k_max)
        same = all(torch.equal(a, b) for a, b in zip(got_b, want_b))
        print(f"{tag} build on a random gas (60 A box), {name}: bitwise "
              f"equal {same}, dropped {int(got_b[2].sum())}")
        check(same, f"build kernel vs plain on a gas ({name}) at R={n_rep}")
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
            lambda: nl_ops.nlist_build_batched(pos, on, old, pk.mask_bits,
                                               *b),
            lambda: nl_ops.build_gated_plain(pos, on, old, pk.nb_mask, *b),
            3),
        "nlist_build (flag 0)": (
            lambda: nl_ops.nlist_build_batched(pos, off, old, pk.mask_bits,
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
    """(bound_ms, bound_by) of the sparse kernel and the build kernels at
    this run's list: the sparse pass needs each unordered pair within the
    cutoff once (PAIR_OPS) and a distance test of each listed pair past
    it; the build reads the positions and writes the list and dropped
    (its bytes: a culled build does not test every pair, so the O(N^2)
    figure of a distance test per unexcluded pair is printed as "all
    pairs", not taken as the bound); the build with flag 0 only reads and
    writes the list."""
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
        # positions in; the list and dropped out
        "nlist_build": (stack + table + n_rep * 4, 0),
        "nlist_build (flag 0)": (4 + 2 * table + n_rep * 4, 0),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
        print(f"{name} bound: {nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP "
              f"-> {out[name][0]:.5f} ms ({out[name][1]})")
    all_ops = n_rep * n_pairs * DIST_TEST_OPS
    print(f"nlist_build, all pairs (a distance test of each of {n_pairs} "
          f"unexcluded unordered pairs per replica, not the bound): "
          f"{all_ops / 1e9:.4f} GFLOP -> "
          f"{all_ops / FP32_FLOPS_PER_S * 1e3:.5f} ms")
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
        noise_launches({"unrolled": n_cycles * 11} if path == "fused"
                       else {"stacked": n_cycles}, f"TSU sparse {tag}")
        evals = n_cycles * 11
        want = {"chain_forces": evals, "nonbonded": 0, "fused_baoab": 0,
                "exchange_matrix": n_cycles if scheme == "matrix" else 0,
                "nonbonded_sparse": evals + n_cycles, "nlist_build": evals,
                "lj_fluid": 0, "flash_attention": 0, "cell_build": 0}
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
            ("nlist_build", r"nlist_(prep|build)_kernel", 11),
            ("chain_forces (bias)", r"(?<!non)bonded_(block|energy)_kernel",
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
    for dev in ("cuda", "cpu"):
        seen, restore = metropolis_spy()
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
            restore()
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
        print_margins(runs, 0, 4)
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
    """The forces and energy kernels at R = 1 and argon's density
    (Rahman's 864 atoms in 34.8 A) for each N of LJ_BIG, after 10 MD
    steps, against their plain versions within TOL_LJ_FORCE and
    TOL_LJ_ENERGY (the forces' partial rows live in device memory at
    every N; the energy's sums are per tile entry, per block, then block
    by block)."""
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
        e_k = nb_ops.lj_energy_batched(pos, *args)
        ee = rel(e_k, nb_ops.ref.lj_energy(pos, *args))
        print(f"N={n} R=1: energy {ee:.2e} (tol {TOL_LJ_ENERGY})")
        check(ee <= TOL_LJ_ENERGY and bool(torch.isfinite(e_k).all()),
              f"N={n}: energy kernel vs plain")


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
            ("lj_energy", r"lj_energy_(pairs|combine)_kernel", 2)):
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
    backup, fail_key = driver._start_carry(ens)
    for guarded in (True, False, True, False):
        guard = (driver._no_host_sync() if guarded
                 else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with guard:
            driver._chunk(ens, backup, fail_key, 16)
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
    for dev in ("cuda", "cpu"):
        seen, restore = metropolis_spy()
        try:
            small = lj_engine(64, 12.0, dev)
            driver = REMDDriver(small, lj_cfg(8, 4), device=dev)
            ens = driver.run_fused(driver.init(SEED), chunk_cycles=2)
        finally:
            restore()
        runs[dev] = ([h["assignment"].tolist() for h in driver.history],
                     driver.acceptance_ratios(), ens.state["pos"].cpu(),
                     seen)
    same = runs["cuda"][:2] == runs["cpu"][:2]
    dpos = float((runs["cuda"][2] - runs["cpu"][2]).abs().max())
    print(f"small LJ run (R=8, N=64, box 12 A, 4 cycles) cuda vs cpu: "
          f"decisions identical {same}, max |dpos| {dpos:.2e} A (tol "
          f"{TOL_SMALL_POS})")
    if not same:
        print_margins(runs, 0, 3)
    check(same and dpos <= TOL_SMALL_POS, "LJ cuda run makes the CPU run's "
                                          "decisions")



def fa_cases():
    """Phase 19's cases: (dtype, mask, H / G, S = T, D, B, H, softcap,
    Dv); Dv = D but in the fifteenth slice's cases."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window in ((True, 0), (False, 0), (True, 64)):
            for rep in (1, 2, 4, 8):
                for s in (16, 100, 2048):
                    for d in (16, 64, 128):
                        cases.append((dtype, causal, window, rep, s, d, 1, 8,
                                      0.0, d))
    # the OLMo-1B prefill shape, and the energy evaluations of phase 34
    # (OLMo-1B) and 34b (the float32 smoke preset)
    cases.append((torch.bfloat16, True, 0, 1, LM_PROMPT, 128, LM_BATCH, 16,
                  0.0, 128))
    cases.append((torch.bfloat16, True, 0, 1, 64, 128, 8, 16, 0.0, 128))
    cases.append((torch.float32, True, 0, 1, 64, 32, 8, 4, 0.0, 32))
    for dtype in (torch.float32, torch.bfloat16):
        for window in (0, 64):
            for rep in (1, 4):
                for s in (100, 2048):
                    for d in (64, 128):
                        cases.append((dtype, True, window, rep, s, d, 1, 8,
                                      FA_SOFTCAP, d))
    # the fifteenth slice: MLA's prefill (D 192, Dv 128, H = G = 16) and
    # RecurrentGemma's local attention (D = Dv = 256, one kv head, window
    # 2048, softcap 30) at the served shape; then a small-S sweep with a
    # window and the softcap, q/k and v head dims apart either way
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((dtype, True, 0, 1, LM_PROMPT, 192, LM_BATCH, 16, 0.0,
                      128))
        cases.append((dtype, True, LM_PROMPT, 16, LM_PROMPT, 256, LM_BATCH,
                      16, FA_SOFTCAP, 256))
        for d, dv in FA_WIDE_DIMS:
            for rep in (1, 16):
                for s in (16, 100, 300):
                    cases.append((dtype, True, 64, rep, s, d, 1, 16,
                                  FA_SOFTCAP, dv))
    return cases


def fa_inputs(dtype, rep, s, d, b, h, seed=SEED, dv=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, h // rep, d), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((b, s, h // rep, dv or d), generator=gen,
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
    absolute error at the served prefill shapes (B = 4, S = 2048,
    bfloat16: OLMo-1B's, MLA's, RecurrentGemma's)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    worst, used = {}, {}
    err_olmo, err_served = None, 0.0
    fa_ops.LIBRARY.reset()
    for dtype, causal, window, rep, s, d, b, h, cap, dv in fa_cases():
        q, k, v = fa_inputs(dtype, rep, s, d, b, h, dv=dv)
        if cap:
            q = FA_SOFTCAP_Q * q
        got = fa_ops.flash_attention_kernel(q, k, v, causal=causal,
                                            window=window, softcap=cap)
        want = fa_ops.ref.attention(q, k, v, causal=causal, window=window,
                                    softcap=cap)
        e = rel(got.float(), want.float())
        u = fa_allowance_used(got, want, dtype)
        tag = (f"{str(dtype)[6:]} causal={causal} window={window} H/G={rep} "
               f"S=T={s} D={d} Dv={dv} B={b} H={h} softcap={cap}")
        check(got.dtype == dtype and bool(torch.isfinite(got).all())
              and u <= 1.0, f"flash_attention vs plain: {tag}: {u:.3f} of "
                            f"the allowance (max |diff| / max |plain| "
                            f"{e:.2e})")
        key = str(dtype)[6:] + (f" softcap {cap}" if cap else "") + (
            f" D {d} Dv {dv}" if (d, dv) in FA_WIDE_DIMS else "")
        worst[key] = max(worst.get(key, 0.0), e)
        used[key] = max(used.get(key, 0.0), u)
        if s == LM_PROMPT and b == LM_BATCH and dtype == torch.bfloat16:
            err_served = max(err_served, float(
                (got.float() - want.float()).abs().max()))
        if s == LM_PROMPT and b == LM_BATCH and d > 128:
            print(f"fifteenth-slice prefill shape {tag}: max |diff| / max "
                  f"|plain| {e:.2e}, {u:.3f} of the allowance")
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
    print(f"max |diff| at the served prefill shapes {err_served:.3e} "
          f"(OLMo-1B's {err_olmo:.3e})")
    return err_served


def attention_work(b: int, s: int, t: int, h: int, g: int, d: int,
                   dv: int, causal: bool, elem: int):
    """(operations, bytes) of attention at these shapes: 2 B H (D + Dv)
    x the kept (query, key) pairs (query i keeps keys 0..i when causal,
    else all T); q, k, v, out read or written once."""
    kept = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    ops = 2 * b * h * (d + dv) * kept
    nbytes = (b * s * h * (d + dv) + b * t * g * (d + dv)) * elem
    return ops, nbytes


def bound_of(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations at the bf16
    tensor-core rate and the bytes at the memory rate."""
    t_ops, t_bytes = ops / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bounds_fifth(b: int, s: int, h: int, g: int, d: int, elem: int,
                 dv: int = 0):
    """(bound_ms, bound_by) of causal attention at these shapes, S = T
    (``attention_work``; a window of S or more keeps every pair)."""
    dv = dv or d
    ops, nbytes = attention_work(b, s, s, h, g, d, dv, True, elem)
    t_ops, t_bytes = ops / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound = bound_of(ops, nbytes)
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


# Phase 20's fifteenth-slice prefill shapes of kernel 8: (tag, D, Dv, kv
# heads, window, softcap), B = 4, S = 2048, H = 16, bfloat16, causal
FA_WIDE_SHAPES = (("DeepSeek-V2-Lite MLA", 192, 128, 16, 0, 0.0),
                  ("RecurrentGemma-9B local", 256, 256, 1, LM_PROMPT,
                   FA_SOFTCAP),
                  ("RecurrentGemma-9B local, no softcap", 256, 256, 1,
                   LM_PROMPT, 0.0))


def timing_wide(smi: str) -> dict:
    """Phase 20 at the fifteenth slice's prefill shapes: the kernel's
    device time (graph replays), the plain version's, the bound, and
    ``scaled_dot_product_attention`` where it computes the same function
    (no softcap; a window of S keys or more is the causal mask alone).
    Returns {tag: (kernel ms, plain ms, bound ms, bound by, library ms or
    None)}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    phase(f"20b timing at the MLA and RecurrentGemma prefill shapes (B="
          f"{LM_BATCH}, S={LM_PROMPT}, H=16, bfloat16, causal)")
    out = {}
    for tag, d, dv, g, window, cap in FA_WIDE_SHAPES:
        q, k, v = fa_inputs(torch.bfloat16, 16 // g, LM_PROMPT, d, LM_BATCH,
                            16, dv=dv)
        kw = dict(causal=True, window=window, softcap=cap)
        k_ms = graph_ms(lambda: fa_ops.flash_attention_kernel(q, k, v, **kw),
                        calls=5)
        p_ms = median_ms(lambda: fa_ops.ref.attention(q, k, v, **kw), 5, 1)
        lib_ms = None
        if not cap:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            lib_ms = graph_ms(sdpa, calls=5)
            u_lib = fa_allowance_used(sdpa().transpose(1, 2),
                                      fa_ops.ref.attention(q, k, v, **kw),
                                      torch.bfloat16)
        bound = bounds_fifth(LM_BATCH, LM_PROMPT, 16, g, d, 2, dv=dv)[
            "flash_attention"]
        lib = ("none (no softcap in scaled_dot_product_attention)"
               if lib_ms is None else
               f"{lib_ms:.4f} ms (its share of phase 19's allowance "
               f"{u_lib:.3f})")
        print(f"{tag} (D={d}, Dv={dv}, G={g}, window={window}, softcap="
              f"{cap}): kernel {k_ms:.4f} ms device (graph replay), plain "
              f"{p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
              f"{bound[0] / k_ms:.4f} of it; scaled_dot_product_attention "
              f"{lib} [{smi}]")
        out[tag] = (k_ms, p_ms, bound[0], bound[1], lib_ms)
        del q, k, v
    return out


# The seventeenth slice's shapes of kernel 8, bfloat16 (phase 19c): (tag,
# B, S, T, H, G, D = Dv, causal, launches a prefill, launches a decode
# step).  Whisper-small's encoder (causal, as the JAX package's) at its
# 1,500 frames, 23 whole 64-key tiles and a tail of 28; its decoder's self
# attention; its cross attention, S queries against the 1,500 encoder
# keys, no mask, in prefill and in decode (one live row of a 64-row
# q-tile); InternVL2-26B's prefill, 2048 prompt + 256 image tokens, GQA
# 48 / 8.
FA_SERVE_SHAPES = (
    ("Whisper encoder", 4, 1500, 1500, 12, 12, 64, True, 12, 0),
    ("Whisper decoder self", 4, LM_PROMPT, LM_PROMPT, 12, 12, 64, True, 12,
     0),
    ("Whisper cross, prefill", 4, LM_PROMPT, 1500, 12, 12, 64, False, 12, 0),
    ("Whisper cross, decode", 4, 1, 1500, 12, 12, 64, False, 0, 12),
    ("InternVL2 prefill", 4, LM_PROMPT + 256, LM_PROMPT + 256, 48, 8, 128,
     True, 48, 0))


def serve_shapes(smi: str) -> tuple:
    """Phase 19c: kernel 8 at ``FA_SERVE_SHAPES`` against its plain version
    (phase 19's per-element allowance) in bfloat16, the Whisper shapes in
    float32 too; in bfloat16 the kernel's device time (graph replays),
    the plain version's, the bound and ``scaled_dot_product_attention``'s
    (``is_causal`` where the shape is causal, S = T; no mask elsewhere).
    Returns (the max absolute error in bfloat16, {tag: (kernel ms, plain
    ms, bound ms, bound by, library ms)})."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    phase("19c kernel 8 at the encdec and vlm shapes (Whisper-small: T = "
          "1500, cross attention S != T without a mask, one decode row; "
          "InternVL2-26B: S = 2304, H/G = 6)")
    worst, out = 0.0, {}
    for tag, b, s, t, h, g, d, causal, n_pre, n_tok in FA_SERVE_SHAPES:
        kw = dict(causal=causal)
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.float32 and h != g:
                continue    # InternVL2 serves in bfloat16 alone
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
                dtype) for shape in ((b, s, h, d), (b, t, g, d), (b, t, g, d)))
            got = fa_ops.flash_attention_kernel(q, k, v, **kw)
            want = fa_ops.ref.attention(q, k, v, **kw)
            u = fa_allowance_used(got, want, dtype)
            err = float((got.float() - want.float()).abs().max())
            print(f"{tag} {str(dtype)[6:]}: q {tuple(q.shape)}, k, v "
                  f"{tuple(k.shape)}, causal={causal}: {u:.3f} of the "
                  f"allowance, max |diff| {err:.3e}, max |diff| / max "
                  f"|plain| {rel(got.float(), want.float()):.2e}")
            check(got.shape == (b, s, h, d) and got.dtype == dtype and
                  bool(torch.isfinite(got).all()) and u <= 1.0,
                  f"flash_attention vs plain: {tag} {str(dtype)[6:]}")
            del want
        worst = max(worst, err)
        k_ms = graph_ms(lambda: fa_ops.flash_attention_kernel(q, k, v, **kw),
                        calls=5)
        p_ms = median_ms(lambda: fa_ops.ref.attention(q, k, v, **kw), 5, 1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
        lib_ms = graph_ms(sdpa, calls=5)
        u_lib = fa_allowance_used(sdpa().transpose(1, 2),
                                  fa_ops.ref.attention(q, k, v, **kw),
                                  torch.bfloat16)
        ops, nbytes = attention_work(b, s, t, h, g, d, d, causal, 2)
        bound = bound_of(ops, nbytes)
        print(f"{tag}: kernel {k_ms:.4f} ms device (graph replay), plain "
              f"{p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}: "
              f"{ops:.4e} operations, {nbytes / 1e6:.1f} MB), "
              f"{bound[0] / k_ms:.4f} of it; scaled_dot_product_attention "
              f"{lib_ms:.4f} ms (its share of the allowance {u_lib:.3f}); "
              f"launches on the served path {n_pre} a prefill, {n_tok} a "
              f"decode step [{smi}]")
        out[tag] = (k_ms, p_ms, bound[0], bound[1], lib_ms)
        del q, k, v, qt, kt, vt
    return worst, out


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
    for arch in ("olmo_1b", "phi3_medium_14b"):
        serve_card_vs_cpu(arch)


# The sixth slice: the driver's asynchronous pattern, Mode II and fault
# tolerance at full width.  Phase 23: the oracle force paths against the
# analytic one after one propagate of 10 steps from the same state and
# keys — the same float32 forces through autograd instead of the analytic
# passes, about 1e-6 of max |F| apart per evaluation (3e-5 A and 7.5e-4
# A/ps after 10 steps on the CPU at N = 512).
TOL_ORACLE = {"pos": 1e-3, "vel": 1e-2}
# Phase 24: T-REMD 64 under the asynchronous pattern (the paper's Fig 1b
# straggler scenario): a window of 0.5 x 10 steps, at most 10, so every
# cycle is 11 force evaluations, as phase 5's; faults at 5 % a replica a
# cycle, escalation budget 2; a checkpoint each chunk of 4.
ASYNC = dict(pattern="asynchronous", async_window=0.5, relaunch_budget=2)
FAIL_RATE = 0.05


def oracle_paths(smi: str) -> None:
    phase(f"23 oracle force paths: batched and vmap vs pallas at R=4, "
          f"N={N_ATOMS}")
    from repro_torch import random as jr
    from repro_torch.config import RepExConfig
    from repro_torch.core.controls import build_grid, ctrl_for_assignment
    from repro_torch.core.modes import per_replica_keys
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    system = chain_molecule(N_ATOMS)
    engines = {"pallas": MDEngine(system, device="cuda"),
               "batched": MDEngine(system, force_path="batched",
                                   device="cuda"),
               "vmap": MDEngine(system, batched=False, device="cuda")}
    grid = build_grid(RepExConfig(dimensions=(("temperature", 4),)), "cuda")
    state = engines["pallas"].init_state(jr.key(SEED, "cuda"), 4)
    ctrl = ctrl_for_assignment(grid, torch.arange(4, device="cuda"))
    keys = per_replica_keys(jr.key(SEED + 1, "cuda"), 4)
    n_steps = torch.full((4,), 10, dtype=torch.int64, device="cuda")
    out = {}
    for name, eng in engines.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[name] = eng.propagate(state, ctrl, n_steps, keys, max_steps=10)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"{name}: one propagate of 10 steps {ms:.1f} ms (first call), "
              f"peak memory above the state {peak:.3f} GiB [{smi}]")
    for name in ("batched", "vmap"):
        d = {k: float((out[name][k] - out["pallas"][k]).abs().max())
             for k in ("pos", "vel")}
        print(f"{name} vs pallas: max |dpos| {d['pos']:.2e} A, max |dvel| "
              f"{d['vel']:.2e} A/ps (tol {TOL_ORACLE})")
        check(all(d[k] <= TOL_ORACLE[k] for k in d),
              f"the {name} oracle agrees with the analytic path")
        check(bool(torch.isfinite(out[name]["pos"]).all()),
              f"{name}: finite positions")


def async_faults(libs, smi: str) -> None:
    """Phase 24: T-REMD 64 x 2881 under the asynchronous pattern with
    failure injection and escalation, a checkpoint each chunk; then kill
    and resume bitwise."""
    phase(f"24 async + faults + checkpoint: T-REMD {R_MAIN} x {N_ATOMS}, "
          f"{ASYNC}, failure_rate {FAIL_RATE}")
    import tempfile
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.core.ensemble import control_multiset_ok
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    cfg = RepExConfig(dimensions=(("temperature", R_MAIN),),
                      md_steps_per_cycle=10, n_cycles=8, **ASYNC)
    engine = MDEngine(chain_molecule(N_ATOMS), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        def driver_():
            return REMDDriver(engine, cfg, ckpt_dir=tmp, ckpt_every=4,
                              failure_rate=FAIL_RATE, device="cuda")
        driver = driver_()
        ens = driver.init(SEED)
        torch.cuda.synchronize()
        reset(libs)
        ens = driver.run_fused(ens, chunk_cycles=4)
        launches = {lib.name: lib.launches for lib in libs}
        hist = driver.history
        ms_cycle = hist[-1]["t_step"] * 1e3
        ready = [h["ready_frac"] for h in hist]
        esc = {k: sum(h[k] for h in hist)
               for k in ("failed", "esc_relaunch", "esc_reinit", "esc_dead")}
        print(f"ms/cycle {ms_cycle:.2f} (last chunk of 4) [{smi}]")
        print(f"ready_frac by cycle {[round(r, 4) for r in ready]}, mean "
              f"{statistics.mean(ready):.4f}")
        print(f"failures and escalations over 8 cycles {esc}; alive "
              f"{int(ens.alive.sum())}/{R_MAIN}")
        want = dict.fromkeys(launches, 0)
        want.update(chain_forces=cfg.n_cycles * 11,
                    nonbonded=cfg.n_cycles * 11)
        print(f"launches {launches} (want {want})")
        check(launches == want, "each per-pass kernel 8 cycles x 11")
        check(min(ready) < 1.0, "stragglers: some cycles not all ready")
        check(esc["failed"] > 0, "failures were injected and detected")
        check(control_multiset_ok(ens), "assignment is a permutation")
        alive = ens.alive
        check(bool(torch.isfinite(ens.state["pos"][alive]).all()),
              "every live replica finite after recovery")
        steps = sorted(os.listdir(tmp))
        print(f"checkpoints {steps}")
        check("step-00000003" in steps and "step-00000007" in steps,
              "a checkpoint after each chunk")
        step_dir = os.path.join(tmp, "step-00000003")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))

        resumed = driver_()
        out = resumed.resume(via="fused", chunk_cycles=4, step=3)
        same_rows = all(
            a["assignment"].tolist() == b["assignment"].tolist()
            and all(a[k] == b[k] for k in ("accept", "failed", "ready_frac",
                                           "esc_relaunch", "esc_reinit",
                                           "esc_dead"))
            for a, b in zip(resumed.history[4:], hist[4:]))
        same_state = all(torch.equal(out.state[k][alive], ens.state[k][alive])
                         for k in ("pos", "vel")) and all(
            torch.equal(getattr(out, k), getattr(ens, k))
            for k in ("debt", "alive", "relaunches", "failures", "rng"))
        print(f"resume from the checkpoint after cycle 4 (step 3): last 4 "
              f"rows identical {same_rows}, final state bitwise equal "
              f"{same_state}")
        check(len(resumed.history) == 8 and same_rows and same_state,
              "kill then resume is bitwise")

        payload = driver._ckpt_payload(ens, ens.state, ens.rng)
        like = resumed._ckpt_payload(out, out.state, out.rng)
        save_ms, load_ms = [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(os.path.join(tmp, "timing"), i, payload,
                            driver._ckpt_extra())
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            load_checkpoint(tmp, like, step=3)
            torch.cuda.synchronize()
            load_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"checkpoint: save {statistics.median(save_ms):.1f} ms, load "
              f"{statistics.median(load_ms):.1f} ms (medians of 3), "
              f"{nbytes} bytes on disk per checkpoint [{smi}]")

    # the busy share, from a driver without checkpoints (the same chunk)
    probe = REMDDriver(engine, cfg, failure_rate=FAIL_RATE, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        probe.run_fused(ens, n_cycles=2, chunk_cycles=2)
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / 2
    print(f"profiled chunk: device kernel time {busy:.2f} ms/cycle, busy "
          f"share of the measured ms/cycle {busy / ms_cycle:.3f}")


def mode2_runs(libs, smi: str) -> None:
    """Phase 25: Mode II (waves) against Mode I, bitwise, on the three
    full-width paths."""
    phase("25 Mode II vs Mode I at full width, 4 cycles each")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    cases = (
        (f"T-REMD {R_MAIN} x {N_ATOMS} pallas",
         MDEngine(chain_molecule(N_ATOMS), device="cuda"),
         RepExConfig(dimensions=(("temperature", R_MAIN),),
                     md_steps_per_cycle=10, n_cycles=4), 24,
         (("chain_forces", None), ("nonbonded", None))),
        (f"TSU {R_TSU} x {N_ATOMS} fused", tsu_engine("fused"),
         RepExConfig(dimensions=TSU_DIMS, md_steps_per_cycle=10,
                     n_cycles=4), 128, (("fused_baoab", None),)),
        (f"LJ {R_MAIN} x {LJ_ATOMS}", lj_engine(), lj_cfg(R_MAIN, 4), 24,
         (("lj_fluid", "forces"),)))

    def counts(kernels):
        """Launches of the propagate kernels (a library, or one of its
        variants): a wave launches them once per force evaluation."""
        by = {lib.name: lib for lib in libs}
        return {f"{n}:{v}" if v else n: (by[n].launches if v is None
                                          else by[n].variants.get(v, 0))
                for n, v in kernels}

    for tag, engine, cfg, slots, kernels in cases:
        res, dev_ms = {}, {}
        for mode, sl in (("mode1", None), ("mode2", slots)):
            driver = REMDDriver(engine, cfg, slots=sl, device="cuda")
            ens = driver.init(SEED)
            torch.cuda.synchronize()
            reset(libs)
            ens = driver.run_fused(ens, chunk_cycles=2)
            res[mode] = (driver, ens, counts(kernels),
                         driver.history[-1]["t_step"] * 1e3)
            # device time of one more cycle, from a driver of its own
            probe = REMDDriver(engine, cfg, slots=sl, device="cuda")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                probe.run_fused(ens, n_cycles=1, chunk_cycles=1)
            dev_ms[mode] = sum(e.device_time_total for e in prof.events()
                               if e.device_type == DeviceType.CUDA) / 1e3
        (d1, e1, l1, ms1), (d2, e2, l2, ms2) = res["mode1"], res["mode2"]
        waves = d2.execution["n_waves"]
        same_rows = ([h["assignment"].tolist() for h in d1.history]
                     == [h["assignment"].tolist() for h in d2.history])
        same_state = all(torch.equal(e1.state[k], e2.state[k])
                         for k in ("pos", "vel"))
        want2 = {k: v * waves for k, v in l1.items()}
        print(f"{tag}: slots {slots} -> {d2.execution}; rows identical "
              f"{same_rows}, positions and velocities bitwise equal "
              f"{same_state}")
        print(f"{tag}: ms/cycle Mode I {ms1:.2f}, Mode II {ms2:.2f} (last "
              f"chunk of 2); device kernel time of a profiled cycle Mode I "
              f"{dev_ms['mode1']:.2f}, Mode II {dev_ms['mode2']:.2f} ms "
              f"[{smi}]; propagate launches Mode I {l1}, Mode II {l2} "
              f"(want {want2})")
        check(d2.execution["mode"] == "mode2" and waves == 3,
              f"{tag}: three waves")
        check(all(l2[k] == want2[k] > 0 for k in l1),
              f"{tag}: each wave launches the path's kernels")
        check(same_rows and same_state, f"{tag}: Mode II bitwise Mode I")


def async_against_cpu() -> None:
    """Phase 26: async + faults + escalation under Mode II (3 waves) on
    the card and on the CPU: the same decisions."""
    phase(f"26 card vs CPU: R=8, N={N_ATOMS}, asynchronous, faults, "
          f"escalation, Mode II with 3 waves, 6 cycles")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    # a 1-step window (at most 2): three force evaluations per cycle keep
    # the CPU's all-pairs oracle at N = 2881 to seconds per cycle
    cfg = RepExConfig(dimensions=(("temperature", 8),), md_steps_per_cycle=2,
                      n_cycles=6, pattern="asynchronous", async_window=0.5,
                      relaunch_budget=1)
    runs = {}
    for dev in ("cuda", "cpu"):
        seen, restore = metropolis_spy()
        try:
            driver = REMDDriver(MDEngine(chain_molecule(N_ATOMS), device=dev),
                                cfg, slots=3, failure_rate=0.15, device=dev)
            t0 = time.perf_counter()
            ens = driver.run_fused(driver.init(SEED), chunk_cycles=3)
            wall = time.perf_counter() - t0
        finally:
            restore()
        hist = driver.history
        runs[dev] = ([h["assignment"].tolist() for h in hist],
                     [(h["failed"], h["esc_relaunch"], h["esc_reinit"],
                       h["esc_dead"], h["ready_frac"]) for h in hist],
                     driver.acceptance_ratios(), ens, seen)
        print(f"{dev}: {driver.execution}, {wall:.1f} s; per cycle (failed, "
              f"relaunch, reinit, dead, ready_frac) {runs[dev][1]}")
    same = runs["cuda"][:3] == runs["cpu"][:3]
    e_gpu, e_cpu = runs["cuda"][3], runs["cpu"][3]
    alive = e_cpu.alive
    dpos = float((e_gpu.state["pos"].cpu()[alive]
                  - e_cpu.state["pos"][alive]).abs().max())
    print(f"decisions, failures and escalations identical {same}, max |dpos| "
          f"over live replicas {dpos:.2e} A (tol {TOL_SMALL_POS})")
    if not same:
        print_margins(runs, 0, 4)
    check(sum(f[0] for f in runs["cpu"][1]) > 0, "failures were injected")
    check(same and dpos <= TOL_SMALL_POS, "the card makes the CPU's "
                                          "decisions")


# The seventh slice: the cell-list build, observability and the CLI.
# The cell build's gas is a random gas at the LJ fluid's density (Rahman's
# 864 atoms in a 34.8 A box, 0.0205 / A^3) of N_GAS atoms, where
# suggest_build_method picks "cell" (cells at the engine's r_list of
# 9 + 1.5 A); R_GAS replicas, which the plain version builds one at a time
# (~4 GB of candidate planes each); k_max above the largest neighbor count
# (~100 on average at this density).
GAS_DENSITY = 864 / 34.8 ** 3
N_GAS, R_GAS = 20000, 4
GAS_R_LIST, GAS_K_MAX = 10.5, 160
# The telemetry phase: the CUDA launches of the main path's chunk with
# telemetry off must equal phase 5's (the same run), and the fetches per
# chunk stay one with it on.
OBS_CHUNK = 4


@contextlib.contextmanager
def counting_fetches():
    """Counts ``Tensor.cpu`` calls (the driver's per-chunk fetch) while
    the block runs."""
    orig, box = torch.Tensor.cpu, [0]

    def cpu(self, *args, **kwargs):
        box[0] += 1
        return orig(self, *args, **kwargs)

    torch.Tensor.cpu = cpu
    try:
        yield box
    finally:
        torch.Tensor.cpu = orig


def print_eq1(tag: str, report, ms_cycle: float, smi: str) -> None:
    eq1 = report.phases["eq1"]
    terms = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in eq1.items())
    print(f"{tag}: Eq. (1) split, ms per cycle: {terms}; measured ms/cycle "
          f"{ms_cycle:.2f} (last chunk), mean over the run "
          f"{report.phases['t_cycle_mean'] * 1e3:.2f}; phase means "
          + ", ".join(f"{k} {v * 1e3:.3f}"
                      for k, v in report.phases["means"].items())
          + f" ms ({report.phases['samples']} samples) [{smi}]")


def observability(libs, launches5: dict, smi: str):
    """Phase 27: telemetry on and off at full width, T-REMD 64 and TSU 384
    fused with the matrix scheme: bitwise the same runs, the off run's
    launches phase 5's, one fetch per chunk, a valid report and its
    Eq. (1) split.  Returns the T-REMD report (phase 30's reference)."""
    phase(f"27 observability: T-REMD {R_MAIN} x {N_ATOMS} and TSU {R_TSU} "
          f"fused matrix, run_fused, telemetry on and off")
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    from repro_torch.obs import Telemetry, validate_report
    cases = (
        ("T-REMD 64", MDEngine(chain_molecule(N_ATOMS), device="cuda"),
         RepExConfig(dimensions=(("temperature", R_MAIN),),
                     md_steps_per_cycle=10, n_cycles=8), OBS_CHUNK),
        ("TSU 384 fused matrix", tsu_engine("fused"),
         RepExConfig(dimensions=TSU_DIMS, md_steps_per_cycle=10,
                     n_cycles=4, exchange_scheme="matrix"), 2))
    out = {}
    for tag, engine, cfg, chunk in cases:
        runs = {}
        for mode, tel in (("off", None),
                          ("on", Telemetry(phase_probe_every=1))):
            driver = REMDDriver(engine, cfg, device="cuda", telemetry=tel)
            ens = driver.init(SEED)
            reset(libs)
            with counting_fetches() as fetches:
                ens = driver.run_fused(ens, chunk_cycles=chunk)
            runs[mode] = dict(driver=driver, ens=ens, fetches=fetches[0],
                              launches={lib.name: lib.launches
                                        for lib in libs},
                              ms=driver.history[-1]["t_step"] * 1e3)
        n_chunks = cfg.n_cycles // chunk
        on, off = runs["on"], runs["off"]
        same_rows = ([h["assignment"].tolist() for h in on["driver"].history]
                     == [h["assignment"].tolist()
                         for h in off["driver"].history])
        same_state = all(torch.equal(on["ens"].state[k], off["ens"].state[k])
                         for k in ("pos", "vel"))
        per_chunk = {k: v / n_chunks for k, v in off["launches"].items()}
        added = {k: (on["launches"][k] - v) / n_chunks
                 for k, v in off["launches"].items()
                 if on["launches"][k] != v}
        report = on["driver"].last_report
        print(f"{tag}: rows identical {same_rows}, positions and velocities "
              f"bitwise equal {same_state}")
        print(f"{tag}: launches per chunk, telemetry off {per_chunk}; added "
              f"by telemetry (the phase probes) {added}; fetches per chunk "
              f"off {off['fetches'] / n_chunks}, on "
              f"{on['fetches'] / n_chunks}; every chunk under "
              f"set_sync_debug_mode('error')")
        print_eq1(tag, report, on["ms"], smi)
        print(f"{tag}: ms/cycle telemetry off {off['ms']:.2f}, on "
              f"{on['ms']:.2f} (last chunk) [{smi}]")
        if tag == "T-REMD 64":
            want = {k: v / 2 for k, v in launches5.items()}
        else:
            want = dict.fromkeys(per_chunk, 0)
            want.update(fused_baoab=11 * chunk, exchange_matrix=chunk)
        check(same_rows and same_state, f"{tag}: telemetry on and off "
                                        f"bitwise")
        check(per_chunk == want, f"{tag}: telemetry off launches {want} per "
                                 f"chunk")
        check(on["fetches"] == off["fetches"] == n_chunks,
              f"{tag}: one fetch per chunk with telemetry on and off")
        validate_report(report.to_dict())
        validate_report(off["driver"].last_report.to_dict())
        has_rows = report.exchange["pair_attempt"] is not None
        check(has_rows == (cfg.exchange_scheme == "neighbor")
              and report.phases["samples"] == n_chunks
              and report.cycles == {"total": cfg.n_cycles,
                                    "counted": cfg.n_cycles}
              and report.meta["backend"] == "cuda",
              f"{tag}: the report's pair rows, samples and cycles")
        out[tag] = report
    return out["T-REMD 64"]


def gas_mask(n_atoms: int):
    """(mask bits, dense uint8 mask) of a gas: every pair but the
    diagonal."""
    from repro_torch.kernels.lj_forces import ops as nb_ops
    mask = 1 - torch.eye(n_atoms, dtype=torch.uint8, device="cuda")
    ld = nb_ops.pad_to_block(n_atoms, nb_ops.TILE)
    u8 = torch.zeros((n_atoms, ld), dtype=torch.uint8, device="cuda")
    u8[:, :n_atoms] = mask
    return nb_ops.tile_flags(u8)[0], mask


def kept_list(pos, bits, r_list, k_max, cells):
    """A kept (idx, valid) for the gated builds: the cell build of
    ``pos`` stretched by 5% about the origin, so its pairs and their order
    differ from the list of ``pos`` (a shift would leave both the same)."""
    from repro_torch.kernels.nlist_build import ops as nl_ops
    return nl_ops.cell_build_batched(pos * 1.05, None, None, bits, r_list,
                                     k_max, *cells)[:2]


def cell_bitwise(tag, pos, bits, mask, r_list, k_max, cells) -> float:
    """The cell-build kernels against their plain version on ``pos``, in
    both flag states and a flag row (the kept list ``kept_list``'s, which
    the check shows differs from the fresh one): check them bitwise, return
    the largest difference."""
    from repro_torch.kernels.nlist_build import ops as nl_ops
    n_rep = pos.shape[0]
    on = torch.ones(1, dtype=torch.int32, device="cuda")
    off = torch.zeros(1, dtype=torch.int32, device="cuda")
    row = (torch.arange(n_rep, device="cuda") % 2).to(torch.int32)
    old = kept_list(pos, bits, r_list, k_max, cells)
    check(not torch.equal(old[0], nl_ops.cell_build_batched(
        pos, on, old, bits, r_list, k_max, *cells)[0]),
        f"{tag}: the kept list differs from the fresh one")
    err = 0.0
    for name, flag in (("flag 0", off), ("flag 1", on), ("flag row", row)):
        got = nl_ops.cell_build_batched(pos, flag, old, bits, r_list, k_max,
                                        *cells)
        want = nl_ops.build_gated_plain(pos, flag, old, mask, r_list, k_max,
                                        cells)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        e = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(got, want))
        err = max(err, e)
        print(f"{tag} cell build, {name}: bitwise equal {same}, dropped "
              f"{int(got[2].sum())}, valid slots {int(got[1].sum())}")
        check(same, f"{tag}: cell build kernel vs plain ({name})")
    return err


def cell_work(pos, r_list, k_max, cells, nw: int):
    """What a flag-1 cell build on ``pos`` must do, from this run's data:
    (bytes, pair tests, mask words, stencil candidates).  Bytes: positions
    in, the mask words (i, j >> 5) of the pairs within r_list (each
    distinct word once over all replicas), the list and dropped out.
    Pair tests: the ordered pairs within r_list, each of which a build
    has to test (distances formed in float32).  Stencil candidates: a
    row's in-grid stencil cells' kept atoms, from the run's own bins
    (``ref._bin_atoms``), what a build that culls nothing would test;
    printed beside the bound, not part of it."""
    from repro_torch.kernels import f32_square
    from repro_torch.kernels.nlist_build import ref
    (gx, gy, gz), cap = cells
    n_rep, n = pos.shape[:2]
    n_cells, dev = gx * gy * gz, pos.device
    r2 = f32_square(r_list)
    need = torch.zeros((n, nw), dtype=torch.bool, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    rows = max(1, (1 << 26) // (n * 3))
    for r in range(n_rep):
        p = pos[r].float()
        for a in range(0, n, rows):
            d = p[a:a + rows, None, :] - p[None, :, :]
            d = d * d
            within = (d[..., 0] + d[..., 1] + d[..., 2]) <= r2
            i = torch.arange(a, a + within.shape[0], device=dev)
            within[i - a, i] = False
            pairs += within.sum()
            pad = torch.nn.functional.pad(within, (0, nw * 32 - n))
            need[a:a + rows] |= pad.view(-1, nw, 32).any(-1)
    cc = ref._cell_coords(pos, r_list, (gx, gy, gz))
    cell_id = ((cc[..., 0] * gy + cc[..., 1]) * gz + cc[..., 2]).long()
    bins, _ = ref._bin_atoms(cell_id, n_cells, cap)     # (R, cells + 1, C)
    kept = (bins < n).sum(-1)                           # (R, cells + 1)
    dims = torch.tensor((gx, gy, gz), device=dev)
    c = torch.arange(n_cells, device=dev)
    own = torch.stack([c // (gy * gz), (c // gz) % gy, c % gz], -1)
    st = torch.from_numpy(ref._stencil((gx, gy, gz))).to(dev)
    ncc = own[:, None, :] + st                          # (cells, S, 3)
    in_grid = torch.all((ncc >= 0) & (ncc < dims), dim=-1)
    nid = torch.where(in_grid, (ncc[..., 0] * gy + ncc[..., 1]) * gz
                      + ncc[..., 2], n_cells)           # padding: cells
    per_cell = kept[:, nid].sum(-1)                     # (R, cells)
    candidates = int(torch.gather(per_cell, 1, cell_id).sum())
    mask_words = int(need.sum())
    nbytes = (n_rep * n * 3 * 4 + mask_words * 4
              + n_rep * n * k_max * (4 + 4) + n_rep * 4)
    return nbytes, int(pairs), mask_words, candidates


def cell_times(case, pos, bits, mask, r_list, k_max, cells, smi,
               dense: bool = False):
    """Device ms of the cell-build kernels on ``pos`` in both flag states
    (and of the dense build beside them where ``dense``), each beside its
    plain version, its time before the current design (BEFORE_MS,
    ``cell_build {case}``) and its bound: flag 1 the larger of the bytes
    and the pair tests of ``cell_work``, flag 0 its copy's bytes.  Flag
    1's split between its two CUDA kernels from profiled calls.  Returns
    (times, bounds) keyed by kernel name."""
    from repro_torch.kernels.nlist_build import ops as nl_ops
    n_rep, n = pos.shape[:2]
    on = torch.ones(1, dtype=torch.int32, device="cuda")
    off = torch.zeros(1, dtype=torch.int32, device="cuda")
    old = kept_list(pos, bits, r_list, k_max, cells)
    kernels = {
        "cell_build": lambda: nl_ops.cell_build_batched(
            pos, on, old, bits, r_list, k_max, *cells),
        "cell_build (flag 0)": lambda: nl_ops.cell_build_batched(
            pos, off, old, bits, r_list, k_max, *cells)}
    if dense:
        kernels.update({
            "dense build": lambda: nl_ops.nlist_build_batched(
                pos, on, old, bits, r_list, k_max),
            "dense build (flag 0)": lambda: nl_ops.nlist_build_batched(
                pos, off, old, bits, r_list, k_max)})
    table = n_rep * n * k_max * (4 + 4)
    nbytes, tests, words, candidates = cell_work(pos, r_list, k_max, cells,
                                                 bits.shape[1])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = tests * DIST_TEST_OPS / FP32_FLOPS_PER_S * 1e3
    need = {"cell_build": (max(t_bytes, t_ops),
                           "bytes" if t_bytes >= t_ops else "operations"),
            "cell_build (flag 0)": ((4 + 2 * table + n_rep * 4)
                                    / HBM_BYTES_PER_S * 1e3, "bytes")}
    print(f"{case} cell build, flag 1 bound: {nbytes / 1e6:.3f} MB "
          f"(positions in, the {words} distinct mask words of the pairs "
          f"within r_list, list and dropped out) -> {t_bytes:.5f} ms; "
          f"{tests} pairs within r_list x {DIST_TEST_OPS} -> {t_ops:.5f} "
          f"ms; flag 0: its copy's bytes; stencil candidates "
          f"{candidates} (x {DIST_TEST_OPS} -> "
          f"{candidates * DIST_TEST_OPS / FP32_FLOPS_PER_S * 1e3:.5f} ms, "
          f"not the bound)")
    plain = {
        "cell_build": lambda: nl_ops.build_gated_plain(
            pos, on, old, mask, r_list, k_max, cells),
        "cell_build (flag 0)": lambda: nl_ops.build_gated_plain(
            pos, off, old, mask, r_list, k_max, cells)}
    times, bound = {}, {}
    for name, fn in kernels.items():
        k_ms = graph_ms(fn, calls=5)
        line = (f"{case} {name}: kernel {k_ms:.4f} ms device (graph "
                f"replay), wrapper host {host_ms(fn, 10):.4f} ms/call")
        if name in need:
            p_ms = median_ms(plain[name], 1, 0)
            before = BEFORE_MS[name.replace("cell_build", f"cell_build "
                                                          f"{case}")]
            line += (f", plain {p_ms:.4f} ms, bound {need[name][0]:.5f} ms "
                     f"({need[name][1]}): {k_ms / need[name][0]:.2f}x the "
                     f"bound; {before:.4f} ms before (PERF.md), "
                     f"{before / k_ms:.2f}x faster")
            times[name] = (k_ms, p_ms)
            bound[name] = need[name]
        print(line + f" [{smi}]")
    split = profiled_split(kernels["cell_build"], r"cell_\w+_kernel")
    print(f"{case} cell build, flag 1, split (profiled, ms a call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f" [{smi}]")
    return times, bound


def gas_case():
    """Phase 28's gas: (pos, mask bits, mask, r_list, k_max, (grid dims,
    capacity)) of R_GAS seeded replicas of N_GAS atoms at the LJ fluid's
    density, the grid and capacity as the suggest_* functions give
    them."""
    from repro_torch.md import neighbors as NB
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    side = (N_GAS / GAS_DENSITY) ** (1.0 / 3.0)
    gas = side * torch.rand((R_GAS, N_GAS, 3), device="cuda", generator=gen)
    host = gas.double().cpu().numpy()
    gdims = NB.suggest_grid_dims(host[0].max(0) - host[0].min(0)
                                 + 2 * GAS_R_LIST, GAS_R_LIST)
    gcap = NB.suggest_cell_capacity(host, GAS_R_LIST, gdims)
    gbits, gmask = gas_mask(N_GAS)
    return gas, gbits, gmask, GAS_R_LIST, GAS_K_MAX, (gdims, gcap)


def chain_case():
    """Phase 28's chain: the TSU sparse positions at R_TSU on the cell
    path's engine, in ``gas_case``'s form."""
    sp = sparse_engine("fused", nlist_build="cell")
    state = sparse_state(sp, tsu_grid(), R_TSU)
    pk = sp._nb_pack
    return (state["pos"], pk.mask_bits, pk.nb_mask, sp.r_list, sp.k_max,
            (sp._grid_dims, sp._cell_capacity))


def main_path_engine(dev: str):
    """Phase 29's engine: the chain on the sparse path with the cell
    build, a skin of 0.5 A (so the lists are rebuilt within the run)."""
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    return MDEngine(chain_molecule(N_ATOMS), nonbonded="sparse",
                    nlist_build="cell", skin=0.5, device=dev)


def main_path_cfg():
    """Phase 29's run: T-REMD 8 rungs, 10 MD steps a cycle, 2 cycles: one
    chunk, the lists rebuilt in the second cycle; the CPU's run of 4
    cycles took 90.9 s of the script's time limit."""
    from repro_torch.config import RepExConfig
    return RepExConfig(dimensions=(("temperature", 8),),
                       md_steps_per_cycle=10, n_cycles=2)


def main_path_inputs(eng) -> tuple:
    """(mask bits, mask, r_list, k_max, (grid dims, capacity)) of a cell
    path engine."""
    return (eng._nb_pack.mask_bits, eng._nb_pack.nb_mask, eng.r_list,
            eng.k_max, (eng._grid_dims, eng._cell_capacity))


def cell_build(smi: str):
    """Phase 28: the cell-build kernels against their plain version,
    bitwise, in both flag states and a flag row, on the chain at R = 384
    (the TSU sparse positions) and on the gas; the lists as sets equal to
    the dense build's; each timed beside the dense build on the same
    positions and beside its bytes bound.  Returns the largest difference
    from the plain version over both inputs."""
    phase(f"28 the cell build vs its plain version: the chain N={N_ATOMS} "
          f"at R={R_TSU}, a gas N={N_GAS} at R={R_GAS}")
    from repro_torch.kernels.nlist_build import ops as nl_ops
    from repro_torch.md import neighbors as NB
    cases = {f"chain R={R_TSU}": chain_case(), "gas": gas_case()}
    gdims, gcap = cases["gas"][5]
    side = (N_GAS / GAS_DENSITY) ** (1.0 / 3.0)
    method = NB.suggest_build_method(N_GAS, gdims, gcap)
    print(f"gas: box {side:.2f} A, density {GAS_DENSITY:.5f} / A^3, "
          f"r_list {GAS_R_LIST}, grid {gdims}, cell capacity {gcap}, "
          f"k_max {GAS_K_MAX}, R = {R_GAS} (the plain version builds one "
          f"replica at a time), suggest_build_method -> {method!r}")
    check(method == "cell", "the gas takes the cell build")
    _, _, _, r_list, k_max, (dims, cap) = cases[f"chain R={R_TSU}"]
    print(f"chain: grid {dims}, cell capacity {cap}, k_max {k_max}, "
          f"r_list {r_list}")
    err = 0.0
    for tag, (pos, bits, mask, r_list, k_max, cells) in cases.items():
        err = max(err, cell_bitwise(tag, pos, bits, mask, r_list, k_max,
                                    cells))
        on = torch.ones(1, dtype=torch.int32, device="cuda")
        old = kept_list(pos, bits, r_list, k_max, cells)
        fresh = nl_ops.cell_build_batched(pos, on, old, bits, r_list, k_max,
                                          *cells)
        dense = nl_ops.nlist_build_batched(pos, on, old, bits, r_list, k_max)
        as_sets = torch.equal(torch.sort(fresh[0], dim=-1).values, dense[0])
        print(f"{tag}: cell lists as sets equal to the dense build's "
              f"{as_sets}; dropped cell {int(fresh[2].sum())}, dense "
              f"{int(dense[2].sum())}; valid slots "
              f"{int(fresh[1].sum())} of {fresh[1].numel()}")
        check(as_sets and int(fresh[2].sum()) == 0 == int(dense[2].sum()),
              f"{tag}: the cell and dense builds list the same pairs")
        cell_times(tag, pos, bits, mask, r_list, k_max, cells, smi,
                   dense=True)
    return err


def cell_against_cpu(libs, smi: str):
    """Phase 29: the cell path at R = 8, N = 2881 on the card and on the
    CPU, with telemetry's counters on both: the same decisions, rebuilds
    and per-pair counters.  On the card the cell-build kernels are held
    bitwise against their plain version on the run's own inputs (its
    first and last positions, its grid, capacity, r_list and k_max), and
    timed on the first.  Returns (launches, err, times, bounds) of the
    card run for the kernels' record."""
    phase(f"29 card vs CPU: R=8, N={N_ATOMS}, nonbonded='sparse', "
          f"nlist_build='cell', run_fused, telemetry counters")
    from repro_torch.core import REMDDriver
    from repro_torch.obs import Telemetry
    cfg = main_path_cfg()
    runs, launches = {}, {}
    for dev in ("cuda", "cpu"):
        seen, restore = metropolis_spy()
        try:
            eng = main_path_engine(dev)
            driver = REMDDriver(eng, cfg, device=dev,
                                telemetry=Telemetry(phase_probe_every=0))
            ens = driver.init(SEED)
            if dev == "cuda":
                inputs = main_path_inputs(eng)
                pos0 = ens.state["pos"].contiguous()
                err = cell_bitwise("R=8 chain, first positions", pos0,
                                   *inputs)
                times, bound = cell_times("chain R=8", pos0, *inputs, smi)
                reset(libs)
            t0 = time.perf_counter()
            ens = driver.run_fused(ens, chunk_cycles=2)
            wall = time.perf_counter() - t0
            if dev == "cuda":
                launches = {lib.name: lib.launches for lib in libs}
                err = max(err, cell_bitwise(
                    "R=8 chain, last positions",
                    ens.state["pos"].contiguous(), *inputs))
        finally:
            restore()
        hist = driver.history
        runs[dev] = ([h["assignment"].tolist() for h in hist],
                     driver.acceptance_ratios(),
                     [h["nb_rebuilds"] for h in hist],
                     ens.state["pos"].cpu(), seen, driver.last_report)
        print(f"{dev}: grid {eng._grid_dims}, capacity {eng._cell_capacity}, "
              f"k_max {eng.k_max}; {wall:.1f} s; rebuilds by cycle "
              f"{runs[dev][2]}, overflow {hist[-1]['nb_overflow']}")
        if dev == "cuda":
            per_chunk = [round(h["t_step"] * 1e3, 2) for h in hist[::2]]
            print(f"cuda ms/cycle by chunk of 2 {per_chunk} (the first "
                  f"includes warm-up) [{smi}]")
    same = runs["cuda"][:3] == runs["cpu"][:3]
    dpos = float((runs["cuda"][3] - runs["cpu"][3]).abs().max())
    print(f"decisions and rebuilds identical {same}, max |dpos| {dpos:.2e} A "
          f"(tol {TOL_SMALL_POS})")
    if not same:
        print_margins(runs, 0, 4)
    ex = {dev: runs[dev][5].exchange for dev in runs}
    counters = all(np.array_equal(np.asarray(ex["cuda"][k]),
                                  np.asarray(ex["cpu"][k]))
                   for k in ("pair_attempt", "pair_accept", "occupancy",
                             "round_trips"))
    print(f"per-pair counters, occupancy and round trips identical "
          f"{counters}; pair_accept by slot (dim 0, both parities) "
          f"{np.asarray(ex['cuda']['pair_accept']).tolist()}")
    evals = cfg.n_cycles * 11
    want = dict.fromkeys(launches, 0)
    want.update(chain_forces=evals, nonbonded_sparse=evals + cfg.n_cycles,
                cell_build=evals)
    print(f"card launches {launches} (want {want})")
    check(runs["cpu"][2][-1] > 0, "the lists were rebuilt")
    check(same and dpos <= TOL_SMALL_POS, "the card makes the CPU's "
                                          "decisions on the cell path")
    check(counters, "telemetry's counters on the card equal the CPU's")
    check(launches == want, "the cell path's kernels, each force "
                            "evaluation")
    return launches, err, times, bound


_COUNTER_KEYS = ("path", "chunk_cycles", "n_replicas", "cycles",
                 "exchange", "failures", "neighbor")


def cli_run(report, smi: str) -> None:
    """Phase 30: ``python -m repro_torch.launch.repex_run`` as a
    subprocess, the configuration of phase 27's T-REMD run: exit 0, a
    valid report, phase 27's counters."""
    phase("30 the repex_run CLI on the card (a subprocess)")
    import tempfile
    from repro_torch.obs import validate_report
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = Path(tmp) / "report.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.repex_run",
               "--atoms", str(N_ATOMS), "--dims", f"temperature:{R_MAIN}",
               "--md-steps", "10", "--cycles", "8", "--chunk",
               str(OBS_CHUNK), "--report-out", str(out)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                   if os.environ.get("PYTHONPATH") else [])))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=600, cwd=ROOT)
        wall = time.perf_counter() - t0
        print(f"$ {' '.join(cmd[1:])}  ->  exit {proc.returncode}, "
              f"{wall:.1f} s")
        for line in proc.stdout.splitlines()[-6:]:
            print(f"  | {line}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
        check(proc.returncode == 0, "the CLI exits 0")
        with open(out) as f:
            got = validate_report(json.load(f))
    want = json.loads(json.dumps(report.to_dict()))
    same = {k: got[k] == want[k] for k in _COUNTER_KEYS}
    eq1 = {k: round(v * 1e3, 3) for k, v in got["phases"]["eq1"].items()}
    print(f"CLI report vs phase 27's in-process run: {same}; Eq. (1) split "
          f"ms {eq1} [{smi}]")
    check(all(same.values()), "the CLI's counters equal the in-process "
                              "run's")


def same_trajectory(a, ea, b, eb) -> dict:
    """Driver a's run (history, final ensemble ea) against b's: which of
    the discrete trajectory and the state are bitwise equal."""
    keys = ("cycle", "dim", "accept", "attempt", "failed", "esc_relaunch",
            "esc_reinit", "esc_dead", "ready_frac", "nb_overflow",
            "nb_rebuilds")
    out = {
        "rows": ([h["assignment"].tolist() for h in a.history]
                 == [h["assignment"].tolist() for h in b.history]),
        "history": ([[h[k] for k in keys] for h in a.history]
                    == [[h[k] for k in keys] for h in b.history]),
        "acceptance": a.acceptance == b.acceptance}
    for f in ("assignment", "alive", "failures", "relaunches", "debt",
              "cycle"):
        out[f] = torch.equal(getattr(ea, f), getattr(eb, f))
    live = ea.alive
    out["state"] = all(torch.equal(ea.state[k][live], eb.state[k][live])
                       for k in ("pos", "vel"))
    return out


def sharded(libs, smi: str):
    """Phase 31: run_sharded on one NCCL rank at full width against
    run_fused from the same seed, bitwise; times, launches and the wire
    ledger per chunk.  Returns the mesh."""
    phase("31 run_sharded on a one-rank NCCL group vs run_fused")
    import tempfile
    import torch.distributed as dist
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    from repro_torch.obs import Telemetry, validate_report
    print(f"torch.cuda.nccl.version() {torch.cuda.nccl.version()}, "
          f"dist.is_nccl_available() {dist.is_nccl_available()}")
    check(dist.is_nccl_available(), "NCCL is available")
    t0 = time.perf_counter()
    mesh = make_replica_mesh(1, device="cuda")
    print(f"mesh {mesh.shape} on {mesh.device}, backend "
          f"{dist.get_backend()}, made in "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    check(dist.get_backend() == "nccl", "the group is NCCL's")
    from repro_torch import sharding
    x = torch.zeros(R_MAIN, device="cuda")
    for name, fn in (("all-gather", sharding.all_gather_rows),
                     ("all-reduce", sharding.all_reduce_max)):
        print(f"one NCCL {name} of {R_MAIN} float32: host "
              f"{host_ms(lambda: fn(x, mesh), 100):.4f} ms a call "
              f"[{smi}]")
    main = MDEngine(chain_molecule(N_ATOMS), device="cuda")
    t_cfg = dict(dimensions=(("temperature", R_MAIN),),
                 md_steps_per_cycle=10, n_cycles=8)
    cases = (
        ("T-REMD 64 halo", main, RepExConfig(**t_cfg), 0.0, 4),
        ("T-REMD 64 gather", main,
         RepExConfig(exchange_comm="gather", **t_cfg), 0.0, 4),
        ("TSU 384 fused matrix", tsu_engine("fused"),
         RepExConfig(dimensions=TSU_DIMS, md_steps_per_cycle=10,
                     n_cycles=3, exchange_scheme="matrix"), 0.0, 3),
        ("T-REMD 64 async faults", main, RepExConfig(**t_cfg, **ASYNC),
         FAIL_RATE, 4))
    for tag, engine, cfg, rate, chunk in cases:
        n_chunks = cfg.n_cycles // chunk
        runs = {}
        # fused, sharded (the compared runs), then sharded, fused again
        # for one chunk each: the times of both paths in turns
        for path in ("fused", "sharded", "sharded", "fused"):
            tel = (Telemetry(phase_probe_every=0, exchange_counters=False)
                   if path == "sharded" else None)
            d = REMDDriver(engine, cfg, failure_rate=rate, telemetry=tel,
                           device="cuda")
            if path in runs:
                start = runs[path]["ens"]
                (d.run_fused(start, n_cycles=chunk, chunk_cycles=chunk)
                 if path == "fused" else d.run_sharded(
                     start, mesh=mesh, n_cycles=chunk, chunk_cycles=chunk))
                runs[path]["ms"].append(d.history[-1]["t_step"] * 1e3)
                continue
            ens = d.init(SEED)
            reset(libs)
            with counting_fetches() as fetches:
                if path == "fused":
                    ens = d.run_fused(ens, chunk_cycles=chunk)
                else:
                    ens = d.run_sharded(ens, mesh=mesh, chunk_cycles=chunk)
            runs[path] = dict(d=d, ens=ens, fetches=fetches[0],
                              ms=[d.history[-1]["t_step"] * 1e3],
                              launches={lib.name: lib.launches / n_chunks
                                        for lib in libs if lib.launches})
        f, sh = runs["fused"], runs["sharded"]
        same = same_trajectory(f["d"], f["ens"], sh["d"], sh["ens"])
        rep = sh["d"].last_report
        validate_report(rep.to_dict())
        wire = rep.wire["per_chunk"][str(chunk)]
        print(f"{tag}: bitwise {same}")
        print(f"{tag}: ms/cycle run_fused {f['ms'][0]:.2f} / "
              f"{f['ms'][1]:.2f}, run_sharded {sh['ms'][0]:.2f} / "
              f"{sh['ms'][1]:.2f} (the compared run's last chunk / one "
              f"more chunk, in the order fused, sharded, sharded, fused) "
              f"[{smi}]")
        print(f"{tag}: kernel launches per chunk {sh['launches']} "
              f"(run_fused {f['launches']}); fetches per chunk "
              f"{sh['fetches'] / n_chunks}; NCCL collectives per chunk "
              f"{wire or 'none (one rank: the halo ring has no hop)'}; "
              f"failures {rep.failures}")
        check(all(same.values()), f"{tag}: run_sharded bitwise run_fused")
        check(sh["launches"] == f["launches"] and sh["launches"],
              f"{tag}: the same kernels launched on both paths")
        check(sh["fetches"] == n_chunks, f"{tag}: one fetch per chunk")
        check(rep.path == "sharded", f"{tag}: the report's path")
        if cfg.exchange_comm == "gather":
            check(wire.get("all-gather", {}).get("count", 0) > 0,
                  f"{tag}: the gather wire issued NCCL all-gathers")
        if rate:
            check(rep.failures["total"] > 0, f"{tag}: failures injected")

    tag = "resume(via='sharded') of a run_fused checkpoint"
    cfg = RepExConfig(**t_cfg, **ASYNC)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        a = REMDDriver(main, cfg, ckpt_dir=tmp, ckpt_every=4,
                       failure_rate=FAIL_RATE, device="cuda")
        ea = a.run_fused(a.init(SEED), chunk_cycles=4)
        b = REMDDriver(main, cfg, ckpt_dir=tmp, ckpt_every=4,
                       failure_rate=FAIL_RATE, device="cuda")
        reset(libs)
        eb = b.resume(via="sharded", mesh=mesh, chunk_cycles=4, step=3)
        launches = {lib.name: lib.launches for lib in libs if lib.launches}
    same = same_trajectory(a, ea, b, eb)
    print(f"{tag}, cycles 4-7: bitwise {same}; launches {launches}")
    check(all(same.values()), f"{tag}: bitwise the uninterrupted run")
    check(launches == {"chain_forces": 44, "nonbonded": 44},
          f"{tag}: 4 cycles x 11 launches of each per-pass kernel")
    return mesh


def leaves(x) -> list:
    """The tensors of a state dict, a tuple of tensors or a tensor."""
    from repro_torch.tree import tree_leaves
    if isinstance(x, dict):
        return tree_leaves(x)
    return list(x) if isinstance(x, tuple) else [x]


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 units in the last place."""
    if not a.is_floating_point():
        return int((a != b).sum())
    ia = a.float().contiguous().view(torch.int32).to(torch.int64)
    ib = b.float().contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def block_invariance(mesh, smi: str) -> None:
    """Phase 32: the per-shard functions on blocks of R/2 and R/4 rows,
    called as a rank of ``run_sharded`` calls them (inside
    ``ensemble_scope``), bitwise their rows of the full stack."""
    phase("32 block invariance: the per-shard functions on R/2 and R/4 "
          "row blocks vs the full stack")
    from repro_torch import random as jr
    from repro_torch import sharding
    from repro_torch.core.controls import build_grid, ctrl_for_assignment
    from repro_torch.config import RepExConfig
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    from repro_torch.tree import tree_map
    configs = (
        ("T-REMD 64", MDEngine(chain_molecule(N_ATOMS), device="cuda"),
         (("temperature", R_MAIN),)),
        ("TSU 384 dense fused", tsu_engine("fused"), TSU_DIMS),
        ("TSU 384 sparse fused", sparse_engine("fused"), TSU_DIMS),
        ("LJ 384", lj_engine(), (("temperature", R_TSU),)))
    orig_any = sharding.ensemble_any
    worst = {}
    try:
        for tag, engine, dims in configs:
            t0 = time.perf_counter()
            grid = build_grid(RepExConfig(dimensions=dims), "cuda")
            r = grid.n_ctrl
            keys = jr.split(jr.key(SEED, "cuda"), 3)
            state = engine.init_state(keys[0], r)
            perm = jr.permutation(keys[1], r)
            ctrl = ctrl_for_assignment(grid, torch.arange(r, device="cuda"),
                                       getattr(engine, "ctrl_keys", None))
            swap = ctrl_for_assignment(grid, perm,
                                       getattr(engine, "ctrl_keys", None))
            n_steps = torch.full((r,), 10, dtype=torch.int64, device="cuda")
            rngs = jr.split(keys[2], r)
            # the full stack, the list's collective rebuild flags recorded
            flags = []

            def record(flag):
                flags.append(flag.clone())
                return flag
            sharding.ensemble_any = record
            full_prop = engine.propagate(state, ctrl, n_steps, rngs,
                                         max_steps=10)
            sharding.ensemble_any = orig_any
            bad = full_prop["pos"][r // 3].clone()
            bad[7] = float("nan")
            broken = dict(full_prop, pos=full_prop["pos"].clone())
            broken["pos"][r // 3] = bad
            feats = engine.replica_features(full_prop)
            want = {"propagate": full_prop,
                    "replica_features": feats,
                    "energy_pair_from_features":
                        engine.energy_pair_from_features(feats, ctrl, swap),
                    "cross_energy_from_features":
                        engine.cross_energy_from_features(
                            feats, dict(grid.values)),
                    "is_failed": engine.is_failed(broken)}
            for n_shards in (2, 4):
                b = r // n_shards
                for s in range(n_shards):
                    def rows(x, s=s, b=b):
                        return x[s * b:(s + 1) * b]
                    replay = iter(flags)
                    # each rank's flag or-ed over the ranks: the full stack's
                    sharding.ensemble_any = lambda flag: next(replay)
                    with sharding.ensemble_scope(mesh, r):
                        prop = engine.propagate(
                            tree_map(rows, state), tree_map(rows, ctrl),
                            rows(n_steps), rows(rngs), max_steps=10,
                            stack=r)
                        sharding.ensemble_any = orig_any
                        bf = engine.replica_features(
                            tree_map(rows, full_prop))
                    got = {"propagate": prop, "replica_features": bf,
                           "energy_pair_from_features":
                               engine.energy_pair_from_features(
                                   bf, tree_map(rows, ctrl),
                                   tree_map(rows, swap)),
                           "cross_energy_from_features":
                               engine.cross_energy_from_features(
                                   bf, dict(grid.values)),
                           "is_failed": engine.is_failed(
                               tree_map(rows, broken))}
                    # the same features without the scope: a split sized by
                    # the block, as a rank would size it without being told
                    got["features, split by the block"] = \
                        engine.replica_features(tree_map(rows, full_prop))
                    want["features, split by the block"] = feats
                    for name, val in got.items():
                        d = max(ulps(g, rows(w)) for g, w in zip(
                            leaves(val), leaves(want[name])))
                        key = (tag, name)
                        worst[key] = max(worst.get(key, 0), d)
            torch.cuda.synchronize()
            print(f"{tag}: R = {r}, blocks of {r // 2} and {r // 4}; "
                  f"collective rebuilds in the cycle "
                  f"{sum(int(f.item()) for f in flags)} of {len(flags)} "
                  f"force evaluations; largest ulp distance per function "
                  f"{ {k[1]: v for k, v in worst.items() if k[0] == tag} } "
                  f"({time.perf_counter() - t0:.1f} s) [{smi}]")
    finally:
        sharding.ensemble_any = orig_any
    off = {f"{k[0]}: {k[1]}": v for k, v in worst.items()
           if v and k[1] != "features, split by the block"}
    check(not off, f"every per-shard function bitwise on its block; not: "
                   f"{off}")


def across_ranks(mesh, half, cases, smi: str) -> None:
    """run_sharded across the ranks of ``mesh`` (every rank) and of
    ``half`` (its first half) against run_fused on rank 0's device from
    the same seed, bitwise; ms/cycle of each, in turns."""
    import torch.distributed as dist
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.obs import Telemetry
    rank, n = dist.get_rank(), mesh.n_shards
    say = print if rank == 0 else (lambda *a, **k: None)
    for tag, make, cfg_kw, rate, chunk in cases:
        engine, cfg = make(), RepExConfig(**cfg_kw)
        runs, ms = {}, {}

        def run(path, start=None):
            """One run on ``path`` ("fused" on rank 0, or a shard count);
            from ``start`` for one more chunk, timed only."""
            sharded = path != "fused"
            tel = (Telemetry(phase_probe_every=0, exchange_counters=False)
                   if sharded else None)
            d = REMDDriver(engine, cfg, failure_rate=rate, telemetry=tel,
                           device=mesh.device)
            m = {n: mesh, n // 2: half}.get(path)
            ens = d.init(SEED) if start is None else start
            k = None if start is None else chunk
            ens = (d.run_sharded(ens, mesh=m, n_cycles=k, chunk_cycles=chunk)
                   if sharded else
                   d.run_fused(ens, n_cycles=k, chunk_cycles=chunk))
            ms.setdefault(path, []).append(d.history[-1]["t_step"] * 1e3)
            if start is None:
                runs[path] = (d, ens)

        order = ["fused", n, n // 2, n // 2, n, "fused"]
        for path in order:
            member = (rank == 0 if path == "fused"
                      else (mesh if path == n else half).is_member)
            if member:
                again = path in runs
                run(path, runs[path][1] if again else None)
            dist.barrier()
        # one more chunk on every GPU, profiled: rank 0's device time
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(n, runs[n][1])
        prof_ms = ms[n].pop()
        # NCCL's kernels wait on the device for the other ranks: their
        # time is the wire's and the ranks' skew, not work
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        nccl = sum(e.device_time_total for e in dev
                   if "nccl" in e.name.lower()) / 1e3 / chunk
        busy = sum(e.device_time_total for e in dev
                   if "nccl" not in e.name.lower()) / 1e3 / chunk
        dist.barrier()
        if rank == 0:
            d0, e0 = runs["fused"]
            for path in (n, n // 2):
                d, e = runs[path]
                same = same_trajectory(d0, e0, d, e)
                wire = d.last_report.wire["per_chunk"][str(chunk)]
                say(f"{tag} on {path} GPUs: bitwise {same}; NCCL "
                    f"collectives per chunk {wire}")
                check(all(same.values()),
                      f"{tag}: run_sharded on {path} GPUs bitwise run_fused")
            say(f"{tag}: ms/cycle on 1 GPU (run_fused) "
                + " / ".join(f"{t:.2f}" for t in ms["fused"])
                + "".join(f", on {p} GPUs (run_sharded) "
                          + " / ".join(f"{t:.2f}" for t in ms[p])
                          for p in (n // 2, n))
                + f" (the compared run's last chunk / one more chunk, in "
                  f"the order {order}); on {n} GPUs, a profiled chunk: "
                  f"{prof_ms:.2f} ms/cycle, rank 0's device kernel time "
                  f"{busy:.2f} ms/cycle (busy share {busy / prof_ms:.3f}) "
                  f"and NCCL kernels {nccl:.2f} ms/cycle [{smi}]")


# ---------------------------------------------------------------------------
# The twelfth slice: LM training on the card (RE-SGLD and the launcher)
# ---------------------------------------------------------------------------


def lm_pieces_ms(eng, smi: str) -> dict:
    """Phase 34's split of one replica-step, each part timed alone on one
    full-width replica (CUDA events around synchronised calls, median):
    fwd + bwd (autograd, the plain attention), the AdamW update of the
    whole tree, the SGLD noise of the whole tree, and one energy
    evaluation (the held-out loss under no_grad: 16 flash launches)."""
    from repro_torch import random as jr
    from repro_torch.optim import adamw_update, sgld_noise
    from repro_torch.optim.adamw import AdamWState, lr_schedule
    from repro_torch.tree import tree_map
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = eng.init_state(jr.key(SEED, "cuda"), 1)
    torch.cuda.synchronize()
    init1 = time.perf_counter() - t0
    params = tree_map(lambda x: x[0], state["params"])
    batch = eng._batch(state["step"][0])
    out = {"fwd+bwd": median_ms(lambda: eng._grads(params, batch), n=3,
                                warmup=1)}
    _, grads = eng._grads(params, batch)
    opt = AdamWState(state["step"][0], tree_map(lambda x: x[0], state["mu"]),
                     tree_map(lambda x: x[0], state["nu"]))
    out["adamw"] = median_ms(lambda: adamw_update(eng.tcfg, params, grads,
                                                  opt), n=3, warmup=1)
    lr = lr_schedule(eng.tcfg, state["step"][0] + 1)
    temp = torch.full((), 300.0 * eng.noise_per_kelvin, device="cuda")
    key = jr.key(SEED + 1, "cuda")
    out["sgld noise"] = median_ms(lambda: sgld_noise(key, params, lr, temp),
                                  n=2, warmup=1)
    out["energy"] = median_ms(lambda: eng._eval_loss(params), n=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"one replica: init_state {init1:.2f} s; parts timed alone (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in out.items())
          + f"; peak memory {peak:.2f} GiB [{smi}]")
    return out


def energy_through_kernel(eng, params, tol_loss: float, smi: str,
                          control: bool) -> float:
    """Kernel 8 on the engine's own inputs: one held-out loss evaluation
    of ``params`` on the card, every flash call's q, k, v and output
    captured (one per layer) and held against the plain attention at
    phase 19's per-element allowance.  Then that loss against the same
    params' loss through the plain attention (``default_use_kernel``
    off) within ``tol_loss`` (|diff| / |plain|), beside two readings:
    the plain route with float32 compute (the spread the compute dtype
    alone makes) and the kernel without its causal mask (a wrong
    attention), which with ``control`` the limit must see.  Returns the
    kernel's max absolute error."""
    import dataclasses
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers
    from repro_torch.models.lm import LM
    flash, use_kernel = layers.flash_attention, layers.default_use_kernel
    seen = []

    def spy(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    def acausal(q, k, v, **kw):
        return flash(q, k, v, **dict(kw, causal=False))
    f32 = LM(dataclasses.replace(eng.cfg, compute_dtype="float32",
                                 reduce_dtype="float32"))
    n0 = fa_ops.LIBRARY.launches
    try:
        layers.flash_attention = spy
        loss_k = float(eng._eval_loss(params))
        layers.flash_attention = acausal
        loss_wrong = float(eng._eval_loss(params))
        layers.flash_attention = flash
        layers.default_use_kernel = lambda t: False
        loss_p = float(eng._eval_loss(params))
        with torch.no_grad():
            loss_f32 = float(f32.loss(params, eng.eval_batch)[0])
    finally:
        layers.flash_attention, layers.default_use_kernel = flash, use_kernel
    n_layers = eng.cfg.n_layers
    check(len(seen) == n_layers and fa_ops.LIBRARY.launches - n0 ==
          2 * n_layers, f"one flash launch per layer ({len(seen)} calls)")
    used, err = 0.0, 0.0
    for q, k, v, kw, got in seen:
        want = fa_ops.ref.attention(q, k, v, **kw)
        used = max(used, fa_allowance_used(got, want, q.dtype))
        err = max(err, float((got.float() - want.float()).abs().max()))
    q, k = seen[0][:2]
    tag = (f"{str(q.dtype)[6:]} causal B={q.shape[0]} S={q.shape[1]} "
           f"H={q.shape[2]} G={k.shape[2]} D={q.shape[3]}")

    def gap(x):
        return abs(x - loss_p) / abs(loss_p)
    print(f"flash on the engine's inputs ({tag}, {n_layers} layers): "
          f"{used:.3f} of the allowance, max |diff| {err:.3e}; held-out "
          f"loss kernel {loss_k:.6f}, plain {loss_p:.6f}: |diff| / |plain| "
          f"{gap(loss_k):.2e} (tol {tol_loss}); plain with float32 compute "
          f"{gap(loss_f32):.2e}; kernel without the causal mask "
          f"{gap(loss_wrong):.2e} [{smi}]")
    check(used <= 1.0, f"flash vs plain on the engine's inputs ({tag})")
    check(gap(loss_k) <= tol_loss, "the held-out loss through the kernel "
          "is the plain route's")
    check(not control or gap(loss_wrong) > tol_loss,
          "the loss limit sees a wrong attention")
    return err


def re_sgld(libs, smi: str) -> dict:
    """Phase 34: RE-SGLD at OLMo-1B's full width through REMDDriver on
    one card, then the float32 smoke preset on the card and the CPU.
    Returns the launch counts of the full-width run and the flash
    kernel's max absolute error on the engines' own inputs."""
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.core.ensemble import control_multiset_ok
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import registry
    from repro_torch.models.lm_engine import LMEngine
    from repro_torch.tree import tree_map, tree_paths
    gc.collect()
    torch.cuda.empty_cache()
    cfg = registry.get_config(LM_ARCH)
    phase(f"34 RE-SGLD at full width: {LM_ARCH} (seeded weights), "
          f"{RSGLD_RUNGS} temperature rungs, synchronous DEO, "
          f"run_fused(chunk_cycles=2), {RSGLD_CYCLES} cycles of 1 step")
    eng = LMEngine(cfg, device="cuda")
    parts = lm_pieces_ms(eng, smi)
    gc.collect()
    torch.cuda.empty_cache()

    rcfg = RepExConfig(engine="lm", dimensions=(("temperature",
                                                 RSGLD_RUNGS),),
                       md_steps_per_cycle=1, n_cycles=RSGLD_CYCLES,
                       relaunch_failed=False)
    driver = REMDDriver(eng, rcfg, device="cuda")
    # under the "continue" policy the driver hands the state to the
    # engine to step in place: a second copy would not fit
    check(driver._donate, "RE-SGLD: the driver donates the state")
    evals = [0]
    energy = eng.energy

    def counted_energy(state, ctrl):
        evals[0] += 1
        return energy(state, ctrl)
    eng.energy = counted_energy
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ens = driver.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset(libs)
    t0 = time.perf_counter()
    ens = driver.run_fused(ens, chunk_cycles=2)     # one sync per chunk
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {lib.name: lib.launches for lib in libs}
    variants = dict(fa_ops.LIBRARY.variants)
    n_leaves = len(tree_paths(ens.state["params"]))
    noise_launches({"sgld": n_leaves * RSGLD_RUNGS * RSGLD_CYCLES},
                   f"RE-SGLD ({n_leaves} leaves x {RSGLD_RUNGS} replicas x "
                   f"{RSGLD_CYCLES} steps)")
    eng.energy = energy
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_cycle = driver.history[-1]["t_step"] * 1e3
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.n_layers * RSGLD_RUNGS * evals[0]
    losses = eng._losses(ens.state)
    n_rs = RSGLD_RUNGS * RSGLD_CYCLES
    print(f"R={RSGLD_RUNGS} init_state {init_s:.2f} s; run_fused "
          f"{run_s:.2f} s, {ms_cycle:.1f} ms per cycle ({n_rs} replica-"
          f"steps, {ms_cycle * RSGLD_CYCLES / n_rs:.1f} ms each, "
          f"{evals[0]} energy evaluations); peak memory {peak:.2f} GiB "
          f"[{smi}]")
    per = sum(parts[k] for k in ("fwd+bwd", "adamw", "sgld noise"))
    print("replica-step split (parts alone, ms): " + ", ".join(
        f"{k} {v:.2f} ({v / per:.3f})" for k, v in parts.items()
        if k != "energy") + f"; energy evaluation {parts['energy']:.2f} "
          f"per replica")
    print(f"held-out losses {[round(float(x), 4) for x in losses]}; "
          f"assignment {ens.assignment.tolist()}; acceptance "
          f"{driver.acceptance_ratios()}")
    print(f"launches {launches}, flash by variant {variants} (want "
          f"{want['flash_attention']} = {cfg.n_layers} layers x "
          f"{RSGLD_RUNGS} replicas x {evals[0]} evaluations, all bf16_tc)")
    check(launches == want and variants == {
        "bf16_tc": want["flash_attention"]},
          "RE-SGLD: flash in every energy evaluation, never under autograd")
    check(bool(torch.isfinite(losses).all()) and control_multiset_ok(ens),
          "RE-SGLD: finite losses, a permutation of the rungs")
    err = energy_through_kernel(eng, tree_map(lambda x: x[0],
                                              ens.state["params"]),
                                TOL_LM_LOSS[torch.bfloat16], smi,
                                control=False)
    del ens, driver, losses
    eng = None
    gc.collect()
    torch.cuda.empty_cache()
    err = max(err, re_sgld_small(smi))
    return launches, err


def lm_smoke_engine(device: str):
    """The float32 smoke preset of examples/lm_parallel_tempering_torch.py
    (2 layers, d_model 128, vocab 2048; its engine settings), every
    dtype float32."""
    from repro_torch.config import ModelConfig, TrainConfig
    from repro_torch.models.lm_engine import LMEngine
    cfg = ModelConfig(name="pt-smoke", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=4, d_ff=512, vocab_size=2048,
                      compute_dtype="float32", reduce_dtype="float32",
                      cache_dtype="float32")
    return LMEngine(cfg, tcfg=TrainConfig(learning_rate=3e-3,
                                          warmup_steps=20, total_steps=5000,
                                          weight_decay=0.01),
                    batch_size=8, seq_len=64, pool_batches=16,
                    noise_per_kelvin=3e-9, device=device)


def re_sgld_small(smi: str) -> float:
    """Phase 34b: the float32 smoke preset, R = 4, 3 cycles of 2 steps:
    ``run`` and ``run_fused`` on the card make the same decisions and the
    card makes the CPU's.  On one seeded state: the flash kernel (its f32
    variant) on the engine's inputs, the held-out losses card against
    CPU within TOL_LM_CPU, and one replica-step's gradient on the card
    the CPU's within TOL_LM_GRAD for every leaf, with TF32 matmuls as the
    control the limit must see.  Returns the kernel's max absolute
    error."""
    from repro_torch import random as jr
    from repro_torch.config import RepExConfig
    from repro_torch.core import REMDDriver
    from repro_torch.tree import tree_map, tree_paths
    phase("34b RE-SGLD float32 smoke preset: R=4, 3 cycles of 2 steps, "
          "card vs CPU")
    rcfg = RepExConfig(engine="lm", dimensions=(("temperature", 4),),
                       md_steps_per_cycle=2, n_cycles=3)
    runs = {}
    for dev in ("cuda", "cpu"):
        seen, restore = metropolis_spy()
        try:
            driver = REMDDriver(lm_smoke_engine(dev), rcfg, device=dev)
            ens = driver.run_fused(driver.init(SEED), chunk_cycles=3)
        finally:
            restore()
        runs[dev] = ([h["assignment"].tolist() for h in driver.history],
                     seen, driver.engine._losses(ens.state).cpu())
    drv = REMDDriver(lm_smoke_engine("cuda"), rcfg, device="cuda")
    drv.run(drv.init(SEED))
    rows_run = [h["assignment"].tolist() for h in drv.history]
    same = runs["cuda"][0] == runs["cpu"][0]
    # printed, not held: after six AdamW steps the rounding of near-zero
    # gradient elements has moved some parameters by up to 2 lr a step
    # (AdamW's first steps are lr sign(g)), so the trajectories part;
    # the decisions above and the same-state checks below are held
    dloss = float((runs["cuda"][2] - runs["cpu"][2]).abs().max())
    print(f"run_fused cuda {runs['cuda'][0]}, cpu {runs['cpu'][0]}, run "
          f"(cuda) {rows_run}; final held-out losses max |cuda - cpu| "
          f"{dloss:.2e} (printed: the trajectories part by AdamW's sign "
          f"steps)")
    if not same:
        print_margins(runs, 0, 1)
    check(rows_run == runs["cuda"][0], "RE-SGLD: run makes run_fused's "
          "decisions on the card")
    check(same, "RE-SGLD: the card makes the CPU's decisions")

    # one seeded state on both devices
    engs = {dev: lm_smoke_engine(dev) for dev in ("cuda", "cpu")}
    state = engs["cuda"].init_state(jr.key(SEED, "cuda"), 4)
    err = energy_through_kernel(engs["cuda"], tree_map(
        lambda x: x[0], state["params"]), TOL_LM_LOSS[torch.float32], smi,
        control=True)
    losses = {dev: eng._losses(tree_map(lambda x: x.to(dev), state)).cpu()
              for dev, eng in engs.items()}
    e_loss = rel(losses["cuda"], losses["cpu"])
    print(f"held-out losses of one state, card (kernel) vs CPU (plain): "
          f"max |diff| / max |cpu| {e_loss:.2e} (tol {TOL_LM_CPU})")
    check(e_loss <= TOL_LM_CPU, "RE-SGLD: the card's energies are the "
          "CPU's")

    # one replica-step's gradient, card against CPU, every leaf; the
    # control takes the card's matmuls in TF32
    def grads(dev):
        eng = engs[dev]
        params = tree_map(lambda x: x[0].to(dev), state["params"])
        _, g = eng._grads(params, eng._batch(
            torch.zeros((), dtype=torch.int32, device=dev)))
        return [(path, x.cpu()) for path, x in tree_paths(g)]
    cpu = grads("cpu")
    card = grads("cuda")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = grads("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = {"/".join(path): (rel(g, c), rel(t, c), float(c.abs().max()))
            for (path, c), (_, g), (_, t) in zip(cpu, card, tf32)}
    print("gradient card vs CPU, max |diff| / max |cpu| (TF32 control; "
          "max |cpu|): " + ", ".join(
              f"{k} {e:.2e} ({t:.2e}; {m:.2e})"
              for k, (e, t, m) in errs.items())
          + f" (tol {TOL_LM_GRAD}) [{smi}]")
    check(all(e <= TOL_LM_GRAD and m > 0 for e, _, m in errs.values()),
          "RE-SGLD: every leaf's gradient on the card is the CPU's")
    check(all(t > TOL_LM_GRAD for _, t, _ in errs.values()),
          "RE-SGLD: the gradient limit sees TF32 matmuls in every leaf")
    return err


def train_report(arch: str, rep: dict, libs, smi: str,
                 positions: int = 0) -> None:
    """Print a train launcher run's init, ms per step, tokens/s (and, for
    the vlm family, positions/s with the image prefix), peak memory and
    losses; check no kernel launch (autograd takes the plain attention),
    TRAIN_STEPS finite losses and the peak under the card's memory."""
    launches = {lib.name: lib.launches for lib in libs}
    ms = rep["step_ms"]
    warm = statistics.median(ms[1:])
    extra = (f", {positions / warm * 1e3:.0f} positions/s" if positions
             else "")
    total = torch.cuda.get_device_properties(0).total_memory
    steps_ms = [round(x, 2) for x in ms]
    print(f"init {rep['init_s']:.2f} s; ms per step {steps_ms} (median "
          f"after the first {warm:.2f}), "
          f"{rep['tokens'] / warm * 1e3:.0f} tokens/s{extra}; peak memory "
          f"{rep['peak_bytes'] / 2 ** 30:.2f} GiB of "
          f"{total / 2 ** 30:.2f}; losses "
          f"{[round(x, 4) for x in rep['losses']]} [{smi}]")
    print(f"launches {launches} (want none: autograd takes the plain "
          f"attention)")
    check(all(v == 0 for v in launches.values()),
          f"train {arch}: no kernel launch under autograd")
    check(len(rep["losses"]) == TRAIN_STEPS and all(
        math.isfinite(x) for x in rep["losses"]),
        f"train {arch}: finite losses")
    check(rep["peak_bytes"] < total, f"train {arch}: the peak fits the card")


def train_launcher(libs, smi: str) -> None:
    """Phase 35: ``repro_torch.launch.train.main`` at OLMo-1B's full
    width (B = 8, S = 128, remat per block, 5 steps) with every launch
    count at 0 (training never reaches the flash kernel); then a
    killed-then-resumed smoke run bitwise the uninterrupted one."""
    import shutil
    from repro_torch.launch import train
    from repro_torch.tree import tree_paths
    phase(f"35 train launcher at full width: {LM_ARCH}, batch 8, seq 128, "
          f"remat block, {TRAIN_STEPS} steps")
    gc.collect()
    torch.cuda.empty_cache()
    reset(libs)
    rep = {}
    state = train.main(["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS)],
                       report=rep)
    train_report(LM_ARCH, rep, libs, smi)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    flags = ["--arch", LM_ARCH, "--smoke", "--steps", "5", "--ckpt-dir",
             str(ckpt), "--ckpt-every", "1"]
    full = train.main(flags)
    for step in (4, 5):              # a run killed after step 3
        shutil.rmtree(ckpt / f"step-{step:08d}")
    resumed = train.main(flags)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_paths(full), tree_paths(resumed)))
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"smoke: killed after step 3 and resumed, final state bitwise "
          f"the uninterrupted run's: {same}")
    check(same, "train: resume is bitwise the uninterrupted run")


# The fourteenth slice: the four MD examples (phase 36) and DeepSeek-MoE
# 16B (arXiv:2401.06066) served at full width (phase 37): the serving
# flags of phase 21, float32 parameters (the launcher's default) with
# bf16 compute.
EXAMPLES = (("quickstart_torch.py", ()), ("multidim_tsu_torch.py",
                                          ("--full",)),
            ("async_faults_torch.py", ()), ("sharded_ensemble_torch.py", ()))
EXAMPLE_CHECKS = {
    "quickstart_torch.py": ("control multiset preserved: True",),
    "multidim_tsu_torch.py": ("multiset ok: True",),
    "async_faults_torch.py": ("multiset ok after restart: True",),
    "sharded_ensemble_torch.py": (
        "control multiset preserved: True",
        "assignment trace identical to run_fused: True")}
# runs an example as ``__main__`` in a fresh process, then prints the
# kernel launches that process made (its counts start at 0)
EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "from repro_torch.kernels.chain_forces import ops as c\n"
    "from repro_torch.kernels.lj_forces import ops as n\n"
    "print('LAUNCHES ' + json.dumps({'chain_forces': c.LIBRARY.variants,"
    " 'nonbonded': n.LIBRARY.launches}))\n")
MOE_ARCH = "deepseek_moe_16b"


def examples(smi: str) -> None:
    """Phase 36: the port's four MD examples on the card, each in its own
    process as a user runs it (``--device`` left at its default, the
    card; multidim at the paper's 6 x 8 x 8 grid): exit 0, each one's
    closing check printed, its wall time and the launches of kernels 1
    (``chain_forces`` "plain"), 1b ("bias") and 2 (``nonbonded``)."""
    phase("36 the four MD examples on the card, each in its own process")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for script, args in EXAMPLES:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", EXAMPLE_RUNNER,
             str(ROOT / "examples" / script), *args],
            capture_output=True, text=True, timeout=300, env=env)
        wall = time.perf_counter() - t0
        lines = out.stdout.splitlines()
        tail = [ln for ln in lines if not ln.startswith(("chunk @", "cycle "))]
        print(f"{script} {' '.join(args)}: exit {out.returncode}, wall "
              f"{wall:.1f} s [{smi}]")
        for ln in tail[-12:]:
            print(f"  {ln}")
        if out.returncode != 0:
            print(out.stderr[-4000:])
        launches = json.loads(lines[-1].split(" ", 1)[1]) \
            if lines and lines[-1].startswith("LAUNCHES ") else None
        check(out.returncode == 0 and launches is not None,
              f"{script}: exits 0")
        missing = [want for want in EXAMPLE_CHECKS[script]
                   if want not in lines]
        check(not missing, f"{script}: prints {missing}")
        bonded = launches["chain_forces"]
        need = "bias" if "--full" in args else "plain"
        check(bonded.get(need, 0) > 0 and launches["nonbonded"] > 0,
              f"{script}: kernels 1/1b and 2 launched")


def serve_moe(libs, smi: str) -> int:
    """Phase 37: ``serve_wide`` on DeepSeek-MoE-16B (28 flash launches a
    prefill), then 37c, the share of routed choices dropped at capacity
    (``forward``'s aux on the served prompts) and prefill(S) + decode
    against prefill(S + 1), printed, not held (a choice prefill drops at
    capacity 240 decode keeps at 8).  Returns the first run's flash
    launches."""
    from repro_torch import random as jr
    from repro_torch.models import moe as MOE
    from repro_torch.models import registry

    def then(lm, params):
        cfg = lm.cfg
        moe_layer_card_vs_cpu(cfg, params, smi)
        prompt = jr.randint(jr.key(1, "cuda"), (LM_BATCH, LM_PROMPT), 0,
                            cfg.vocab_size)
        with torch.no_grad():
            logits, aux = lm.forward(params, {"tokens": prompt})
        del logits
        print(f"forward on the served prompts: capacity "
              f"{MOE.capacity(cfg, LM_PROMPT)} at S = {LM_PROMPT} "
              f"({MOE.capacity(cfg, 1)} at decode); share of routed choices "
              f"dropped {float(aux['moe_dropped']):.4f}; moe_aux "
              f"{float(aux['moe_aux']):.5f}, moe_z "
              f"{float(aux['moe_z']):.5f}")
        toks = jr.randint(jr.key(2, "cuda"), (LM_BATCH, LM_PROMPT + 1), 0,
                          cfg.vocab_size)
        _, state = lm.prefill(params, {"tokens": toks[:, :-1]},
                              cache_len=LM_PROMPT + 1)
        dec_logits, _ = lm.decode_step(params, state, toks[:, -1:])
        del state
        full_logits, _ = lm.prefill(params, {"tokens": toks})
        agree = float((dec_logits.argmax(-1) == full_logits.argmax(-1))
                      .float().mean())
        print(f"prefill({LM_PROMPT}) + decode vs prefill({LM_PROMPT + 1}): "
              f"max |diff| / max |logit| {rel(dec_logits, full_logits):.2e}, "
              f"argmax agreement {agree:.2f} (not held: routing at capacity "
              f"{MOE.capacity(cfg, LM_PROMPT + 1)} drops choices that "
              f"decode's {MOE.capacity(cfg, 1)} keeps)")
    return serve_wide(libs, smi, MOE_ARCH, "37",
                      registry.get_config(MOE_ARCH).n_layers, then)


# kernel groups of phases 37a, 38a, 39a, by the first pattern a kernel's
# name matches
MOE_GROUPS = (("flash_attention kernel", r"flash_attention_kernel"),
              ("matmuls (cuBLAS)", r"gemm|nvjet|xmma|cutlass|sm90_"),
              ("casts and copies", r"copy"),
              ("routing (sort, scan, index, scatter, gather)",
               r"sort|scan|index|scatter|gather"))


def breakdown_by_group(lm, params, smi: str, label: str,
                       kernel_groups) -> None:
    """Phases 37a-43a: where a warm full-width prefill's and a decode
    step's device time goes, one profiled call each (the device's
    activity alone), by the first of ``kernel_groups`` whose pattern a
    kernel's name matches; the busy share against the same call
    unprofiled (median of 5 CUDA-event times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.launch.serve import frontend_stubs
    phase(label)
    cfg = lm.cfg
    toks = jr.randint(jr.key(1, "cuda"), (LM_BATCH, LM_PROMPT), 0,
                      cfg.vocab_size)
    batch = {"tokens": toks, **frontend_stubs(cfg, LM_BATCH, "cuda")}
    _, state = lm.prefill(params, batch, cache_len=LM_PROMPT + LM_TOKENS
                          + cfg.n_image_tokens)
    tok = toks[:, -1:]
    calls = {"prefill": lambda: lm.prefill(params, batch),
             "decode step": lambda: lm.decode_step(params, state, tok)}
    for tag, fn in calls.items():
        wall = median_ms(fn, n=5, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups = dict.fromkeys([g for g, _ in kernel_groups] + ["the rest"],
                               0.0)
        by_name = {}
        n = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            n += 1
            key = next((g for g, pat in kernel_groups
                        if re.search(pat, e.name.lower())), "the rest")
            groups[key] += e.device_time_total / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.device_time_total / 1e3
        busy = sum(groups.values())
        check(n > 0 and busy > 0, f"{label}: the profiler saw the kernels")
        print(f"{tag}: {n} kernels, device time {busy:.3f} ms of "
              f"{wall:.3f} ms (median of 5, unprofiled): busy share "
              f"{busy / wall:.3f} [{smi}]")
        for key, ms in groups.items():
            print(f"  {key}: {ms:.3f} ms ({ms / busy:.3f})")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"  top: {ms:.3f} ms {name[:110]}")
    del state


def moe_layer_card_vs_cpu(cfg, params, smi: str) -> None:
    """Phase 37c: ``moe_apply`` at full width (the served prompts' shape,
    B 4, S 2048, E 64, top 6, capacity 240) on the first MoE layer's
    seeded weights, float32 compute, on the card and on the CPU from the
    same input, one that spills choices at capacity: the same expert ids
    and keep wherever the CPU's top-k margin exceeds MOE_FLIP_MARGIN, y
    within TOL_MOE_LAYER of max |y| at every token whose choices agree,
    and the aux terms."""
    from repro_torch.models import moe as MOE
    from repro_torch.tree import tree_map
    phase(f"37c one full-width MoE layer at float32, card vs CPU (B "
          f"{LM_BATCH}, S {LM_PROMPT}, E {cfg.moe.num_experts}, top "
          f"{cfg.moe.top_k}, capacity {MOE.capacity(cfg, LM_PROMPT)})")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = MOE.capacity(cfg, LM_PROMPT)
    # unit normals plus a direction shared by a row's tokens, which
    # biases the row's router logits alike, so experts overfill and
    # choices spill at capacity as the served prompts' do
    gen = torch.Generator().manual_seed(37)
    x = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), generator=gen) + \
        torch.randn((LM_BATCH, 1, cfg.d_model), generator=gen)
    runs = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t[0].to(dev), params["layers"]["moe"])
        t0 = time.perf_counter()
        with torch.no_grad():
            y, aux = MOE.moe_apply(p, f32, x.to(dev))
            logits = (x.to(dev).reshape(-1, cfg.d_model) @ p["router"]
                      ).reshape(LM_BATCH, LM_PROMPT, e)
            probs, _, ids, _, keep = MOE.route(logits, k, e, cap)
        runs[dev] = [t.cpu() for t in (y, probs, ids, keep)] + [
            {key: float(v) for key, v in aux.items()},
            time.perf_counter() - t0]
        del p
    (yc, _, ids_c, keep_c, aux_c, s_c), (y, probs, ids, keep, aux, s) = (
        runs["cuda"], runs["cpu"])
    top = torch.sort(probs, -1, descending=True).values
    margin = (top[..., k - 1] - top[..., k]).reshape(LM_BATCH, -1)
    flip = (ids_c != ids).reshape(LM_BATCH, LM_PROMPT, k).any(-1)
    moved = flip | (keep_c != keep).reshape(LM_BATCH, LM_PROMPT, k).any(-1)
    worst = float(margin[flip].max()) if flip.any() else 0.0
    ok_tok = ~moved
    err = float((yc - y).abs()[ok_tok].max() / y.abs().max())
    print(f"card {s_c:.2f} s, CPU {s:.2f} s [{smi}]; tokens with another "
          f"expert choice {int(flip.sum())} (largest CPU top-k margin "
          f"among them {worst:.3e}, limit {MOE_FLIP_MARGIN}), with another "
          f"keep {int((moved & ~flip).sum())}, of {flip.numel()}; y max "
          f"|diff| / max |y| over the rest {err:.3e} (tol {TOL_MOE_LAYER}); "
          f"aux card {aux_c}, CPU {aux}")
    check(worst <= MOE_FLIP_MARGIN and int(ok_tok.sum()) > 0.99 *
          ok_tok.numel() and err <= TOL_MOE_LAYER and
          all(abs(aux_c[key] - aux[key]) <= TOL_MOE_LAYER * abs(aux[key])
              for key in ("moe_aux", "moe_z")) and
          aux["moe_dropped"] > 0 and
          (flip.any() or aux_c["moe_dropped"] == aux["moe_dropped"]),
          "moe layer: the card routes and combines as the CPU at full "
          "width")


# The fifteenth slice: DeepSeek-V2-Lite-16B (arXiv:2405.04434; moe on MLA
# attention, phase 38) and RecurrentGemma-9B (arXiv:2402.19427; the hybrid
# family, phase 39) served at full width with phase 21's flags, float32
# parameters, bf16 compute; one after the other, the first one's state
# freed before the second starts.
V2_ARCH, RG_ARCH = "deepseek_v2_lite_16b", "recurrentgemma_9b"


def serve_wide(libs, smi: str, arch: str, label: str, n_flash: int,
               then=None, kernel_groups=MOE_GROUPS, n_flash_token: int = 0,
               param_dtype=None) -> int:
    """Phases 37-40, 42 and 43: ``serve.main`` on ``arch`` at full width
    on one card (with the launcher's frontend stubs), once the earlier LM
    phases' memory is freed (less than 4 GiB held: the MD phases' engines
    hold ~2 GiB), twice from the same weights: ``n_flash`` flash launches
    a prefill and ``n_flash_token`` a decode step (one per attention layer
    that runs the kernel) on the tensor cores and nothing else, bitwise
    tokens, finite logits; init, the cold and the warm prefill, decode ms
    per token, peak memory; then a prefill and a decode step counted
    apart, the breakdown by kernel group and ``then(lm, params)``, the
    groups being ``kernel_groups``.  With ``param_dtype`` the weights are
    drawn here at that dtype (``init_params(key(0), defs, dtype=)``, timed
    as the init) and handed to ``serve.main``.  Prints the phase's
    seconds.  Returns the first run's flash launches."""
    from repro_torch import random as jr
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.models.params import init_params
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated() / 2 ** 30
    cfg = registry.get_config(arch)
    pdt = str(param_dtype)[6:] if param_dtype else cfg.param_dtype
    phase(f"{label} LM serving: {arch} at full width, {LM_BATCH} prompts x "
          f"{LM_PROMPT} tokens, {LM_TOKENS} new tokens (seeded weights, "
          f"{pdt} parameters, {cfg.compute_dtype} compute)")
    print(f"memory held before the phase {held:.2f} GiB")
    check(held < 4.0, f"serve {arch}: the earlier LM phases' memory is freed")
    argv = ["--arch", arch, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--tokens", str(LM_TOKENS)]
    params, init_s = None, None
    if param_dtype is not None:
        t0 = time.perf_counter()
        params = init_params(jr.key(0, "cuda"),
                             registry.build(cfg).param_defs(),
                             dtype=param_dtype)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    reset(libs)
    rep = {}
    gen = serve.main(argv, params=params, report=rep)
    init_s = rep["init_s"] if init_s is None else init_s
    launches = {lib.name: lib.launches for lib in libs}
    want = dict.fromkeys(launches, 0)
    n_run = n_flash + (LM_TOKENS - 1) * n_flash_token
    want["flash_attention"] = n_run
    variants = dict(fa_ops.LIBRARY.variants)
    # a family without attention launches no kernel at all
    want_variants = {"bf16_tc": n_run} if n_run else {}
    dec = statistics.median(rep["decode_ms"])
    print(f"params {registry.param_count(cfg)} ({pdt}); init "
          f"{init_s:.2f} s; prefill {rep['prefill_ms']:.2f} ms "
          f"(cold); decode {dec:.3f} ms/token (median of "
          f"{len(rep['decode_ms'])}; min {min(rep['decode_ms']):.3f}, max "
          f"{max(rep['decode_ms']):.3f}); peak memory "
          f"{rep['peak_bytes'] / 2 ** 30:.2f} GiB [{smi}]")
    print(f"launches {launches}, flash by variant {variants} (want "
          f"{n_run} flash on bf16_tc, nothing else)")
    check(launches == want and variants == want_variants,
          f"serve {arch}: {n_run} flash launches on the tensor cores, "
          f"nothing else")
    check(gen.shape == (LM_BATCH, LM_TOKENS) and all(
        bool(torch.isfinite(x).all()) for x in rep["logits"]),
          f"serve {arch}: tokens of the right shape, finite logits")
    params = rep.pop("params")
    reset(libs)
    rep2 = {}
    gen2 = serve.main(argv, params=params, report=rep2)
    same = torch.equal(gen, gen2)
    print(f"second run, same weights: tokens bitwise equal {same}; warm "
          f"prefill {rep2['prefill_ms']:.2f} ms, decode "
          f"{statistics.median(rep2['decode_ms']):.3f} ms/token (median of "
          f"{len(rep2['decode_ms'])}) [{smi}]")
    check(same and fa_ops.LIBRARY.launches == n_run,
          f"serve {arch}: bitwise reproducible tokens")
    del rep, rep2
    lm = registry.build(cfg)
    toks = jr.randint(jr.key(1, "cuda"), (LM_BATCH, LM_PROMPT), 0,
                      cfg.vocab_size)
    reset(libs)
    _, state = lm.prefill(
        params, {"tokens": toks, **serve.frontend_stubs(cfg, LM_BATCH,
                                                         "cuda")},
        cache_len=LM_PROMPT + 1 + cfg.n_image_tokens)
    n_pre = fa_ops.LIBRARY.launches
    lm.decode_step(params, state, toks[:, -1:])
    n_dec = fa_ops.LIBRARY.launches - n_pre
    del state
    print(f"flash launches {n_pre} in a prefill, {n_dec} in a decode step")
    check(n_pre == n_flash and n_dec == n_flash_token,
          f"serve {arch}: {n_flash} flash launches per prefill, "
          f"{n_flash_token} per decode step")
    breakdown_by_group(lm, params, smi,
                       f"{label}a where a prefill's and a decode step's "
                       f"time goes ({arch})", kernel_groups)
    if then is not None:
        then(lm, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase {label} took {time.perf_counter() - t_phase:.1f} s")
    return launches["flash_attention"]


def serve_card_vs_cpu(arch: str) -> None:
    """``arch``'s smoke config at float32 dtypes on the card (kernel) and
    on the CPU (plain): identical tokens, logits within TOL_LM_CPU."""
    from repro_torch.launch import serve
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


# The sixteenth slice: xLSTM-1.3B (arXiv:2405.04517; the ssm family: 6
# units of 7 mLSTM + 1 sLSTM blocks, no attention) served at full width
# with phase 21's flags (phase 40), then training card against CPU on the
# smoke configs of the MLA, hybrid and ssm families (phase 41).
XL_ARCH = "xlstm_1_3b"
XLSTM_GROUPS = (("matmuls (cuBLAS)", r"gemm|nvjet|xmma|cutlass|sm90_"),
                ("casts and copies", r"copy"),
                ("reductions and scans", r"reduce|scan"),
                ("elementwise", r"elementwise"))
WH_ARCH, IV_ARCH = "whisper_small", "internvl2_26b"
TRAIN_ARCHS = (V2_ARCH, RG_ARCH, XL_ARCH, WH_ARCH, IV_ARCH)
TRAIN_CPU_STEPS = 3


def frontend_input(cfg, batch: int, seed: int) -> dict:
    """The encdec or vlm family's frontend input: seeded unit normals,
    float32 ``audio_embeds`` (B, encoder_seq_len, d) or ``pixel_embeds``
    (B, n_image_tokens, d); nothing for the other families."""
    if cfg.family not in ("encdec", "vlm"):
        return {}
    name, n = (("audio_embeds", cfg.encoder_seq_len)
               if cfg.family == "encdec" else
               ("pixel_embeds", cfg.n_image_tokens))
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.randn((batch, n, cfg.d_model), generator=gen)}


def train_card_vs_cpu(libs) -> None:
    """Phase 41: ``make_train_step`` (AdamW, remat per block, as the train
    launcher runs it) for TRAIN_CPU_STEPS steps on the card and on the
    CPU from one seeded state (drawn on the CPU, copied to the card) and
    the same batches, every dtype float32 and TF32 off: step 1's loss
    within TOL_LM_LOSS[float32] and its gradient (``LM.value_and_grad``
    with remat, the step's own) within TOL_LM_GRAD of max |cpu| in every
    leaf, each leaf non-zero (phase 34b's limits, set before this phase
    first ran); the later steps' losses printed; no kernel launch
    (autograd takes the plain attention).  The encdec and vlm smoke
    configs' batches carry seeded random frontend inputs
    (``frontend_input``)."""
    from repro_torch import random as jr
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.tree import tree_map, tree_paths
    t_phase = time.perf_counter()
    phase(f"41 training card vs CPU at float32, TF32 off: the smoke configs "
          f"of {', '.join(TRAIN_ARCHS)}, {TRAIN_CPU_STEPS} AdamW steps with "
          f"remat")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "train card vs CPU: TF32 matmuls off")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=50,
                       remat_policy="block")
    tol_loss = TOL_LM_LOSS[torch.float32]
    reset(libs)
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  compute_dtype="float32",
                                  cache_dtype="float32",
                                  reduce_dtype="float32")
        lm = registry.build(cfg)
        ds = SyntheticLMDataset(cfg.vocab_size, 32, 4)
        batches = [{**{k: torch.as_tensor(v)
                       for k, v in ds.next_batch().items()},
                    **frontend_input(cfg, 4, SEED + i)}
                   for i in range(TRAIN_CPU_STEPS)]
        start = steps.init_train_state(jr.key(0), lm)
        step = steps.make_train_step(lm, tcfg)
        runs = {}
        for dev in ("cpu", "cuda"):
            # a copy on either device: the step writes in place
            state = tree_map(lambda t: t.to(dev, copy=True), start)
            bs = [{k: v.to(dev) for k, v in b.items()} for b in batches]
            (loss, _), grads = lm.value_and_grad(state["params"], bs[0],
                                                 remat=True)
            losses = []
            for b in bs:
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
            runs[dev] = (float(loss), tree_map(lambda t: t.cpu(), grads),
                         losses)
        (loss_c, g_c, l_c), (loss_g, g_g, l_g) = runs["cpu"], runs["cuda"]
        errs = {"/".join(path): rel(g, w) for (path, g), (_, w) in
                zip(tree_paths(g_g), tree_paths(g_c))}
        zero = [k for (path, w) in tree_paths(g_c)
                for k in ["/".join(path)] if float(w.abs().max()) == 0.0]
        worst = max(errs, key=errs.get)
        e_loss = abs(loss_g - loss_c) / abs(loss_c)
        print(f"{arch} smoke: step 1 loss card {loss_g:.7f} CPU {loss_c:.7f} "
              f"(rel {e_loss:.2e}, tol {tol_loss}); gradient worst leaf "
              f"{worst} {errs[worst]:.2e} of max |cpu| over {len(errs)} "
              f"leaves (tol {TOL_LM_GRAD}); zero leaves {zero}; step losses "
              f"card {[round(x, 6) for x in l_g]}, CPU "
              f"{[round(x, 6) for x in l_c]}")
        check(e_loss <= tol_loss and errs[worst] <= TOL_LM_GRAD and not zero
              and abs(l_g[0] - l_c[0]) <= tol_loss * abs(l_c[0])
              and all(math.isfinite(x) for x in l_g),
              f"train {arch}: the card's step 1 loss and gradient are the "
              f"CPU's")
    launches = {lib.name: lib.launches for lib in libs}
    check(all(v == 0 for v in launches.values()),
          f"train card vs CPU: no kernel launch under autograd {launches}")
    print(f"phase 41 took {time.perf_counter() - t_phase:.1f} s")


# The seventeenth slice: Whisper-small (arXiv:2212.04356; the encdec
# family: 12 encoder and 12 decoder layers, cross attention to 1,500
# frames) served at full width with phase 21's flags on float32 weights
# (phase 42), then InternVL2-26B (arXiv:2404.16821; the vlm family:
# InternLM2-20B's 48 layers after 256 image tokens) on bfloat16 weights,
# 37 GiB (phase 43): in float32 its 74 GiB do not fit one card beside a
# prefill.  42b and 43b hold the smoke configs card against CPU on a
# random frontend input.
ENCDEC_GROUPS = (("flash_attention kernel", r"flash_attention_kernel"),
                 ("matmuls (cuBLAS)", r"gemm|nvjet|xmma|cutlass|sm90_"),
                 ("casts and copies", r"copy"),
                 ("norms and reductions", r"reduce|norm"),
                 ("elementwise", r"elementwise"))
# Phases 42b-43b, card (kernel) against CPU (plain) at float32, of max
# |logit| over the prefill and the decode steps.  On whisper-smoke with
# random audio the seeded weights amplify rounding: on the CPU each
# float32 form (JAX's, the port's) lies up to 9.7e-5 of max |logit| from
# the port run in float64 (tests/test_torch_encdec.py), so two float32
# forms may lie up to about twice that apart; a missed key tile or a
# wrong mask moves logits by their own size.
TOL_FRONTEND_CPU = 5e-4
FRONTEND_STEPS = 8


def frontend_card_vs_cpu(libs, arch: str) -> None:
    """Phases 42b and 43b: ``arch``'s smoke config at float32 dtypes, the
    weights drawn on the CPU and copied to the card, a random frontend
    input (``audio_embeds`` or ``pixel_embeds``, seeded unit normals) and
    prompt: prefill and FRONTEND_STEPS - 1 greedy decode steps on the card
    (the kernel, counted) and on the CPU (the plain version): identical
    tokens, logits within TOL_FRONTEND_CPU of max |logit|."""
    from repro_torch import random as jr
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import registry
    from repro_torch.models.params import init_params
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              compute_dtype="float32",
                              cache_dtype="float32", reduce_dtype="float32")
    lm = registry.build(cfg)
    params = init_params(jr.key(0), lm.param_defs())
    (name, extra), = frontend_input(cfg, 2, SEED).items()
    tokens = jr.randint(jr.key(1), (2, 16), 0, cfg.vocab_size)
    runs = {}
    reset(libs)
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        logits, state = lm.prefill(
            p, {"tokens": tokens.to(dev), name: extra.to(dev)},
            cache_len=16 + FRONTEND_STEPS + cfg.n_image_tokens)
        toks, logs = [], []
        for step in range(FRONTEND_STEPS):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks.append(tok.cpu())
            logs.append(logits[:, -1].cpu())
            if step + 1 < FRONTEND_STEPS:
                logits, state = lm.decode_step(p, state, tok)
        runs[dev] = (torch.cat(toks, 1), torch.stack(logs))
    same = torch.equal(runs["cuda"][0], runs["cpu"][0])
    e = rel(runs["cuda"][1], runs["cpu"][1])
    print(f"{cfg.name}: random {name} {tuple(extra.shape)}; tokens identical "
          f"{same}; logits max |diff| / max |logit| {e:.2e} (tol "
          f"{TOL_FRONTEND_CPU}); flash launches on the card "
          f"{fa_ops.LIBRARY.variants}")
    check(same and e <= TOL_FRONTEND_CPU and fa_ops.LIBRARY.launches > 0,
          f"{arch} smoke: the card makes the CPU's tokens on a random "
          f"{name}")


# The eighteenth slice: the train launcher on the encdec and vlm families
# at full width (phase 44), as phase 35 runs OLMo-1B: B 8, S 128, remat
# per block, TRAIN_STEPS AdamW steps, float32 state, the launcher's zero
# frontend stubs.  Whisper-small uncut (0.264e9 parameters, 1,500 audio
# frames); InternVL2-26B at full width with its depth cut to
# IV_TRAIN_LAYERS of 48: 19.86e9 parameters' float32 params, moments and
# gradient are 318 GB, and 4 layers (2.698e9 with the embedding and the
# unembedding) are 43 GB, stepped in place (the launcher donates).
IV_TRAIN_LAYERS = 4


def train_frontends(libs, smi: str) -> None:
    """Phase 44: ``repro_torch.launch.train.main`` on Whisper-small and on
    InternVL2-26B cut to IV_TRAIN_LAYERS layers, each with every launch
    count at 0 (``train_report``'s checks), the earlier phases' memory
    freed first."""
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    for label, arch, extra in (
            ("44", WH_ARCH, []),
            ("44b", IV_ARCH, ["--override", f"n_layers={IV_TRAIN_LAYERS}"])):
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2 ** 30
        cfg = registry.get_config(arch)
        cut = f", depth {IV_TRAIN_LAYERS} of {cfg.n_layers}" if extra else ""
        stub = (f"{cfg.encoder_seq_len} audio frames"
                if cfg.family == "encdec"
                else f"+ {cfg.n_image_tokens} image positions")
        phase(f"{label} train launcher at full width: {arch}{cut}, batch 8, "
              f"seq 128 ({stub}), remat block, {TRAIN_STEPS} steps")
        print(f"memory held before the phase {held:.2f} GiB")
        check(held < 4.0, f"train {arch}: the earlier phases' memory is "
                          f"freed")
        reset(libs)
        rep = {}
        state = train.main(["--arch", arch, "--steps", str(TRAIN_STEPS),
                            *extra], report=rep)
        n = sum(p.numel() for p in tree_leaves(state["params"]))
        print(f"{arch}: {n:,} parameters trained")
        train_report(arch, rep, libs, smi, positions=8 * (
            128 + cfg.n_image_tokens) if cfg.family == "vlm" else 0)
        del state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 44 took {time.perf_counter() - t_phase:.1f} s")


# Phase 45: the LM dry run against the card.  OLMo-1B's cells on the
# one-rank test mesh at phase 35's train shape and phase 21's serving
# shapes (kind, sequence or cache length, batch), then the production
# cells traced on the host alone.
DRY_ARCH = "olmo_1b"
DRY_MESH = {"data": 1, "model": 1}
DRY_CELLS = (("train", 128, 8), ("prefill", 2048, 4), ("decode", 2080, 4))
DRY_PRODUCTION = (("train_4k", False), ("prefill_32k", False),
                  ("decode_32k", False), ("decode_32k", True))
# the card's peak above the bytes held against the traced high-water
# mark: the caching allocator rounds each block to 512 bytes, and the
# host's small index tensors (positions, masks) are on the card there
TOL_DRY_PEAK = 0.10

_DRY_HOST = r"""
import json, sys, time, traceback
sys.path.insert(0, SRC)
import torch
torch.set_num_threads(1)
from repro_torch.config import SHAPE_CELLS, ShapeCell
from repro_torch.launch import dryrun


def trace(cell, mp, mesh):
    t1 = time.perf_counter()
    try:
        r = dryrun.lower_cell(ARCH, cell, mp, mesh_shape=mesh)
    except Exception as e:
        r = {"arch": ARCH, "cell": cell.name, "mesh": "2x16x16" if mp
             else "16x16", "ok": False, "error": f"{type(e).__name__}: {e}",
             "traceback": traceback.format_exc()[-1500:]}
    r["wall_s"] = time.perf_counter() - t1
    return r


out = {"test": {}, "production": []}
t0 = time.perf_counter()
for kind, seq, batch in CELLS:
    out["test"][kind] = trace(ShapeCell(f"{kind}_{seq}", kind, seq, batch),
                              False, MESH)
for name, mp in PRODUCTION:
    out["production"].append(
        trace(next(c for c in SHAPE_CELLS if c.name == name), mp, None))
out["wall_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def start_dry_host() -> subprocess.Popen:
    """Phase 45's host traces, in a child process on one CPU thread that
    runs beside the card's phases (it touches no device)."""
    code = (f"SRC = {str(ROOT / 'src')!r}\nARCH = {DRY_ARCH!r}\n"
            f"MESH = {DRY_MESH!r}\nCELLS = {DRY_CELLS!r}\n"
            f"PRODUCTION = {DRY_PRODUCTION!r}\n" + _DRY_HOST)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    atexit.register(proc.kill)          # a failed phase leaves none behind
    return proc


def dry_inputs(setup, mesh, vocab: int):
    """The cell's inputs on the card, random: DTensors on ``mesh``, or
    plain tensors when ``mesh`` is None."""
    from repro_torch.launch import dryrun
    from repro_torch.tree import tree_map

    def local(shape, dtype):
        if dtype.is_floating_point:
            return (torch.randn(shape, device="cuda") * 0.02).to(dtype)
        return torch.randint(0, vocab, shape, dtype=dtype, device="cuda")
    if mesh is None:
        return tuple(tree_map(lambda a: local(a.shape, a.dtype), t)
                     for t in setup.inputs)
    return tuple(dryrun.materialize(t, mesh, local) for t in setup.inputs)


def dry_run_vs_card(host: subprocess.Popen, smi: str) -> None:
    phase(f"45 the dry run vs the card: {DRY_ARCH} at full width on a "
          f"one-rank NCCL test mesh (1, 1); the production cells traced "
          f"on the host")
    import torch.distributed as dist
    from repro_torch.config import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _free_port, make_test_mesh
    from repro_torch.models import registry
    t0 = time.perf_counter()
    so, se = host.communicate(timeout=900)
    check(host.returncode == 0, f"the host traces ran: {se[-2000:]}")
    traced = json.loads(so.strip().splitlines()[-1])
    print(f"host traces: {traced['wall_s']:.1f} s in the child process, "
          f"waited {time.perf_counter() - t0:.1f} s for them here")
    vocab = registry.get_config(DRY_ARCH).vocab_size
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_test_mesh()
        for kind, seq, batch in DRY_CELLS:
            pred = traced["test"][kind]
            if not pred["ok"]:
                print(pred["traceback"])
            check(pred["ok"] is True, f"the {kind} cell traced: "
                  f"{pred.get('error', '')[:300]}")
            cell = ShapeCell(f"{kind}_{seq}", kind, seq, batch)
            setup = dryrun.setup_cell(DRY_ARCH, cell, DRY_MESH)
            # prefill takes the flash kernel, which reads plain tensors
            inputs = dry_inputs(setup, None if kind == "prefill" else mesh,
                                vocab)
            if kind == "decode":
                inputs[1]["index"].fill_(seq - 32)
            args = inputs if kind == "prefill" else tuple(
                _local_tree(t) for t in inputs)
            setup.step(*args)                       # warm: cuBLAS, caches
            del args
            gc.collect()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = dryrun.measure(setup, inputs, DRY_MESH, device="cuda")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            pm, gm = pred["memory"], got["memory"]
            arg_card = dryrun.local_bytes(inputs)
            temp = pm["temp_size_in_bytes"]
            print(f"{kind} B {batch} S {seq}: argument bytes predicted "
                  f"{pm['argument_size_in_bytes']}, on the card {arg_card}; "
                  f"output {pm['output_size_in_bytes']} / "
                  f"{gm['output_size_in_bytes']}; alias "
                  f"{pm['alias_size_in_bytes']} / {gm['alias_size_in_bytes']}"
                  f"; flops {pred['flops_per_device']:.6e} / "
                  f"{got['flops_per_device']:.6e}; peak above the held "
                  f"bytes {peak / 2**30:.4f} GiB, predicted temp "
                  f"{temp / 2**30:.4f} GiB ({peak / temp - 1:+.4f}), the "
                  f"probe's own count on the card {gm['temp_size_in_bytes'] / 2**30:.4f} "
                  f"GiB; trace {pred['t_trace_s']} s on the host, "
                  f"{got['t_trace_s']} s on the card [{smi}]")
            check(arg_card == pm["argument_size_in_bytes"],
                  f"{kind}: argument bytes as predicted")
            check(gm["output_size_in_bytes"] == pm["output_size_in_bytes"],
                  f"{kind}: output bytes as predicted")
            if kind != "prefill":
                check(got["flops_per_device"] == pred["flops_per_device"],
                      f"{kind}: op_analysis FLOPs on the card as predicted")
                check(abs(peak / temp - 1) <= TOL_DRY_PEAK,
                      f"{kind}: the card's peak within {TOL_DRY_PEAK} of "
                      f"the predicted temp")
            del inputs, got
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for r in traced["production"]:
        print(dryrun.status_line(r) + f"  (wall {r['wall_s']:.1f} s)")
        if not r["ok"]:
            print(r["traceback"])
        check(r.get("ok") is True, f"{r['cell']} on {r['mesh']} traced OK")


def _local_tree(t):
    """A tree of DTensors as its local tensors (on one rank, the whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                    t)


# Phase 46: CUDA launches of one propagate (R = 8, 10 steps), the
# counterpart of tests/test_op_budget.py's compiled-op budgets: the kernel
# nodes of a CUDA graph captured around one call after a warm one
# (op_analysis.graph_nodes), a count of the call alone, whatever ran before
# it in the process.  Pinned exactly, as counted on an NVIDIA H100 80GB
# HBM3 at 700 W (MEASURED_LAUNCHES; the graph's memset, memcpy and other
# nodes in MEASURED_OTHER_NODES), with the budgets 25% above beside them.
MEASURED_LAUNCHES = {"pallas dense": 309, "pallas all-sparse": 452,
                     "fused dense": 126, "fused bonded-sparse": 126,
                     "fused all-sparse": 422, "batched": 3642}
MEASURED_OTHER_NODES = {name: {"memcpy": 55 if name == "batched" else 0,
                               "memset": 0, "other": 0}
                        for name in MEASURED_LAUNCHES}
LAUNCH_BUDGET = {k: int(1.25 * v) for k, v in MEASURED_LAUNCHES.items()}
BUDGET_ENGINES = {
    "pallas dense": {},
    "pallas all-sparse": dict(bonded="sparse", nonbonded="sparse"),
    "fused dense": dict(force_path="fused"),
    "fused bonded-sparse": dict(force_path="fused", bonded="sparse"),
    "fused all-sparse": dict(force_path="fused", bonded="sparse",
                             nonbonded="sparse"),
    "batched": dict(force_path="batched")}


def op_budgets(smi: str) -> None:
    """JAX's relative guard, fused < pallas, compares compiled op counts,
    where XLA fuses the fused path's in-loop noise hash into the body's
    elementwise fusions.  The noise kernel is the port's form of that
    fusion: each of the fused path's 11 legacy-layout blocks is one
    launch, the "pallas" path's stacked draw one (read from the graph's
    kernel nodes, the wrapper's counter printed beside), so the guard
    holds on the total launches; it is held besides each path's noise
    draw too (what kernel 3 fuses)."""
    phase("46 the op budgets on the card: CUDA launches of one propagate "
          "(R = 8, 10 MD steps), CUDA-graph kernel nodes")
    from repro_torch import random as jr
    from repro_torch.config import RepExConfig
    from repro_torch.core.controls import build_grid, ctrl_for_assignment
    from repro_torch.core.modes import per_replica_keys
    from repro_torch.kernels.noise import ops as nz_ops
    from repro_torch.launch import op_analysis
    from repro_torch.md import MDEngine
    from repro_torch.md import noise as NZ
    from repro_torch.md.integrators import stacked_step_noise
    grid = build_grid(RepExConfig(dimensions=(("temperature", 8),)), "cuda")
    ctrl = ctrl_for_assignment(grid, torch.arange(8, device="cuda"))
    keys = per_replica_keys(jr.key(7, "cuda"), 8)
    n_steps = torch.full((8,), 10, dtype=torch.int64, device="cuda")
    counts, failed = {}, []
    for name, kw in BUDGET_ENGINES.items():
        eng = MDEngine(device="cuda", **kw)
        state = eng.init_state(jr.key(SEED, "cuda"), 8)
        nodes = op_analysis.graph_nodes(
            eng.propagate, state, ctrl, n_steps, keys, max_steps=10)
        counts[name] = nodes.pop("kernel")
        print(f"{name}: {counts[name]} CUDA launches a propagate (pinned "
              f"{MEASURED_LAUNCHES[name]}, budget {LAUNCH_BUDGET[name]}); "
              f"other graph nodes {nodes} (pinned "
              f"{MEASURED_OTHER_NODES[name]}) [{smi}]")
        if (counts[name] != MEASURED_LAUNCHES[name]
                or nodes != MEASURED_OTHER_NODES[name]):
            failed.append(name)
        check(counts[name] <= LAUNCH_BUDGET[name],
              f"{name}: launches within the budget")
    check(not failed, f"the launches as pinned: {failed}")
    shape = tuple(state["pos"].shape[1:])
    draws = {"pallas": lambda: stacked_step_noise(keys, 11, shape),
             "fused": lambda: [NZ.step_noise_unrolled(keys, i, shape)
                               for i in range(11)]}
    noise, counted = {}, {}
    for path, draw in draws.items():
        noise[path] = op_analysis.count_launches(draw)
        reset([])
        draw()
        counted[path] = nz_ops.LIBRARY.launches
    print(f"noise draws: pallas {noise['pallas']} launches (one stacked "
          f"draw; the wrapper counted {counted['pallas']}), fused "
          f"{noise['fused']} (11 blocks in the loop body; "
          f"{counted['fused']})")
    check(noise == {"pallas": 1, "fused": 11} == counted,
          "the noise draws: one launch a draw")
    for kind in ("dense", "all-sparse"):
        f, p = counts[f"fused {kind}"], counts[f"pallas {kind}"]
        print(f"{kind}: fused {f} against pallas {p} launches in all; "
              f"besides the noise draws {f - noise['fused']} against "
              f"{p - noise['pallas']}")
        check(f < p, f"fused < pallas in launches, {kind}")
        check(f - noise["fused"] < p - noise["pallas"],
              f"fused < pallas in launches besides the noise, {kind}")
    check(counts["pallas dense"] < counts["batched"],
          "the analytic path < autodiff in launches")


# Phase 47: the noise kernel's bound, per element, from the operations
# its source runs (kernels/noise/csrc/threefry_normal.cu) for this run's
# data.  A threefry block: 2 key adds, 20 rounds of an add, a rotate (one
# funnel shift) and a xor, 5 injections of 3 adds, the parity key's 2
# xors: 79 int32 operations; the partitionable layout one block an
# element plus the counter split and b1 ^ b2 (3), the legacy layout one
# block for two elements plus the second counter's test (2); the
# mantissa map 2 more.  float32 operations (an FMA one), each element:
# the uniform 3 (a subtract, an FMA, a max), erf_inv 13 (-x^2, the test
# w < 5, w - 2.5, 8 FMAs, the test |x| = 1, p x), the normal's sqrt 2 1;
# log1p's rational branch (|u| < 0.6436, its argument -u^2 above
# -0.41421) 25 (the test, x^2, 14 FMAs, the division as a reciprocal and
# 3 FMAs, 5 for the sum) or its log branch 23 (x + 1, the exponent's
# select and float, the mantissa's 2, m^2, m^3, 9 FMAs, 7 for the
# sums); past w = 5 (|u| >= 0.99663) the square root's 5.  Double
# operations, as the fp64 peak counts them (a multiply and an add, 2):
# past w = 5 the double rsqrt (~6) and its 2 conversions; the SGLD
# update's last FMA, emulated in double, 2 and 3 conversions (the float
# <-> double conversions at 16 a clock an SM, beside the FP32 pipes' 128).
THREEFRY_INT_OPS = 79
# H100 SXM (NVIDIA data sheet: fp64 outside the tensor cores; the Hopper
# white paper: 64 int32 and 128 fp32 lanes an SM, 16 conversions to and
# from fp64 a clock, 132 SMs, at the 1,980 MHz boost clock that the fp32
# peak of 67 TFLOP/s assumes).
FP64_FLOPS_PER_S = 34e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9
F2F_PER_S = 132 * 16 * 1.98e9
NOISE_CASES = (1, 8, 384)
NOISE_TS = (0, 5, 10)
SGLD_LEAF = (50304, 2048)      # OLMo-1B's embedding: 103 M > 2^26
# the noise kernel's times before its float32 FMAs (the float64-emulated
# design; NVIDIA H100 80GB HBM3, 700 W) and that design's float <-> double
# conversions a kernel in its SASS (experiments/noise_kernel_ab.py)
NOISE_BEFORE_MS = {"stacked": 0.1588, "unrolled": 0.0892, "sgld": 2.7248}
NOISE_BEFORE_F2F = {"stacked": 104, "unrolled": 208, "sgld": 108}


def noise_bound(u: torch.Tensor, layout: str, nbytes: float):
    """(bound_ms, bound_by, parts) of one noise call whose uniforms
    (each before erf_inv, on (-1, 1)) are ``u``, ``layout`` "legacy",
    "partitionable" (a normal) or "sgld" (the partitionable layout into
    the SGLD update), writing and reading ``nbytes``."""
    a = u.abs()
    n = u.numel()
    n_rational = int((a < 0.6436).sum())
    n_tail = int((a >= 0.99663).sum())
    per = (THREEFRY_INT_OPS + 2) / 2 if layout == "legacy" \
        else THREEFRY_INT_OPS + 3
    int_ops = n * (per + 2)
    sgld = layout == "sgld"
    fp32 = (n * (16 + (0 if sgld else 1)) + 25 * n_rational
            + 23 * (n - n_rational) + 5 * n_tail)
    fp64 = 6 * n_tail + (2 * n if sgld else 0)
    f2f = 2 * n_tail + (3 * n if sgld else 0)
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "int32": int_ops / INT32_OPS_PER_S,
             "fp32": fp32 / FP32_OPS_PER_S,
             "fp64": fp64 / FP64_FLOPS_PER_S,
             "conversions": f2f / F2F_PER_S}
    by = max(times, key=times.get)
    parts = (f"{int_ops:.4e} int32 ops {times['int32'] * 1e3:.4f} ms, "
             f"{fp32:.4e} fp32 ops {times['fp32'] * 1e3:.4f} ms, "
             f"{fp64:.4e} fp64 FLOPs {times['fp64'] * 1e3:.4f} ms, "
             f"{f2f:.4e} conversions {times['conversions'] * 1e3:.4f} ms, "
             f"{nbytes / 1e6:.1f} MB {times['bytes'] * 1e3:.4f} ms; "
             f"log1p rational {n_rational / n:.4f}, erf_inv tail "
             f"{n_tail / n:.5f}")
    return (times[by] * 1e3, "bytes" if by == "bytes" else "operations",
            parts)


def noise_sass() -> dict:
    """The noise library's SASS census (``cuobjdump -sass``) by kernel:
    the float <-> double conversions ``F2F``, the fp64 and fp32
    arithmetic and the funnel shifts ``SHF`` (the hash's rotates)."""
    from repro_torch.kernels import sass_census
    from repro_torch.kernels.noise import ops as nz_ops
    ops = ("F2F", "DMUL", "DADD", "DFMA", "FFMA", "FMUL", "FADD", "SHF",
           "IADD3", "LOP3", "MUFU")
    out = {}
    for kernel, census in sass_census(nz_ops.LIBRARY.path).items():
        name = next((k for k in ("unrolled", "stacked", "sgld", "map")
                     if k in kernel), kernel)
        out[name] = {op: census.get(op, 0) for op in ops}
        out[name]["all"] = sum(census.values())
        print(f"SASS {name} ({kernel}): {out[name]}")
    check(set(out) == {"unrolled", "stacked", "sgld", "map"},
          "the noise library's four kernels in its SASS")
    return out


def noise_kernel(smi: str) -> dict:
    """Phase 47: the noise kernel bitwise its plain version on the card
    and on the CPU, the number of differing elements printed (0): the
    legacy-layout block and the stacked draw for R = 1, 8 and 384 at N =
    2,881 and t (a step of the stacked draw on the CPU) 0, 5, 10; the
    SGLD update on an OLMo-1B-sized leaf in one launch against the plain
    version's 2^26 slices, and around the slice border through the
    offset entry point against the launch over the whole leaf and the
    CPU; the bits -> normal map alone on all 2^23 mantissas it reads
    against the plain map on the card.  Then the library's SASS census
    and each entry point timed at its path's shape beside its bound, its
    plain version and the float64-emulated design's time.  Returns the
    kernels-line row's numbers (the main path's stacked draw, R = 64)."""
    phase(f"47 the noise kernel vs its plain version: R = {NOISE_CASES}, "
          f"N = {N_ATOMS}, t = {NOISE_TS}, an OLMo-1B leaf {SGLD_LEAF}")
    from repro_torch import random as jr
    from repro_torch.kernels.noise import ops as nz_ops
    from repro_torch.kernels.noise import ref as nz_ref
    gc.collect()
    torch.cuda.empty_cache()
    shape = (N_ATOMS, 3)
    diffs, err = {}, 0.0

    def differ(tag, got, want):
        nonlocal err
        d = int((got != want.to(got.device)).sum())
        err = max(err, float((got - want.to(got.device)).abs().max()))
        diffs[tag] = d
        return d
    for r in NOISE_CASES:
        keys = jr.split(jr.key(SEED + r, "cuda"), r)
        for t in NOISE_TS:
            got = nz_ops.step_noise_unrolled_batched(keys, t, shape)
            a = differ(f"unrolled R={r} t={t} card", got,
                       nz_ref.step_noise_unrolled(keys, t, shape))
            b = differ(f"unrolled R={r} t={t} cpu", got.cpu(),
                       nz_ref.step_noise_unrolled(keys.cpu(), t, shape))
            print(f"unrolled R={r} t={t}: differing elements {a} (card), "
                  f"{b} (CPU) of {got.numel()}")
        got = nz_ops.stacked_step_noise_batched(keys, 11, shape)
        a = differ(f"stacked R={r} card", got,
                   nz_ref.stacked_step_noise(keys, 11, shape))
        b = sum(differ(f"stacked R={r} t={t} cpu", got[t].cpu(),
                       jr.normal(jr.fold_in(keys.cpu(), t), shape))
                for t in NOISE_TS)
        print(f"stacked R={r}, 11 steps: differing elements {a} (card, all "
              f"steps), {b} (CPU, steps {NOISE_TS})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    leaf = torch.randn(SGLD_LEAF, generator=gen, device="cuda")
    key = jr.key(SEED + 1, "cuda")
    std = torch.tensor(0.0123, device="cuda")
    whole = nz_ops.add_noise_batched(leaf, key, std)
    a = differ("sgld leaf card", whole, nz_ref.add_noise(leaf, key, std))
    lo, hi = (1 << 26) - 2048, (1 << 26) + 2048
    flat = leaf.view(-1)
    part = nz_ops.add_noise_batched(flat[lo:hi].contiguous(), key, std, lo)
    b = differ("sgld window whole", part, whole.view(-1)[lo:hi])
    c = differ("sgld window cpu", part.cpu(),
               nz_ref.add_noise(flat[lo:hi].cpu(), key.cpu(), std.cpu(),
                                lo))
    print(f"sgld leaf {SGLD_LEAF}: differing elements {a} (card, plain in "
          f"2^26 slices); offset {lo}..{hi}: {b} (against the whole "
          f"leaf's launch), {c} (CPU)")
    # the bits -> normal map alone on every input it reads: the top 23
    # bits of a word (bits = m << 9), against the plain map on the card
    bits = torch.arange(1 << 23, dtype=torch.int64, device="cuda") << 9
    a = differ("map 2^23 card", nz_ops.bits_to_erf_inv_batched(bits),
               jr.bits_to_erf_inv(bits))
    del bits
    print(f"map on all 2^23 mantissas: differing elements {a} (card, "
          f"against the plain random.bits_to_erf_inv)")
    print(f"phase 47: {sum(diffs.values())} differing elements in "
          f"{len(diffs)} comparisons, max |diff| {err}")
    check(sum(diffs.values()) == 0, "the noise kernel bitwise its plain "
          "version, card and CPU")

    keys64 = jr.split(jr.key(SEED, "cuda"), R_MAIN)
    keys384 = jr.split(jr.key(SEED, "cuda"), R_TSU)
    sqrt2 = float(np.float32(np.sqrt(2.0)))
    cases = {
        "stacked": (lambda: nz_ops.stacked_step_noise_batched(
                        keys64, 11, shape),
                    lambda: nz_ref.stacked_step_noise(keys64, 11, shape),
                    "partitionable", 4),
        "unrolled": (lambda: nz_ops.step_noise_unrolled_batched(
                         keys384, 1, shape),
                     lambda: nz_ref.step_noise_unrolled(keys384, 1, shape),
                     "legacy", 4),
        "sgld": (lambda: nz_ops.add_noise_batched(leaf, key, std),
                 lambda: nz_ref.add_noise(leaf, key, std),
                 "sgld", 8)}
    sass = noise_sass()
    for name, f2f in NOISE_BEFORE_F2F.items():
        print(f"{name}: float <-> double conversions in the kernel's SASS "
              f"{f2f} (float64-emulated FMAs) -> {sass[name]['F2F']}")
    out = {}
    for name, (kern, plain, layout, per) in cases.items():
        z = kern()
        u = torch.erf(((z.double() - leaf.double()) / (std.double() * sqrt2))
                      if name == "sgld" else z.double() / sqrt2)
        bound, by, parts = noise_bound(u, layout, per * z.numel())
        del z, u
        k_ms = graph_ms(kern, calls=5 if name == "sgld" else 20)
        p_ms = median_ms(plain, n=3 if name == "sgld" else 5, warmup=1)
        print(f"{name}: kernel {k_ms:.4f} ms device (graph replay; "
              f"float64-emulated FMAs {NOISE_BEFORE_MS[name]}), plain "
              f"{p_ms:.4f} ms; bound {bound:.4f} ms ({by}: {parts}) "
              f"[{smi}]")
        out[name] = (k_ms, p_ms, bound, by)
    del leaf, whole
    k_ms, p_ms, bound, by = out["stacked"]
    return {"err": err, "ms": k_ms, "plain_ms": p_ms, "bound": (bound, by)}


def ready() -> bool:
    """CUDA and the repository around the script (``src/repro_torch``),
    which goes on ``sys.path``; else a message and False."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return False
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return False
    sys.path.insert(0, str(src))
    return True


def across_gpus() -> int:
    """``python3 -m torch.distributed.run --nproc-per-node N chip_smoke.py``
    with N > 1 GPUs: phase 33, run_sharded across the GPUs (one NCCL rank
    each) and across half of them, against run_fused on one GPU."""
    if not ready():
        return 1
    import torch.distributed as dist
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.exchange_matrix import ops as x_ops
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    from repro_torch.kernels.lj_forces import ops as nb_ops
    from repro_torch.kernels.nlist_build import ops as nl_ops
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    mesh = make_replica_mesh(device="cuda")
    half = make_replica_mesh(mesh.n_shards // 2, device="cuda")
    rank = dist.get_rank()
    smi = [environment() if rank == 0 else None]
    dist.broadcast_object_list(smi, src=0)
    smi = smi[0].replace("\n", "; ")
    from repro_torch.kernels.noise import ops as nz_ops
    libs = [chain_ops.LIBRARY, nb_ops.LIBRARY, fused_ops.LIBRARY,
            x_ops.LIBRARY, nb_ops.SPARSE_LIBRARY, nl_ops.LIBRARY,
            nz_ops.LIBRARY]
    if rank == 0:
        build(libs)
    dist.barrier()
    for lib in libs:
        lib.load()
    if rank == 0:
        phase(f"33 run_sharded across {mesh.n_shards} and "
              f"{half.n_shards} GPUs (NCCL {torch.cuda.nccl.version()}) vs "
              f"run_fused on one")
    t_cfg = dict(dimensions=(("temperature", R_MAIN),),
                 md_steps_per_cycle=10, n_cycles=8)
    tsu = dict(dimensions=TSU_DIMS, md_steps_per_cycle=10, n_cycles=3)

    def chain():
        return MDEngine(chain_molecule(N_ATOMS), device="cuda")
    cases = (
        ("T-REMD 64 halo", chain, t_cfg, 0.0, 4),
        ("T-REMD 64 gather", chain, dict(t_cfg, exchange_comm="gather"),
         0.0, 4),
        ("T-REMD 64 async faults", chain, dict(t_cfg, **ASYNC), FAIL_RATE,
         4),
        ("TSU 384 fused neighbor", lambda: tsu_engine("fused"), tsu, 0.0,
         3),
        ("TSU 384 fused matrix", lambda: tsu_engine("fused"),
         dict(tsu, exchange_scheme="matrix"), 0.0, 3),
        ("TSU 384 sparse fused", lambda: sparse_engine("fused"), tsu, 0.0,
         3))
    across_ranks(mesh, half, cases, smi)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        print(f"total seconds {time.perf_counter() - _T0:.1f}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not ready():
        return 1
    from repro_torch.kernels.chain_forces import ops as chain_ops
    from repro_torch.kernels.exchange_matrix import ops as x_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_propagate import ops as fused_ops
    from repro_torch.kernels.lj_forces import ops as nb_ops
    from repro_torch.kernels.nlist_build import ops as nl_ops
    from repro_torch.kernels.noise import ops as nz_ops
    from repro_torch.md import MDEngine
    from repro_torch.md.system import chain_molecule
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    dry_host = start_dry_host()
    smi = environment()
    libs = [chain_ops.LIBRARY, nb_ops.LIBRARY, fused_ops.LIBRARY,
            x_ops.LIBRARY, nb_ops.SPARSE_LIBRARY, nl_ops.LIBRARY,
            nb_ops.LJ_FLUID_LIBRARY, fa_ops.LIBRARY, nl_ops.CELL_LIBRARY]
    build(libs + [nz_ops.LIBRARY])

    phase(f"3 kernels vs plain versions at N={N_ATOMS}, R=4 and R={R_MAIN}")
    engine = MDEngine(chain_molecule(N_ATOMS), device="cuda")
    compare(engine, 4, "R=4")
    abs_b, abs_nb, pos = compare(engine, R_MAIN, f"R={R_MAIN}")
    times = timing(engine, pos, smi)
    bound = bounds(engine, R_MAIN)
    before_and_bound("nonbonded", times["nonbonded"][0], bound)
    before_and_bound("chain_forces", times["chain_forces"][0], bound)
    launches_per_call(engine, pos)
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
    before_and_bound("chain_forces_bias", times["chain_forces_bias"][0],
                     bound)
    before_and_bound("exchange_matrix", times["exchange_matrix"][0], bound)
    del inputs
    no_ceiling_fused(smi)

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
    for name in ("nlist_build", "nlist_build (flag 0)"):
        before_and_bound(name, times[name][0], bound)
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
    before_and_bound("lj_energy", times["lj_energy"][0], bound)
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
    timing_wide(smi)
    err19c, _ = serve_shapes(smi)
    times.update(times5)
    bound.update(bound5)
    serve_rep, serve_launches = run_serve(libs, smi)
    breakdown_serve(serve_rep, smi)
    del serve_rep
    serve_against_cpu()

    oracle_paths(smi)
    async_faults(libs, smi)
    mode2_runs(libs, smi)
    async_against_cpu()

    report27 = observability(libs, launches, smi)
    err28 = cell_build(smi)
    cell_launches, err29, times_cell, bound_cell = cell_against_cpu(libs,
                                                                    smi)
    err_cell = max(err28, err29)
    times.update(times_cell)
    bound.update(bound_cell)
    cli_run(report27, smi)
    mesh = sharded(libs, smi)
    block_invariance(mesh, smi)
    import torch.distributed as dist
    dist.destroy_process_group()
    sgld_launches, err34 = re_sgld(libs, smi)
    train_launcher(libs, smi)
    examples(smi)
    moe_launches = serve_moe(libs, smi)
    phase("37b LM serving: card vs CPU (deepseek-moe-smoke, float32)")
    serve_card_vs_cpu(MOE_ARCH)
    from repro_torch.models import registry
    v2_launches = serve_wide(libs, smi, V2_ARCH, "38",
                             registry.get_config(V2_ARCH).n_layers)
    phase("38b LM serving: card vs CPU (deepseek-v2-lite-smoke, float32)")
    serve_card_vs_cpu(V2_ARCH)
    rg_launches = serve_wide(libs, smi, RG_ARCH, "39",
                             registry.get_config(RG_ARCH).n_layers // 3)
    phase("39b LM serving: card vs CPU (recurrentgemma-smoke, float32)")
    serve_card_vs_cpu(RG_ARCH)
    serve_wide(libs, smi, XL_ARCH, "40", 0, kernel_groups=XLSTM_GROUPS)
    phase("40b LM serving: card vs CPU (xlstm-smoke, float32)")
    serve_card_vs_cpu(XL_ARCH)
    train_card_vs_cpu(libs)
    wh = registry.get_config(WH_ARCH)
    wh_launches = serve_wide(libs, smi, WH_ARCH, "42",
                             wh.n_encoder_layers + 2 * wh.n_layers,
                             kernel_groups=ENCDEC_GROUPS,
                             n_flash_token=wh.n_layers)
    phase("42b LM serving: card vs CPU (whisper-smoke, float32, random "
          "audio)")
    frontend_card_vs_cpu(libs, WH_ARCH)
    iv_launches = serve_wide(libs, smi, IV_ARCH, "43",
                             registry.get_config(IV_ARCH).n_layers,
                             kernel_groups=ENCDEC_GROUPS,
                             param_dtype=torch.bfloat16)
    phase("43b LM serving: card vs CPU (internvl2-smoke, float32, random "
          "pixel embeddings)")
    frontend_card_vs_cpu(libs, IV_ARCH)
    train_frontends(libs, smi)
    t45 = time.perf_counter()
    dry_run_vs_card(dry_host, smi)
    op_budgets(smi)
    print(f"phases 45-46: {time.perf_counter() - t45:.1f} s")
    t47 = time.perf_counter()
    nz = noise_kernel(smi)
    print(f"phase 47: {time.perf_counter() - t47:.1f} s")

    names = ("chain_forces", "chain_forces_bias", "nonbonded", "fused_baoab",
             "exchange_matrix", "nonbonded_sparse", "nlist_build",
             "lj_energy", "lj_forces", "flash_attention", "cell_build",
             "threefry_normal")
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
                           "flash_attention.cu",
        "cell_build": "src/repro_torch/kernels/nlist_build/csrc/"
                      "cell_build.cu",
        "threefry_normal": "src/repro_torch/kernels/noise/csrc/"
                           "threefry_normal.cu"}
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
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85",
        # not a TPU kernel: build_cells, the jnp cell-list build (under the
        # same lax.cond)
        "cell_build": "src/repro/md/neighbors.py:204",
        # not a TPU kernel: XLA's elementwise fusion of the unrolled
        # threefry hash and the bits -> normal map (step_noise_unrolled)
        "threefry_normal": "src/repro/md/noise.py:109"}
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
              "flash_attention": serve_launches["flash_attention"]
              + sgld_launches["flash_attention"] + moe_launches
              + v2_launches + rg_launches + wh_launches + iv_launches,
              "cell_build": cell_launches["cell_build"],
              "threefry_normal": sum(NOISE_RUNS.values())}
    errs = dict(errs2, chain_forces=abs_b, nonbonded=abs_nb, **errs3,
                **errs4, flash_attention=max(err5, err34, err19c),
                cell_build=err_cell, threefry_normal=nz["err"])
    times["threefry_normal"] = (nz["ms"], nz["plain_ms"])
    bound["threefry_normal"] = nz["bound"]
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
    sys.exit(across_gpus() if int(os.environ.get("WORLD_SIZE", "1")) > 1
             else main())
