"""Host side of the fused BAOAB kernel: the wrapper, its plain version
and the iteration loop.

``fused_baoab_batched`` launches ``csrc/fused_baoab.cu`` on CUDA tensors
(and counts the launch); ``fused_iteration_plain`` is the same function
in PyTorch: the slot-sum bonded force (``ref.bonded_forces_sparse``),
the direct pair sums (``nonbonded_plain``), ``f = fb + (lj + salt * el)``
and the masked update.  ``fused_iteration`` sends a CUDA stack to the
kernel and a CPU stack to the plain version.

``fused_propagate`` is the driver of the JAX package's
``fused_propagate/ops.py``: ``max_steps + 1`` iterations, each drawing
its noise block in place (``md/noise.py``, pre-scaled by the hoisted
``noise_scale``), building the (R, 8) step rows [trail, lead, salt
scale, 0...] on the device and running one fused iteration.  The
kernel reads the (R, N, 3) stacks directly: no packed layout, no one-hot
gather matrix.  ``c1`` comes from the port's ``baoab_scales``, as on the
plain path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import (KernelLibrary, check_cuda,
                                 default_use_kernel, raise_on_error,
                                 stream_ptr)
from repro_torch.kernels.chain_forces import ops as chain_ops
from repro_torch.kernels.chain_forces import ref as chain_ref
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.kernels.lj_forces import ref as nb_ref
from repro_torch.md import integrators as I
from repro_torch.md import noise as NZ

LIBRARY = KernelLibrary(
    "fused_baoab", Path(__file__).parent / "csrc" / "fused_baoab.cu")

_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])
STAGE_BYTES = 24    # a staged j atom in the kernel: x, y, z, q, sigma / 2,
                    # sqrt(eps)


def rows_in_shared(ld: int) -> bool:
    """Whether a replica's three force rows of ``ld`` floats fit in the
    kernel's shared memory beside its warps' staged j atoms: up to
    ld = 16,256 (so N <= 16,256).  Above, they live in an (R, 3, ld)
    scratch in device memory (variant "rows_l2"), the same sums in the
    same order."""
    staged = (nb_ops.pair_warps(ld // nb_ops.PAIR_TILE) * nb_ops.PAIR_TILE
              * STAGE_BYTES)
    return staged + 3 * ld * 4 <= nb_ops.SMEM_LIMIT


def step_par(i: int, n_steps: torch.Tensor, max_steps: int,
             salt_col: torch.Tensor) -> torch.Tensor:
    """The (R, 8) step rows of iteration ``i``: [trail, lead, salt scale,
    0 ...], the masks of ``integrators.baoab_fused_iteration``."""
    trail = ((n_steps >= i) & bool(i >= 1)).to(torch.float32)
    lead = ((n_steps > i) & bool(i < max_steps)).to(torch.float32)
    zero = torch.zeros_like(trail)
    return torch.stack([trail, lead, salt_col.to(torch.float32)]
                       + [zero] * 5, dim=1)


def fused_baoab_batched(pos, vel, noise, st, bias: Optional[torch.Tensor],
                        cpack, npack, masses, c1: float, dt: float):
    """The kernel: CUDA (R, N, 3) pos / vel / pre-scaled noise, (R, 8)
    step rows, (R, 8) bias rows or None -> (new pos, new vel) in one
    launch (one block per replica, its force rows in shared memory up to
    N = 16,256 and in device memory above); anything else raises.
    Counted under the variant "rows_shared" or "rows_l2"."""
    r, n, _ = pos.shape
    tables = (cpack.bonds, cpack.bond_par, cpack.angles, cpack.ang_par,
              cpack.quads, cpack.quad_par, cpack.slot_idx, cpack.slot_sign,
              npack.lj_sigma, npack.sqrt_eps, npack.charges,
              npack.mask_bits, npack.tile_kept, masses)
    stacks = (pos, vel, noise, st) + (() if bias is None else (bias,))
    check_cuda(stacks + tables,
               ("pos", "vel", "noise", "step_par")
               + (() if bias is None else ("bias",))
               + ("bonds", "bond_par", "angles", "ang_par", "quads",
                  "quad_par", "slot_idx", "slot_sign", "lj_sigma",
                  "sqrt_eps", "charges", "mask_bits", "tile_kept",
                  "masses"))
    for name, t, shape in (("pos", pos, (r, cpack.n_atoms, 3)),
                           ("vel", vel, (r, n, 3)),
                           ("noise", noise, (r, n, 3)),
                           ("step_par", st, (r, 8)),
                           ("bias", bias, (r, 8))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    ld = npack.mask_bits.shape[0]
    shared = rows_in_shared(ld)
    rows = (None if shared else
            torch.empty((r, 3, ld), dtype=torch.float32, device=pos.device))
    fn = LIBRARY.function("fused_baoab_launch", _ARGTYPES)
    npos = torch.empty_like(pos)
    nvel = torch.empty_like(vel)
    ptrs = [t.data_ptr() for t in (pos, vel, noise, st)]
    ptrs += [None if bias is None else bias.data_ptr()]
    ptrs += [t.data_ptr() for t in tables]
    ptrs += [None if rows is None else rows.data_ptr()]
    ptrs += [npos.data_ptr(), nvel.data_ptr()]
    code = fn(*ptrs, r, n, ld, cpack.bonds.shape[0],
              cpack.angles.shape[0], cpack.quads.shape[0],
              cpack.top.edge_width, cpack.slots.n_slots, nb_ref.COULOMB, c1,
              0.5 * dt * I.AKMA, 0.5 * dt, stream_ptr())
    raise_on_error(code, "fused_baoab")
    LIBRARY.count("rows_shared" if shared else "rows_l2")
    return npos, nvel


def fused_iteration_plain(pos, vel, noise, st, bias: Optional[torch.Tensor],
                          cpack, npack, masses, c1: float, dt: float):
    """The kernel's plain PyTorch version, same arguments and result."""
    center, k = (None, None) if bias is None else (bias[:, 0:2],
                                                   bias[:, 2:4])
    fb, _ = chain_ref.bonded_forces_sparse(pos, cpack.top, cpack.slots,
                                           center, k)
    f_lj, f_el, _, _ = nb_ops.nonbonded_plain(pos, npack)
    f = fb + (f_lj + st[:, 2, None, None] * f_el)
    return I.baoab_masked_update(pos, vel, f, noise, c1, masses,
                                 (st[:, 0] > 0.5)[:, None, None],
                                 (st[:, 1] > 0.5)[:, None, None], dt)


def fused_iteration(pos, vel, noise, st, bias, cpack, npack, masses,
                    c1: float, dt: float):
    """One fused iteration: the kernel on the card, its plain version on
    the CPU."""
    fn = (fused_baoab_batched if default_use_kernel(pos)
          else fused_iteration_plain)
    return fn(pos, vel, noise, st, bias, cpack, npack, masses, c1, dt)


def fused_propagate(state, cpack, npack, masses, ctrl, n_steps, rngs,
                    max_steps: int, dt: float, gamma: float):
    """Propagate the replica stack through ``max_steps + 1`` fused
    iterations.  ``cpack`` / ``npack``: the engine's bonded and
    nonbonded packs; ``ctrl`` rows as the engine consumes them; ``rngs``
    (R, 2) keys.  Returns {"pos", "vel"}."""
    pos = state["pos"].contiguous()
    vel = state["vel"].contiguous()
    r, n, _ = pos.shape
    center = ctrl.get("umbrella_center")
    bias = (None if center is None else
            chain_ops.pack_bias(center, ctrl["umbrella_k"], r, pos.device))
    salt = ctrl.get("salt")
    salt_col = (torch.ones(r, dtype=torch.float32, device=pos.device)
                if salt is None else 1.0 - 0.5 * salt)
    c1, noise_scale = I.baoab_scales(masses, ctrl["temperature"], dt, gamma)
    for i in range(max_steps + 1):
        nz = noise_scale * NZ.step_noise_unrolled(rngs, i, (n, 3))
        st = step_par(i, n_steps, max_steps, salt_col)
        pos, vel = fused_iteration(pos, vel, nz, st, bias, cpack, npack,
                                   masses, c1, dt)
    return {"pos": pos, "vel": vel}
