"""Host-side packing + dispatch for the Lennard-Jones kernels.

The LJ fluid (``LJEngine``): ``lj_energy_batched`` / ``lj_forces_batched``
launch ``csrc/lj_fluid.cu`` on a CUDA (R, N, 3) stack (counted on
``LJ_FLUID_LIBRARY`` under the variants "energy" and "forces") and raise
on anything else; ``fluid_energy`` / ``fluid_forces`` are the MD-facing
entry points, the kernels on the card and ``ref.lj_energy`` /
``ref.lj_forces`` (their plain versions) on the CPU; ``LJEnergy`` is the
counterpart of the JAX ops' ``custom_vjp``: energy forward, the forces
kernel backward; ``lj_energy`` / ``lj_forces`` take one (N, 3)
configuration through an R = 1 launch.

The chain nonbonded kernels:

``build_pack(system)`` keeps the system's per-atom parameters and builds
what the CUDA kernels read, once: the sqrt(eps) row, a uint8 copy of
the 0/1 exclusion mask (the neighbor-list build reads it) and the same
mask as 32-bit rows of bits with a flag per pair of 64-atom tiles that
no exclusion touches (``tile_flags``; the all-pairs and fused kernels
read these).

The all-pairs kernels (``csrc/nonbonded.cu``, the forces kernel of
``csrc/lj_fluid.cu``) visit each unordered pair once through the walk
of ``csrc/pair_tiles.cuh``; the host side of that walk is here:
``tile_schedule`` (the round table), ``block_split`` (blocks per
replica) and ``rows_in_shared`` (where the chain kernel's partial force
rows live; the fluid's are always in device memory).

``nonbonded_force`` is the one MD-facing entry point: a CUDA stack goes
through the kernel (``nonbonded_batched``, which launches
``csrc/nonbonded.cu`` and counts the launch), with the salt scale applied
outside it; a CPU stack through the PyTorch oracle
(``ref.nonbonded_force``, the JAX package's CPU path).  The kernel's
plain version, ``nonbonded_plain``, makes the same direct pair sums as
the TPU kernel's ``nonbonded_pair_rows``.

The sparse pass over a neighbor list: ``nonbonded_sparse`` /
``nonbonded_force_sparse`` dispatch, ``nonbonded_sparse_batched``
launches ``csrc/nonbonded_sparse.cu`` (counted on ``SPARSE_LIBRARY``).
Its plain version is the oracle, ``ref.nonbonded_sparse``: the same
direct slot sums, with eps as sqrt(eps_i eps_j) where the kernel takes
sqrt(eps_i) sqrt(eps_j), a rounding apart.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import (REPLICA_CHUNK, KernelLibrary, check_cuda,
                                 default_use_kernel, f32_square,
                                 pad_to_block, raise_on_error, stream_ptr)
from repro_torch.kernels.lj_forces import ref

# -- the all-pairs walk (csrc/pair_tiles.cuh) ---------------------------------

TILE = 128          # atoms per block of the per-atom kernels (kTile in
                    # csrc/md_terms.cuh); atom axes pad to a multiple of it
PAIR_TILE = 64      # atoms per tile of the pair walk; kPT in pair_tiles.cuh
                    # and kFT in fused_baoab.cu
MAX_WARPS = 24      # warps of a block at most; kMaxWarps in pair_tiles.cuh
SMEM_LIMIT = 232448  # shared memory one block may use on an H100 (kMaxSmem)
# Warps that one wave of blocks keeps in flight: 132 SMs at 24 warps each.
# A constant, not read from the card, so a split and with it every sum's
# order depend on the shapes alone.
WAVE_WARPS = 132 * MAX_WARPS

_SCHEDULES: dict = {}


def pair_warps(n_tiles: int) -> int:
    """Warps of a block: one per tile pair of a round, at most
    ``MAX_WARPS``."""
    return min(n_tiles // 2, MAX_WARPS)


def block_split(n_rep: int, n_tiles: int, waves: int = 1) -> int:
    """Blocks per replica S: enough for ``waves`` waves of ``WAVE_WARPS``
    warps over the stack, at least 1, at most one round of the schedule
    per block.  The chain kernel takes one wave (R = 64, N = 2881: S = 2;
    its 23-warp, 80-register blocks fit once per SM, so S = 2 fills 128
    of the 132 SMs); the fluid's forces kernel two (R = 64, N = 864:
    S = 14, one round per block; its 7-warp blocks fit four to an SM).
    Each was the fastest split of those timed on an H100 80GB HBM3 at
    700 W."""
    return max(1, min(n_tiles, waves * WAVE_WARPS
                      // (max(n_rep, 1) * pair_warps(n_tiles))))


def rows_in_shared(ld: int) -> bool:
    """Whether a chain-kernel block's six partial force rows of ``ld``
    floats fit in shared memory beside its warps' staged j atoms (24 bytes
    each): up to ld = 8064.  If not they live in the partial-sum scratch
    in device memory (pair_tiles.cuh smem_bytes)."""
    staged = pair_warps(ld // PAIR_TILE) * PAIR_TILE * 24
    return staged + 6 * ld * 4 <= SMEM_LIMIT


def tile_schedule(n_tiles: int, device) -> torch.Tensor:
    """The round table of the pair walk for an even ``n_tiles``: (n_tiles,
    n_tiles) int32, row 0 the diagonal tiles (t, t), row u >= 1 the
    n_tiles / 2 disjoint tile pairs I < J of round u - 1 of the circle
    method (pairs (n_tiles - 1, u) and ((u + k) % (n_tiles - 1),
    (u - k) % (n_tiles - 1)) for k = 1 .. n_tiles / 2 - 1), then -1; an
    entry packs I | J << 16.  Block s of a replica's S runs rows s, s + S,
    ...  Built once per (n_tiles, device) from device operations, so a
    first call inside a ``run_fused`` chunk copies nothing from the
    host."""
    key = (n_tiles, str(device))
    if key not in _SCHEDULES:
        odd, half = n_tiles - 1, n_tiles // 2
        u = torch.arange(odd, device=device)[:, None].expand(odd, half)
        k = torch.arange(half, device=device)[None, :]
        a = torch.remainder(u + k, odd)
        b = torch.remainder(u - k, odd)
        a[:, 0] = odd
        b[:, 0] = u[:, 0]
        table = torch.full((n_tiles, n_tiles), -1, dtype=torch.int32,
                           device=device)
        table[0] = (torch.arange(n_tiles, device=device) * 65537).to(
            torch.int32)
        table[1:, :half] = (torch.minimum(a, b)
                            | (torch.maximum(a, b) << 16)).to(torch.int32)
        _SCHEDULES[key] = table
    return _SCHEDULES[key]


# -- the LJ fluid -------------------------------------------------------------

LJ_FLUID_LIBRARY = KernelLibrary(
    "lj_fluid", Path(__file__).parent / "csrc" / "lj_fluid.cu")

_ENERGY_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
    [ctypes.c_float] * 3 + [ctypes.c_void_p]
_FORCES_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
    [ctypes.c_float] * 4 + [ctypes.c_void_p]


def _check_stack(pos: torch.Tensor) -> None:
    check_cuda((pos,), ("pos",))
    if pos.dtype != torch.float32 or pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be a float32 (R, N, 3) stack, got "
                         f"{pos.dtype} {tuple(pos.shape)}")


def lj_energy_batched(pos: torch.Tensor, sigma: float, eps: float,
                      box: float) -> torch.Tensor:
    """The energy kernel: a CUDA (R, N, 3) stack -> (R,) in one launch
    (the block sums, then their in-order sum); anything else raises."""
    _check_stack(pos)
    r, n, _ = pos.shape
    sig2, c4, _, box = ref.fluid_constants(sigma, eps, box)
    fn = LJ_FLUID_LIBRARY.function("lj_energy_launch", _ENERGY_ARGTYPES)
    e_part = torch.empty((r, (n + TILE - 1) // TILE), dtype=torch.float32,
                         device=pos.device)
    energy = torch.empty(r, dtype=torch.float32, device=pos.device)
    code = fn(pos.data_ptr(), e_part.data_ptr(), energy.data_ptr(), r, n,
              box, sig2, c4, stream_ptr())
    raise_on_error(code, "lj_energy")
    LJ_FLUID_LIBRARY.count("energy")
    return energy


def lj_forces_batched(pos: torch.Tensor, sigma: float, eps: float,
                      box: float) -> torch.Tensor:
    """The forces kernel: a CUDA (R, N, 3) stack -> (R, N, 3) forces in
    one launch (the pair walk, then the sum of its partial rows); anything
    else raises."""
    _check_stack(pos)
    r, n, _ = pos.shape
    sig2, _, c24, box = ref.fluid_constants(sigma, eps, box)
    inv_box = float(np.float32(1.0 / box)) if box > 0 else 0.0
    fn = LJ_FLUID_LIBRARY.function("lj_forces_launch", _FORCES_ARGTYPES)
    ld = pad_to_block(n, TILE)
    n_tiles = ld // PAIR_TILE
    split = block_split(r, n_tiles, waves=2)
    sched = tile_schedule(n_tiles, pos.device)
    part = torch.empty((r, split, 3, ld), dtype=torch.float32,
                       device=pos.device)
    forces = torch.empty_like(pos)
    code = fn(pos.data_ptr(), sched.data_ptr(), part.data_ptr(),
              forces.data_ptr(), r, n, ld, split, box, inv_box, sig2, c24,
              stream_ptr())
    raise_on_error(code, "lj_forces")
    LJ_FLUID_LIBRARY.count("forces")
    return forces


def fluid_energy(pos, sigma: float, eps: float, box: float):
    """(R, N, 3) -> (R,): the energy kernel on the card, the oracle on
    the CPU."""
    if default_use_kernel(pos):
        return lj_energy_batched(pos.contiguous(), sigma, eps, box)
    return ref.lj_energy(pos, sigma, eps, box)


def fluid_forces(pos, sigma: float, eps: float, box: float):
    """(R, N, 3) -> (R, N, 3): the forces kernel on the card, the oracle
    on the CPU."""
    if default_use_kernel(pos):
        return lj_forces_batched(pos.contiguous(), sigma, eps, box)
    return ref.lj_forces(pos, sigma, eps, box)


class LJEnergy(torch.autograd.Function):
    """(R, N, 3) -> (R,) energies whose gradient is the forces pass, not
    autodiff through the sweep: ``dU/dx = -F``, the backward of the JAX
    ops' ``custom_vjp``.  Both directions dispatch by device."""

    @staticmethod
    def forward(ctx, pos, sigma: float, eps: float, box: float):
        ctx.save_for_backward(pos)
        ctx.params = (sigma, eps, box)
        return fluid_energy(pos, sigma, eps, box)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        f = fluid_forces(pos, *ctx.params)
        return -g[:, None, None] * f, None, None, None


def lj_energy(pos, sigma: float, eps: float, box: float):
    """One (N, 3) configuration -> scalar, differentiable (``LJEnergy``
    on an R = 1 stack: one launch each way on the card)."""
    return LJEnergy.apply(pos[None], sigma, eps, box)[0]


def lj_forces(pos, sigma: float, eps: float, box: float):
    """One (N, 3) configuration -> (N, 3) forces (an R = 1 launch on the
    card)."""
    return fluid_forces(pos[None], sigma, eps, box)[0]


# -- the chain nonbonded pass -------------------------------------------------

LIBRARY = KernelLibrary(
    "nonbonded", Path(__file__).parent / "csrc" / "nonbonded.cu")


class NonbondedPack(NamedTuple):
    lj_sigma: torch.Tensor    # (N,) f32
    lj_eps: torch.Tensor      # (N,) f32
    charges: torch.Tensor     # (N,) f32
    nb_mask: torch.Tensor     # (N, N) f32, 0 on the diagonal + exclusions
    sqrt_eps: torch.Tensor    # (N,) f32: eps_ij = sqrt_eps_i * sqrt_eps_j
    mask_u8: torch.Tensor     # (N, ld) uint8 copy of nb_mask, zero-padded
                              # to ld = a whole number of tiles
    mask_bits: torch.Tensor   # (ld, ld / 32) int32: bit b of word w in row
                              # i is mask_u8[i, 32 w + b]; rows >= N zero
    tile_kept: torch.Tensor   # (ld / 64, ld / 64) uint8: 1 where a tile
                              # pair holds only kept pairs of real atoms


def tile_flags(mask_u8: torch.Tensor, tile: int = PAIR_TILE):
    """(mask bits, all-kept flags) of an (N, ld) uint8 mask, ld a multiple
    of ``tile`` and of 32, padded with zero rows to (ld, ld): a tile pair
    at the ragged edge or holding an exclusion is not all kept."""
    n, ld = mask_u8.shape
    full = torch.zeros((ld, ld), dtype=torch.uint8, device=mask_u8.device)
    full[:n] = mask_u8
    words = sum(full[:, b::32].to(torch.int64) << b for b in range(32))
    bits = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    nt = ld // tile
    kept = full.reshape(nt, tile, nt, tile).amin(dim=(1, 3))
    return bits.to(torch.int32), kept


def build_pack(system) -> NonbondedPack:
    n = int(system.n_atoms)
    ld = pad_to_block(n, TILE)
    mask_u8 = torch.zeros((n, ld), dtype=torch.uint8,
                          device=system.nb_mask.device)
    mask_u8[:, :n] = system.nb_mask.to(torch.uint8)
    mask_bits, tile_kept = tile_flags(mask_u8)
    return NonbondedPack(
        lj_sigma=system.lj_sigma.contiguous(),
        lj_eps=system.lj_eps.contiguous(),
        charges=system.charges.contiguous(), nb_mask=system.nb_mask,
        sqrt_eps=torch.sqrt(system.lj_eps).contiguous(), mask_u8=mask_u8,
        mask_bits=mask_bits, tile_kept=tile_kept)


def _plain_block(pos, pack: NonbondedPack):
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    dx = x[..., :, None] - x[..., None, :]
    dy = y[..., :, None] - y[..., None, :]
    dz = z[..., :, None] - z[..., None, :]
    m = pack.nb_mask
    # masked pairs (diagonal, exclusions) never see r2 -> 0
    r2 = dx * dx + dy * dy + dz * dz + (1.0 - m)
    sig = 0.5 * (pack.lj_sigma[:, None] + pack.lj_sigma[None, :])
    eps = pack.sqrt_eps[:, None] * pack.sqrt_eps[None, :]
    qq = pack.charges[:, None] * pack.charges[None, :]
    s6 = (sig * sig / r2) ** 3
    r = torch.sqrt(r2)
    e_lj = 0.5 * torch.sum(4.0 * eps * (s6 * s6 - s6) * m, dim=(-2, -1))
    e_el = 0.5 * torch.sum(ref.COULOMB * qq / r * m, dim=(-2, -1))
    c_lj = 24.0 * eps * (2.0 * s6 * s6 - s6) / r2 * m
    c_el = ref.COULOMB * qq / (r2 * r) * m
    f_lj = torch.stack([torch.sum(c_lj * d, -1) for d in (dx, dy, dz)], -1)
    f_el = torch.stack([torch.sum(c_el * d, -1) for d in (dx, dy, dz)], -1)
    return f_lj, f_el, e_lj, e_el


def nonbonded_plain(pos: torch.Tensor, pack: NonbondedPack):
    """The kernel's plain PyTorch version: the same direct pair sums
    ``F_i = sum_j c_ij (x_i - x_j)`` (no rowsum identity), chunked over
    replicas so the (R, N, N) planes stay a few GB at N = 2881."""
    outs = [_plain_block(pos[i:i + REPLICA_CHUNK], pack)
            for i in range(0, pos.shape[0], REPLICA_CHUNK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_void_p])


def nonbonded_batched(pos: torch.Tensor, pack: NonbondedPack):
    """The kernel: a CUDA (R, N, 3) stack -> (f_lj (R, N, 3),
    f_el (R, N, 3), e_lj (R,), e_el (R,)) in one launch (the pair walk,
    then the sum of its partial rows); anything else raises.  Counted
    under the variant "rows_shared", or "rows_l2" where the partial rows
    live in device memory (N above 8064)."""
    r, n, _ = pos.shape
    rows = (pack.lj_sigma, pack.sqrt_eps, pack.charges, pack.mask_bits,
            pack.tile_kept)
    check_cuda((pos,) + rows,
               ("pos", "lj_sigma", "sqrt_eps", "charges", "mask_bits",
                "tile_kept"))
    if pos.dtype != torch.float32 or n != pack.lj_sigma.shape[0]:
        raise ValueError(f"pos must be float32 (R, {pack.lj_sigma.shape[0]},"
                         f" 3), got {pos.dtype} {tuple(pos.shape)}")
    fn = LIBRARY.function("nonbonded_launch", _ARGTYPES)
    ld = pack.mask_bits.shape[0]
    n_tiles = ld // PAIR_TILE
    split = block_split(r, n_tiles)
    shared = rows_in_shared(ld)
    sched = tile_schedule(n_tiles, pos.device)
    part = torch.empty((r, split, 6, ld), dtype=torch.float32,
                       device=pos.device)
    e_part = torch.empty((r, split, 2), dtype=torch.float32,
                         device=pos.device)
    f_lj = torch.empty_like(pos)
    f_el = torch.empty_like(pos)
    e_lj = torch.empty(r, dtype=torch.float32, device=pos.device)
    e_el = torch.empty(r, dtype=torch.float32, device=pos.device)
    ptrs = [t.data_ptr() for t in (pos,) + rows
            + (sched, part, e_part, f_lj, f_el, e_lj, e_el)]
    code = fn(*ptrs, r, n, ld, split, int(shared), ref.COULOMB,
              stream_ptr())
    raise_on_error(code, "nonbonded")
    LIBRARY.count("rows_shared" if shared else "rows_l2")
    return f_lj, f_el, e_lj, e_el


def nonbonded_force(pos: torch.Tensor, pack: NonbondedPack,
                    salt_scale=None):
    """Combined (salt-scaled) nonbonded force for the propagate loop:
    (R, N, 3) -> (R, N, 3).  The kernel path combines the sweep's split
    outputs; the CPU path folds the scaling into one coefficient pass."""
    if not default_use_kernel(pos):
        return ref.nonbonded_force(pos, pack.lj_sigma, pack.lj_eps,
                                   pack.charges, pack.nb_mask, salt_scale)
    f_lj, f_el, _, _ = nonbonded_batched(pos.contiguous(), pack)
    if salt_scale is not None:
        f_el = salt_scale[..., None, None] * f_el
    return f_lj + f_el


# -- the sparse (neighbor-list) pass ------------------------------------------

SPARSE_LIBRARY = KernelLibrary(
    "nonbonded_sparse",
    Path(__file__).parent / "csrc" / "nonbonded_sparse.cu")


_SPARSE_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                    + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def nonbonded_sparse_batched(pos, pack: NonbondedPack, idx, valid,
                             cutoff: float):
    """The sparse kernel: a CUDA (R, N, 3) stack and its (R, N, K) int32
    ``idx`` / f32 ``valid`` list -> (f_lj (R, N, 3), f_el (R, N, 3),
    e_lj (R,), e_el (R,)) in one launch; anything else raises."""
    r, n, _ = pos.shape
    rows = (pack.lj_sigma, pack.sqrt_eps, pack.charges)
    check_cuda((pos,) + rows + (idx, valid),
               ("pos", "lj_sigma", "sqrt_eps", "charges", "idx", "valid"))
    k = idx.shape[-1]
    if (pos.dtype != torch.float32 or n != pack.lj_sigma.shape[0]
            or idx.dtype != torch.int32 or valid.dtype != torch.float32
            or tuple(idx.shape) != (r, n, k)
            or tuple(valid.shape) != (r, n, k)):
        raise ValueError(f"want float32 pos (R, {pack.lj_sigma.shape[0]}, 3)"
                         f" with an int32 idx and f32 valid of (R, N, K); got "
                         f"{pos.dtype} {tuple(pos.shape)}, {idx.dtype} "
                         f"{tuple(idx.shape)}, {valid.dtype}")
    fn = SPARSE_LIBRARY.function("nonbonded_sparse_launch", _SPARSE_ARGTYPES)
    f_lj = torch.empty_like(pos)
    f_el = torch.empty_like(pos)
    e_part = torch.empty((r, pad_to_block(n, TILE) // TILE, 2),
                         dtype=torch.float32, device=pos.device)
    e_lj = torch.empty(r, dtype=torch.float32, device=pos.device)
    e_el = torch.empty(r, dtype=torch.float32, device=pos.device)
    ptrs = [t.data_ptr() for t in (pos,) + rows
            + (idx, valid, f_lj, f_el, e_part, e_lj, e_el)]
    code = fn(*ptrs, r, n, k, f32_square(cutoff), ref.COULOMB, stream_ptr())
    raise_on_error(code, "nonbonded_sparse")
    SPARSE_LIBRARY.count()
    return f_lj, f_el, e_lj, e_el


def nonbonded_sparse(pos, pack: NonbondedPack, idx, valid, cutoff: float,
                     pair=None):
    """The sparse pass with its energies: the kernel on the card (which
    reads the packed atom rows and ignores ``pair``), the oracle on the
    CPU (with the build-time planes when the list carries them)."""
    if default_use_kernel(pos):
        return nonbonded_sparse_batched(pos.contiguous(), pack, idx, valid,
                                        cutoff)
    return ref.nonbonded_sparse(pos, pack.lj_sigma, pack.lj_eps,
                                pack.charges, idx, valid, cutoff, pair)


def nonbonded_force_sparse(pos, pack: NonbondedPack, idx, valid,
                           cutoff: float, salt_scale=None, pair=None):
    """Combined (salt-scaled) sparse force for the propagate loop:
    (R, N, 3) -> (R, N, 3).  The kernel path combines the sweep's split
    outputs; the CPU path folds the scaling into one coefficient pass."""
    if not default_use_kernel(pos):
        return ref.nonbonded_force_sparse(pos, pack.lj_sigma, pack.lj_eps,
                                          pack.charges, idx, valid, cutoff,
                                          salt_scale, pair)
    f_lj, f_el, _, _ = nonbonded_sparse_batched(pos.contiguous(), pack, idx,
                                                valid, cutoff)
    if salt_scale is not None:
        f_el = salt_scale[..., None, None] * f_el
    return f_lj + f_el
