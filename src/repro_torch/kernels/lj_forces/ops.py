"""Host-side packing + dispatch for the chain nonbonded kernel.

``build_pack(system)`` keeps the system's per-atom parameters and builds
what the CUDA kernel reads, once: the sqrt(eps) row and a uint8 copy of
the 0/1 exclusion mask (8.7 MB at N = 2881 instead of the 34.7 MB f32
mask, so it stays in the 50 MB L2 while every replica re-reads it).

``nonbonded_force`` is the one MD-facing entry point: a CUDA stack goes
through the kernel (``nonbonded_batched``, which launches
``csrc/nonbonded.cu`` and counts the launch), with the salt scale applied
outside it; a CPU stack through the PyTorch oracle
(``ref.nonbonded_force``, the JAX package's CPU path).  The kernel's
plain version, ``nonbonded_plain``, makes the same direct pair sums as
the TPU kernel's ``nonbonded_pair_rows``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import (REPLICA_CHUNK, KernelLibrary, check_cuda,
                                 default_use_kernel, pad_to_block,
                                 raise_on_error, stream_ptr)
from repro_torch.kernels.lj_forces import ref

LIBRARY = KernelLibrary(
    "nonbonded", Path(__file__).parent / "csrc" / "nonbonded.cu")

TILE = 128          # atoms per tile; must match kTile in nonbonded.cu


class NonbondedPack(NamedTuple):
    lj_sigma: torch.Tensor    # (N,) f32
    lj_eps: torch.Tensor      # (N,) f32
    charges: torch.Tensor     # (N,) f32
    nb_mask: torch.Tensor     # (N, N) f32, 0 on the diagonal + exclusions
    sqrt_eps: torch.Tensor    # (N,) f32: eps_ij = sqrt_eps_i * sqrt_eps_j
    mask_u8: torch.Tensor     # (N, ld) uint8 copy of nb_mask, zero-padded
                              # to ld = a whole number of tiles


def build_pack(system) -> NonbondedPack:
    n = int(system.n_atoms)
    ld = pad_to_block(n, TILE)
    mask_u8 = torch.zeros((n, ld), dtype=torch.uint8,
                          device=system.nb_mask.device)
    mask_u8[:, :n] = system.nb_mask.to(torch.uint8)
    return NonbondedPack(
        lj_sigma=system.lj_sigma.contiguous(),
        lj_eps=system.lj_eps.contiguous(),
        charges=system.charges.contiguous(), nb_mask=system.nb_mask,
        sqrt_eps=torch.sqrt(system.lj_eps).contiguous(), mask_u8=mask_u8)


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


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_void_p])


def nonbonded_batched(pos: torch.Tensor, pack: NonbondedPack):
    """The kernel: a CUDA (R, N, 3) stack -> (f_lj (R, N, 3),
    f_el (R, N, 3), e_lj (R,), e_el (R,)) in one launch; anything else
    raises."""
    r, n, _ = pos.shape
    rows = (pack.lj_sigma, pack.sqrt_eps, pack.charges, pack.mask_u8)
    check_cuda((pos,) + rows,
               ("pos", "lj_sigma", "sqrt_eps", "charges", "mask_u8"))
    if pos.dtype != torch.float32 or n != pack.lj_sigma.shape[0]:
        raise ValueError(f"pos must be float32 (R, {pack.lj_sigma.shape[0]},"
                         f" 3), got {pos.dtype} {tuple(pos.shape)}")
    fn = LIBRARY.function("nonbonded_launch", _ARGTYPES)
    ld = pack.mask_u8.shape[1]
    f_lj = torch.empty_like(pos)
    f_el = torch.empty_like(pos)
    e_part = torch.empty((r, ld // TILE, 2), dtype=torch.float32,
                         device=pos.device)
    e_lj = torch.empty(r, dtype=torch.float32, device=pos.device)
    e_el = torch.empty(r, dtype=torch.float32, device=pos.device)
    ptrs = [t.data_ptr() for t in (pos,) + rows
            + (f_lj, f_el, e_part, e_lj, e_el)]
    code = fn(*ptrs, r, n, ld, ref.COULOMB, stream_ptr())
    raise_on_error(code, "nonbonded")
    LIBRARY.count()
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
