"""Host-side dispatch for the device-gated neighbor-list build.

``build_gated(pos, take, old, nb_pack, r_list, k_max)`` is the one
entry point: replica r's list is built where ``take`` is set and its old
``idx`` / ``valid`` rows are kept elsewhere; ``take`` is a device tensor,
one element (every replica) or (R,), and is never read on the host.  A
CUDA stack goes through the kernels (``nlist_build_batched``, which
launches ``csrc/nlist_build.cu``, two CUDA launches per call, and counts
the call once), a CPU stack through the plain version,
``build_gated_plain``: the whole build (``ref.build_dense``) and a
per-replica select.  On the CPU that costs a build per call, which only
the small CPU runs pay; on the card the kernels read the flag and build
only where it is set, testing only the tile pairs whose bounding boxes
lie within the list radius (``ref.build_culled`` is that algorithm in
PyTorch).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import (KernelLibrary, check_cuda,
                                 default_use_kernel, f32_square,
                                 raise_on_error, stream_ptr)
from repro_torch.kernels.nlist_build import ref

LIBRARY = KernelLibrary(
    "nlist_build", Path(__file__).parent / "csrc" / "nlist_build.cu")

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _rows(take: torch.Tensor, n_rep: int) -> torch.Tensor:
    """The flag as an (R,) bool row (a view for the one-element form)."""
    return take.reshape(-1).to(torch.bool).expand(n_rep)


def build_gated_plain(pos, take, old: Optional[Tuple], nb_mask,
                      r_list: float, k_max: int):
    """The kernel's plain version: (idx, valid, dropped) with the fresh
    list where ``take`` is set, the ``old`` (idx, valid) rows elsewhere,
    and ``dropped`` 0 for the kept replicas."""
    idx, valid, dropped = ref.build_dense(pos, nb_mask, r_list, k_max)
    if old is None:
        return idx, valid, dropped
    t = _rows(take, pos.shape[0])
    return (torch.where(t[:, None, None], idx, old[0]),
            torch.where(t[:, None, None], valid, old[1]),
            torch.where(t, dropped, 0))


def nlist_build_batched(pos, take, old: Optional[Tuple], mask_bits,
                        r_list: float, k_max: int):
    """The kernels: CUDA tensors -> (idx (R, N, K) int32, valid (R, N, K)
    f32, dropped (R,) int32), written to fresh buffers; anything else
    raises.  ``mask_bits``: the pack's (ld, ld / 32) int32 mask words.
    ``old`` None builds every replica (``take`` is not read)."""
    r, n, _ = pos.shape
    if old is None:
        take = torch.ones(1, dtype=torch.int32, device=pos.device)
    flag = take.reshape(-1).to(torch.int32).contiguous()
    if flag.numel() not in (1, r):
        raise ValueError(f"take must have 1 or {r} elements, got "
                         f"{flag.numel()}")
    idx = torch.empty((r, n, k_max), dtype=torch.int32, device=pos.device)
    valid = torch.empty((r, n, k_max), dtype=torch.float32,
                        device=pos.device)
    old_idx, old_valid = (idx, valid) if old is None else old
    check_cuda((pos, mask_bits, flag, old_idx, old_valid),
               ("pos", "mask_bits", "take", "old idx", "old valid"))
    n_tiles = -(-n // ref.TILE)
    if (pos.dtype != torch.float32 or mask_bits.dtype != torch.int32
            or mask_bits.shape[0] < n or mask_bits.shape[1] < n_tiles
            or old_idx.dtype != torch.int32
            or tuple(old_idx.shape) != (r, n, k_max)
            or tuple(old_valid.shape) != (r, n, k_max)):
        raise ValueError(f"want float32 pos (R, N, 3), int32 mask bits of "
                         f"at least ({n}, {n_tiles}) and an old int32 list "
                         f"of ({r}, {n}, {k_max}); got {pos.dtype} "
                         f"{tuple(pos.shape)}, {mask_bits.dtype} "
                         f"{tuple(mask_bits.shape)}, "
                         f"{tuple(old_idx.shape)} {old_idx.dtype}")
    boxes = torch.empty((r, n_tiles, 6), dtype=torch.float32,
                        device=pos.device)
    dropped = torch.empty(r, dtype=torch.int32, device=pos.device)
    r_list2 = f32_square(r_list)
    fn = LIBRARY.function("nlist_build_launch", _ARGTYPES)
    code = fn(pos.data_ptr(), mask_bits.data_ptr(), mask_bits.shape[1],
              flag.data_ptr(), 0 if flag.numel() == 1 else 1,
              old_idx.data_ptr(), old_valid.data_ptr(), idx.data_ptr(),
              valid.data_ptr(), boxes.data_ptr(), dropped.data_ptr(), r, n,
              k_max, r_list2, ref.cull_threshold(r_list2), stream_ptr())
    raise_on_error(code, "nlist_build")
    LIBRARY.count()
    return idx, valid, dropped


def build_gated(pos, take, old: Optional[Tuple], nb_pack, r_list: float,
                k_max: int):
    """(idx, valid, dropped) of the gated build: the kernel on the card,
    its plain version on the CPU.  ``nb_pack``: the engine's
    ``lj_forces.ops.NonbondedPack`` (its float mask for the plain build,
    its mask bits for the kernels)."""
    if default_use_kernel(pos):
        return nlist_build_batched(pos.contiguous(), take, old,
                                   nb_pack.mask_bits, r_list, k_max)
    return build_gated_plain(pos, take, old, nb_pack.nb_mask, r_list, k_max)
