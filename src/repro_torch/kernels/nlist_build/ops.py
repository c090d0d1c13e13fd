"""Host-side dispatch for the device-gated neighbor-list builds.

``build_gated(pos, take, old, nb_pack, r_list, k_max, cells)`` is the
one entry point: replica r's list is built where ``take`` is set and its
old ``idx`` / ``valid`` rows are kept elsewhere; ``take`` is a device
tensor, one element (every replica) or (R,), and is never read on the
card.  ``cells`` None is the dense build, ``(grid_dims, cell_capacity)``
the cell-list build.  A CUDA stack goes through a kernel pair, which
counts the call once: ``nlist_build_batched`` (``csrc/nlist_build.cu``,
the dense build) or ``cell_build_batched`` (``csrc/cell_build.cu``, the
cell build), two CUDA launches per call each.  A CPU stack goes through
the plain version, ``build_gated_plain``: the whole build
(``ref.build_dense`` / ``ref.build_cells``) and a per-replica select.
On the CPU the dense build runs every call, which only the small CPU runs
pay; the cell build, whose candidate planes are far wider (27 cells of
``cell_capacity`` slots a row), runs there only when a flag is set (a
host read costs the CPU nothing).  On the card the kernels read the flag
and build only where it is set: the dense kernels test only the tile
pairs whose bounding boxes lie within the list radius
(``ref.build_culled`` is that algorithm in PyTorch), the cell kernels
bin the atoms by a counting sort over up to 16 blocks a replica and
test each cell's rows, a thread a row, against its stencil's atoms
staged once for all of them (``ref.build_cells_counting``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import (KernelLibrary, check_cuda,
                                 default_use_kernel, f32_square,
                                 raise_on_error, stream_ptr)
from repro_torch.kernels.nlist_build import ref

LIBRARY = KernelLibrary(
    "nlist_build", Path(__file__).parent / "csrc" / "nlist_build.cu")
CELL_LIBRARY = KernelLibrary(
    "cell_build", Path(__file__).parent / "csrc" / "cell_build.cu")
MAX_CELLS = 4096          # kMaxCells in csrc/cell_build.cu (16^3)

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_CELL_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
                  + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                  + [ctypes.c_void_p])


def _rows(take: torch.Tensor, n_rep: int) -> torch.Tensor:
    """The flag as an (R,) bool row (a view for the one-element form)."""
    return take.reshape(-1).to(torch.bool).expand(n_rep)


def build_gated_plain(pos, take, old: Optional[Tuple], nb_mask,
                      r_list: float, k_max: int, cells=None):
    """The kernels' plain version: (idx, valid, dropped) with the fresh
    list where ``take`` is set, the ``old`` (idx, valid) rows elsewhere,
    and ``dropped`` 0 for the kept replicas.  ``cells``: None (the dense
    build) or (grid_dims, cell_capacity) (the cell build)."""
    if cells is None:
        idx, valid, dropped = ref.build_dense(pos, nb_mask, r_list, k_max)
    else:
        idx, valid, dropped = ref.build_cells(pos, nb_mask, r_list, k_max,
                                              *cells)
    if old is None:
        return idx, valid, dropped
    t = _rows(take, pos.shape[0])
    return (torch.where(t[:, None, None], idx, old[0]),
            torch.where(t[:, None, None], valid, old[1]),
            torch.where(t, dropped, 0))


def _flag_and_outputs(pos, take, old: Optional[Tuple], k_max: int):
    """(flag, old idx, old valid, idx, valid) of a kernel call: the flag
    as contiguous int32 (all ones where ``old`` is None), fresh outputs,
    and the outputs themselves standing in for a missing ``old``."""
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
    return flag, old_idx, old_valid, idx, valid


def nlist_build_batched(pos, take, old: Optional[Tuple], mask_bits,
                        r_list: float, k_max: int):
    """The kernels: CUDA tensors -> (idx (R, N, K) int32, valid (R, N, K)
    f32, dropped (R,) int32), written to fresh buffers; anything else
    raises.  ``mask_bits``: the pack's (ld, ld / 32) int32 mask words.
    ``old`` None builds every replica (``take`` is not read)."""
    r, n, _ = pos.shape
    flag, old_idx, old_valid, idx, valid = _flag_and_outputs(pos, take, old,
                                                             k_max)
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


def cell_build_batched(pos, take, old: Optional[Tuple], mask_bits,
                       r_list: float, k_max: int, grid_dims,
                       cell_capacity: int):
    """The cell-build kernels: CUDA tensors -> (idx (R, N, K) int32, valid
    (R, N, K) f32, dropped (R,) int32), written to fresh buffers; anything
    else raises.  ``mask_bits``: the pack's (ld, ld / 32) int32 mask
    words; ``grid_dims`` (at most MAX_CELLS cells) and ``cell_capacity``
    as for ``ref.build_cells``.  ``old`` None builds every replica."""
    r, n, _ = pos.shape
    gx, gy, gz = (int(g) for g in grid_dims)
    cap = int(cell_capacity)
    flag, old_idx, old_valid, idx, valid = _flag_and_outputs(pos, take, old,
                                                             k_max)
    check_cuda((pos, mask_bits, flag, old_idx, old_valid),
               ("pos", "mask_bits", "take", "old idx", "old valid"))
    n_cells = gx * gy * gz
    if (pos.dtype != torch.float32 or mask_bits.dtype != torch.int32
            or mask_bits.shape[0] < n or 32 * mask_bits.shape[1] < n
            or min(gx, gy, gz, cap) < 1 or n_cells > MAX_CELLS
            or old_idx.dtype != torch.int32
            or tuple(old_idx.shape) != (r, n, k_max)
            or tuple(old_valid.shape) != (r, n, k_max)):
        raise ValueError(f"want float32 pos (R, N, 3), int32 mask bits "
                         f"covering {n} atoms, a grid of 1 to {MAX_CELLS} "
                         f"cells, a capacity >= 1 and an old int32 list of "
                         f"({r}, {n}, {k_max}); got {pos.dtype} "
                         f"{tuple(pos.shape)}, {mask_bits.dtype} "
                         f"{tuple(mask_bits.shape)}, grid {grid_dims}, "
                         f"capacity {cap}, {tuple(old_idx.shape)} "
                         f"{old_idx.dtype}")
    dev = pos.device
    block = ref.bin_block(n)
    n_blocks = -(-n // block)
    cell_of = torch.empty((r, n), dtype=torch.int32, device=dev)
    posc = torch.empty((r, n, 4), dtype=torch.float32, device=dev)
    tab = torch.empty((r, n_cells, n_blocks, 2), dtype=torch.int32,
                      device=dev)
    dropped = torch.empty(r, dtype=torch.int32, device=dev)
    fn = CELL_LIBRARY.function("cell_build_launch", _CELL_ARGTYPES)
    code = fn(pos.data_ptr(), mask_bits.data_ptr(), mask_bits.shape[1],
              flag.data_ptr(), 0 if flag.numel() == 1 else 1,
              old_idx.data_ptr(), old_valid.data_ptr(), idx.data_ptr(),
              valid.data_ptr(), cell_of.data_ptr(), posc.data_ptr(),
              tab.data_ptr(), dropped.data_ptr(), r, n, k_max, gx, gy, gz,
              cap, block, float(np.float32(r_list)), f32_square(r_list),
              stream_ptr())
    raise_on_error(code, "cell_build")
    CELL_LIBRARY.count()
    return idx, valid, dropped


def build_gated(pos, take, old: Optional[Tuple], nb_pack, r_list: float,
                k_max: int, cells=None):
    """(idx, valid, dropped) of the gated build: the kernels on the card,
    their plain version on the CPU.  ``nb_pack``: the engine's
    ``lj_forces.ops.NonbondedPack`` (its float mask for the plain build,
    its mask bits for the kernels); ``cells``: None for the dense build,
    (grid_dims, cell_capacity) for the cell build."""
    if default_use_kernel(pos):
        if cells is None:
            return nlist_build_batched(pos.contiguous(), take, old,
                                       nb_pack.mask_bits, r_list, k_max)
        return cell_build_batched(pos.contiguous(), take, old,
                                  nb_pack.mask_bits, r_list, k_max, *cells)
    # a CPU cost measure, the cell build's alone (see the module
    # docstring): skip its wide candidate planes when no flag is set;
    # the outputs stay fresh tensors, as everywhere else
    if cells is not None and old is not None and not bool(take.any()):
        return (old[0].clone(), old[1].clone(),
                torch.zeros(pos.shape[0], dtype=torch.int32))
    return build_gated_plain(pos, take, old, nb_pack.nb_mask, r_list, k_max,
                             cells)
