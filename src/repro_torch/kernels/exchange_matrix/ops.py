"""Host side of the exchange-matrix kernel: packing, dispatch, the
ctypes wrapper.

``exchange_matrix(features, ctrl)`` is the one entry point: CUDA rows go
through the kernel (``exchange_matrix_batched``, which launches
``csrc/exchange_matrix.cu`` and counts the launch), CPU rows through the
PyTorch oracle ``ref.exchange_matrix``, which is also the kernel's plain
version.  The kernel reads packed rows: features (4, R) [u_base, u_elec,
phi_deg, psi_deg] and controls (6, C) [beta, salt, c0, c1, k0, k1], an
absent field packed as zeros (inert in the formula).
``exchange_matrix_staged`` launches the kernel's staged design (a grid
sized to the work, slower on an H100), and ``empty_launch(r, c, grid)``
an empty kernel on the kernel's grid ("kernel"), on the staged design's
("staged") or as one block ("one"): what the kernel's time is measured
against, on no path and not counted.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import (KernelLibrary, check_cuda,
                                 default_use_kernel, raise_on_error,
                                 stream_ptr)
from repro_torch.kernels.exchange_matrix import ref

LIBRARY = KernelLibrary(
    "exchange_matrix", Path(__file__).parent / "csrc" / "exchange_matrix.cu",
    flags=("-fmad=false",))

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def pack_features(features) -> torch.Tensor:
    """(4, R) rows: u_base, u_elec, phi and psi in degrees."""
    return torch.stack([features["u_base"], features["u_elec"],
                        torch.rad2deg(features["phi"]),
                        torch.rad2deg(features["psi"])]).contiguous()


def pack_ctrl(ctrl) -> torch.Tensor:
    """(6, C) rows: beta, salt, c0, c1, k0, k1."""
    beta = ctrl["beta"]
    rows = torch.zeros((6, beta.shape[0]), dtype=torch.float32,
                       device=beta.device)
    rows[0] = beta
    if "salt" in ctrl:
        rows[1] = ctrl["salt"]
    center = ctrl.get("umbrella_center")
    if center is not None:
        n_u = center.shape[1]
        rows[2:2 + n_u] = center.T
        rows[4:4 + n_u] = ctrl["umbrella_k"].T
    return rows


def exchange_matrix_batched(feat: torch.Tensor, ctrl_rows: torch.Tensor
                            ) -> torch.Tensor:
    """The kernel: CUDA (4, R) feature rows and (6, C) ctrl rows ->
    (R, C) in one launch; anything else raises."""
    check_cuda((feat, ctrl_rows), ("feat", "ctrl_rows"))
    if (feat.dtype != torch.float32 or ctrl_rows.dtype != torch.float32
            or feat.shape[0] != 4 or ctrl_rows.shape[0] != 6):
        raise ValueError(f"want float32 (4, R) and (6, C) rows, got "
                         f"{feat.dtype} {tuple(feat.shape)} and "
                         f"{ctrl_rows.dtype} {tuple(ctrl_rows.shape)}")
    r, c = feat.shape[1], ctrl_rows.shape[1]
    fn = LIBRARY.function("exchange_matrix_launch", _ARGTYPES)
    out = torch.empty((r, c), dtype=torch.float32, device=feat.device)
    code = fn(feat.data_ptr(), ctrl_rows.data_ptr(), out.data_ptr(), r, c,
              stream_ptr())
    raise_on_error(code, "exchange_matrix")
    LIBRARY.count()
    return out


def exchange_matrix_staged(feat: torch.Tensor, ctrl_rows: torch.Tensor
                           ) -> torch.Tensor:
    """The staged design of the kernel (at most one block per SM, the
    control rows in shared memory, 16-byte stores), on the kernel's
    inputs: (R, C), bitwise the kernel's.  On no path; not counted."""
    check_cuda((feat, ctrl_rows), ("feat", "ctrl_rows"))
    r, c = feat.shape[1], ctrl_rows.shape[1]
    fn = LIBRARY.function("exchange_matrix_staged_launch", _ARGTYPES)
    out = torch.empty((r, c), dtype=torch.float32, device=feat.device)
    raise_on_error(fn(feat.data_ptr(), ctrl_rows.data_ptr(), out.data_ptr(),
                      r, c, stream_ptr()), "exchange_matrix_staged")
    return out


EMPTY_GRIDS = ("kernel", "staged", "one")


def empty_launch(r: int, c: int, grid: str) -> None:
    """An empty kernel on the current stream, on the kernel's grid for (R,
    C) ("kernel": C / 128 x R blocks of 128), on the staged design's
    ("staged": at most 132 blocks) or as one block of 32 threads ("one").
    A launch floor; not counted."""
    fn = LIBRARY.function("empty_launch", [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
    raise_on_error(fn(r, c, EMPTY_GRIDS.index(grid), stream_ptr()),
                   "empty_launch")


def exchange_matrix(features, ctrl) -> torch.Tensor:
    """(R, C) matrix u_c(x_i): the kernel on the card, the oracle on the
    CPU."""
    if default_use_kernel(features["u_base"]):
        return exchange_matrix_batched(pack_features(features),
                                       pack_ctrl(ctrl))
    return ref.exchange_matrix(features, ctrl)
