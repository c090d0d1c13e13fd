"""Host side of the noise kernel: the ctypes wrappers, their launch count
and the dispatch.

``step_noise_unrolled_batched``, ``stacked_step_noise_batched`` and
``add_noise_batched`` launch ``csrc/threefry_normal.cu`` on CUDA tensors,
one launch a call, counted under the variants "unrolled", "stacked" and
"sgld"; anything else raises.  ``bits_to_erf_inv_batched`` runs the
bits -> normal map alone on given words (variant "map"), which no path
calls: ``chip_smoke.py`` checks it on every mantissa.  ``step_noise_unrolled``,
``stacked_step_noise`` and ``add_noise`` send CUDA keys (a CUDA leaf) to
the kernel and CPU ones to the plain versions of ``ref.py``, which the
kernel equals bit for bit.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import (KernelLibrary, check_cuda,
                                 default_use_kernel, raise_on_error,
                                 stream_ptr)
from repro_torch.kernels.noise import ref

# no multiply and add contracted into an FMA but the source's own
FLAGS = ("-fmad=false",)
LIBRARY = KernelLibrary(
    "threefry_normal", Path(__file__).parent / "csrc" / "threefry_normal.cu",
    flags=FLAGS)

_GRID_YZ = 65535        # the most blocks along a grid's y and z
_M32 = 0xFFFFFFFF


def _check_keys(keys: torch.Tensor, ndim: int) -> None:
    check_cuda((keys,), ("keys",))
    if (keys.dtype != torch.int64 or keys.ndim != ndim
            or keys.shape[-1] != 2):
        raise ValueError(f"keys must be int64 with {ndim} dims, the last "
                         f"2, got {keys.dtype} {tuple(keys.shape)}")


def step_noise_unrolled_batched(rngs: torch.Tensor, t: int, shape
                                ) -> torch.Tensor:
    """The kernel: CUDA (R, 2) keys, iteration ``t`` -> (R, *shape)
    float32, the legacy layout of ``ref.step_noise_unrolled``."""
    _check_keys(rngs, 2)
    r, size = rngs.shape[0], math.prod(shape)
    if r > _GRID_YZ or size >= 2 ** 32:
        raise ValueError(f"at most {_GRID_YZ} replicas and 2^32 - 1 "
                         f"elements a replica, got {r}, {size}")
    out = torch.empty((r,) + tuple(shape), dtype=torch.float32,
                      device=rngs.device)
    fn = LIBRARY.function("noise_unrolled_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p])
    code = fn(rngs.data_ptr(), r, int(t) & _M32, size, out.data_ptr(),
              stream_ptr())
    raise_on_error(code, "noise_unrolled")
    LIBRARY.count("unrolled")
    return out


def stacked_step_noise_batched(rngs: torch.Tensor, max_steps: int, shape
                               ) -> torch.Tensor:
    """The kernel: CUDA (R, 2) keys -> (max_steps, R, *shape) float32,
    the partitionable layout of ``ref.stacked_step_noise``."""
    _check_keys(rngs, 2)
    r, size = rngs.shape[0], math.prod(shape)
    if r > _GRID_YZ or max_steps > _GRID_YZ:
        raise ValueError(f"at most {_GRID_YZ} replicas and steps, got "
                         f"{r}, {max_steps}")
    out = torch.empty((max_steps, r) + tuple(shape), dtype=torch.float32,
                      device=rngs.device)
    fn = LIBRARY.function("noise_stacked_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p])
    code = fn(rngs.data_ptr(), r, max_steps, size, out.data_ptr(),
              stream_ptr())
    raise_on_error(code, "noise_stacked")
    LIBRARY.count("stacked")
    return out


def add_noise_batched(p: torch.Tensor, key: torch.Tensor, std: torch.Tensor,
                      offset: int = 0) -> torch.Tensor:
    """The kernel: a CUDA float32 leaf, a (2,) key and a one-element
    float32 ``std`` -> ``ref.add_noise(p, key, std, offset)`` in one
    launch, element ``j`` from the bits of flat index ``offset + j``."""
    _check_keys(key, 1)
    check_cuda((p, std), ("p", "std"))
    if p.dtype != torch.float32 or std.dtype != torch.float32 \
            or std.numel() != 1:
        raise ValueError(f"want a float32 leaf and one float32 std, got "
                         f"{p.dtype} and {std.dtype} {tuple(std.shape)}")
    if offset < 0 or offset + p.numel() > 2 ** 63:
        raise ValueError(f"offset {offset} out of range")
    out = torch.empty_like(p)
    fn = LIBRARY.function("sgld_noise_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])
    code = fn(p.data_ptr(), key.data_ptr(), std.data_ptr(), offset,
              p.numel(), out.data_ptr(), stream_ptr())
    raise_on_error(code, "sgld_noise")
    LIBRARY.count("sgld")
    return out


def bits_to_erf_inv_batched(bits: torch.Tensor) -> torch.Tensor:
    """The kernel's bits -> erf_inv map alone: CUDA int64 words (uint32
    values) -> float32 ``random.bits_to_erf_inv(bits)``, one launch,
    counted under "map" (the exhaustive check's entry point)."""
    check_cuda((bits,), ("bits",))
    if bits.dtype != torch.int64:
        raise ValueError(f"bits must be int64 words, got {bits.dtype}")
    words = torch.where(bits > 0x7FFFFFFF, bits - (1 << 32), bits
                        ).to(torch.int32).contiguous()
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    fn = LIBRARY.function("noise_map_launch", [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])
    code = fn(words.data_ptr(), words.numel(), out.data_ptr(), stream_ptr())
    raise_on_error(code, "noise_map")
    LIBRARY.count("map")
    return out


def step_noise_unrolled(rngs: torch.Tensor, t: int, shape) -> torch.Tensor:
    """Iteration ``t``'s legacy-layout block: the kernel on the card, its
    plain version on the CPU."""
    if default_use_kernel(rngs):
        return step_noise_unrolled_batched(rngs.contiguous(), t, shape)
    return ref.step_noise_unrolled(rngs, t, shape)


def stacked_step_noise(rngs: torch.Tensor, max_steps: int, shape
                       ) -> torch.Tensor:
    """Every step's partitionable-layout draw: the kernel on the card,
    its plain version on the CPU."""
    if default_use_kernel(rngs):
        return stacked_step_noise_batched(rngs.contiguous(), max_steps,
                                          shape)
    return ref.stacked_step_noise(rngs, max_steps, shape)


def add_noise(p: torch.Tensor, key: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    """The SGLD update of one leaf: the kernel on the card (the whole
    leaf in one launch), its plain version on the CPU."""
    if default_use_kernel(p):
        return add_noise_batched(p.contiguous(), key.contiguous(), std)
    return ref.add_noise(p, key, std)
