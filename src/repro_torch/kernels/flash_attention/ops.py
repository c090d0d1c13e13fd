"""Dispatch and the ctypes wrapper of the flash attention kernel.

``flash_attention(q, k, v, *, causal, window)`` takes the model layout,
q (B, S, H, D) and k, v (B, T, G, D) with G | H, and returns (B, S, H, D)
in q's dtype (float32 or bfloat16).  A CUDA tensor goes to the kernel
(``flash_attention_kernel``, which launches ``csrc/flash_attention.cu``
and counts the launch on ``LIBRARY``); a CPU tensor to the plain version,
``ref.attention``.  Forward only, as the TPU kernel is.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import (KernelLibrary, check_cuda,
                                 default_use_kernel, raise_on_error,
                                 stream_ptr)
from repro_torch.kernels.flash_attention import ref

LIBRARY = KernelLibrary(
    "flash_attention", Path(__file__).parent / "csrc" / "flash_attention.cu")

MAX_HEAD_DIM = 128
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """The kernel alone: CUDA, contiguous q (B, S, H, D) and k, v
    (B, T, G, D) of one dtype (float32 or bfloat16), G | H, D <= 128;
    anything else raises."""
    check_cuda((q, k, v), ("q", "k", "v"))
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a float32 or bfloat16 dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, D), k and v (B, T, G, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % g or not 0 < d <= \
            MAX_HEAD_DIM or window < 0:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, window {window}")
    out = torch.empty_like(q)
    fn = LIBRARY.function("flash_attention_launch", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              b, s, t, h, g, d, int(causal), int(window),
              int(q.dtype == torch.bfloat16), stream_ptr())
    raise_on_error(code, "flash_attention")
    LIBRARY.count()
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, S, H, D), (B, T, G, D) x 2 -> (B, S, H, D): the kernel on the
    card, the plain version on the CPU."""
    if default_use_kernel(q):
        return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window)
    return ref.attention(q, k, v, causal=causal, window=window)
