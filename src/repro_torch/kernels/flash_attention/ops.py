"""Dispatch and the ctypes wrapper of the flash attention kernel.

``flash_attention(q, k, v, *, causal, window, softcap)`` takes the model
layout, q (B, S, H, Dqk), k (B, T, G, Dqk) and v (B, T, G, Dv) with G | H
and Dqk, Dv <= 256 each, and returns (B, S, H, Dv) in q's dtype (float32
or bfloat16); each score is scaled by 1 / sqrt(Dqk).  MLA's prefill
attends at Dqk = 192, Dv = 128 (v at its own width: the JAX package pads
it to 192 and slices the output, which gives the same values),
RecurrentGemma's local attention at 256 with one kv head.  A CUDA tensor
goes to
the kernel (``flash_attention_kernel``, which launches
``csrc/flash_attention.cu`` and counts the launch on ``LIBRARY`` under
its variant: "bf16_tc" for bfloat16, on the tensor cores, "f32" for
float32); a CPU tensor to the plain version, ``ref.attention``.  Forward
only, as the TPU kernel is: handed tensors that record a gradient, the
kernel raises rather than cut the gradient.  ``softcap`` c > 0 caps
each scaled score as ``tanh(s / c) c`` before the masks and the
softmax, as the plain version and the JAX package's attention cores do.
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

MAX_HEAD_DIM = 256
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
             + [ctypes.c_void_p])


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """The kernel alone: CUDA, contiguous q (B, S, H, Dqk), k (B, T, G,
    Dqk) and v (B, T, G, Dv) of one dtype (float32 or bfloat16), G | H,
    Dqk, Dv <= 256 (in bfloat16 multiples of 8, 16-byte aligned tensors),
    softcap >= 0, none recording a gradient (the kernel has no backward);
    anything else raises.  Returns (B, S, H, Dv)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_kernel has no backward: its output would "
            "carry no gradient to q, k, v; take the plain attention "
            "under autograd, or call it under torch.no_grad()")
    check_cuda((q, k, v), ("q", "k", "v"))
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a float32 or bfloat16 dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q must be (B, S, H, Dqk), k (B, T, G, Dqk), v "
                         f"(B, T, G, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, g, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or h % g or not 0 < d <= \
            MAX_HEAD_DIM or not 0 < dv <= MAX_HEAD_DIM or window < 0 or \
            softcap < 0:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, window "
                         f"{window}, softcap {softcap}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (d % 8 or dv % 8 or
                 any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"the bfloat16 kernel reads rows by TMA: Dqk and "
                         f"Dv must be multiples of 8 (got {d}, {dv}) and "
                         f"q, k, v 16-byte aligned")
    out = q.new_empty((b, s, h, dv))
    fn = LIBRARY.function("flash_attention_launch", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              b, s, t, h, g, d, dv, int(causal), int(window), int(bf16),
              float(softcap), stream_ptr())
    raise_on_error(code, "flash_attention")
    LIBRARY.count("bf16_tc" if bf16 else "f32")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """(B, S, H, Dqk), (B, T, G, Dqk), (B, T, G, Dv) -> (B, S, H, Dv): the
    kernel on the card, the plain version on the CPU."""
    if default_use_kernel(q):
        return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window, softcap=softcap)
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap)
