"""Plain PyTorch attention: the flash kernel's function in the model
layout, the CPU path of ``ops.flash_attention`` and the kernel's oracle.

The JAX package's oracle (``repro/kernels/flash_attention/ref.py``) with
the GQA expansion of its ``ops.flash_attention`` folded in: query head
``h`` reads kv head ``h // (H / G)``, as ``jnp.repeat(k, H // G, axis=2)``
maps it.  ``attention`` is also the model's one plain attention body
(``models.layers.full_attention``): its ``kv_len`` (decode's cache
length) goes beyond the kernel's function, and the kernel's wrapper
never passes it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
         window: int) -> torch.Tensor:
    """(S, T) bool: which keys each query row keeps."""
    keep = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        keep &= qpos[:, None] >= kpos[None, :]
    if window:
        keep &= qpos[:, None] - kpos[None, :] < window
    return keep


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              kv_len: Optional[torch.Tensor] = None,
              softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, D); k: (B, T, G, D), v: (B, T, G, Dv) with G | H ->
    (B, S, H, Dv).

    float32 scores scaled by 1/sqrt(D) (q's true D), masked to -1e30,
    softmax, times v in float32, cast to ``q.dtype``."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    if h % g:
        raise ValueError(f"kv heads {g} must divide query heads {h}")
    qg = q.reshape(b, s, g, h // g, d).float()
    scores = torch.einsum("bsghd,btgd->bghst", qg, k.float()) \
        * (1.0 / math.sqrt(d))
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    kpos = torch.arange(t, device=q.device)
    keep = mask(torch.arange(s, device=q.device), kpos, causal, window)
    if kv_len is not None:                                  # decode
        keep = keep & (kpos[None, :] < kv_len.reshape(-1)[..., None])
    scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bghst,btgd->bsghd", probs, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)
