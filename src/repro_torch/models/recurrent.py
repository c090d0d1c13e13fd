"""Recurrent sequence-mixing cells, the RG-LRU half (Griffin /
RecurrentGemma): the port of the convolution and RG-LRU functions of the
JAX package's ``repro/models/recurrent.py``.

  * ``conv_defs``, ``causal_conv`` (full sequence), ``causal_conv_step``
    (decode, a buffer of the last k - 1 inputs);
  * ``rg_lru_defs``, ``rg_lru_scan`` (full sequence), ``rg_lru_step``
    (decode, the float32 state h).

``rg_lru_scan`` solves h_t = a_t h_{t-1} + b_t over the sequence with a
log-depth scan in plain PyTorch (doubling over S: 11 steps at S = 2048,
each a few elementwise passes), where the JAX package uses
``lax.associative_scan``; the two associate the same products in another
order, so they agree to float32 rounding, not bitwise.  No TPU kernel
covers the recurrence, so plain PyTorch is the port's form of it.  The
xLSTM cells (mLSTM, sLSTM) wait for the ssm family (ROADMAP.md, queue 1
item 8).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.params import ParamDef

Params = Dict[str, Any]

_LRU_C = 8.0   # Griffin's fixed gate sharpness


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------


def conv_defs(width: int, k: int) -> Params:
    return {"conv_w": ParamDef((k, width), ("conv_k", "rec_state")),
            "conv_b": ParamDef((width,), ("rec_state",), "zeros")}


def causal_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, W) depthwise causal conv, kernel k: the k shifted
    products summed first to last in x's dtype, then the bias."""
    k = p["conv_w"].shape[0]
    s = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = xp[:, :s] * p["conv_w"][0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * p["conv_w"][i].to(x.dtype)
    return out + p["conv_b"].to(x.dtype)


def causal_conv_step(p: Params, buf: torch.Tensor, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode: buf (B, k-1, W) holds the last k-1 inputs; returns (the
    output in x's dtype, the new buffer in buf's dtype)."""
    window = torch.cat([buf, x[:, None, :].to(buf.dtype)], dim=1)
    out = torch.einsum("bkw,kw->bw", window.float(), p["conv_w"].float())
    out = (out + p["conv_b"].float()).to(x.dtype)
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def rg_lru_defs(width: int, n_heads: int) -> Params:
    hd = width // n_heads
    return {
        "w_i": ParamDef((n_heads, hd, hd), ("kv_heads", "rec_state", None)),
        "w_r": ParamDef((n_heads, hd, hd), ("kv_heads", "rec_state", None)),
        "lam": ParamDef((width,), ("rec_state",), "ones", scale=1.0),
    }


def _block_diag(p_w: torch.Tensor, x: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    b, s, w = x.shape
    xh = x.reshape(b, s, n_heads, w // n_heads)
    return torch.einsum("bshw,hwv->bshv", xh, p_w.to(x.dtype)
                        ).reshape(b, s, w)


def _lru_coeffs(p: Params, x: torch.Tensor, n_heads: int):
    """(a, gated), float32: a = exp(-c softplus(lam) r) and the gated
    input sqrt(max(1 - a^2, 1e-8)) i x."""
    r = torch.sigmoid(_block_diag(p["w_r"], x, n_heads).float())
    i = torch.sigmoid(_block_diag(p["w_i"], x, n_heads).float())
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -_LRU_C * softplus * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-8)) \
        * i * x.float()
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling:
    after the step of offset o, (a_t, b_t) composes the elements t - 2o +
    1 .. t, (a_{t-o}, b_{t-o}) applied before (a_t, b_t), as
    ``lax.associative_scan``'s combine (a1 a2, a2 b1 + b2)."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return b


def rg_lru_scan(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x: (B, S, W) -> h: (B, S, W) in x's dtype."""
    a, gated = _lru_coeffs(p, x, n_heads)
    return linear_scan(a, gated).to(x.dtype)


def rg_lru_step(p: Params, h_prev: torch.Tensor, x: torch.Tensor,
                n_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_prev: (B, W); x: (B, W) one token -> (h in x's dtype, h in
    float32)."""
    a, gated = _lru_coeffs(p, x[:, None, :], n_heads)
    h = a[:, 0] * h_prev.float() + gated[:, 0]
    return h.to(x.dtype), h
