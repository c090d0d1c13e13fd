"""Core neural layers: norms, RoPE, attention (GQA / local / chunked),
MLPs: the port of the JAX package's ``repro/models/layers.py``.

Pure functions; params are dicts of tensors drawn from ParamDef trees.
Each matmul rounds where the JAX package's ``einsum`` rounds: inputs cast
to ``compute_dtype`` (weights per call, as ``p["wq"].astype(cd)``), the
output in the inputs' dtype, the row-parallel products (``wo``,
``w_down``) in ``reduce_dtype``.

Attention without a cache and without a recorded gradient (prefill, an
evaluation under ``torch.no_grad``) is the flash kernel on the card
(``kernels.flash_attention``), which has no backward, as the TPU kernel
has none; everywhere else, and under autograd on the card too, it is
``full_attention``, or ``chunked_attention`` from 8192 tokens, as in
the JAX package, whose training forward takes the plain path for its
standard attention backward.  The kernel takes q and k at one head dim
and v at its own, each up to 256, and scales by 1 / sqrt(q's head dim):
GQA here (RecurrentGemma's local attention at 256 with one kv head, a
window and a softcap) and MLA's prefill (``models/mla.py``, 192 and 128)
dispatch to it the same way (``prefill_attention``), and the plain cores
take v's head dim too.  Decode attention against the cache stays plain
PyTorch on both; cross attention to the encoder's k, v (``cross_kv``,
Whisper's 1,500 keys) has no cache and goes to the kernel in prefill
and in decode alike, non-causal.  The JAX package's
``shardctx.constrain_*`` calls sit at its sites, on the plain path: the
query of ``full_attention`` (in ``prefill_attention``) and each query
chunk of ``chunked_attention``; identities unless a launcher sets an
activation sharding and the tensors are DTensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.kernels import default_use_kernel
from repro_torch.kernels.flash_attention import flash_attention
# full_attention, the plain O(S^2) attention, is the kernel's plain
# version, which also takes decode's kv_len
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, attention as full_attention, mask as _mask)
from repro_torch.models import shardctx
from repro_torch.models.params import ParamDef, dense

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_defs(cfg: ModelConfig, name: str = "norm") -> Params:
    if cfg.norm == "nonparametric_ln":      # OLMo: no learnable affine
        return {}
    return {name: ParamDef((cfg.d_model,), ("embed",), "ones")}


def apply_norm(p: Params, cfg: ModelConfig, x: torch.Tensor,
               name: str = "norm") -> torch.Tensor:
    """In float32, out in x's dtype; the variance is the population one
    (``jnp.var``)."""
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + 1e-6)
        y = y * p[name].float()
    elif cfg.norm in ("layernorm", "nonparametric_ln"):
        var, mu = shardctx.var_mean(x32)
        y = (x32 - mu) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            y = y * p[name].float()
    else:
        raise ValueError(cfg.norm)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (GPT-NeoX half-rotation)
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    expo = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    power = torch.pow(torch.full_like(expo, theta), expo)
    return torch.ones_like(power) / power


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    if x.ndim - angles.ndim == 2:                           # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores (plain)
# ---------------------------------------------------------------------------


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B,S,H,D) -> (B,S,G,Hg,D) with G = kv_heads."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, d)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 512,
                      softcap: float = 0.0) -> torch.Tensor:
    """Softmax attention over query chunks (memory O(chunk * T)): the JAX
    package's XLA lowering for long prefills, a Python loop here."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    if s % chunk != 0:
        return full_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    scale = 1.0 / math.sqrt(d)
    kpos = torch.arange(t, device=q.device)
    k32, v32 = k.float(), v.float()
    outs = []
    for c0 in range(0, s, chunk):
        qc = shardctx.constrain_qchunk(_grouped(q[:, c0:c0 + chunk], g), h)
        qc = qc.float()
        scores = torch.einsum("bcghd,btgd->bghct", qc, k32) * scale
        if softcap:
            scores = torch.tanh(scores / softcap) * softcap
        qpos = c0 + torch.arange(chunk, device=q.device)
        scores = torch.where(_mask(qpos, kpos, causal, window), scores,
                             NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bghct,btgd->bcghd", probs, v32))
    return torch.cat(outs, 1).reshape(b, s, h, v.shape[-1]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention against a cache. q:(B,1,H,D), cache:(B,T,KVH,D)."""
    return full_attention(q, k_cache, v_cache, causal=False, window=0,
                          kv_len=kv_len, softcap=softcap)


# ---------------------------------------------------------------------------
# GQA attention layer (projections + rope + cache handling)
# ---------------------------------------------------------------------------


def gqa_defs(cfg: ModelConfig) -> Params:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, g, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, g, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed"),
                       scale=1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))),
    }


def gqa_cache_defs(cfg: ModelConfig, batch: int, cache_len: int) -> Params:
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.kv_replicate_to:
        g = cfg.kv_replicate_to
    shape = (batch, cache_len, g, hd)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    cd = torch_dtype(cfg.cache_dtype)
    return {"k": ParamDef(shape, axes, "zeros", dtype=cd),
            "v": ParamDef(shape, axes, "zeros", dtype=cd)}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,d...->bs...", x, w)`` as one matmul in x's dtype."""
    b, s, d = x.shape
    out = x.reshape(b * s, d) @ shardctx.weight_at_use(w).reshape(d, -1)
    out = shardctx.splittable(out, 1, w.shape[1])
    return out.reshape((b, s) + tuple(w.shape[1:]))


def _records_grad(*ts: torch.Tensor) -> bool:
    """Would autograd record an operation on these tensors?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def prefill_attention(q, k, v, *, causal: bool, window: int = 0,
                      softcap: float = 0.0) -> torch.Tensor:
    """Attention without a cache (prefill, training): the flash kernel
    on the card unless autograd records, else ``chunked_attention`` from
    8192 tokens, else ``full_attention``."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if default_use_kernel(q) and not _records_grad(q, k, v):
        return flash_attention(q, k, v, **kw)
    if q.shape[1] >= 8192:
        return chunked_attention(q, k, v, **kw)
    if q.shape[1] > 1:
        # context-parallel fallback for head counts that do not divide TP
        q = shardctx.constrain_seq_parallel_q(q, q.shape[2])
    return full_attention(q, k, v, **kw)


def gqa_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, causal: bool = True,
              cache: Optional[Params] = None,
              cache_index: Optional[torch.Tensor] = None,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              return_kv: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (output, updated_cache_or_new_kv).

    Decode (``cache`` given): the new k, v go into the cache *in place*
    at slot ``cache_index % cache_len`` (a ring buffer when the cache is
    shorter than the stream), with ``index_copy_`` on the device index,
    no host read; then attention against the cache.  The JAX package
    returns a new cache instead; the port saves the copy.

    Cross attention (``cross_kv`` = (k, v), (B, T, G, D) each, the
    encoder's): no k or v projection, no RoPE, no replication, no cache
    and no new kv; the S queries (the prompt, or one decode token) attend
    to the T keys through ``prefill_attention``, the flash kernel on the
    card (the JAX package's ``full_attention``, the same function)."""
    cd = torch_dtype(cfg.compute_dtype)
    xq = x.to(cd)
    q = _project(xq, p["wq"].to(cd))
    if cross_kv is not None:
        k, v = cross_kv
        cache, return_kv = None, False
    else:
        k = _project(xq, p["wk"].to(cd))
        v = _project(xq, p["wv"].to(cd))
        if cfg.use_rope and cfg.pos_embed == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.kv_replicate_to and (cache is not None or return_kv):
        # vLLM-style KV replication: kv head j becomes heads j*rep ..
        # j*rep + rep - 1, so each query head still sees its own kv head
        rep = cfg.kv_replicate_to // k.shape[2]
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
    new_cache = None
    if cache is not None:
        s_new = x.shape[1]
        cache_len = cache["k"].shape[1]
        # dynamic_update_slice clamps the start so the update fits
        start = torch.clamp(cache_index % cache_len, max=cache_len - s_new)
        slots = start.reshape(1).long() + torch.arange(s_new,
                                                       device=x.device)
        shardctx.index_copy_(cache["k"], 1, slots, k.to(cache["k"].dtype))
        shardctx.index_copy_(cache["v"], 1, slots, v.to(cache["v"].dtype))
        new_cache = cache
        kv_len = torch.clamp(cache_index + s_new, max=cache_len)
        out = shardctx.attend_locally(decode_attention, q,
                                      cache["k"].to(cd), cache["v"].to(cd),
                                      kv_len=kv_len,
                                      softcap=cfg.logit_softcap)
    else:
        out = shardctx.attend_locally(prefill_attention, q, k, v,
                                      causal=causal, window=cfg.window_size,
                                      softcap=cfg.logit_softcap)
    if return_kv and cache is None:
        new_cache = {"k": k, "v": v}
    rd = torch_dtype(cfg.reduce_dtype)
    b, s = out.shape[:2]
    y = out.to(rd).reshape(b, s, -1) @ shardctx.weight_at_use(
        p["wo"]).to(rd).reshape(-1, cfg.d_model)
    return y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    out_scale = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    if cfg.activation in ("swiglu", "geglu"):
        return {"w_gate": dense(d, f, "embed", "mlp"),
                "w_up": dense(d, f, "embed", "mlp"),
                "w_down": dense(f, d, "mlp", "embed", scale=out_scale)}
    return {"w_up": dense(d, f, "embed", "mlp"),
            "w_down": dense(f, d, "mlp", "embed", scale=out_scale)}


def _const(c: float, x: torch.Tensor) -> float:
    """A Python constant as JAX applies it to ``x``: rounded to x's dtype."""
    return float(torch.tensor(c, dtype=x.dtype))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op by op, each rounded to x's dtype as XLA rounds
    bfloat16: x * (1 / (1 + exp(-x)))."""
    e = torch.exp(-x)
    return x * (torch.ones_like(e) / (e + 1.0))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) op by op:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))."""
    inner = x + _const(0.044715, x) * ((x * x) * x)
    t = torch.tanh(_const(math.sqrt(2.0 / math.pi), x) * inner)
    return x * (0.5 * (t + 1.0))


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The activations follow ``jax.nn``'s formulas op by op, so bfloat16
    rounds at the same steps (``F.silu`` rounds once, 40% of bf16
    outputs then differ by an ulp)."""
    cd = torch_dtype(cfg.compute_dtype)
    rd = torch_dtype(cfg.reduce_dtype)
    xq = x.to(cd)
    p = {k: shardctx.weight_at_use(w) for k, w in p.items()}
    if cfg.activation == "swiglu":
        h = _silu(xq @ p["w_gate"].to(cd)) * (xq @ p["w_up"].to(cd))
    elif cfg.activation == "geglu":
        h = _gelu(xq @ p["w_gate"].to(cd)) * (xq @ p["w_up"].to(cd))
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(xq @ p["w_up"].to(cd)))
    elif cfg.activation == "gelu":
        h = _gelu(xq @ p["w_up"].to(cd))
    else:
        raise ValueError(cfg.activation)
    return (h.to(rd) @ p["w_down"].to(rd)).to(x.dtype)
