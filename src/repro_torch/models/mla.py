"""Multi-head Latent Attention (DeepSeek-V2): the port of the JAX
package's ``repro/models/mla.py``.

Train / prefill: up-project the latent KV and run standard attention at
a qk head dim of ``qk_nope_dim + qk_rope_dim`` (192 for V2-Lite) and a v
head dim of ``v_head_dim`` (128), dispatched as ``layers.gqa_apply``'s
(``layers.prefill_attention``): without a recorded gradient on the card
the flash kernel, which takes the two head dims as they are; elsewhere
``full_attention``, or ``chunked_attention`` from 8192 tokens.  The JAX
package pads v to the qk head dim for its shared attention core and
slices the output; the port attends at v's own width, which gives the
same values (the padded columns add nothing to the others).

Decode: the *absorbed* form in plain PyTorch, scores and softmax in
float32 as the JAX package computes them, against the compressed latent
cache (rank ``kv_lora_rank``) plus the decoupled RoPE key cache, so the
per-token cache is ``kv_lora_rank + qk_rope_dim`` values (576 for
V2-Lite) instead of ``2 * H * head_dim`` (8192).  The new latent and
RoPE key go into the cache *in place* with ``index_copy_`` on the device
index, as ``gqa_apply`` writes its cache (no host read).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import shardctx
from repro_torch.models.params import ParamDef

Params = Dict[str, Any]


def mla_defs(cfg: ModelConfig) -> Params:
    a = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = a.qk_nope_dim + a.qk_rope_dim
    out_scale = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    return {
        "w_q": ParamDef((d, h, qk), ("embed", "heads", "head_dim")),
        "w_dkv": ParamDef((d, a.kv_lora_rank), ("embed", "lora")),
        "kv_norm": ParamDef((a.kv_lora_rank,), ("lora",), "ones"),
        "w_kr": ParamDef((d, a.qk_rope_dim), ("embed", None)),
        "w_uk": ParamDef((a.kv_lora_rank, h, a.qk_nope_dim),
                         ("lora", "heads", "head_dim")),
        "w_uv": ParamDef((a.kv_lora_rank, h, a.v_head_dim),
                         ("lora", "heads", "head_dim")),
        "w_o": ParamDef((h, a.v_head_dim, d), ("heads", "head_dim", "embed"),
                        scale=out_scale),
    }


def mla_cache_defs(cfg: ModelConfig, batch: int, cache_len: int) -> Params:
    a = cfg.mla
    cd = torch_dtype(cfg.cache_dtype)
    return {
        "c_kv": ParamDef((batch, cache_len, a.kv_lora_rank),
                         ("batch", "kv_seq", "lora"), "zeros", dtype=cd),
        "k_rope": ParamDef((batch, cache_len, a.qk_rope_dim),
                           ("batch", "kv_seq", None), "zeros", dtype=cd),
    }


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + 1e-6)
    return (y * w.float()).to(x.dtype)


def mla_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Optional[Params] = None,
              cache_index: Optional[torch.Tensor] = None,
              return_kv: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (output, the cache (written in place) or the new latent
    and RoPE key, ``{"c_kv": (B, S, r), "k_rope": (B, S, rope)}``)."""
    a = cfg.mla
    cd = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    h = cfg.n_heads
    scale = 1.0 / math.sqrt(a.qk_nope_dim + a.qk_rope_dim)
    xq = x.to(cd)

    q = L._project(xq, p["w_q"].to(cd))
    q_nope, q_rope = q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = _rms(L._project(xq, p["w_dkv"].to(cd)), p["kv_norm"])
    k_rope = L.apply_rope(L._project(xq, p["w_kr"].to(cd)), positions,
                          cfg.rope_theta)

    if cache is not None:
        # ---- absorbed decode ----
        cache_len = cache["c_kv"].shape[1]
        # dynamic_update_slice clamps the start so the update fits
        start = torch.clamp(cache_index % cache_len, max=cache_len - s)
        slots = start.reshape(1).long() + torch.arange(s, device=x.device)
        c_cache, r_cache = cache["c_kv"], cache["k_rope"]
        shardctx.index_copy_(c_cache, 1, slots, c_kv.to(c_cache.dtype))
        shardctx.index_copy_(r_cache, 1, slots, k_rope.to(r_cache.dtype))
        kv_len = torch.clamp(cache_index + s, max=cache_len)
        # absorb W_uk into the query: q_c[b,s,h,r] = q_nope . W_uk
        q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(cd))
        c32 = c_cache.float()
        scores = (torch.einsum("bshr,btr->bhst", q_c.float(), c32)
                  + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                 r_cache.float())) * scale
        keep = torch.arange(cache_len, device=x.device) < kv_len.reshape(-1)
        scores = torch.where(keep, scores, L.NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx_c = torch.einsum("bhst,btr->bshr", probs, c32)    # latent context
        out = torch.einsum("bshr,rhk->bshk", ctx_c.to(cd),
                           p["w_uv"].to(cd))                  # (B,S,H,v_dim)
        y = out.reshape(b, s, -1) @ p["w_o"].to(cd).reshape(-1, cfg.d_model)
        return y.to(x.dtype), cache

    # ---- train / prefill: up-project and run standard attention ----
    k_nope = L._project(c_kv, p["w_uk"].to(cd))
    v = L._project(c_kv, p["w_uv"].to(cd))
    k_rope_h = k_rope[:, :, None, :].expand(b, s, h, a.qk_rope_dim)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = L.prefill_attention(q_full, k, v, causal=True)
    rd = torch_dtype(cfg.reduce_dtype)
    y = out.to(rd).reshape(b, s, -1) @ p["w_o"].to(rd).reshape(
        -1, cfg.d_model)
    new_cache = {"c_kv": c_kv, "k_rope": k_rope} if return_kv else None
    return y.to(x.dtype), new_cache
