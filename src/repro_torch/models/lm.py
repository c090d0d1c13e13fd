"""Language-model assembly, every family of the JAX package: the port of
its ``repro/models/lm.py`` for serving and training, all six families.

One functional ``LM`` facade per ModelConfig:

  * ``param_defs()``                       — ParamDef tree (layer-stacked)
  * ``forward(params, batch, remat)``      — logits for training
  * ``loss(params, batch, remat)``         — cross entropy, metrics
  * ``prefill(params, batch, cache_len)``  — last-position logits + decode
                                             state
  * ``decode_state_defs(batch, cache_len)``— decode-state ParamDefs
  * ``decode_step(params, state, tokens)`` — one-token serve step

Parameters and the KV cache keep the JAX package's stacked ``(L, ...)``
layout, so a tree converts with a plain copy and the cache compares
slice by slice; the ``lax.scan`` over layers is a Python loop over the
stacks.  The gradient is ``torch.autograd``'s: under autograd the
attention takes the plain path (``layers.gqa_apply``), as JAX's training
forward does, and ``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, JAX's ``nothing_saveable`` policy).

The moe family (DeepSeek-MoE on GQA attention, DeepSeek-V2-Lite on MLA,
``models/mla.py``) stacks its first ``moe.first_dense_layers`` blocks as
``dense_layers`` (a dense MLP of the JAX package's width) and the rest as
``layers`` (the MoE FFN, ``models/moe.py``), with caches ``dense_cache``
and ``cache`` (GQA's ``k``, ``v``; MLA's latent ``c_kv`` and RoPE key
``k_rope``); its aux losses are averaged over the MoE layers.

The hybrid family (RecurrentGemma) scales the embedding by
sqrt(d_model), then runs ``groups`` of [RG-LRU block, RG-LRU block,
local-attention block] and a ``tail`` of RG-LRU blocks
(``models/recurrent.py``); the attention block is the dense block, its
local attention the flash kernel on the card (window, softcap, one kv
head).  Its decode state holds each RG-LRU block's convolution buffer and
float32 h (written in place each step) and each attention block's ring
buffer of the window's k, v; prefill fills the ring with the prompt's
last ``window`` positions, which needs the window to divide the prompt
length, as in the JAX package.

The ssm family (xLSTM) runs ``units`` of ``slstm_every`` - 1 mLSTM blocks
and one sLSTM block (``models/recurrent.py``), no attention and no
separate FFN; remat rematerialises each unit as one and, inside it, each
mLSTM block again, as JAX nests them.  Its decode state holds each
block's convolution buffer and cell state (the mLSTM's float32 (C, n, m),
the sLSTM's (c, n, h, m)), written in place each step; prefill fills it
with ``mlstm_final_state``'s closed form and the sLSTM loop's last state.

The encdec family (Whisper) adds the learned ``enc_pos`` to the
frontend's ``audio_embeds`` (B, encoder_seq_len, d), runs ``enc_layers``
(the dense block, causal as in the JAX package) and ``enc_norm``, then
``dec_layers`` of three pre-norm residuals: causal self attention,
cross attention to each layer's k, v of the encoder output
(``_cross_kv``, non-causal, through the flash kernel on the card in
prefill and decode alike, the plain attention under autograd) and the
MLP.  In training each decoder block computes its cross k, v itself,
inside its remat, as JAX's rematted ``dec_block`` does.  Its decode
state holds each decoder layer's self cache and its ``cross`` k, v (B,
encoder_seq_len, G, hd), which prefill writes once.  The vlm family
(InternVL2) is the dense stack with the frontend's ``pixel_embeds`` (B,
n_image_tokens, d) prepended when the batch has them: positions (RoPE),
the cache length and ``index`` count the prefix, and ``loss`` drops the
prefix's logits; a batch without them runs the text alone, as in the
JAX package.

``shardctx.constrain_*`` sit at the JAX package's sites (the embedding,
each block's entry, the logits): identities unless a launcher sets an
activation sharding and the tensors are DTensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as R
from repro_torch.models import shardctx
from repro_torch.models.params import ParamDef, stack
from repro_torch.tree import tree_map, tree_paths, tree_unflatten

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _embed_defs(cfg: ModelConfig) -> Params:
    d: Params = {"embed": ParamDef((cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), "embed", scale=0.02)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"), scale=1.0)
    if cfg.pos_embed == "learned":
        d["pos_embed"] = ParamDef((cfg.max_seq_len, cfg.d_model),
                                  ("seq", "embed"), "embed", scale=0.02)
    return d


def _logits(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """In compute_dtype (rounded there, as the JAX einsum), then float32."""
    cd = torch_dtype(cfg.compute_dtype)
    table = shardctx.constrain_vocab_table(
        p["embed"].T if cfg.tie_embeddings else p["unembed"])
    x = shardctx.constrain_batch(x)
    logits = shardctx.constrain_logits((x.to(cd) @ table.to(cd)).float())
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """The rows of the table (``F.embedding``: its backward sums the
    rows' gradients in a fixed order, where indexing's accumulating
    ``index_put_`` does not); the hybrid family scales them by
    sqrt(d_model) (gemma)."""
    x = F.embedding(tokens, p["embed"])
    if cfg.pos_embed == "learned":
        x = x + F.embedding(positions, p["pos_embed"])
    if cfg.family == "hybrid":
        x = x * math.sqrt(cfg.d_model)
    return shardctx.constrain_batch(x.to(torch_dtype(cfg.compute_dtype)))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n: int):
    """The ``n`` layers of a stacked tree as views, split once with
    ``unbind`` (whose backward stacks the layers' gradients in one
    allocation; indexing layer by layer would add a zero-filled full
    stack per layer)."""
    parts = tree_map(lambda t: torch.unbind(t, 0), tree)
    return [tree_map(lambda p: p[i], parts) for i in range(n)]


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          mask: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross entropy and exact-match accuracy over the unmasked
    positions.  The label logit is a gather (the JAX package contracts a
    one-hot, which picks the same value exactly; a DTensor takes that
    form, ``shardctx.label_logit``)."""
    ll = shardctx.label_logit(logits, labels)
    mx = torch.amax(logits, -1)
    lse = mx + torch.log(torch.sum(torch.exp(logits - mx[..., None]), -1))
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.to(torch.float32)
    count = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(nll * mask) / count
    acc = torch.sum((ll >= mx).to(torch.float32) * mask) / count
    return loss, acc


def _maybe_remat(fn, enable: bool):
    """``fn`` recomputed in the backward pass, its activations not kept:
    JAX's ``jax.checkpoint(fn, policy=nothing_saveable)``."""
    if not enable:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# blocks: dense, the moe family's (dense FFN or MoE FFN), the hybrid's
# ---------------------------------------------------------------------------


def _block_defs(cfg: ModelConfig, ffn: Optional[Params] = None) -> Params:
    """One block: attention (MLA where ``cfg.attention`` says so, else
    GQA) and its norm, then the FFN's norm and ``ffn`` (by default the
    dense MLP of width ``cfg.d_ff``)."""
    attn = MLA.mla_defs(cfg) if cfg.attention == "mla" else L.gqa_defs(cfg)
    return {"attn_norm": L.norm_defs(cfg, "scale"), "attn": attn,
            "mlp_norm": L.norm_defs(cfg, "scale"),
            **(ffn or {"mlp": L.mlp_defs(cfg)})}


def _moe_ffn_defs(cfg: ModelConfig, dense_ffn: bool) -> Params:
    """A moe-family block's FFN: a dense MLP of the JAX package's width
    for the first layers, else the MoE FFN."""
    m = cfg.moe
    if dense_ffn:
        f = m.d_ff_expert * (m.num_shared_experts + m.num_experts) // 8
        return {"mlp": L.mlp_defs(cfg, d_ff=max(f, m.d_ff_expert * 4))}
    return {"moe": MOE.moe_defs(cfg)}


def _block(p: Params, cfg: ModelConfig, x, positions, cache=None,
           cache_index=None, return_kv=False):
    """One pre-norm block, attention then the FFN (``p["mlp"]`` dense,
    ``p["moe"]`` the MoE layer).  Returns (x, the cache or the new kv,
    the FFN's aux losses)."""
    x = shardctx.constrain_batch(x)
    h = L.apply_norm(p["attn_norm"], cfg, x, "scale")
    attend = MLA.mla_apply if cfg.attention == "mla" else L.gqa_apply
    a, new_cache = attend(p["attn"], cfg, h, positions=positions,
                          cache=cache, cache_index=cache_index,
                          return_kv=return_kv)
    # XLA keeps this sum in float32 for the norm (its excess precision
    # across the fusion) and rounds it for the second residual add
    x32 = shardctx.constrain_batch(x.float() + a.float())
    h = L.apply_norm(p["mlp_norm"], cfg, x32, "scale").to(x.dtype)
    if "moe" in p:
        y, aux = MOE.moe_apply(p["moe"], cfg, h)
    else:
        y, aux = L.mlp_apply(p["mlp"], cfg, h), {}
    return x32.to(x.dtype) + y, new_cache, aux


def _dec_block_defs(cfg: ModelConfig) -> Params:
    """A Whisper decoder block: self attention, cross attention, MLP, each
    with its norm."""
    return {"self_norm": L.norm_defs(cfg, "scale"),
            "self_attn": L.gqa_defs(cfg),
            "cross_norm": L.norm_defs(cfg, "scale"),
            "cross_attn": L.gqa_defs(cfg),
            "mlp_norm": L.norm_defs(cfg, "scale"),
            "mlp": L.mlp_defs(cfg)}


def _dec_block(p: Params, cfg: ModelConfig, x, enc_kv, positions,
               cache=None, cache_index=None, return_kv=False):
    """One decoder block: three pre-norm residuals, causal self attention
    (its cache or new kv as in ``_block``), non-causal cross attention to
    ``enc_kv`` = (k, v), the MLP.  Returns (x, the cache or the new
    kv)."""
    x = shardctx.constrain_batch(x)
    h = L.apply_norm(p["self_norm"], cfg, x, "scale")
    a, new_cache = L.gqa_apply(p["self_attn"], cfg, h, positions=positions,
                               cache=cache, cache_index=cache_index,
                               return_kv=return_kv)
    # each residual sum in float32 for the next norm, rounded for the next
    # add, as in ``_block``
    x32 = shardctx.constrain_batch(x.float() + a.float())
    h = L.apply_norm(p["cross_norm"], cfg, x32, "scale").to(x.dtype)
    x = x32.to(x.dtype)
    a, _ = L.gqa_apply(p["cross_attn"], cfg, h, positions=positions,
                       cross_kv=enc_kv, causal=False)
    x32 = shardctx.constrain_batch(x.float() + a.float())
    h = L.apply_norm(p["mlp_norm"], cfg, x32, "scale").to(x.dtype)
    return x32.to(x.dtype) + L.mlp_apply(p["mlp"], cfg, h), new_cache


def _cross_kv(p: Params, cfg: ModelConfig, enc: torch.Tensor):
    """A decoder layer's cross-attention k, v of the encoder output
    (B, T, d) -> (B, T, G, hd) each, in compute_dtype."""
    cd = torch_dtype(cfg.compute_dtype)
    e = enc.to(cd)
    return (L._project(e, p["cross_attn"]["wk"].to(cd)),
            L._project(e, p["cross_attn"]["wv"].to(cd)))


def _rg_block_defs(cfg: ModelConfig) -> Params:
    w = cfg.recurrent.lru_width or cfg.d_model
    return {
        "norm": L.norm_defs(cfg, "scale"),
        "w_x": ParamDef((cfg.d_model, w), ("embed", "rec_state")),
        "w_y": ParamDef((cfg.d_model, w), ("embed", "rec_state")),
        "conv": R.conv_defs(w, cfg.recurrent.conv_width),
        "lru": R.rg_lru_defs(w, cfg.n_heads),
        "w_out": ParamDef((w, cfg.d_model), ("rec_state", "embed"),
                          scale=1.0 / math.sqrt(2 * cfg.n_layers)),
        "mlp_norm": L.norm_defs(cfg, "scale"),
        "mlp": L.mlp_defs(cfg),
    }


def _rg_block(p: Params, cfg: ModelConfig, x, *, state=None):
    """One RG-LRU block: the gated recurrence (a GELU gate times the
    RG-LRU of the causal convolution), then the MLP.  ``state`` None runs
    the sequence; "collect" runs it and returns the decode state (the
    last k - 1 inputs of the convolution and the last h, float32); a
    state dict runs one token against it and returns the new state."""
    x = shardctx.constrain_batch(x)
    h = L.apply_norm(p["norm"], cfg, x, "scale")
    gate = L._gelu(h @ p["w_x"].to(h.dtype))
    y = h @ p["w_y"].to(h.dtype)
    new_state = None
    if state is None or state == "collect":
        rec = R.rg_lru_scan(p["lru"], R.causal_conv(p["conv"], y),
                            cfg.n_heads)
        if state == "collect":
            kw = cfg.recurrent.conv_width - 1
            new_state = {"conv": y[:, -kw:].float(),
                         "h": rec[:, -1].float()}
    else:
        yc, conv_buf = R.causal_conv_step(p["conv"], state["conv"], y[:, 0])
        rec_h, h32 = R.rg_lru_step(p["lru"], state["h"], yc, cfg.n_heads)
        rec = rec_h[:, None, :]
        new_state = {"conv": conv_buf, "h": h32}
    out = (rec * gate) @ p["w_out"].to(x.dtype)
    # the first residual in float32 for the norm, rounded for the second
    # add, as in ``_block``
    x32 = shardctx.constrain_batch(x.float() + out.float())
    h = L.apply_norm(p["mlp_norm"], cfg, x32, "scale").to(x.dtype)
    return x32.to(x.dtype) + L.mlp_apply(p["mlp"], cfg, h), new_state


def _mlstm_block_defs(cfg: ModelConfig) -> Params:
    rc = cfg.recurrent
    d = cfg.d_model
    inner = int(rc.mlstm_proj_factor * d)
    return {
        "norm": L.norm_defs(cfg, "scale"),
        "w_up": ParamDef((d, 2 * inner), ("embed", "rec_state")),
        "conv": R.conv_defs(inner, rc.conv_width),
        "cell": R.mlstm_defs(inner, cfg.n_heads),
        "w_down": ParamDef((inner, d), ("rec_state", "embed"),
                           scale=1.0 / math.sqrt(2 * cfg.n_layers)),
    }


def _mlstm_block(p: Params, cfg: ModelConfig, x, *, state=None):
    """One mLSTM block: the norm, a 2x up-projection into the cell's
    branch and a SiLU gate z, the causal convolution and SiLU, the mLSTM
    cell, the gate, the down-projection and the residual.  ``state`` as
    in ``_rg_block``: None, "collect" (the prompt's last k - 1 inputs of
    the convolution, float32, and ``mlstm_final_state``) or a state dict
    (one token)."""
    x = shardctx.constrain_batch(x)
    rc = cfg.recurrent
    inner = int(rc.mlstm_proj_factor * cfg.d_model)
    h = L.apply_norm(p["norm"], cfg, x, "scale")
    up = h @ p["w_up"].to(h.dtype)
    z, xi = up[..., :inner], up[..., inner:]
    new_state = None
    if state is None or state == "collect":
        xc = L._silu(R.causal_conv(p["conv"], xi))
        # the projections once, for the outputs and the collected state
        # (XLA's CSE merges JAX's two)
        qkvif = R._mlstm_qkvif(p["cell"], xc)
        cell_out = R.mlstm_parallel(p["cell"], xc, cfg.n_heads,
                                    chunk=rc.chunk_size, qkvif=qkvif)
        if state == "collect":
            kw = rc.conv_width - 1
            new_state = {"conv": xi[:, -kw:].float(),
                         "cell": R.mlstm_final_state(p["cell"], xc,
                                                     cfg.n_heads,
                                                     qkvif=qkvif)}
    else:
        xc, conv_buf = R.causal_conv_step(p["conv"], state["conv"], xi[:, 0])
        cell_out, cell_state = R.mlstm_step(
            p["cell"], state["cell"], L._silu(xc)[:, None, :], cfg.n_heads)
        new_state = {"conv": conv_buf, "cell": cell_state}
    out = cell_out * L._silu(z)
    return x + (out @ p["w_down"].to(out.dtype)).to(x.dtype), new_state


def _slstm_block_defs(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    f = int(cfg.recurrent.slstm_proj_factor * d)
    return {
        "norm": L.norm_defs(cfg, "scale"),
        "conv": R.conv_defs(d, cfg.recurrent.conv_width),
        "cell": R.slstm_defs(d, cfg.n_heads),
        "ffn_norm": L.norm_defs(cfg, "scale"),
        "w_gate": ParamDef((d, f), ("embed", "mlp")),
        "w_up": ParamDef((d, f), ("embed", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed"),
                           scale=1.0 / math.sqrt(2 * cfg.n_layers)),
    }


def _slstm_block(p: Params, cfg: ModelConfig, x, *, state=None):
    """One sLSTM block: the norm, the causal convolution and SiLU, the
    sLSTM cell, the residual; then a 4/3 GeGLU FFN and its residual.
    ``state`` as in ``_mlstm_block`` (collected: the normed input's last
    k - 1 positions, float32, and the cell's final state)."""
    x = shardctx.constrain_batch(x)
    h = L.apply_norm(p["norm"], cfg, x, "scale")
    new_state = None
    if state is None or state == "collect":
        hc = L._silu(R.causal_conv(p["conv"], h))
        cell_out, cell_state = R.slstm_scan(p["cell"], hc, cfg.n_heads,
                                            return_state=True)
        if state == "collect":
            kw = cfg.recurrent.conv_width - 1
            new_state = {"conv": h[:, -kw:].float(), "cell": cell_state}
    else:
        hc, conv_buf = R.causal_conv_step(p["conv"], state["conv"], h[:, 0])
        cell_out, cell_state = R.slstm_step(
            p["cell"], state["cell"], L._silu(hc)[:, None, :], cfg.n_heads)
        new_state = {"conv": conv_buf, "cell": cell_state}
    # the first residual in float32 for the norm, rounded for the second
    # add, as in ``_block``
    x32 = shardctx.constrain_batch(x.float() + cell_out.float())
    h = L.apply_norm(p["ffn_norm"], cfg, x32, "scale").to(x.dtype)
    ff = L._gelu(h @ p["w_gate"].to(h.dtype)) * (h @ p["w_up"].to(h.dtype))
    return x32.to(x.dtype) + (ff @ p["w_down"].to(ff.dtype)).to(x.dtype), \
        new_state


def _xlstm_unit_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(#units, mLSTM blocks per unit): the blocks as units of
    ``slstm_every`` - 1 mLSTM blocks and one sLSTM block."""
    per = cfg.recurrent.slstm_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.n_layers} blocks do not make units of "
                         f"slstm_every = {per}")
    return cfg.n_layers // per, per - 1


def _rg_group_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(#full [rec, rec, attn] groups, #tail rec blocks)."""
    groups = cfg.n_layers // 3
    return groups, cfg.n_layers - 3 * groups


def _to_cache_(buf: torch.Tensor, kv: torch.Tensor) -> None:
    """One layer's (B, clen, ...) cache from the prompt's (B, S, ...)
    values: zero past S, or the last clen positions for a ring buffer
    (aligned with the decode slots index % clen when clen | S)."""
    s, clen = kv.shape[1], buf.shape[1]
    if clen <= s:
        buf.copy_(kv[:, s - clen:])
    else:
        buf[:, :s] = kv


# ---------------------------------------------------------------------------
# LM facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def _stacks(self) -> Tuple[Tuple[str, str, int], ...]:
        """The homogeneous layer stacks in depth order: (parameter key,
        cache key, depth), for the dense, vlm and moe families (the hybrid
        family's groups, the ssm family's units and the encdec family's
        encoder and decoder have methods of their own)."""
        cfg = self.cfg
        if cfg.family in ("dense", "vlm"):
            return (("layers", "cache", cfg.n_layers),)
        if cfg.family == "moe":
            nd = cfg.moe.first_dense_layers
            return tuple(st for st in (
                ("dense_layers", "dense_cache", nd),
                ("layers", "cache", cfg.n_layers - nd)) if st[2])
        raise ValueError(f"family {cfg.family!r}")

    @property
    def _hybrid(self) -> bool:
        return self.cfg.family == "hybrid"

    @property
    def _ssm(self) -> bool:
        return self.cfg.family == "ssm"

    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def param_defs(self) -> Params:
        cfg = self.cfg
        defs: Params = _embed_defs(cfg)
        defs["final_norm"] = L.norm_defs(cfg, "scale")
        if self._hybrid:
            groups, tail = _rg_group_layout(cfg)
            defs["groups"] = stack({"rec": stack(_rg_block_defs(cfg), 2),
                                    "attn": _block_defs(cfg)}, groups)
            if tail:
                defs["tail"] = stack(_rg_block_defs(cfg), tail)
            return defs
        if self._ssm:
            units, n_m = _xlstm_unit_counts(cfg)
            defs["units"] = stack({"mlstm": stack(_mlstm_block_defs(cfg),
                                                  n_m),
                                   "slstm": _slstm_block_defs(cfg)}, units)
            return defs
        if self._encdec:
            defs["enc_pos"] = ParamDef((cfg.encoder_seq_len, cfg.d_model),
                                       ("seq", "embed"), "embed", scale=0.02)
            defs["enc_layers"] = stack(_block_defs(cfg),
                                       cfg.n_encoder_layers)
            defs["enc_norm"] = L.norm_defs(cfg, "scale")
            defs["dec_layers"] = stack(_dec_block_defs(cfg), cfg.n_layers)
            return defs
        for key, _, n in self._stacks():
            ffn = (None if cfg.family != "moe"
                   else _moe_ffn_defs(cfg, key == "dense_layers"))
            defs[key] = stack(_block_defs(cfg, ffn), n)
        return defs

    # ----- forward (training) -----

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                remat: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(B, S) tokens -> ((B, S, V) float32 logits, aux losses: the moe
        family's averaged over its MoE layers).  The encdec family reads
        ``batch["audio_embeds"]`` (B, encoder_seq_len, d); the vlm family
        prepends ``batch["pixel_embeds"]`` (B, n_image_tokens, d) when
        given, and its logits then run over the whole (B, n_image_tokens
        + S) length."""
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed_tokens(params, cfg, tokens, positions)
        if cfg.family == "vlm" and "pixel_embeds" in batch:
            x = torch.cat([batch["pixel_embeds"].to(x.dtype), x], 1)
            positions = torch.arange(x.shape[1], device=x.device)
        aux = {}
        if self._hybrid:
            x = self._hybrid_forward(params, x, positions, remat)
        elif self._ssm:
            x = self._ssm_forward(params, x, remat)
        elif self._encdec:
            x = self._encdec_forward(params, batch, x, positions, remat)
        else:
            x, aux = self._stacks_forward(params, x, positions, remat)
        x = L.apply_norm(params["final_norm"], cfg, x, "scale")
        return _logits(params, cfg, x), aux

    def _stacks_forward(self, params, x, positions, remat):
        cfg = self.cfg

        def block(h, lp):
            h, _, aux = _block(lp, cfg, h, positions)
            return h, aux
        block = _maybe_remat(block, remat)
        auxs = []
        for key, _, n in self._stacks():
            for lp in _unstack(params[key], n):
                x, aux = block(x, lp)
                if aux:
                    auxs.append(aux)
        aux = ({k: torch.mean(torch.stack([a[k] for a in auxs]))
                for k in auxs[0]} if auxs else {})
        return x, aux

    def _encdec_forward(self, params, batch, x, positions, remat):
        """JAX's scans over the encoder's and the decoder's blocks, each
        block rematerialised (remat); a decoder block computes its cross
        k, v of the encoder output inside itself.  The encoder output is
        an argument of the decoder's block function, not a closure, so
        its gradient reaches the encoder through the recomputation."""
        cfg = self.cfg
        enc = self._encode(params, batch["audio_embeds"].to(x.dtype), remat)

        def dec(h, lp, enc):
            return _dec_block(lp, cfg, h, _cross_kv(lp, cfg, enc),
                              positions)[0]
        dec = _maybe_remat(dec, remat)
        for lp in _unstack(params["dec_layers"], cfg.n_layers):
            x = dec(x, lp, enc)
        return x

    def _hybrid_forward(self, params, x, positions, remat):
        """JAX's scan over groups, each group rematerialized as one
        (remat), then the tail's blocks."""
        cfg = self.cfg
        groups, tail = _rg_group_layout(cfg)

        def group(h, gp):
            for lp in _unstack(gp["rec"], 2):
                h, _ = _rg_block(lp, cfg, h)
            return _block(gp["attn"], cfg, h, positions)[0]
        group = _maybe_remat(group, remat)
        for gp in _unstack(params["groups"], groups):
            x = group(x, gp)
        if tail:
            for lp in _unstack(params["tail"], tail):
                x, _ = _rg_block(lp, cfg, x)
        return x

    def _ssm_forward(self, params, x, remat):
        """JAX's scan over units, each unit rematerialised as one (remat)
        and inside it each mLSTM block again, then the unit's sLSTM
        block."""
        cfg = self.cfg
        units, n_m = _xlstm_unit_counts(cfg)
        mblock = _maybe_remat(lambda h, lp: _mlstm_block(lp, cfg, h)[0],
                              remat)

        def unit(h, up):
            for lp in _unstack(up["mlstm"], n_m):
                h = mblock(h, lp)
            return _slstm_block(up["slstm"], cfg, h)[0]
        unit = _maybe_remat(unit, remat)
        for up in _unstack(params["units"], units):
            x = unit(x, up)
        return x

    # ----- loss -----

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             remat: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, metrics): the mean cross entropy of the text's
        logits (the vlm family's image prefix dropped) against
        ``batch["labels"]`` under ``batch.get("mask")``, plus the moe
        family's aux losses."""
        logits, aux = self.forward(params, batch, remat=remat)
        if self.cfg.family == "vlm" and "pixel_embeds" in batch:
            logits = logits[:, batch["pixel_embeds"].shape[1]:]
        ce, acc = _xent(logits, batch["labels"], batch.get("mask"))
        total = ce + sum(v for k, v in aux.items() if k != "moe_dropped")
        return total, {"loss": total, "ce": ce, "acc": acc, **aux}

    def value_and_grad(self, params: Params, batch: Dict[str, torch.Tensor],
                       remat: bool = False):
        """((loss, metrics), gradient tree): ``jax.value_and_grad(loss,
        has_aux=True)`` by ``torch.autograd``, the gradient a float32
        tree shaped like ``params`` (zeros where a leaf is unused); the
        values detached."""
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = [p for _, p in tree_paths(req)]
        with torch.enable_grad():
            loss, metrics = self.loss(req, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_unflatten(req, grads)

    # ----- decode state -----

    def _attn_cache_len(self, cache_len: int) -> int:
        """Windowed archs keep a ring buffer of the window size."""
        if self.cfg.window_size:
            return min(cache_len, self.cfg.window_size)
        return cache_len

    def decode_state_defs(self, batch: int, cache_len: int) -> Params:
        cfg = self.cfg
        clen = self._attn_cache_len(cache_len)
        state: Params = {"index": ParamDef((), (), "zeros",
                                           dtype=torch.int32)}
        if self._hybrid:
            groups, tail = _rg_group_layout(cfg)
            w = cfg.recurrent.lru_width or cfg.d_model
            kw = cfg.recurrent.conv_width - 1
            rstate = {
                "conv": ParamDef((batch, kw, w),
                                 ("batch", "conv_k", "rec_state"), "zeros"),
                "h": ParamDef((batch, w), ("batch", "rec_state"), "zeros"),
            }
            state["groups"] = stack({
                "rec": stack(rstate, 2),
                "attn": L.gqa_cache_defs(cfg, batch, clen)}, groups)
            if tail:
                state["tail"] = stack(rstate, tail)
            return state
        if self._ssm:
            units, n_m = _xlstm_unit_counts(cfg)
            inner = int(cfg.recurrent.mlstm_proj_factor * cfg.d_model)
            kw = cfg.recurrent.conv_width - 1
            mstate = {
                "conv": ParamDef((batch, kw, inner),
                                 ("batch", "conv_k", "rec_state"), "zeros"),
                "cell": R.mlstm_state_defs(inner, cfg.n_heads, batch)}
            sstate = {
                "conv": ParamDef((batch, kw, cfg.d_model),
                                 ("batch", "conv_k", "rec_state"), "zeros"),
                "cell": R.slstm_state_defs(cfg.d_model, batch)}
            state["units"] = stack({"mlstm": stack(mstate, n_m),
                                    "slstm": sstate}, units)
            return state
        if self._encdec:
            state["cache"] = stack(L.gqa_cache_defs(cfg, batch, clen),
                                   cfg.n_layers)
            ckv = ParamDef((batch, cfg.encoder_seq_len, cfg.n_kv_heads,
                            cfg.resolved_head_dim),
                           ("batch", "kv_seq", "kv_heads", "head_dim"),
                           "zeros", dtype=torch_dtype(cfg.cache_dtype))
            state["cross"] = stack({"k": ckv, "v": ckv}, cfg.n_layers)
            return state
        mk = (MLA.mla_cache_defs if cfg.attention == "mla"
              else L.gqa_cache_defs)
        for _, ckey, n in self._stacks():
            state[ckey] = stack(mk(cfg, batch, clen), n)
        return state

    # ----- decode step (one token against the state) -----

    def decode_step(self, params: Params, state: Params,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """(B, 1) tokens -> ((B, 1, V) float32 logits, the new state).  The
        state is written in place: the new state holds the same tensors
        as ``state``, and a new ``index``."""
        cfg = self.cfg
        idx = state["index"]
        positions = idx.reshape(1)
        x = _embed_tokens(params, cfg, tokens, positions)
        new_state: Params = {"index": idx + 1}
        if self._hybrid:
            groups, tail = _rg_group_layout(cfg)
            gs = state["groups"]
            for g in range(groups):
                gp = _layer(params["groups"], g)
                for j in range(2):
                    x = self._into(_rg_block, _layer(gp["rec"], j), x,
                                   _layer(_layer(gs["rec"], g), j))
                x, _, _ = _block(gp["attn"], cfg, x, positions,
                                 cache=_layer(gs["attn"], g),
                                 cache_index=idx)
            new_state["groups"] = gs
            if tail:
                for i in range(tail):
                    x = self._into(_rg_block, _layer(params["tail"], i), x,
                                   _layer(state["tail"], i))
                new_state["tail"] = state["tail"]
        elif self._ssm:
            x = self._units_into(params, x, state["units"])
            new_state["units"] = state["units"]
        elif self._encdec:
            for i in range(cfg.n_layers):
                cross = _layer(state["cross"], i)
                kv = (cross["k"].to(x.dtype), cross["v"].to(x.dtype))
                x, _ = _dec_block(_layer(params["dec_layers"], i), cfg, x, kv,
                                  positions, cache=_layer(state["cache"], i),
                                  cache_index=idx)
            new_state["cache"] = state["cache"]
            new_state["cross"] = state["cross"]
        else:
            for key, ckey, n in self._stacks():
                cache = state[ckey]
                for i in range(n):
                    x, _, _ = _block(_layer(params[key], i), cfg, x,
                                     positions, cache=_layer(cache, i),
                                     cache_index=idx)
                new_state[ckey] = cache
        x = L.apply_norm(params["final_norm"], cfg, x, "scale")
        return _logits(params, cfg, x), new_state

    def _into(self, block, lp: Params, x: torch.Tensor, st: Params,
              prompt: bool = False) -> torch.Tensor:
        """One recurrent block (``_rg_block``, ``_mlstm_block``,
        ``_slstm_block``) on one token against its state ``st`` (views
        into the stacked state), or on the ``prompt``; the new state
        written into ``st`` in place."""
        x, ns = block(lp, self.cfg, x, state="collect" if prompt else st)
        for (_, dst), (_, src) in zip(tree_paths(st), tree_paths(ns)):
            dst.copy_(src)
        return x

    def _units_into(self, params: Params, x: torch.Tensor, us: Params,
                    prompt: bool = False) -> torch.Tensor:
        """The ssm family's units on one token (or the ``prompt``), each
        block's state in ``us`` written in place."""
        units, n_m = _xlstm_unit_counts(self.cfg)
        for u in range(units):
            up, ust = _layer(params["units"], u), _layer(us, u)
            for j in range(n_m):
                x = self._into(_mlstm_block, _layer(up["mlstm"], j), x,
                               _layer(ust["mlstm"], j), prompt)
            x = self._into(_slstm_block, up["slstm"], x, ust["slstm"],
                           prompt)
        return x

    # ----- prefill (forward + build decode state) -----

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
        """(B, S) prompt tokens -> ((B, 1, V) float32 logits of the last
        position, the decode state: ``index`` = S and each layer's cache,
        zero past S, or its last clen positions for a ring; the hybrid
        family's RG-LRU states, the ssm family's cell states, the encdec
        family's ``cross`` k, v).  The encdec family reads
        ``batch["audio_embeds"]`` (B, encoder_seq_len, d); the vlm family
        prepends ``batch["pixel_embeds"]`` (B, n_image_tokens, d) when
        given, and S, the positions and the default cache length then
        count them."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        dev = tokens.device
        positions = torch.arange(s, device=dev)
        x = _embed_tokens(params, cfg, tokens, positions)
        if cfg.family == "vlm" and "pixel_embeds" in batch:
            x = torch.cat([batch["pixel_embeds"].to(x.dtype), x], 1)
            s = x.shape[1]
            positions = torch.arange(s, device=dev)
        defs = self.decode_state_defs(b, cache_len or s)
        state = shardctx.zero_state(defs, tokens)
        state["index"].fill_(s)
        if self._hybrid:
            groups, tail = _rg_group_layout(cfg)
            gs = state["groups"]
            for g in range(groups):
                gp = _layer(params["groups"], g)
                for j in range(2):
                    x = self._into(_rg_block, _layer(gp["rec"], j), x,
                                   _layer(_layer(gs["rec"], g), j),
                                   prompt=True)
                x, kv, _ = _block(gp["attn"], cfg, x, positions,
                                  return_kv=True)
                for name, buf in _layer(gs["attn"], g).items():
                    _to_cache_(buf, kv[name])
            for i in range(tail):
                x = self._into(_rg_block, _layer(params["tail"], i), x,
                               _layer(state["tail"], i), prompt=True)
        elif self._ssm:
            x = self._units_into(params, x, state["units"], prompt=True)
        elif self._encdec:
            enc = self._encode(params, batch["audio_embeds"].to(x.dtype))
            for i in range(cfg.n_layers):
                lp = _layer(params["dec_layers"], i)
                kv = _cross_kv(lp, cfg, enc)
                x, new_kv = _dec_block(lp, cfg, x, kv, positions,
                                       return_kv=True)
                for name, buf in _layer(state["cache"], i).items():
                    _to_cache_(buf, new_kv[name])
                for name, buf in zip("kv", kv):
                    _layer(state["cross"], i)[name].copy_(buf)
        else:
            for key, ckey, n in self._stacks():
                for i in range(n):
                    x, kv, _ = _block(_layer(params[key], i), cfg, x,
                                      positions, return_kv=True)
                    for name, buf in _layer(state[ckey], i).items():
                        _to_cache_(buf, kv[name])
        x = L.apply_norm(params["final_norm"], cfg, x[:, -1:], "scale")
        return _logits(params, cfg, x), state

    def _encode(self, params: Params, audio: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
        """The encdec family's encoder: (B, encoder_seq_len, d) frontend
        embeddings in compute_dtype + ``enc_pos``, the encoder blocks
        (causal, as the JAX package's; each rematerialised under
        ``remat``), ``enc_norm``."""
        cfg = self.cfg
        enc = audio + params["enc_pos"].to(audio.dtype)
        positions = torch.arange(enc.shape[1], device=enc.device)
        block = _maybe_remat(lambda h, lp: _block(lp, cfg, h, positions)[0],
                             remat)
        for lp in _unstack(params["enc_layers"], cfg.n_encoder_layers):
            enc = block(enc, lp)
        return L.apply_norm(params["enc_norm"], cfg, enc, "scale")
