"""Language-model assembly, dense family: the port of the JAX package's
``repro/models/lm.py`` for serving.

One functional ``LM`` facade per ModelConfig:

  * ``param_defs()``                       — ParamDef tree (layer-stacked)
  * ``prefill(params, batch, cache_len)``  — last-position logits + decode
                                             state
  * ``decode_state_defs(batch, cache_len)``— decode-state ParamDefs
  * ``decode_step(params, state, tokens)`` — one-token serve step

Parameters and the KV cache keep the JAX package's stacked ``(L, ...)``
layout, so a tree converts with a plain copy and the cache compares
slice by slice; the ``lax.scan`` over layers is a Python loop indexing
the stacks.  The other families (moe, ssm, hybrid, encdec, vlm) and the
training surface (``forward``, ``loss``) are still to port (ROADMAP.md,
queue 1 item 15).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, stack
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def _not_ported(fam: str) -> NotImplementedError:
    return NotImplementedError(
        f"family {fam!r}: only the dense family is ported (ROADMAP.md, "
        f"queue 1 item 15)")


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
    table = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = (x.to(cd) @ table.to(cd)).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    x = p["embed"][tokens]
    if cfg.pos_embed == "learned":
        x = x + p["pos_embed"][positions]
    return x.to(torch_dtype(cfg.compute_dtype))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# dense family
# ---------------------------------------------------------------------------


def _dense_block_defs(cfg: ModelConfig) -> Params:
    return {
        "attn_norm": L.norm_defs(cfg, "scale"),
        "attn": L.gqa_defs(cfg),
        "mlp_norm": L.norm_defs(cfg, "scale"),
        "mlp": L.mlp_defs(cfg),
    }


def _dense_block(p: Params, cfg: ModelConfig, x, positions, cache=None,
                 cache_index=None, return_kv=False):
    h = L.apply_norm(p["attn_norm"], cfg, x, "scale")
    a, new_cache = L.gqa_apply(p["attn"], cfg, h, positions=positions,
                               cache=cache, cache_index=cache_index,
                               return_kv=return_kv)
    # XLA keeps this sum in float32 for the norm (its excess precision
    # across the fusion) and rounds it for the second residual add
    x32 = x.float() + a.float()
    h = L.apply_norm(p["mlp_norm"], cfg, x32, "scale").to(x.dtype)
    x = x32.to(x.dtype) + L.mlp_apply(p["mlp"], cfg, h)
    return x, new_cache


# ---------------------------------------------------------------------------
# LM facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def _check_family(self) -> None:
        if self.cfg.family != "dense":
            raise _not_ported(self.cfg.family)

    def param_defs(self) -> Params:
        cfg = self.cfg
        self._check_family()
        defs: Params = _embed_defs(cfg)
        defs["final_norm"] = L.norm_defs(cfg, "scale")
        defs["layers"] = stack(_dense_block_defs(cfg), cfg.n_layers)
        return defs

    # ----- decode state -----

    def _attn_cache_len(self, cache_len: int) -> int:
        """Windowed archs keep a ring buffer of the window size."""
        if self.cfg.window_size:
            return min(cache_len, self.cfg.window_size)
        return cache_len

    def decode_state_defs(self, batch: int, cache_len: int) -> Params:
        cfg = self.cfg
        self._check_family()
        clen = self._attn_cache_len(cache_len)
        return {"index": ParamDef((), (), "zeros", dtype=torch.int32),
                "cache": stack(L.gqa_cache_defs(cfg, batch, clen),
                               cfg.n_layers)}

    # ----- decode step (one token against the state) -----

    def decode_step(self, params: Params, state: Params,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """(B, 1) tokens -> ((B, 1, V) float32 logits, the new state).  The
        cache is written in place: the new state holds the same cache
        tensors as ``state``."""
        cfg = self.cfg
        self._check_family()
        idx = state["index"]
        positions = idx.reshape(1)
        x = _embed_tokens(params, cfg, tokens, positions)
        cache = state["cache"]
        for i in range(cfg.n_layers):
            x, _ = _dense_block(_layer(params["layers"], i), cfg, x,
                                positions, cache=_layer(cache, i),
                                cache_index=idx)
        x = L.apply_norm(params["final_norm"], cfg, x, "scale")
        return _logits(params, cfg, x), {"index": idx + 1, "cache": cache}

    # ----- prefill (forward + build decode state) -----

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
        """(B, S) prompt tokens -> ((B, 1, V) float32 logits of the last
        position, the decode state: ``index`` = S and the (L, B, clen, G,
        hd) cache, zero past S, or its last clen positions for a ring)."""
        cfg = self.cfg
        self._check_family()
        tokens = batch["tokens"]
        b, s = tokens.shape
        dev = tokens.device
        positions = torch.arange(s, device=dev)
        x = _embed_tokens(params, cfg, tokens, positions)
        defs = self.decode_state_defs(b, cache_len or s)["cache"]
        cache = {name: torch.zeros(d.shape, dtype=d.dtype, device=dev)
                 for name, d in defs.items()}
        clen = cache["k"].shape[2]
        for i in range(cfg.n_layers):
            x, kv = _dense_block(_layer(params["layers"], i), cfg, x,
                                 positions, return_kv=True)
            for name in ("k", "v"):
                if clen <= s:     # ring buffer: the last clen positions
                    cache[name][i] = kv[name][:, s - clen:]
                else:
                    cache[name][i, :, :s] = kv[name]
        x = L.apply_norm(params["final_norm"], cfg, x[:, -1:], "scale")
        state = {"index": torch.tensor(s, dtype=torch.int32, device=dev),
                 "cache": cache}
        return _logits(params, cfg, x), state
