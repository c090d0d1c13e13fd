"""Language-model assembly, dense and moe families: the port of the JAX
package's ``repro/models/lm.py`` for training and serving.

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

The moe family (DeepSeek-MoE) on GQA attention stacks its first
``moe.first_dense_layers`` blocks as ``dense_layers`` (a dense MLP of
the JAX package's width) and the rest as ``layers`` (the MoE FFN,
``models/moe.py``), with caches ``dense_cache`` and ``cache``; its aux
losses are averaged over the MoE layers.  Still to port (ROADMAP.md,
queue 1 item 8): moe with MLA attention, and the ssm, hybrid, encdec and
vlm families.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.params import ParamDef, stack
from repro_torch.tree import tree_map, tree_paths, tree_unflatten

Params = Dict[str, Any]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: only the dense family and moe on GQA attention are "
        f"ported; moe with MLA, ssm, hybrid, encdec and vlm are not yet "
        f"(ROADMAP.md, queue 1 item 8)")


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
    """The rows of the table (``F.embedding``: its backward sums the
    rows' gradients in a fixed order, where indexing's accumulating
    ``index_put_`` does not)."""
    x = F.embedding(tokens, p["embed"])
    if cfg.pos_embed == "learned":
        x = x + F.embedding(positions, p["pos_embed"])
    return x.to(torch_dtype(cfg.compute_dtype))


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
    one-hot, which picks the same value exactly)."""
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
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
# blocks: dense, and the moe family's (dense FFN or MoE FFN)
# ---------------------------------------------------------------------------


def _block_defs(cfg: ModelConfig, ffn: Optional[Params] = None) -> Params:
    """One block: attention and its norm, then the FFN's norm and ``ffn``
    (by default the dense MLP of width ``cfg.d_ff``)."""
    return {"attn_norm": L.norm_defs(cfg, "scale"), "attn": L.gqa_defs(cfg),
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
    h = L.apply_norm(p["attn_norm"], cfg, x, "scale")
    a, new_cache = L.gqa_apply(p["attn"], cfg, h, positions=positions,
                               cache=cache, cache_index=cache_index,
                               return_kv=return_kv)
    # XLA keeps this sum in float32 for the norm (its excess precision
    # across the fusion) and rounds it for the second residual add
    x32 = x.float() + a.float()
    h = L.apply_norm(p["mlp_norm"], cfg, x32, "scale").to(x.dtype)
    if "moe" in p:
        y, aux = MOE.moe_apply(p["moe"], cfg, h)
    else:
        y, aux = L.mlp_apply(p["mlp"], cfg, h), {}
    return x32.to(x.dtype) + y, new_cache, aux


# ---------------------------------------------------------------------------
# LM facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def _stacks(self) -> Tuple[Tuple[str, str, int], ...]:
        """The layer stacks in depth order: (parameter key, cache key,
        depth), for the families the port runs."""
        cfg = self.cfg
        if cfg.family == "dense":
            return (("layers", "cache", cfg.n_layers),)
        if cfg.family == "moe":
            if cfg.attention == "mla":
                raise _not_ported("family 'moe' with attention 'mla'")
            nd = cfg.moe.first_dense_layers
            return tuple(st for st in (
                ("dense_layers", "dense_cache", nd),
                ("layers", "cache", cfg.n_layers - nd)) if st[2])
        raise _not_ported(f"family {cfg.family!r}")

    def param_defs(self) -> Params:
        cfg = self.cfg
        defs: Params = _embed_defs(cfg)
        defs["final_norm"] = L.norm_defs(cfg, "scale")
        for key, _, n in self._stacks():
            ffn = (None if cfg.family == "dense"
                   else _moe_ffn_defs(cfg, key == "dense_layers"))
            defs[key] = stack(_block_defs(cfg, ffn), n)
        return defs

    # ----- forward (training) -----

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                remat: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(B, S) tokens -> ((B, S, V) float32 logits, aux losses: the moe
        family's averaged over its MoE layers)."""
        cfg = self.cfg
        stacks = self._stacks()
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed_tokens(params, cfg, tokens, positions)

        def block(h, lp):
            h, _, aux = _block(lp, cfg, h, positions)
            return h, aux
        block = _maybe_remat(block, remat)
        auxs = []
        for key, _, n in stacks:
            for lp in _unstack(params[key], n):
                x, aux = block(x, lp)
                if aux:
                    auxs.append(aux)
        aux = ({k: torch.mean(torch.stack([a[k] for a in auxs]))
                for k in auxs[0]} if auxs else {})
        x = L.apply_norm(params["final_norm"], cfg, x, "scale")
        return _logits(params, cfg, x), aux

    # ----- loss -----

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             remat: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = self.forward(params, batch, remat=remat)
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
        for _, ckey, n in self._stacks():
            state[ckey] = stack(L.gqa_cache_defs(cfg, batch, clen), n)
        return state

    # ----- decode step (one token against the state) -----

    def decode_step(self, params: Params, state: Params,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """(B, 1) tokens -> ((B, 1, V) float32 logits, the new state).  The
        caches are written in place: the new state holds the same cache
        tensors as ``state``."""
        cfg = self.cfg
        stacks = self._stacks()
        idx = state["index"]
        positions = idx.reshape(1)
        x = _embed_tokens(params, cfg, tokens, positions)
        new_state: Params = {"index": idx + 1}
        for key, ckey, n in stacks:
            cache = state[ckey]
            for i in range(n):
                x, _, _ = _block(_layer(params[key], i), cfg, x, positions,
                                 cache=_layer(cache, i), cache_index=idx)
            new_state[ckey] = cache
        x = L.apply_norm(params["final_norm"], cfg, x, "scale")
        return _logits(params, cfg, x), new_state

    # ----- prefill (forward + build decode state) -----

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
        """(B, S) prompt tokens -> ((B, 1, V) float32 logits of the last
        position, the decode state: ``index`` = S and each stack's (L, B,
        clen, G, hd) cache, zero past S, or its last clen positions for a
        ring)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        dev = tokens.device
        positions = torch.arange(s, device=dev)
        x = _embed_tokens(params, cfg, tokens, positions)
        defs = self.decode_state_defs(b, cache_len or s)
        state: Params = {"index": torch.tensor(s, dtype=torch.int32,
                                               device=dev)}
        for key, ckey, n in self._stacks():
            cache = {name: torch.zeros(d.shape, dtype=d.dtype, device=dev)
                     for name, d in defs[ckey].items()}
            clen = cache["k"].shape[2]
            for i in range(n):
                x, kv, _ = _block(_layer(params[key], i), cfg, x, positions,
                                  return_kv=True)
                for name in ("k", "v"):
                    if clen <= s:     # ring buffer: the last clen positions
                        cache[name][i] = kv[name][:, s - clen:]
                    else:
                        cache[name][i, :, :s] = kv[name]
            state[ckey] = cache
        x = L.apply_norm(params["final_norm"], cfg, x[:, -1:], "scale")
        return _logits(params, cfg, x), state
