"""Mixture-of-Experts layer (DeepSeek-style: shared + routed top-k), the
port of the JAX package's ``repro/models/moe.py``.

Dispatch is GShard-style with a *per-batch-row* capacity: each row of
the batch routes its own S tokens into (E, cap) expert slots, so the
same tokens spill at capacity as in the JAX package.  All shapes are
static.  The rows are routed together here (the JAX package's ``vmap``
over rows), and the expert products of all rows are one batched matmul
per weight, over the experts (plain ``torch.bmm``: the JAX package
computes them outside any Pallas kernel).

Routing follows ``_route_row`` step by step: softmax in float32, the
top k by a descending *stable* sort (``lax.top_k`` puts the lower
expert first among equal probabilities; ``torch.topk`` promises no
order, and bf16 router logits over 64 experts tie often), weights
renormalised by their sum + 1e-9, and each (token, choice)'s slot its
rank within its expert over the token-major, then k-major flat order.
Overflowing choices write to the spill column ``cap``, which is sliced
off before anything reads it, so its duplicate writes never decide a
value.  ``shardctx.constrain_expert_weight`` sits at the JAX package's
site, on the three expert weights in compute_dtype: the identity unless
a launcher sets an activation sharding and the weights are DTensors.
On DTensors the dispatch and the combine run on each rank's batch rows
(``shardctx.rows_locally``) and the expert products on its rows and
experts (``shardctx.experts_locally``), as XLA partitions the JAX
package's row function, vmapped over the rows.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.models import shardctx
from repro_torch.models.layers import _silu
from repro_torch.models.params import ParamDef, dense

Params = Dict[str, Any]


def moe_defs(cfg: ModelConfig) -> Params:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    out_scale = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    defs: Params = {
        "router": ParamDef((d, e), ("embed", None)),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": ParamDef((e, f, d), ("experts", "expert_mlp", "embed"),
                           scale=out_scale),
    }
    if m.num_shared_experts:
        fs = m.d_ff_expert * m.num_shared_experts
        defs["shared"] = {
            "w_gate": dense(d, fs, "embed", "mlp"),
            "w_up": dense(d, fs, "embed", "mlp"),
            "w_down": dense(fs, d, "mlp", "embed", scale=out_scale),
        }
    return defs


def capacity(cfg: ModelConfig, seq: int) -> int:
    m = cfg.moe
    c = int(math.ceil(m.top_k * seq * m.capacity_factor / m.num_experts))
    return max(8, min(c, seq * m.top_k))


def route(logits: torch.Tensor, k: int, e: int, cap: int):
    """Routing of each row. logits: (B, S, E) -> (probs (B, S, E) float32,
    weights (B, S*k) float32, expert ids (B, S*k), slots (B, S*k), keep
    (B, S*k) bool); the flat axis is token-major, then choice."""
    x = logits.float()
    ex = torch.exp(x - torch.amax(x, -1, keepdim=True))
    probs = ex / torch.sum(ex, -1, keepdim=True)            # jax.nn.softmax
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = vals[..., :k], idx[..., :k]
    top_w = top_w / (torch.sum(top_w, -1, keepdim=True) + 1e-9)
    b = logits.shape[0]
    flat_ids = top_ids.reshape(b, -1)                       # (B, S*k)
    onehot = torch.nn.functional.one_hot(flat_ids, e)       # (B, S*k, E)
    # rank within the expert: the running count of its choices so far
    pos_in_e = torch.gather(torch.cumsum(onehot, 1), 2,
                            flat_ids[..., None])[..., 0] - 1
    keep = pos_in_e < cap
    slot = torch.where(keep, pos_in_e, cap)                 # overflow: spill
    return probs, top_w.reshape(b, -1), flat_ids, slot, keep


def _dispatch(xq: torch.Tensor, ids: torch.Tensor, slot: torch.Tensor, *,
              e: int, cap: int) -> torch.Tensor:
    """An index buffer (B, E, cap + 1) of source tokens, the pad token s
    (a zero row) where a slot stays empty, then a token gather ->
    (B, E, cap, D)."""
    b, s, d = xq.shape
    k = ids.shape[1] // s
    rows = torch.arange(b, device=xq.device)[:, None]
    tok_ids = torch.arange(s * k, device=xq.device) // k
    idx_buf = ids.new_full((b, e, cap + 1), s, dtype=torch.int64)
    idx_buf[rows, ids, slot] = tok_ids.expand(b, -1)
    x_pad = torch.cat([xq, xq.new_zeros(b, 1, d)], 1)
    return x_pad[rows[..., None], idx_buf[:, :, :cap]]


def _combine(out: torch.Tensor, ids: torch.Tensor, slot: torch.Tensor,
             keep: torch.Tensor, w: torch.Tensor, *, k: int
             ) -> torch.Tensor:
    """Each choice's slot output (``out`` (B, E, cap, D)) times its
    weight (zero if dropped), summed over the ``k`` choices in float32
    (jnp.sum's upcast) -> (B, S, D) in ``out``'s dtype."""
    b, e, cap, d = out.shape
    out_buf = torch.cat([out, out.new_zeros(b, e, 1, d)], 2)  # cap + 1
    rows = torch.arange(b, device=out.device)[:, None]
    gathered = out_buf[rows, ids, torch.where(keep, slot, cap)]
    gathered = gathered * (w * keep.to(torch.float32)).to(out.dtype)[..., None]
    return torch.sum(gathered.reshape(b, -1, k, d).float(), 2).to(out.dtype)


def _expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """(B, E, cap, D) slots through each expert's SwiGLU -> (B, E, cap,
    D): one ``torch.bmm`` a weight over the experts, every row's slots
    together."""
    b, e, cap, d = buf.shape
    h = buf.transpose(0, 1).reshape(e, b * cap, d)
    hg = _silu(torch.bmm(h, w_gate))
    hu = torch.bmm(h, w_up)
    out = torch.bmm(hg * hu, w_down)                        # (E, B*cap, D)
    return out.reshape(e, b, cap, -1).transpose(0, 1)


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux losses ``moe_aux``, ``moe_z``,
    ``moe_dropped``)."""
    m = cfg.moe
    cd = torch_dtype(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = capacity(cfg, s)
    xq = x.to(cd)
    logits = (xq.reshape(b * s, d) @ p["router"].to(cd)).reshape(b, s, e)
    probs, w, ids, slot, keep = route(logits, k, e, cap)

    # dispatch, the expert FFN and the combine, each on each rank's batch
    # rows (and the FFN on its experts) where the tensors are DTensors
    buf = shardctx.rows_locally(functools.partial(_dispatch, e=e, cap=cap),
                                xq, ids, slot)
    # the FSDP weight shards gathered at the use site
    w_gate, w_up, w_down = (shardctx.constrain_expert_weight(
        p[name].to(cd), e) for name in ("w_gate", "w_up", "w_down"))
    out = shardctx.experts_locally(_expert_ffn, buf, w_gate, w_up, w_down)
    y = shardctx.rows_locally(functools.partial(_combine, k=k), out, ids,
                              slot, keep, w)

    # aux statistics per row, then averaged over rows
    frac_tokens = torch.mean(
        torch.nn.functional.one_hot(ids, e).to(torch.float32), 1)
    frac_probs = torch.mean(probs, 1)
    aux = e * torch.sum(frac_tokens * frac_probs, -1)
    zloss = torch.mean(torch.logsumexp(logits.float(), -1) ** 2, -1)
    dropped = 1.0 - torch.mean(keep.to(torch.float32), -1)

    y = y.to(x.dtype)
    if m.num_shared_experts:
        sp = p["shared"]
        hs = _silu(xq @ sp["w_gate"].to(cd)) * (xq @ sp["w_up"].to(cd))
        y = y + (hs @ sp["w_down"].to(cd)).to(x.dtype)
    losses = {
        "moe_aux": torch.mean(aux) * m.aux_loss_coef,
        "moe_z": torch.mean(zloss) * m.router_z_coef,
        "moe_dropped": torch.mean(dropped),
    }
    return y, losses
