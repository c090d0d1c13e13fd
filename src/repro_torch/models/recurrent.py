"""Recurrent sequence-mixing cells: the port of the JAX package's
``repro/models/recurrent.py``, RG-LRU (Griffin / RecurrentGemma) and the
xLSTM cells, mLSTM and sLSTM.

  * ``conv_defs``, ``causal_conv`` (full sequence), ``causal_conv_step``
    (decode, a buffer of the last k - 1 inputs);
  * ``rg_lru_defs``, ``rg_lru_scan`` (full sequence), ``rg_lru_step``
    (decode, the float32 state h);
  * ``mlstm_dims``, ``mlstm_defs``, ``mlstm_state_defs``,
    ``mlstm_parallel`` (the decay-masked parallel form over query chunks),
    ``mlstm_final_state`` (the closed-form (C, n, m) after a prompt),
    ``mlstm_step`` (decode, the stabilised recurrent update);
  * ``slstm_defs``, ``slstm_state_defs``, ``slstm_scan`` (a time loop,
    where JAX has ``lax.scan``), ``slstm_step``.

``rg_lru_scan`` solves h_t = a_t h_{t-1} + b_t over the sequence with a
log-depth scan in plain PyTorch (doubling over S: 11 steps at S = 2048,
each a few elementwise passes), where the JAX package uses
``lax.associative_scan``; the two associate the same products in another
order, so they agree to float32 rounding, not bitwise.  No TPU kernel
covers any of these cells, so plain PyTorch is the port's form of them;
the sLSTM's time loop issues a few small kernels per step.  The casts
follow JAX's one by one: projections in the compute dtype, the gates and
cell states in float32, the cell output cast back before the group norm
(which works in float32).  ``F.logsigmoid`` (through
``shardctx.log_sigmoid``, the plain op on plain tensors) stands for
``jax.nn.log_sigmoid`` (-softplus(-x)): it computes min(x, 0) -
log1p(exp(-|x|)), within one float32 ulp of JAX's on |x| up to 120.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import shardctx
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
    xh = shardctx.splittable(x, 2, n_heads).reshape(b, s, n_heads,
                                                    w // n_heads)
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


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating)
# ---------------------------------------------------------------------------


def mlstm_dims(d_inner: int, n_heads: int) -> Tuple[int, int]:
    """(qk head dim, v head dim)."""
    return d_inner // (2 * n_heads), d_inner // n_heads


def mlstm_defs(d_inner: int, n_heads: int) -> Params:
    """q, k, v are block-diagonal per head (each head projects its own
    slice of the inner dim).  ``b_f`` is declared "ones" at scale 3, and
    both packages' ``init_params`` ignore the scale of "ones": it starts
    at 1."""
    dk, dv = mlstm_dims(d_inner, n_heads)
    hw = d_inner // n_heads
    return {
        "wq": ParamDef((n_heads, hw, dk), ("kv_heads", "rec_state", None)),
        "wk": ParamDef((n_heads, hw, dk), ("kv_heads", "rec_state", None)),
        "wv": ParamDef((n_heads, hw, dv), ("kv_heads", "rec_state", None)),
        "w_i": ParamDef((d_inner, n_heads), ("rec_state", "kv_heads"),
                        "zeros"),
        "w_f": ParamDef((d_inner, n_heads), ("rec_state", "kv_heads"),
                        "zeros"),
        "b_i": ParamDef((n_heads,), ("kv_heads",), "zeros"),
        "b_f": ParamDef((n_heads,), ("kv_heads",), "ones", scale=3.0),
        "gn": ParamDef((d_inner,), ("rec_state",), "ones"),
    }


def mlstm_state_defs(d_inner: int, n_heads: int, batch: int) -> Params:
    dk, dv = mlstm_dims(d_inner, n_heads)
    return {
        "C": ParamDef((batch, n_heads, dk, dv),
                      ("batch", "kv_heads", None, None), "zeros"),
        "n": ParamDef((batch, n_heads, dk), ("batch", "kv_heads", None),
                      "zeros"),
        "m": ParamDef((batch, n_heads), ("batch", "kv_heads"), "zeros"),
    }


def _mlstm_qkvif(p: Params, x: torch.Tensor):
    """(q, k, v) per head in x's dtype, (B, S, H, dk / dv); the input and
    forget gate pre-activations (B, S, H) in float32."""
    cd = x.dtype
    b, s, w = x.shape
    n_heads = p["wq"].shape[0]
    xh = shardctx.splittable(x, 2, n_heads).reshape(b, s, n_heads,
                                                    w // n_heads)
    q = torch.einsum("bshw,hwk->bshk", xh, p["wq"].to(cd))
    k = torch.einsum("bshw,hwk->bshk", xh, p["wk"].to(cd))
    v = torch.einsum("bshw,hwk->bshk", xh, p["wv"].to(cd))
    i_t = (x @ p["w_i"].to(cd)).float() + p["b_i"].float()
    f_t = (x @ p["w_f"].to(cd)).float() + p["b_f"].float()
    return q, k, v, i_t, f_t


def _groupnorm(p: Params, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-head group norm of (B, S, W) in float32 (the population
    variance, ``jnp.var``), scaled by ``gn``, out in h's dtype."""
    b, s, w = h.shape
    hh = shardctx.splittable(h, 2, n_heads).reshape(
        b, s, n_heads, w // n_heads).float()
    var, mu = torch.var_mean(hh, -1, correction=0, keepdim=True)
    out = (hh - mu) * torch.rsqrt(var + 1e-5)
    out = shardctx.merged(out.reshape(b, s, w), 2, n_heads)
    return (out * p["gn"].float()).to(h.dtype)


def mlstm_parallel(p: Params, x: torch.Tensor, n_heads: int,
                   chunk: int = 512, qkvif=None) -> torch.Tensor:
    """Decay-masked parallel form, query chunk by query chunk: D_ij = F_i
    - F_j + itilde_j for j <= i (else -inf), each row stabilised by m_i =
    max(max_j D_ij, 0), the scores q k^T / sqrt(dk) exp(D - m) normalised
    by max(|their sum|, exp(-m)).  A length that ``chunk`` does not
    divide is one chunk.  ``qkvif``: ``_mlstm_qkvif(p, x)`` when the
    caller has it (prefill shares it with ``mlstm_final_state``)."""
    b, s, w = x.shape
    dk, _ = mlstm_dims(w, n_heads)
    q, k, v, i_t, f_t = qkvif if qkvif is not None else _mlstm_qkvif(p, x)
    fc = torch.cumsum(shardctx.log_sigmoid(f_t), 1).transpose(1, 2)
    # fc: (B, H, S)
    it = i_t.transpose(1, 2)
    kf = k.float().permute(0, 2, 3, 1)                        # (B, H, dk, S)
    vf = v.float().transpose(1, 2)                            # (B, H, S, dv)
    scale = 1.0 / math.sqrt(dk)
    if s % chunk != 0:
        chunk = s
    cols = torch.arange(s, device=x.device)
    outs = []
    for c0 in range(0, s, chunk):
        d = (fc[:, :, c0:c0 + chunk, None] - fc[:, :, None, :]
             + it[:, :, None, :])                             # (B, H, c, S)
        causal = (c0 + torch.arange(chunk, device=x.device))[:, None] >= cols
        d = torch.where(causal, d, -math.inf)
        m = torch.clamp_min(torch.amax(d, -1, keepdim=True), 0.0)
        dm = torch.exp(d - m)
        qc = q[:, c0:c0 + chunk].float().transpose(1, 2)      # (B, H, c, dk)
        scores = (qc @ kf) * scale * dm
        norm = torch.maximum(torch.abs(torch.sum(scores, -1, keepdim=True)),
                             torch.exp(-m))
        out = (scores / norm) @ vf                            # (B, H, c, dv)
        outs.append(out.transpose(1, 2).reshape(b, chunk, w))
    h = torch.cat(outs, 1).to(x.dtype)
    return _groupnorm(p, h, n_heads)


def mlstm_final_state(p: Params, x: torch.Tensor, n_heads: int,
                      qkvif=None) -> Params:
    """The closed-form (C, n, m) after x, which the step recursion
    reaches: m_T = max(F_T, max_j (F_T - F_j + i_j)), C_T = sum_j
    exp(F_T - F_j + i_j - m_T) k_j v_j^T, n_T the same sum of k_j.
    ``qkvif`` as ``mlstm_parallel``'s."""
    _, k, v, i_t, f_t = qkvif if qkvif is not None else _mlstm_qkvif(p, x)
    fc = torch.cumsum(shardctx.log_sigmoid(f_t), 1)
    ft = fc[:, -1]                                            # (B, H)
    d = ft[:, None] - fc + i_t                                # (B, S, H)
    m = torch.maximum(ft, torch.amax(d, 1))
    wgt = torch.exp(d - m[:, None])
    kw = k.float() * wgt[..., None]                           # (B, S, H, dk)
    c = torch.einsum("bshk,bshv->bhkv", kw, v.float())
    n = torch.sum(kw, 1)
    return {"C": c, "n": n, "m": m}


def mlstm_step(p: Params, state: Params, x: torch.Tensor, n_heads: int
               ) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, W) -> (h in x's dtype, the new float32 (C, n, m))."""
    b, _, w = x.shape
    dk, _ = mlstm_dims(w, n_heads)
    q, k, v, i_t, f_t = _mlstm_qkvif(p, x)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i_t, logf = i_t[:, 0], shardctx.log_sigmoid(f_t[:, 0])    # (B, H)
    m_prev, c_prev, n_prev = state["m"], state["C"], state["n"]
    m_new = torch.maximum(logf + m_prev, i_t)
    f_sc = torch.exp(logf + m_prev - m_new)[..., None]
    i_sc = torch.exp(i_t - m_new)[..., None]
    c = f_sc[..., None] * c_prev + i_sc[..., None] * (k[..., :, None]
                                                      * v[..., None, :])
    n = f_sc * n_prev + i_sc * k
    qs = q * (1.0 / math.sqrt(dk))
    num = (qs[..., None, :] @ c)[..., 0, :]                   # (B, H, dv)
    den = torch.maximum(torch.abs(torch.sum(qs * n, -1)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, w).to(x.dtype)
    return _groupnorm(p, h, n_heads), {"C": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, block-diagonal recurrence)
# ---------------------------------------------------------------------------


def slstm_defs(d_inner: int, n_heads: int) -> Params:
    hd = d_inner // n_heads
    return {
        "w_in": ParamDef((d_inner, 4 * d_inner), ("rec_state", None)),
        "r": ParamDef((4, n_heads, hd, hd),
                      (None, "kv_heads", "rec_state", None), scale=0.5),
        "b": ParamDef((4 * d_inner,), (None,), "zeros"),
        "gn": ParamDef((d_inner,), ("rec_state",), "ones"),
    }


def slstm_state_defs(d_inner: int, batch: int) -> Params:
    ax = ("batch", "rec_state")
    return {k: ParamDef((batch, d_inner), ax, "zeros")
            for k in ("c", "n", "h", "m")}


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """(H, B, hd) -> (B, H hd)."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def _slstm_r(p: Params) -> torch.Tensor:
    """The recurrent weights (4, H, hd, hd) as (H, hd, 4 hd) float32: one
    batched product per step gives every gate of every head."""
    r = p["r"].float()
    g, n_heads, hd, _ = r.shape
    return r.permute(1, 2, 0, 3).reshape(n_heads, hd, g * hd)


def _slstm_cell(r: torch.Tensor, state: Params, z: torch.Tensor) -> Params:
    """One time step in float32, per head: ``state`` (c, n, h, m) each
    (H, B, hd), ``z`` (H, B, 4 hd) the pre-activations plus the bias,
    ``r`` from ``_slstm_r``: one batched product gives the recurrence of
    every gate and head, added to ``z`` as JAX adds it; 17 kernels a
    step on the card."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    it, ft, zt, ot = torch.split(z + torch.bmm(h, r), h.shape[-1], -1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    lf = shardctx.log_sigmoid(ft) + m
    m_new = torch.maximum(lf, it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.exp(lf - m_new)
    c_new = torch.addcmul(f_sc * c, i_sc, zt)
    n_new = torch.clamp_min(torch.addcmul(i_sc, f_sc, n), 1.0)
    return {"c": c_new, "n": n_new, "h": ot * c_new / n_new, "m": m_new}


def _slstm_loop(z: torch.Tensor, r: torch.Tensor):
    """The time loop from the zero state: ``z`` (S, H, B, 4 hd) and ``r``
    from ``_slstm_r`` -> (h (H, S, B, hd), the final float32 state (c, n,
    h, m) each (H, B, hd)).  In the dry run's fake trace: of a step that
    records no gradient (prefill, decode), ``_slstm_loop_weighted``; of
    one that records it (train), the loop unrolled on meta twins of its
    inputs (``op_analysis.on_meta``), every step counted as on the fake
    tensors, where a weighted body would miss eager autograd's per-step
    accumulations of the gradients of z and r."""
    from repro_torch.launch import op_analysis
    probe = op_analysis.fake_trace_probe(z)
    if probe is not None and z.shape[0] > 2:
        if torch.is_grad_enabled() and (z.requires_grad or r.requires_grad):
            return op_analysis.on_meta(probe, _slstm_loop_unrolled, z, r)
        return _slstm_loop_weighted(z, r, probe)
    return _slstm_loop_unrolled(z, r)


def _slstm_zero_state(z, r) -> Params:
    zero = z.new_zeros(z.shape[1:3] + (r.shape[1],))
    return {k: zero for k in ("c", "n", "h", "m")}


def _slstm_loop_unrolled(z, r):
    state = _slstm_zero_state(z, r)
    hs = []
    for t in range(z.shape[0]):
        state = _slstm_cell(r, state, z[t])
        hs.append(state["h"])
    return torch.stack(hs, 1), state


def _slstm_loop_weighted(z, r, probe):
    """The loop as the dry run's probe counts it, the counterpart of JAX's
    ``hlo_analysis`` weighting a scan's while body by its trip count:
    step 0 traced, step 1 traced for steps 1 .. S - 1 (every step runs
    the same ops on the same shapes), with the h of steps 1 .. S - 2
    held as bytes meanwhile, then the S h's stacked whole.  FLOPs,
    write bytes, the op census, collectives and the peak are the
    unrolled loop's; the values are not (the trace has none)."""
    s = z.shape[0]
    state = _slstm_cell(r, _slstm_zero_state(z, r), z[0])
    h0 = state["h"]
    nbytes = h0.numel() * h0.element_size()
    with probe.holding((s - 2) * nbytes):
        with probe.weighted(s - 1):
            state = _slstm_cell(r, state, z[1])
        return torch.stack([h0] + [state["h"]] * (s - 1), 1), state


def slstm_scan(p: Params, x: torch.Tensor, n_heads: int,
               return_state: bool = False):
    """x: (B, S, W) -> (B, S, W), a loop over time from the zero state
    (with the final float32 state, (B, W) each, when
    ``return_state``); on DTensors on each rank's shards
    (``shardctx.recur_locally``)."""
    b, s, w = x.shape
    hd = w // n_heads
    pre = x @ p["w_in"].to(x.dtype)                          # (B, S, 4 W)
    z = (pre.float() + p["b"].float()).reshape(b, s, 4, n_heads, hd) \
        .permute(1, 3, 0, 2, 4).reshape(s, n_heads, b, 4 * hd)
    h, state = shardctx.recur_locally(_slstm_loop, z, _slstm_r(p))
    h = h.permute(2, 1, 0, 3).reshape(b, s, w)
    h = _groupnorm(p, h.to(x.dtype), n_heads)
    if return_state:
        return h, {k: _unheads(v) for k, v in state.items()}
    return h


def slstm_step(p: Params, state: Params, x: torch.Tensor, n_heads: int
               ) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, W), ``state`` (c, n, h, m) each (B, W) -> (h in x's
    dtype, the new float32 state).  The pre-activations stay unrounded
    float32 products of x's dtype's values: XLA drops the rounding
    between the step's dot and the cell's float32 cast (its excess
    precision, ROADMAP P5), where the scan's rounds."""
    b, _, w = x.shape
    hd = w // n_heads
    pre = x[:, 0].float() @ p["w_in"].to(x.dtype).float()
    z = shardctx.splittable(pre + p["b"].float(), 1, 4).reshape(
        b, 4, n_heads, hd).permute(2, 0, 1, 3).reshape(n_heads, b, 4 * hd)
    heads = {k: shardctx.splittable(v, 1, n_heads).reshape(
        b, n_heads, hd).transpose(0, 1) for k, v in state.items()}
    new = {k: _unheads(v) for k, v in
           _slstm_cell(_slstm_r(p), heads, z).items()}
    return _groupnorm(p, new["h"][:, None, :].to(x.dtype), n_heads), new
