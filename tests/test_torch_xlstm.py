"""The ssm family (xLSTM): the port's mLSTM and sLSTM cells
(``models/recurrent.py``), the ssm branches of ``models/lm.py`` and
``serve.main`` against the JAX package's, on the CPU, on xlstm-smoke (4
blocks: 2 units of one mLSTM and one sLSTM block; d 64, 2 heads, mLSTM
inner width 128, chunk 16).

  * the config and the ParamDef tree as JAX's, ``init_params`` bitwise
    JAX's draw on a leaf of each kind (``b_f``, "ones" at scale 3, drawn
    as 1 by both packages), the parameter count at full width
    (1,844,443,472, the JAX registry's, from the defs);
  * ``F.logsigmoid``, which the cells use, within one float32 ulp of
    ``jax.nn.log_sigmoid`` on |x| up to 120 (94% bitwise, as
    -logaddexp(-x, 0) is; below the smallest normal float32 JAX flushes
    to zero);
  * ``_groupnorm`` within 1e-6 of max |y| in float32 (JAX and the port
    each within 5e-7 of a float64 group norm; seen 8.5e-8) and one
    bfloat16 step (2^-7 of max |y|) in bfloat16 (seen bitwise);
  * the mLSTM cell, its float32 tolerances set from float64 forms in
    numpy on the port's float32 q, k, v and gates (JAX's float32 within
    8.5e-7 of max |h| of the parallel form, 8.8e-7 of the closed-form
    state and 1.2e-6 of the recursion's h): each float32 form within
    F32_CELL = 2e-6 of its float64 form, two of them within 2 F32_CELL;
    ``mlstm_parallel`` chunked (16) against one chunk and against JAX's
    (chunked alike), bfloat16 within one bfloat16 step;
    ``mlstm_final_state`` against JAX's, and against S steps of
    ``mlstm_step`` from the zero state (C, n, m: the closed form and the
    recursion agree to rounding in float64); ``mlstm_step`` token by
    token against JAX's step;
  * ``slstm_scan`` (output and final state) and ``slstm_step`` token by
    token against JAX's and against a float64 loop of the cell in numpy:
    float32 each within 1e-6 of the float64 loop (JAX's seen 2.0e-7), the
    two within 2e-6; bfloat16 within one bfloat16 step (seen bitwise);
  * ``LM.prefill`` of 32 tokens + 20 ``decode_step``s: float32 within
    5e-5 of max |logit|, every state leaf within the same, identical
    greedy tokens, which ``serve.main(--arch xlstm_1_3b --smoke --device
    cpu)`` makes, as the other families' tests hold them; bfloat16
    within 2e-2 (fed JAX's tokens), their allowance; prefill of S tokens
    and one step give prefill of S + 1's state (the closed form against
    the recursion, 2 F32_CELL);
  * ``LM.loss`` in float32 within 1e-5, and ``LM.value_and_grad`` with
    and without remat (each unit rematerialised, each mLSTM block inside
    it again) against ``jax.value_and_grad(loss)`` leaf by leaf,
    float32 within 1e-4 (a float64 control: JAX's float32 gradient
    within 2.0e-5 of max |leaf| of JAX's in float64), bfloat16 within
    1e-1 of each leaf's max and 2e-2 of the whole gradient's L2 norm
    (between sound forms of the sLSTM cell, 6.0e-2 and 1.43e-2, and
    planted faults, from 1.4e-1 and 2.6e-2), remat bitwise the plain
    backward;
  * ``serve.main`` prints JAX ``serve.main``'s line and tokens.

bfloat16 parity needs two of XLA's excess-precision choices (ROADMAP
P5): the sLSTM block's first residual in float32 for its FFN's norm (as
the dense and RG-LRU blocks'), and the decode step's sLSTM
pre-activations unrounded (the bf16 rounding between the dot and the
cell's float32 cast is dropped; rounded, decode's first step is 6e-3
off JAX's, unrounded 0).
"""
import contextlib
import dataclasses
import io
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro.models import lm as JLM
from repro.models import recurrent as JR
from repro.models import registry as j_registry
from repro_torch import random as jr
from repro_torch.launch import serve
from repro_torch.models import lm as TLM
from repro_torch.models import recurrent as TR
from repro_torch.models import registry
from test_torch_mla import (EXACT, _err, _t, both_params,
                            defs_match_and_draw_bitwise, prefill_and_decode,
                            value_and_grad_per_leaf)

ARCH = "xlstm_1_3b"
H, INNER = 2, 128                  # the smoke config's heads, mLSTM width
BF16_STEP = 2.0 ** -7
F32_CELL = 2e-6                    # a float32 mLSTM form vs its float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(exact=False):
    kw = EXACT if exact else {}
    return (dataclasses.replace(j_registry.get_smoke_config(ARCH), **kw),
            dataclasses.replace(registry.get_smoke_config(ARCH), **kw))


def _x(shape, dtype, seed=0, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    jx = jnp.asarray(a.astype(np.float32)).astype(dtype)
    return jx, _t(jx)


def _np64(t):
    return t.double().numpy()


def test_config_and_param_defs_as_jax():
    defs_match_and_draw_bitwise(ARCH, 27, 1_844_443_472)
    for get in ("get_config", "get_smoke_config"):
        assert TLM._xlstm_unit_counts(getattr(registry, get)(ARCH)) == \
            JLM._xlstm_unit_counts(getattr(j_registry, get)(ARCH))
    assert TLM._xlstm_unit_counts(registry.get_config(ARCH)) == (6, 7)


def test_log_sigmoid_matches_jax():
    x = np.concatenate([np.linspace(-120, 120, 20001),
                        np.random.default_rng(0).standard_normal(10000) * 10]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    got = torch.nn.functional.logsigmoid(torch.from_numpy(x)).numpy()
    # XLA flushes the denormal results of x > 87 to zero
    tiny = np.finfo(np.float32).tiny
    assert np.all(np.abs(got - want) <= 2.0 ** -22 * np.abs(want) + tiny)


def _groupnorm64(gn, h, n_heads):
    b, s, w = h.shape
    hh = h.reshape(b, s, n_heads, w // n_heads)
    out = (hh - hh.mean(-1, keepdims=True)) / np.sqrt(
        hh.var(-1, keepdims=True) + 1e-5)
    return out.reshape(b, s, w) * gn


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_groupnorm_matches_jax(dtype):
    jp, tp = both_params(jr.key(6), {"gn": TR.mlstm_defs(INNER, H)["gn"]})
    jp["gn"], tp["gn"] = jp["gn"] * 1.5, tp["gn"] * 1.5
    jx, tx = _x((2, 8, INNER), dtype, scale=3.0)
    jx, tx = jx + 1.0, tx + 1.0                  # a mean that shows
    want = JR._groupnorm(jp, jx, H)
    got = TR._groupnorm(tp, tx, H)
    assert got.dtype == tx.dtype
    if dtype == jnp.float32:
        exact = _groupnorm64(1.5, _np64(tx), H)
        assert _err(want, exact) <= 5e-7 and _err(got, exact) <= 5e-7
        assert _err(got, want) <= 1e-6
    else:
        assert _err(got, want) <= BF16_STEP


def _cell_params(key, defs):
    """Drawn cell parameters with the gate projections and biases made
    non-zero (their init is zero), so that the gates vary."""
    jp, tp = both_params(key, defs)
    rng = np.random.default_rng(7)
    for name in ("w_i", "w_f", "b_i", "b"):
        if name in tp:
            a = (rng.standard_normal(tuple(tp[name].shape)) * 0.1
                 ).astype(np.float32)
            jp[name] = jp[name] + a
            tp[name] = tp[name] + torch.from_numpy(a)
    return jp, tp


def _logsig64(x):
    return np.minimum(x, 0.0) - np.log1p(np.exp(-np.abs(x)))


def _mlstm_parallel64(tp, tx, n_heads):
    """The decay-masked parallel form in float64 numpy on the port's
    float32 q, k, v and gates, then the group norm in float64."""
    q, k, v, i_t, f_t = (_np64(t) for t in TR._mlstm_qkvif(tp, tx))
    b, s, w = tx.shape
    f = np.cumsum(_logsig64(f_t), 1).transpose(0, 2, 1)      # (B, H, S)
    d = (f[..., :, None] - f[..., None, :]
         + i_t.transpose(0, 2, 1)[..., None, :])
    d = np.where(np.tril(np.ones((s, s), bool)), d, -np.inf)
    m = np.maximum(d.max(-1, keepdims=True), 0.0)
    scores = np.einsum("bchk,bshk->bhcs", q, k) / math.sqrt(q.shape[-1]) \
        * np.exp(d - m)
    norm = np.maximum(np.abs(scores.sum(-1, keepdims=True)), np.exp(-m))
    h = np.einsum("bhcs,bshv->bchv", scores / norm, v).reshape(b, s, w)
    return _groupnorm64(_np64(tp["gn"]), h, n_heads)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mlstm_parallel_chunked_and_against_jax(dtype):
    jp, tp = _cell_params(jr.key(7), TR.mlstm_defs(INNER, H))
    jx, tx = _x((2, 64, INNER), dtype)
    want = jax.jit(lambda p, x: JR.mlstm_parallel(p, x, H, chunk=16))(jp, jx)
    got = TR.mlstm_parallel(tp, tx, H, chunk=16)
    whole = TR.mlstm_parallel(tp, tx, H, chunk=512)   # 64 % 512: one chunk
    assert got.dtype == tx.dtype
    if dtype == jnp.float32:
        exact = _mlstm_parallel64(tp, tx, H)
        assert _err(want, exact) <= F32_CELL
        assert _err(got, exact) <= F32_CELL
        assert _err(got, want) <= 2 * F32_CELL
        assert _err(whole, got) <= 2 * F32_CELL
    else:
        assert _err(got, want) <= BF16_STEP and _err(whole, got) <= BF16_STEP


def test_mlstm_final_state_and_step_match_jax_and_each_other():
    jp, tp = _cell_params(jr.key(8), TR.mlstm_defs(INNER, H))
    jx, tx = _x((2, 40, INNER), jnp.float32)
    want = jax.jit(lambda p, x: JR.mlstm_final_state(p, x, H))(jp, jx)
    got = TR.mlstm_final_state(tp, tx, H)
    for name in ("C", "n", "m"):
        assert got[name].dtype == torch.float32
        assert _err(got[name], want[name]) <= 2 * F32_CELL, name
    # S steps of the recursion from the zero state, token by token
    # against JAX's step
    dk, dv = TR.mlstm_dims(INNER, H)
    st = {"C": torch.zeros(2, H, dk, dv), "n": torch.zeros(2, H, dk),
          "m": torch.zeros(2, H)}
    jst = jax.tree.map(lambda t: jnp.asarray(t.numpy()), st)
    step = jax.jit(lambda p, s, x: JR.mlstm_step(p, s, x, H))
    for i in range(40):
        jh, jst = step(jp, jst, jx[:, i:i + 1])
        th, st = TR.mlstm_step(tp, st, tx[:, i:i + 1], H)
        assert _err(th, jh) <= 2 * F32_CELL, i
        for name in ("C", "n", "m"):
            assert _err(st[name], jst[name]) <= 2 * F32_CELL, (i, name)
    for name in ("C", "n", "m"):
        assert _err(st[name], got[name]) <= 2 * F32_CELL, name


def _slstm64(tp, pre, n_heads):
    """The sLSTM cell's time loop in float64 numpy."""
    r, bias = _np64(tp["r"]), _np64(tp["b"])
    b, s, w4 = pre.shape
    w = w4 // 4
    c = n = h = m = np.zeros((b, w))
    hs = []
    for t in range(s):
        rec = np.einsum("bhw,ghwv->gbhv", h.reshape(b, n_heads, -1), r
                        ).reshape(4, b, w)
        it, ft, zt, ot = np.split(pre[:, t] + bias, 4, -1)
        it, ft = it + rec[0], ft + rec[1]
        zt, ot = np.tanh(zt + rec[2]), 1.0 / (1.0 + np.exp(-(ot + rec[3])))
        logf = _logsig64(ft)
        m_new = np.maximum(logf + m, it)
        i_sc, f_sc = np.exp(it - m_new), np.exp(logf + m - m_new)
        c = f_sc * c + i_sc * zt
        n = np.maximum(f_sc * n + i_sc, 1.0)
        h, m = ot * c / n, m_new
        hs.append(h)
    return np.stack(hs, 1), {"c": c, "n": n, "h": h, "m": m}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_slstm_scan_and_step_match_jax(dtype):
    jp, tp = _cell_params(jr.key(9), TR.slstm_defs(64, H))
    jx, tx = _x((2, 48, 64), dtype)
    jh, jst = jax.jit(lambda p, x: JR.slstm_scan(p, x, H, return_state=True)
                      )(jp, jx)
    th, tst = TR.slstm_scan(tp, tx, H, return_state=True)
    assert th.dtype == tx.dtype
    tol = 2e-6 if dtype == jnp.float32 else BF16_STEP
    assert _err(th, jh) <= tol
    if dtype == jnp.float32:
        pre = _np64(tx @ tp["w_in"])
        hs64, st64 = _slstm64(tp, pre, H)
        exact = _groupnorm64(_np64(tp["gn"]), hs64, H)
        assert _err(jh, exact) <= 1e-6 and _err(th, exact) <= 1e-6
    for name in ("c", "n", "h", "m"):
        assert tst[name].dtype == torch.float32
        assert _err(tst[name], jst[name]) <= tol, name
        if dtype == jnp.float32:
            assert _err(tst[name], st64[name]) <= 1e-6, name
    jst = {k: jnp.zeros((2, 64), jnp.float32) for k in ("c", "n", "h", "m")}
    tst = {k: torch.zeros((2, 64)) for k in ("c", "n", "h", "m")}
    step = jax.jit(lambda p, s, x: JR.slstm_step(p, s, x, H))
    for i in range(12):
        jy, jst = step(jp, jst, jx[:, i:i + 1])
        ty, tst = TR.slstm_step(tp, tst, tx[:, i:i + 1], H)
        assert ty.dtype == tx.dtype
        assert _err(ty, jy) <= tol, i
        for name in ("c", "n", "h", "m"):
            assert _err(tst[name], jst[name]) <= tol, (i, name)
        if dtype == jnp.float32:
            assert _err(ty, th[:, i:i + 1]) <= 2e-6, i


@pytest.mark.parametrize("exact", [True, False])
def test_prefill_and_decode(exact):
    """A 32-token prompt and 20 decode steps (float32 tol 5e-5, bfloat16
    2e-2) and, in float32, ``serve.main``'s tokens."""
    tst = prefill_and_decode(ARCH, _cfgs, exact, 32, 20, 53,
                             5e-5 if exact else 2e-2)
    assert set(tst) == {"index", "units"}
    assert tst["units"]["mlstm"]["cell"]["C"].shape == (2, 1, 2, H, 32, 64)
    assert tst["units"]["mlstm"]["cell"]["C"].dtype == torch.float32
    assert tst["units"]["slstm"]["cell"]["h"].shape == (2, 2, 64)


def test_prefill_then_step_is_prefill_of_one_more():
    """The decode state after prefill(S) and one step is prefill(S + 1)'s
    (the recursion against the closed form) within 2 F32_CELL of each
    leaf's max, the logits within 5e-5."""
    _, tc = _cfgs(True)
    lm = registry.build(tc)
    _, tp = both_params(jr.key(0), lm.param_defs())
    tokens = jr.randint(jr.key(1), (2, 33), 0, tc.vocab_size)
    _, st = lm.prefill(tp, {"tokens": tokens[:, :32]})
    log_a, st = lm.decode_step(tp, st, tokens[:, 32:])
    log_b, want = lm.prefill(tp, {"tokens": tokens})
    assert _err(log_a, log_b) <= 5e-5
    from repro_torch.tree import tree_paths
    for (path, g), (_, w) in zip(tree_paths(st), tree_paths(want)):
        assert _err(g, w) <= 2 * F32_CELL, path


@pytest.mark.parametrize("exact", [True, False])
def test_prefill_projects_each_mlstm_block_once(monkeypatch, exact):
    """Prefill computes each mLSTM block's q, k, v, i, f once and hands
    them to ``mlstm_parallel`` and ``mlstm_final_state`` (XLA's CSE
    merges JAX's two): one ``_mlstm_qkvif`` call a block, and the logits
    and every state leaf bitwise those of the two functions computing
    their own projections."""
    _, tc = _cfgs(exact)
    lm = registry.build(tc)
    _, tp = both_params(jr.key(0), lm.param_defs())
    from repro_torch.tree import tree_paths
    tokens = jr.randint(jr.key(1), (2, 32), 0, tc.vocab_size)
    calls = []
    qkvif = TR._mlstm_qkvif

    def counted(p, x):
        calls.append(x.shape)
        return qkvif(p, x)

    monkeypatch.setattr(TR, "_mlstm_qkvif", counted)
    logits, state = lm.prefill(tp, {"tokens": tokens})
    n_mlstm = tc.n_layers - tc.n_layers // tc.recurrent.slstm_every
    assert len(calls) == n_mlstm == 2
    parallel, final = TR.mlstm_parallel, TR.mlstm_final_state

    def own(fn):
        return lambda *a, qkvif=None, **kw: fn(*a, **kw)

    monkeypatch.setattr(TR, "mlstm_parallel", own(parallel))
    monkeypatch.setattr(TR, "mlstm_final_state", own(final))
    calls.clear()
    want_logits, want = lm.prefill(tp, {"tokens": tokens})
    assert len(calls) == 3 * n_mlstm    # the block's, unused, and theirs
    assert torch.equal(logits, want_logits)
    for (path, g), (_, w) in zip(tree_paths(state), tree_paths(want)):
        assert torch.equal(g, w), path


def test_loss_matches_jax():
    jc, tc = _cfgs(True)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp, tp = both_params(jr.key(0), tlm.param_defs())
    tokens = jax.random.randint(jax.random.key(2), (2, 32), 0, jc.vocab_size)
    batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, 1)}
    jl, jm = jax.jit(jlm.loss)(jp, batch)
    tl, tm = tlm.loss(tp, {k: _t(v).long() for k, v in batch.items()})
    assert set(tm) == set(jm) == {"loss", "ce", "acc"}
    for key in ("loss", "ce"):
        assert _err(tm[key], jm[key]) <= 1e-5, key
    assert float(tm["acc"]) == float(jm["acc"])


# float32 tolerance of the gradient, set from a float64 control before the
# port was compared: JAX's own float32 gradient on this config lies within
# 2.0e-5 of max |leaf| of JAX's in float64 (x64, every float32 cast of the
# model code made float64); two float32 implementations may each be that
# far off in opposite directions.  bfloat16, set between what sound forms
# and planted faults read on this batch: the port's sLSTM cell and a
# JAX-literal (B, W) form of it, which associate the cell's float32 sums
# differently and so round h to bfloat16 differently, read 6.0e-2 and
# 2.6e-2 of a leaf's max (both on the mLSTM's two-element b_i, a sum over
# the batch's 128 tokens with cancellation); the unbiased variance in the
# group norm reads 1.4e-1, the sLSTM's h normed in float32 before its
# bfloat16 cast 1.9e-1, the mLSTM cell run in float32 4.5e-1.  The whole
# gradient in relative L2 norm separates them further: both sound forms
# 1.43e-2 (MLA's smoke config 1.47e-2, the hybrid's 1.08e-2), the faults
# 2.6e-2, 6.0e-2 and 9.6e-2.
GRAD_TOL = {True: 1e-4, False: 1e-1}
GRAD_WHOLE_TOL = {True: None, False: 2e-2}


@pytest.mark.parametrize("exact", [True, False])
def test_value_and_grad_per_leaf(exact):
    """The gradient through the units (the mLSTM blocks' projections,
    gates, convolution and group norm; the sLSTM blocks' recurrence and
    FFN) against JAX's, leaf by leaf, with and without remat."""
    paths = value_and_grad_per_leaf(_cfgs, exact, 27, GRAD_TOL[exact],
                                    ("loss", "ce"), GRAD_WHOLE_TOL[exact])
    for leaf in ("wq", "wk", "wv", "w_i", "w_f", "b_i", "b_f", "gn"):
        assert ("units", "mlstm", "cell", leaf) in paths
    for leaf in ("w_in", "r", "b", "gn"):
        assert ("units", "slstm", "cell", leaf) in paths


def test_serve_main_makes_jax_tokens(monkeypatch):
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "16",
            "--tokens", "8", "--override", "compute_dtype=float32",
            "cache_dtype=float32", "reduce_dtype=float32"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_serve.main()
    jax_line, *rows = out.getvalue().splitlines()
    want = np.array([[int(v) for v in r.strip(" []").split()] for r in rows])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = serve.main(argv + ["--device", "cpu"])
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert out.getvalue().splitlines()[0].split(" in ")[0] == \
        jax_line.split(" in ")[0]
