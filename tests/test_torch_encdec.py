"""The encdec family (Whisper): ``gqa_apply(cross_kv=)``, the encdec
branches of ``models/lm.py`` and ``serve.main`` against the JAX
package's, on the CPU, on whisper-smoke (2 encoder + 2 decoder layers, d
64, 4 heads of 16, 32 audio frames, layernorm, GELU, learned positions).

  * the config and the ParamDef tree (``enc_pos``, ``enc_layers``,
    ``enc_norm``, ``dec_layers`` beside the learned ``pos_embed``) leaf
    for leaf as JAX's, the parameter count at full width (264,378,624,
    the JAX registry's), and ``init_params`` of the whole smoke tree
    bitwise JAX's;
  * ``gqa_apply`` with ``cross_kv``: 16 queries and one decode query
    against 32 encoder keys, no new kv, within 1e-6 of max |y| in
    float32 and one bfloat16 step (2^-7) in bfloat16;
  * the attention dispatch the card takes, through a recording stand-in
    for the flash kernel: a prefill calls it once per encoder layer
    (causal, S = T), and twice per decoder layer (causal self attention;
    non-causal cross attention, 16 queries against 32 keys); a decode
    step once per decoder layer (the cross attention, 1 query against 32
    keys);
  * ``LM.prefill`` + 8 ``decode_step``s with random numpy audio and with
    the launcher's zeros: float32 logits within 2e-4 of max |logit| and
    every state leaf (self cache, ``cross`` k, v) within 5e-5, set from a
    float64 control (the port run in float64: on random audio JAX's
    float32 logits sit up to 3.2e-5 of max |logit| from it and the port's
    up to 9.7e-5, the two packages up to 7.4e-5 apart; the state leaves
    each within 1.1e-5), identical greedy tokens; bfloat16 within 2e-2
    (fed JAX's tokens; seen up to 1.8e-2 on three seeds);
  * the encoder is causal, as JAX's (``src/repro/models/lm.py:434-437``
    call ``gqa_apply`` without ``causal=``, whose default is True): a
    change to audio frame 20 leaves the ``cross`` k, v of frames 0-19
    bitwise unchanged in both packages, and changes frame 20's;
  * bfloat16 parity (ROADMAP P5): the decoder block keeps both its
    self-attention and its cross-attention residual sums in float32 for
    the next norm, as XLA does across its fusions; on the test's weights
    and audio the bf16 prefill logits are then bitwise JAX's, and a
    planted fault, the two sums rounded to bfloat16, is 4.5e-2 off;
  * ``serve.main(--arch whisper_small --smoke --device cpu)`` prints JAX
    ``serve.main``'s line and tokens at the same flags (float32 dtypes).
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro.models import layers as JL
from repro.models import registry as j_registry
from repro.models.params import init_params as j_init_params
from repro_torch import random as jr
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.tree import tree_paths
from test_torch_mla import (EXACT, _err, _np, _t, both_params,
                            defs_match_and_draw_bitwise)

ARCH = "whisper_small"
BF16_STEP = 2.0 ** -7
# float32 tolerances from the float64 control (module docstring)
F32_LOGITS, F32_STATE = 2e-4, 5e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, exact=False):
    kw = EXACT if exact else {}
    return (dataclasses.replace(j_registry.get_smoke_config(arch), **kw),
            dataclasses.replace(registry.get_smoke_config(arch), **kw))


def frontend(cfg, batch, zeros=False, seed=0):
    """The frontend's input of ``cfg``'s family as float32 numpy:
    ``audio_embeds`` (encdec) or ``pixel_embeds`` (vlm), unit normals from
    ``seed`` or the launcher's zeros."""
    name, n = (("audio_embeds", cfg.encoder_seq_len)
               if cfg.family == "encdec" else
               ("pixel_embeds", cfg.n_image_tokens))
    shape = (batch, n, cfg.d_model)
    a = (np.zeros(shape) if zeros else
         np.random.default_rng(seed).standard_normal(shape))
    return {name: a.astype(np.float32)}


def _batches(tokens, extra):
    return ({"tokens": jnp.asarray(tokens.numpy()),
             **{k: jnp.asarray(v) for k, v in extra.items()}},
            {"tokens": tokens,
             **{k: torch.from_numpy(v) for k, v in extra.items()}})


def prefill_and_decode(arch, exact, extra, tol_logits, tol_state,
                       prompt=16, steps=8, params=None):
    """``LM.prefill`` on the prompt and the frontend input ``extra`` (a
    numpy dict), then ``steps`` greedy ``decode_step``s on JAX's tokens,
    the port's drawn weights (``init_params(key(0))``, the serving
    launcher's) given to both unless ``params`` = (JAX tree, port tree):
    logits within ``tol_logits`` of max |logit|, every state leaf within
    ``tol_state`` of its max, and in float32 the same greedy tokens.
    Returns (the port's final state, the greedy tokens).  Shared with
    ``test_torch_vlm.py``."""
    jc, tc = _cfgs(arch, exact)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp, tp = params or both_params(jr.key(0), tlm.param_defs())
    tokens = jr.randint(jr.key(1), (2, prompt), 0, tc.vocab_size)
    cache_len = prompt + steps + 1 + tc.n_image_tokens
    jb, tb = _batches(tokens, extra)
    jlog, jst = jax.jit(lambda p, b: jlm.prefill(p, b, cache_len=cache_len))(
        jp, jb)
    tlog, tst = tlm.prefill(tp, tb, cache_len=cache_len)
    decode = jax.jit(jlm.decode_step)
    greedy = []
    for step in range(steps + 1):
        assert _err(tlog, jlog) <= tol_logits, step
        want = jax.tree_util.tree_leaves_with_path(jst)
        assert [tuple(k.key for k in path) for path, _ in want] == \
            [path for path, _ in tree_paths(tst)]
        for (path, w), (_, g) in zip(want, tree_paths(tst)):
            assert g.shape == w.shape and g.dtype == _t(w).dtype, path
            assert _err(g, w) <= tol_state, (step, path)
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None]
        greedy.append(np.asarray(jtok))
        if exact:
            np.testing.assert_array_equal(
                torch.argmax(tlog[:, -1], -1)[:, None].numpy(), greedy[-1])
        if step == steps:
            break
        jlog, jst = decode(jp, jst, jtok)
        tlog, tst = tlm.decode_step(tp, tst, _t(jtok).long())
    assert int(tst["index"]) == int(jst["index"]) == \
        prompt + tc.n_image_tokens + steps
    return tst, np.concatenate(greedy, 1)


def serve_main_makes_jax_tokens(arch, monkeypatch):
    """``serve.main`` on the CPU prints JAX ``serve.main``'s line and
    tokens at the same flags (the smoke config, float32 dtypes: the
    launchers feed their own zero frontend stubs).  Shared with
    ``test_torch_vlm.py``."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "16",
            "--tokens", "8", "--override",
            *(f"{k}={v}" for k, v in EXACT.items())]
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


def init_params_bitwise(arch, dtype=None):
    """``init_params`` of the whole smoke tree bitwise JAX's, leaf for
    leaf, optionally at ``dtype`` (JAX draws each normal in float32 and
    rounds it).  Shared with ``test_torch_vlm.py``."""
    jdefs = j_registry.build(j_registry.get_smoke_config(arch)).param_defs()
    tdefs = registry.build(registry.get_smoke_config(arch)).param_defs()
    want = j_init_params(jax.random.key(0), jdefs,
                         dtype=None if dtype is None else jnp.bfloat16)
    got = P.init_params(jr.key(0), tdefs, dtype=dtype)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert len(wl) == len(tree_paths(got))
    for (path, w), (tpath, g) in zip(wl, tree_paths(got)):
        assert tuple(k.key for k in path) == tpath
        assert str(g.dtype)[6:] == str(w.dtype), tpath
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(w.astype(jnp.float32)),
            err_msg=str(tpath))


def test_config_and_param_defs_as_jax():
    defs_match_and_draw_bitwise(ARCH, 26, 264_378_624)
    tdefs = registry.build(registry.get_smoke_config(ARCH)).param_defs()
    assert set(tdefs) == {"embed", "pos_embed", "final_norm", "enc_pos",
                          "enc_layers", "enc_norm", "dec_layers"}


def test_init_params_bitwise():
    init_params_bitwise(ARCH)


@pytest.mark.parametrize("exact", [True, False])
def test_gqa_cross_kv_matches_jax(exact):
    jc, tc = _cfgs(ARCH, exact)
    jp, tp = both_params(jr.key(3), TL.gqa_defs(tc))
    dt = jnp.float32 if exact else jnp.bfloat16
    rng = np.random.default_rng(0)
    x, k, v = (jnp.asarray(rng.standard_normal(s).astype(np.float32)
                           ).astype(dt)
               for s in ((2, 16, 64), (2, 32, 4, 16), (2, 32, 4, 16)))
    for xs in (x, x[:, -1:]):
        jy, jkv = jax.jit(lambda p, a, b, c: JL.gqa_apply(
            p, jc, a, positions=jnp.arange(a.shape[1]), cross_kv=(b, c),
            causal=False, return_kv=True))(jp, xs, k, v)
        ty, tkv = TL.gqa_apply(tp, tc, _t(xs),
                               positions=torch.arange(xs.shape[1]),
                               cross_kv=(_t(k), _t(v)), causal=False,
                               return_kv=True)
        assert jkv is None and tkv is None
        assert ty.dtype == _t(xs).dtype
        assert _err(ty, jy) <= (1e-6 if exact else BF16_STEP)


def test_attention_dispatch_on_the_card(monkeypatch):
    """The dispatch the card takes, with a recording stand-in for the
    kernel: (S, T, causal) per call."""
    _, tc = _cfgs(ARCH, True)
    lm = registry.build(tc)
    params = P.init_params(jr.key(0), lm.param_defs())
    calls = []

    def kernel(q, k, v, causal=True, window=0, softcap=0.0):
        calls.append((q.shape[1], k.shape[1], causal))
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    monkeypatch.setattr(TL, "default_use_kernel", lambda t: True)
    monkeypatch.setattr(TL, "flash_attention", kernel)
    tokens = jr.randint(jr.key(1), (2, 16), 0, tc.vocab_size)
    extra = {k: torch.from_numpy(v)
             for k, v in frontend(tc, 2, zeros=True).items()}
    t = tc.encoder_seq_len
    _, state = lm.prefill(params, {"tokens": tokens, **extra}, cache_len=20)
    assert calls == [(t, t, True)] * tc.n_encoder_layers + \
        [(16, 16, True), (16, t, False)] * tc.n_layers
    del calls[:]
    lm.decode_step(params, state, tokens[:, :1])
    assert calls == [(1, t, False)] * tc.n_layers


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("zeros", [False, True], ids=["audio", "zeros"])
def test_prefill_and_decode(exact, zeros):
    """8 decode steps on random audio and on the launcher's zeros (float32
    2e-4 / 5e-5 with identical tokens, bfloat16 2e-2)."""
    _, tc = _cfgs(ARCH)
    tol = (F32_LOGITS, F32_STATE) if exact else (BF16_TOL, BF16_TOL)
    tst, _ = prefill_and_decode(ARCH, exact, frontend(tc, 2, zeros), *tol)
    assert set(tst) == {"index", "cache", "cross"}
    assert set(tst["cross"]) == {"k", "v"}
    assert tst["cross"]["k"].shape == (tc.n_layers, 2, tc.encoder_seq_len,
                                       tc.n_kv_heads, tc.resolved_head_dim)


def test_encoder_is_causal_as_jax():
    jc, tc = _cfgs(ARCH, True)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp, tp = both_params(jr.key(0), tlm.param_defs())
    tokens = jr.randint(jr.key(1), (2, 8), 0, tc.vocab_size)
    audio = frontend(tc, 2)
    later = {"audio_embeds": audio["audio_embeds"].copy()}
    later["audio_embeds"][:, 20] += 1.0
    prefill = jax.jit(lambda p, b: jlm.prefill(p, b))
    for run in (lambda b: prefill(jp, b[0])[1]["cross"],
                lambda b: tlm.prefill(tp, b[1])[1]["cross"]):
        a = run(_batches(tokens, audio))
        b = run(_batches(tokens, later))
        for name in ("k", "v"):
            x, y = _np(a[name]), _np(b[name])
            np.testing.assert_array_equal(x[:, :, :20], y[:, :, :20])
            assert not np.array_equal(x[:, :, 20], y[:, :, 20])


def _rounded_dec_block(p, cfg, x, enc_kv, positions, cache=None,
                       cache_index=None, return_kv=False):
    """A planted fault: the decoder block with its residual sums rounded
    to x's dtype before each norm."""
    h = TL.apply_norm(p["self_norm"], cfg, x, "scale")
    a, new_cache = TL.gqa_apply(p["self_attn"], cfg, h, positions=positions,
                                cache=cache, cache_index=cache_index,
                                return_kv=return_kv)
    x = x + a
    h = TL.apply_norm(p["cross_norm"], cfg, x, "scale")
    a, _ = TL.gqa_apply(p["cross_attn"], cfg, h, positions=positions,
                        cross_kv=enc_kv, causal=False)
    x = x + a
    h = TL.apply_norm(p["mlp_norm"], cfg, x, "scale")
    return x + TL.mlp_apply(p["mlp"], cfg, h), new_cache


def test_decoder_residuals_kept_in_float32(monkeypatch):
    """bf16 prefill logits bitwise JAX's on these weights and audio; the
    planted fault (the sums rounded) more than 2e-2 off."""
    jc, tc = _cfgs(ARCH)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp, tp = both_params(jr.key(0), tlm.param_defs())
    tokens = jr.randint(jr.key(10), (2, 16), 0, tc.vocab_size)
    jb, tb = _batches(tokens, frontend(tc, 2))
    want = jax.jit(lambda p, b: jlm.prefill(p, b, cache_len=20))(jp, jb)[0]
    got = tlm.prefill(tp, tb, cache_len=20)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    monkeypatch.setattr(TLM, "_dec_block", _rounded_dec_block)
    assert _err(tlm.prefill(tp, tb, cache_len=20)[0], want) > BF16_TOL


def test_serve_main_makes_jax_tokens(monkeypatch):
    serve_main_makes_jax_tokens(ARCH, monkeypatch)
