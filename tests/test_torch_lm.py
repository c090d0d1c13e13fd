"""The dense LM serving slice: the port's ``models/`` and
``launch/serve.py`` against the JAX package's, on the CPU, from the same
seeds and numpy inputs.

  * ``random.randint`` bitwise ``jax.random.randint``;
  * ``init_params`` bitwise on the four dense smoke configs (leaf order,
    fold-in, the float32 std multiply), and a draw made in slices
    bitwise the whole draw;
  * ``apply_norm`` (rmsnorm, layernorm, nonparametric), ``apply_rope``,
    ``mlp_apply`` (swiglu, geglu, relu2, gelu) and ``gqa_apply``
    (prefill, decode, a ring buffer at window 16, ``kv_replicate_to``)
    against JAX's jitted functions, at float32 and bfloat16;
  * ``LM.prefill`` + 8 ``decode_step``s on the four smoke configs from
    weights converted with ``convert.lm_params_from_arrays``, through
    both packages' ``launch/steps.py`` ``make_prefill_step`` and
    ``make_decode_step``;
  * ``LM.prefill`` + 2 ``decode_step``s of the olmo smoke config with
    ``logit_softcap=30`` (the attention scores capped as tanh(s / c) c);
  * ``serve.main(--smoke --device cpu)`` makes JAX ``serve.main``'s
    tokens.

Tolerances.  float32: within 1e-5 of max |out| for the layers and for
the logits, and identical greedy tokens (the same formulas; XLA and
PyTorch differ in reduction order, FMA contraction and their exp, sin
and cos by ulps: seen up to 5e-6).  bfloat16: within 2e-2 of max |out|,
the decode fed JAX's tokens (a greedy flip on bf16-rounded logits would
send the two runs down different prompts).  Seen at bfloat16 (prefill +
8 decode steps): the logits of olmo bitwise, nemotron within 3e-7, phi3
1.5e-2 and mistral 1.3e-2 of max |logit|, where the norms' float32
statistics round in another order than XLA's and a row's scale moves an
ulp.  The rest needs the port to round where compiled XLA rounds
(``jax.nn``'s activations op by op, the first residual sum kept in
float32 for the second norm).
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
from repro.launch import steps as j_steps
from repro.models import layers as JL
from repro.models import registry as j_registry
from repro.models.params import init_params as j_init_params
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.launch import serve, steps
from repro_torch.models import layers as TL
from repro_torch.models import params as P
from repro_torch.models import registry

ARCHS = ("olmo_1b", "phi3_medium_14b", "nemotron_4_15b",
         "mistral_large_123b")
EXACT = dict(compute_dtype="float32", cache_dtype="float32",
             reduce_dtype="float32")


def _cfgs(arch, exact=False, **kw):
    jc, tc = j_registry.get_smoke_config(arch), registry.get_smoke_config(arch)
    kw = dict(EXACT, **kw) if exact else kw
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _t(a):
    """A JAX or numpy array as a torch tensor of the same dtype."""
    return convert.lm_params_from_arrays({"a": np.asarray(a)}, "cpu")["a"]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _tol(exact):
    return 1e-5 if exact else 2e-2


def _x(shape, dtype, seed=0, scale=1.0):
    a = scale * np.random.default_rng(seed).standard_normal(shape)
    j = jnp.asarray(a.astype(np.float32)).astype(dtype)
    return j, _t(j)


# -- random and parameters -----------------------------------------------


@pytest.mark.parametrize("seed,shape,lo,hi", [
    (1, (2, 16), 0, 256), (1, (4, 2048), 0, 50304), (7, (3, 5), -5, 100),
    (3, (10,), 0, 2 ** 31 - 1), (3, (4,), 5, 5), (2, (50,), 0, 70000)])
def test_randint_bitwise(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi))
    got = jr.randint(jr.key(seed), shape, lo, hi).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_bitwise(arch):
    jc, tc = _cfgs(arch)
    want = j_init_params(jax.random.key(0), j_registry.build(jc).param_defs())
    got = P.init_params(jr.key(0), registry.build(tc).param_defs())
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(P._leaves_sorted(registry.build(tc)
                                               .param_defs()))
    for path, leaf in leaves:
        t = got
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    assert registry.param_count(tc) == j_registry.param_count(jc)


def test_sliced_draw_is_the_whole_draw(monkeypatch):
    key = jr.fold_in(jr.key(0), 6)
    whole = P._normal(key, (3, 50, 7))
    monkeypatch.setattr(P, "SLICE", 64)
    np.testing.assert_array_equal(P._normal(key, (3, 50, 7)).numpy(),
                                  whole.numpy())


# -- layers ---------------------------------------------------------------


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm",
                                  "nonparametric_ln"])
def test_apply_norm(norm, exact):
    jc, tc = _cfgs("phi3_medium_14b", exact, norm=norm)
    dt = jnp.float32 if exact else jnp.bfloat16
    jx, tx = _x((2, 16, 64), dt, scale=0.02)
    scale = jnp.asarray(1 + 0.1 * np.random.default_rng(1).standard_normal(
        64).astype(np.float32))
    jp = {} if norm == "nonparametric_ln" else {"scale": scale}
    want = jax.jit(lambda x, p: JL.apply_norm(p, jc, x, "scale"))(jx, jp)
    got = TL.apply_norm({k: _t(v) for k, v in jp.items()}, tc, tx, "scale")
    assert got.dtype == tx.dtype
    _close(got, want, _tol(exact))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    jx, tx = _x((2, 40, 4, 16), getattr(jnp, dtype))
    pos = np.arange(40) + 1000
    want = jax.jit(lambda x: JL.apply_rope(x, jnp.asarray(pos), 1e4))(jx)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 1e4)
    _close(got, want, _tol(dtype == "float32"))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_apply(act, exact):
    jc, tc = _cfgs("nemotron_4_15b", exact, activation=act)
    jp = j_init_params(jax.random.key(3), JL.mlp_defs(jc))
    jx, tx = _x((2, 16, 64), jnp.float32 if exact else jnp.bfloat16)
    want = jax.jit(lambda p, x: JL.mlp_apply(p, jc, x))(jp, jx)
    got = TL.mlp_apply(convert.lm_params_from_arrays(jp, "cpu"), tc, tx)
    _close(got, want, _tol(exact))


def _gqa(arch, exact, **kw):
    jc, tc = _cfgs(arch, exact, **kw)
    jp = j_init_params(jax.random.key(5), JL.gqa_defs(jc))
    return jc, tc, jp, convert.lm_params_from_arrays(jp, "cpu")


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("arch,kw", [
    ("olmo_1b", {}), ("phi3_medium_14b", {}), ("mistral_large_123b", {}),
    ("phi3_medium_14b", {"kv_replicate_to": 4}),
    ("olmo_1b", {"window_size": 8})])
def test_gqa_prefill(arch, kw, exact):
    jc, tc, jp, tp = _gqa(arch, exact, **kw)
    jx, tx = _x((2, 24, 64), jnp.float32 if exact else jnp.bfloat16)
    fn = jax.jit(lambda p, x: JL.gqa_apply(p, jc, x,
                                           positions=jnp.arange(24),
                                           return_kv=True))
    want, wkv = fn(jp, jx)
    got, gkv = TL.gqa_apply(tp, tc, tx, positions=torch.arange(24),
                            return_kv=True)
    _close(got, want, _tol(exact))
    for name in ("k", "v"):
        _close(gkv[name], wkv[name], _tol(exact))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("arch,kw,cache_len,steps", [
    ("phi3_medium_14b", {}, 32, 8),
    ("olmo_1b", {"window_size": 16}, 16, 24),          # ring buffer
    ("mistral_large_123b", {"kv_replicate_to": 8}, 32, 8)])
def test_gqa_decode(arch, kw, cache_len, steps, exact):
    """Token by token from an empty cache: each step's output and the
    whole cache after it (the port writes its cache in place)."""
    jc, tc, jp, tp = _gqa(arch, exact, **kw)
    g = jc.kv_replicate_to or jc.n_kv_heads
    cd = jnp.dtype(jc.cache_dtype)
    jcache = {n: jnp.zeros((2, cache_len, g, jc.resolved_head_dim), cd)
              for n in ("k", "v")}
    tcache = convert.lm_state_from_arrays(jcache, "cpu")
    fn = jax.jit(lambda p, x, c, i: JL.gqa_apply(
        p, jc, x, positions=i[None], cache=c, cache_index=i))
    for i in range(steps):
        jx, tx = _x((2, 1, 64), jnp.float32 if exact else jnp.bfloat16,
                    seed=i)
        want, jcache = fn(jp, jx, jcache, jnp.asarray(i, jnp.int32))
        idx = torch.tensor(i, dtype=torch.int32)
        got, tcache = TL.gqa_apply(tp, tc, tx, positions=idx.reshape(1),
                                   cache=tcache, cache_index=idx)
        _close(got, want, _tol(exact))
        for name in ("k", "v"):
            _close(tcache[name], jcache[name], _tol(exact))


# -- the model ------------------------------------------------------------


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(arch, exact):
    jc, tc = _cfgs(arch, exact)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp = j_init_params(jax.random.key(0), jlm.param_defs())
    tp = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    tokens = jax.random.randint(jax.random.key(1), (2, 16), 0, jc.vocab_size)
    # through both packages' serving steps, which wrap prefill and decode
    prefill = jax.jit(j_steps.make_prefill_step(jlm, cache_len=24))
    decode = jax.jit(j_steps.make_decode_step(jlm))
    tprefill = steps.make_prefill_step(tlm, cache_len=24)
    tdecode = steps.make_decode_step(tlm)
    jlog, jst = prefill(jp, {"tokens": tokens})
    tlog, tst = tprefill(tp, {"tokens": _t(tokens).long()})
    assert tst["index"].dtype == torch.int32 and int(tst["index"]) == 16
    for name in ("k", "v"):
        assert tst["cache"][name].dtype == _t(jst["cache"][name]).dtype
        _close(tst["cache"][name], jst["cache"][name], _tol(exact))
    for step in range(9):
        _close(tlog, jlog, _tol(exact))
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None]
        ttok = torch.argmax(tlog[:, -1], -1)[:, None]
        if exact:
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        if step == 8:
            break
        jlog, jst = decode(jp, jst, jtok)
        tlog, tst = tdecode(tp, tst, _t(jtok).long())
    assert int(tst["index"]) == int(jst["index"]) == 24


@pytest.mark.parametrize("exact", [True, False])
def test_prefill_and_decode_with_softcap(exact):
    jc, tc = _cfgs("olmo_1b", exact, logit_softcap=30.0)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp = j_init_params(jax.random.key(0), jlm.param_defs())
    tp = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    tokens = jax.random.randint(jax.random.key(1), (2, 16), 0, jc.vocab_size)
    jlog, jst = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t},
                                                 cache_len=24))(jp, tokens)
    ttok = _t(tokens).long()
    tlog, tst = tlm.prefill(tp, {"tokens": ttok}, cache_len=24)
    uncapped, _ = registry.build(dataclasses.replace(tc, logit_softcap=0.0)
                                 ).prefill(tp, {"tokens": ttok}, cache_len=24)
    assert float((uncapped - tlog).abs().max()) > _tol(exact) * float(
        tlog.abs().max())                      # the cap moves the logits
    decode = jax.jit(jlm.decode_step)
    for step in range(3):
        _close(tlog, jlog, _tol(exact))
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None]
        if exact:
            np.testing.assert_array_equal(
                torch.argmax(tlog[:, -1], -1)[:, None].numpy(),
                np.asarray(jtok))
        if step == 2:
            break
        jlog, jst = decode(jp, jst, jtok)
        tlog, tst = tlm.decode_step(tp, tst, _t(jtok).long())


def test_serve_main_makes_jax_tokens(monkeypatch):
    argv = ["--arch", "olmo_1b", "--smoke", "--batch", "2", "--prompt-len",
            "16", "--tokens", "8", "--override", "compute_dtype=float32",
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
    line = out.getvalue().splitlines()[0]
    assert got.shape == (2, 8) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert line.split(" in ")[0] == jax_line.split(" in ")[0]


def test_serve_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "olmo_1b", "--smoke"])


def test_other_families_raise():
    """Nothing still to port raises: every architecture of the JAX
    registry is registered and builds its parameter tree, and the encdec
    and vlm families' ``forward`` and ``loss`` run
    (``test_torch_train_encdec_vlm.py`` holds their training against
    JAX's).  A batch without its frontend input fails or runs as JAX's
    does: an encdec batch raises ``KeyError`` on ``audio_embeds`` in both
    packages; a vlm batch runs the text alone, its logits and loss
    within 1e-5 of JAX's on the same batch (float32)."""
    from repro_torch.models.lm import LM
    from repro_torch.tree import tree_map
    assert set(registry.ARCH_IDS) == set(j_registry.ARCH_IDS)
    for arch in ("whisper_small", "internvl2_26b"):
        jc, tc = _cfgs(arch, exact=True)
        lm, jlm = LM(tc), j_registry.build(jc)
        params = P.init_params(jr.key(0), lm.param_defs())
        jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), params))
        tokens = jr.randint(jr.key(1), (2, 8), 0, tc.vocab_size)
        batch = {"tokens": tokens, "labels": tokens}
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        if tc.family == "encdec":
            for call, jcall in ((lm.forward, jlm.forward),
                                (lm.loss, jlm.loss)):
                with pytest.raises(KeyError, match="audio_embeds"):
                    call(params, batch)
                with pytest.raises(KeyError, match="audio_embeds"):
                    jcall(jp, jbatch)
            continue
        logits, _ = lm.forward(params, batch)
        assert logits.shape == (2, 8, tc.vocab_size)
        _close(logits, jax.jit(jlm.forward)(jp, jbatch)[0], 1e-5)
        loss, _ = lm.loss(params, batch)
        _close(loss, jax.jit(jlm.loss)(jp, jbatch)[0], 1e-5)
    for arch in ("deepseek_v2_lite_16b", "recurrentgemma_9b", "xlstm_1_3b"):
        assert arch in registry.ARCH_IDS
        LM(registry.get_smoke_config(arch)).param_defs()
