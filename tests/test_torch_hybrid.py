"""The hybrid family (RecurrentGemma / Griffin): the port's
``models/recurrent.py`` (convolution, RG-LRU), the hybrid branches of
``models/lm.py`` and ``serve.main`` against the JAX package's, on the
CPU, on recurrentgemma-smoke (5 layers: one [RG-LRU, RG-LRU, local
attention] group and 2 tail RG-LRU blocks; window 16, one kv head,
softcap 30).

  * the config and the ParamDef tree as JAX's, ``init_params`` bitwise
    JAX's draw on a leaf of each kind, the parameter count at full width
    (9,626,882,048, the JAX registry's);
  * ``causal_conv`` and ``causal_conv_step`` (token by token from a zero
    buffer) within 1e-6 of max |y| in float32, bitwise in bfloat16 (the
    same products and sums, rounded at the same steps);
  * ``rg_lru_scan`` against JAX's ``lax.associative_scan`` within 2e-6
    of max |h| in float32 (both associate the recurrence's products in
    their own order: each within 2e-6 of a float64 loop here) and 2e-2
    in bfloat16; ``linear_scan`` against a float64 loop at S = 1, 7, 100;
    ``rg_lru_step`` token by token against JAX's step (its float32 h
    within 1e-6) and against the scan;
  * the local attention goes to the flash kernel's entry point with head
    dim 16, one kv head, window 16 and softcap 30 (a recording stand-in
    for the kernel, as on the card), once per attention block, never in
    decode or under autograd;
  * ``LM.prefill`` of 32 tokens (a multiple of the window, which the
    ring buffer's alignment needs) + 20 ``decode_step``s, past the
    window so the ring wraps: float32 within 5e-5 of max |logit|, every
    state leaf within the same, identical greedy tokens, which
    ``serve.main(--arch recurrentgemma_9b --smoke --device cpu)`` makes;
    bfloat16 within 2e-2 (fed JAX's tokens), the RG-LRU block's first
    residual kept in float32 for its norm as the dense block's (ROADMAP
    P5: XLA's excess precision there; rounded, 5e-2 off);
  * ``LM.loss`` in float32 within 1e-5;
  * ``LM.value_and_grad`` with and without remat (each group
    rematerialised as one unit) against ``jax.value_and_grad(loss)``
    leaf by leaf, the ``groups`` and ``tail`` leaves included: float32
    within 1e-4, set from a float64 control (JAX's own float32 gradient
    within 1.3e-5 of JAX's in float64), bfloat16 within 3e-2 (the moe
    tests' allowance), remat bitwise the plain backward; 3 AdamW steps of
    ``make_train_step`` against JAX's, as ``test_torch_moe.py`` holds
    them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro.models import recurrent as JR
from repro.models import registry as j_registry
from repro_torch import random as jr
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import params as P
from repro_torch.models import recurrent as TR
from repro_torch.models import registry
from test_torch_mla import (EXACT, _err, _t, both_params,
                            defs_match_and_draw_bitwise, prefill_and_decode,
                            train_step_matches_jax, value_and_grad_per_leaf)

ARCH = "recurrentgemma_9b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(exact=False):
    import dataclasses
    kw = EXACT if exact else {}
    return (dataclasses.replace(j_registry.get_smoke_config(ARCH), **kw),
            dataclasses.replace(registry.get_smoke_config(ARCH), **kw))


def test_config_and_param_defs_as_jax():
    defs_match_and_draw_bitwise(ARCH, 38, 9_626_882_048)


def _x(shape, dtype, seed=0, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    jx = jnp.asarray(a.astype(np.float32)).astype(dtype)
    return jx, _t(jx)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_causal_conv_and_step_match_jax(dtype):
    _, tc = _cfgs()
    jp, tp = both_params(jr.key(4), TR.conv_defs(64, 4))
    jp["conv_b"] = jp["conv_b"] + 0.5            # a bias that shows
    tp["conv_b"] = tp["conv_b"] + 0.5
    jx, tx = _x((2, 24, 64), dtype)
    want = jax.jit(JR.causal_conv)(jp, jx)
    got = TR.causal_conv(tp, tx)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == jnp.float32 else 0.0
    assert _err(got, want) <= tol
    jbuf = jnp.zeros((2, 3, 64), jnp.float32)
    tbuf = torch.zeros((2, 3, 64))
    step = jax.jit(JR.causal_conv_step)
    for i in range(24):
        jy, jbuf = step(jp, jbuf, jx[:, i])
        ty, tbuf = TR.causal_conv_step(tp, tbuf, tx[:, i])
        assert ty.dtype == tx.dtype and tbuf.dtype == torch.float32
        assert _err(ty, jy) <= 1e-6 and _err(tbuf, jbuf) == 0.0
        # the step is the full convolution's column i
        assert _err(ty, got[:, i]) <= (1e-6 if dtype == jnp.float32
                                       else 2.0 ** -7)


def _loop64(a, b):
    h = np.zeros_like(b[:, 0], dtype=np.float64)
    out = np.empty(b.shape, np.float64)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


@pytest.mark.parametrize("s", [1, 7, 100])
def test_linear_scan_is_the_recurrence(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.0, 1.0, (2, s, 8))
    b = rng.standard_normal((2, s, 8))
    got = TR.linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, _loop64(a, b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rg_lru_scan_and_step_match_jax(dtype):
    jp, tp = both_params(jr.key(5), TR.rg_lru_defs(64, 4))
    jx, tx = _x((2, 64, 64), dtype, scale=2.0)
    want = jax.jit(lambda p, x: JR.rg_lru_scan(p, x, 4))(jp, jx)
    got = TR.rg_lru_scan(tp, tx, 4)
    assert got.dtype == tx.dtype
    if dtype == jnp.float32:
        a, gated = TR._lru_coeffs(tp, tx, 4)
        exact = _loop64(a.double().numpy(), gated.double().numpy())
        assert _err(got, want) <= 2e-6
        assert _err(got, exact) <= 2e-6 and _err(want, exact) <= 2e-6
    else:
        assert _err(got, want) <= 2e-2
    jh = jnp.zeros((2, 64), jnp.float32)
    th = torch.zeros((2, 64))
    step = jax.jit(lambda p, h, x: JR.rg_lru_step(p, h, x, 4))
    for i in range(64):
        jy, jh = step(jp, jh, jx[:, i])
        ty, th = TR.rg_lru_step(tp, th, tx[:, i], 4)
        assert ty.dtype == tx.dtype and th.dtype == torch.float32
        assert _err(th, jh) <= 1e-6 and _err(ty, jy) <= 2.0 ** -7
        assert _err(ty, got[:, i]) <= (2e-6 if dtype == jnp.float32
                                       else 2e-2)


def test_local_attention_goes_to_the_flash_kernel(monkeypatch):
    """The dispatch the card takes, with a recording stand-in for the
    kernel: once per attention block in prefill, at head dim 16 with one
    kv head, window 16, softcap 30; never in decode or under autograd."""
    _, tc = _cfgs(True)
    lm = registry.build(tc)
    params = P.init_params(jr.key(0), lm.param_defs())
    calls = []

    def kernel(q, k, v, causal=True, window=0, softcap=0.0):
        calls.append((q.shape[2:], k.shape[2:], v.shape[2:], causal, window,
                      softcap))
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    monkeypatch.setattr(TL, "default_use_kernel", lambda t: True)
    monkeypatch.setattr(TL, "flash_attention", kernel)
    groups, _ = TLM._rg_group_layout(tc)
    tokens = jr.randint(jr.key(1), (2, 32), 0, tc.vocab_size)
    _, state = lm.prefill(params, {"tokens": tokens}, cache_len=40)
    assert calls == [((4, 16), (1, 16), (1, 16), True, 16, 30.0)] * groups
    lm.decode_step(params, state, tokens[:, :1])
    lm.value_and_grad(params, {"tokens": tokens, "labels": tokens})
    assert len(calls) == groups


@pytest.mark.parametrize("exact", [True, False])
def test_prefill_and_decode_past_the_window(exact):
    """A 32-token prompt and 20 decode steps: the 16-slot ring buffer
    wraps (float32 tol 5e-5, bfloat16 2e-2)."""
    tst = prefill_and_decode(ARCH, _cfgs, exact, 32, 20, 53,
                             5e-5 if exact else 2e-2)
    assert set(tst) == {"index", "groups", "tail"}
    assert tst["groups"]["attn"]["k"].shape == (1, 2, 16, 1, 16)
    assert tst["tail"]["h"].dtype == torch.float32


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
    jlog, _ = jax.jit(jlm.forward)(jp, batch)
    tlog, _ = tlm.forward(tp, {"tokens": _t(tokens).long()})
    assert _err(tlog, jlog) <= 5e-5
    assert JLM._rg_group_layout(jc) == TLM._rg_group_layout(tc) == (1, 2)


# float32 tolerance of the gradient, set from a float64 control before the
# port was compared: JAX's own float32 gradient on this config lies within
# 1.3e-5 of max |leaf| of JAX's in float64 (x64, every float32 cast of the
# model code made float64); two float32 implementations may each be that
# far off in opposite directions (the doubling scan and
# ``lax.associative_scan`` associate differently).  bfloat16: the moe
# tests' allowance (``test_torch_moe.py``), 3e-2.
GRAD_TOL = {True: 1e-4, False: 3e-2}


@pytest.mark.parametrize("exact", [True, False])
def test_value_and_grad_per_leaf(exact):
    """The gradient through the groups (two RG-LRU blocks and the local
    attention block, rematerialised as one unit) and the tail against
    JAX's, leaf by leaf, with and without remat."""
    paths = value_and_grad_per_leaf(_cfgs, exact, 38, GRAD_TOL[exact],
                                    ("loss", "ce"))
    for leaf in (("lru", "lam"), ("lru", "w_i"), ("lru", "w_r"),
                 ("conv", "conv_w"), ("w_x",), ("w_y",), ("w_out",)):
        assert ("groups", "rec") + leaf in paths
        assert ("tail",) + leaf in paths
    assert ("groups", "attn", "attn", "wq") in paths


@pytest.mark.parametrize("exact", [True, False])
def test_train_step_matches_jax(exact):
    """3 AdamW steps with remat: float32 losses within 1e-5 and parameters
    within 1e-4, bfloat16 losses within 1e-3 of JAX's loss on the port's
    parameters and parameters within 2 x the rates' sum (the moe tests'
    allowances)."""
    train_step_matches_jax(_cfgs, exact, 1e-5 if exact else 1e-3,
                           (lambda s: 1e-4) if exact else (lambda s: 2 * s))
