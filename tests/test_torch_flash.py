"""The flash attention kernel's plain version and the port's plain
attention cores against the JAX package's, on the CPU, from the same
numpy inputs.

  * ``kernels/flash_attention/ref.attention`` (the kernel's plain
    version, model layout, GQA folded in) against the JAX Pallas kernel
    in interpret mode through its ``ops.flash_attention``, on
    ``tests/test_kernels.py``'s ``FA_CASES`` (blocks of 64) and on ragged
    S = 100 (one block of 100) with and without a window;
  * the port's ``full_attention`` and ``chunked_attention(chunk=64)``
    against JAX's, GQA 1, 2 and 4 query heads per kv head;
  * the softcap (``tanh(s / c) c``, c = 30, scores scaled up so the cap
    bites): the plain version and the port's attention cores against
    JAX's ``full_attention`` and ``chunked_attention``;
  * ``flash_attention`` on CPU tensors is the plain version (softcap
    included) and launches nothing;
  * q/k and v head dims apart (Dqk, Dv) = (24, 16) and (192, 128), MLA's
    prefill: the plain version and ``chunked_attention`` at v's own width
    against JAX's ``full_attention`` / ``chunked_attention`` on v padded
    to Dqk and the output sliced (what ``repro/models/mla.py`` does), and
    D = 256 with one kv head, a window and the softcap (RecurrentGemma's
    local attention), within 1e-6 (1e-5 with the softcap, as below);
  * the bf16 kernel's P V arithmetic, emulated: P rounded once to bf16
    spends several times the per-element allowance of phase 19 of
    ``chip_smoke.py`` on short rows, P split as P_hi + P_lo (both bf16)
    stays within it.

Tolerance: ``test_kernels.py``'s own, max |diff| < 5e-5 in float32 and
2e-2 in bfloat16 (the kernel's online softmax and the plain softmax sum
in another order); the plain cores within 1e-6 (one formula, PyTorch's
and XLA's reductions), 1e-5 with the softcap (scores near 30, where an
ulp of tanh's argument or result is 2e-6 and the near one-hot softmax
passes it on).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa_ops
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers as TL

# (b, s, h, g, d, causal, window, dtype, block): test_kernels.py's
# FA_CASES at blocks of 64, then ragged S = 100 (block = S)
CASES = [
    (2, 128, 4, 2, 64, True, 0, "float32", 64),
    (1, 256, 4, 4, 32, True, 64, "float32", 64),
    (2, 128, 8, 2, 128, False, 0, "float32", 64),
    (1, 128, 4, 1, 64, True, 0, "float32", 64),       # MQA
    (1, 256, 2, 2, 80, True, 0, "float32", 64),       # D not a lane multiple
    (2, 128, 4, 2, 64, True, 0, "bfloat16", 64),
    (2, 100, 4, 2, 16, True, 0, "float32", 128),      # ragged S
    (1, 100, 8, 2, 32, True, 24, "float32", 128),
    (1, 100, 4, 1, 64, False, 0, "bfloat16", 128),
]


def _inputs(b, s, h, g, d, dtype, seed=0, t=None):
    rng = np.random.default_rng(seed)
    t = t or s
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, g, d)).astype(np.float32)
    v = rng.standard_normal((b, t, g, d)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    j = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    # bf16 through float32 on both sides: the same rounded values
    tt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in j]
    return j, tt


@pytest.mark.parametrize("b,s,h,g,d,causal,window,dtype,block", CASES)
def test_plain_version_matches_pallas_kernel(b, s, h, g, d, causal, window,
                                             dtype, block):
    (jq, jk, jv), (q, k, v) = _inputs(b, s, h, g, d, dtype, seed=s + h + d)
    want = j_fa_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    block_q=block, block_k=block,
                                    interpret=True)
    got = fa_ref.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 5e-5 if dtype == "float32" else 2e-2
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert float(diff.max()) < tol


@pytest.mark.parametrize("h,g", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_plain_cores_match_jax(h, g, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(2, 128, h, g, 16, "float32", seed=h)
    want = np.asarray(JL.full_attention(jq, jk, jv, causal=causal,
                                        window=window))
    full = TL.full_attention(q, k, v, causal=causal, window=window).numpy()
    chunked = TL.chunked_attention(q, k, v, causal=causal, window=window,
                                   chunk=64).numpy()
    jchunked = np.asarray(JL.chunked_attention(jq, jk, jv, causal=causal,
                                               window=window, chunk=64))
    plain = fa_ref.attention(q, k, v, causal=causal, window=window).numpy()
    np.testing.assert_allclose(full, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(chunked, jchunked, rtol=0, atol=1e-6)
    np.testing.assert_allclose(plain, full, rtol=0, atol=1e-6)


def test_flash_attention_on_cpu_is_the_plain_version():
    _, (q, k, v) = _inputs(1, 100, 4, 2, 16, "bfloat16")
    before = fa_ops.LIBRARY.launches
    got = fa_ops.flash_attention(q, k, v, causal=True, window=16)
    assert torch.equal(got, fa_ref.attention(q, k, v, causal=True,
                                             window=16))
    assert fa_ops.LIBRARY.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    _, (q, k, v) = _inputs(1, 16, 2, 2, 8, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_kernel(q, k, v)


@pytest.mark.parametrize("h,g", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_softcap_matches_jax(h, g, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(2, 128, h, g, 16, "float32", seed=h)
    jq, q = 20 * jq, 20 * q                   # scores up to ~100: capped
    kw = dict(causal=causal, window=window, softcap=30.0)
    want = np.asarray(JL.full_attention(jq, jk, jv, **kw))
    jchunked = np.asarray(JL.chunked_attention(jq, jk, jv, chunk=64, **kw))
    plain = fa_ref.attention(q, k, v, **kw)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(TL.full_attention(q, k, v, **kw).numpy(),
                               want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        TL.chunked_attention(q, k, v, chunk=64, **kw).numpy(), jchunked,
        rtol=0, atol=1e-5)
    # the cap moves the output: it is exercised
    uncapped = fa_ref.attention(q, k, v, causal=causal, window=window)
    assert float((uncapped - plain).abs().max()) > 1e-2


def test_flash_attention_on_cpu_passes_the_softcap():
    _, (q, k, v) = _inputs(1, 100, 4, 2, 16, "bfloat16")
    q = 20 * q
    before = fa_ops.LIBRARY.launches
    got = fa_ops.flash_attention(q, k, v, causal=True, window=16,
                                 softcap=30.0)
    assert torch.equal(got, fa_ref.attention(q, k, v, causal=True,
                                             window=16, softcap=30.0))
    assert fa_ops.LIBRARY.launches == before


def _pv(q, k, v, causal, split):
    """The bf16 kernel's output arithmetic, whole rows at once: float32
    scores and P = exp(s - max), P V with P as one bf16 rounding or as
    P_hi + P_lo, divided by l = sum of the float32 P, rounded to bf16."""
    b, s, h, d = q.shape
    sc = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sc = sc.masked_fill(torch.ones(s, s).triu(1).bool(), -math.inf)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    terms = (hi, (p - hi).bfloat16().float()) if split else (hi,)
    acc = sum(torch.einsum("bhst,bthd->bshd", t, v.float()) for t in terms)
    return (acc / p.sum(-1).transpose(1, 2)[..., None]).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
def test_split_p_keeps_the_bf16_allowance(causal):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 100, 4, 64), generator=gen).bfloat16()
               for _ in range(3))
    want = fa_ref.attention(q, k, v, causal=causal).float()
    allow = 2.0 ** -7 * want.abs() + 5e-5 * want.abs().max()
    used = {split: float(((_pv(q, k, v, causal, split).float() - want).abs()
                          / allow).max()) for split in (False, True)}
    assert used[True] <= 1.0 < 2.0 < used[False]


def _padded_jax(attn, jq, jk, jv, **kw):
    """JAX's MLA prefill core: v padded with zeros to q's head dim, the
    output sliced back to v's."""
    dv = jv.shape[-1]
    pad = jnp.pad(jv, ((0, 0), (0, 0), (0, 0), (0, jq.shape[-1] - dv)))
    return np.asarray(attn(jq, jk, pad, **kw)[..., :dv])


@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_separate_v_head_dim_matches_jax_padded(d, dv, causal, window):
    rng = np.random.default_rng(d + window)
    q, k = (rng.standard_normal((1, 128, 4, d)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, 128, 4, dv)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window)
    want = _padded_jax(JL.full_attention, jq, jk, jv, **kw)
    plain = fa_ref.attention(tq, tk, tv, **kw)
    assert plain.shape == (1, 128, 4, dv)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(TL.full_attention(tq, tk, tv, **kw).numpy(),
                               want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        TL.chunked_attention(tq, tk, tv, chunk=64, **kw).numpy(),
        _padded_jax(JL.chunked_attention, jq, jk, jv, chunk=64, **kw),
        rtol=0, atol=1e-6)
    # on the CPU the dispatch is the plain version, at v's width
    assert torch.equal(fa_ops.flash_attention(tq, tk, tv, **kw), plain)


@pytest.mark.parametrize("window,softcap", [(16, 30.0), (0, 30.0),
                                            (48, 0.0)])
def test_head_dim_256_one_kv_head_matches_jax(window, softcap):
    (jq, jk, jv), (q, k, v) = _inputs(1, 64, 4, 1, 256, "float32", seed=7)
    if softcap:
        jq, q = 20 * jq, 20 * q               # scores up to ~100: capped
    kw = dict(causal=True, window=window, softcap=softcap)
    want = np.asarray(JL.full_attention(jq, jk, jv, **kw))
    got = fa_ref.attention(q, k, v, **kw)
    assert got.shape == (1, 64, 4, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 if softcap else 1e-6)
