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
  * ``flash_attention`` on CPU tensors is the plain version and launches
    nothing.

Tolerance: ``test_kernels.py``'s own, max |diff| < 5e-5 in float32 and
2e-2 in bfloat16 (the kernel's online softmax and the plain softmax sum
in another order); the plain cores within 1e-6 (one formula, PyTorch's
and XLA's reductions).
"""
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
