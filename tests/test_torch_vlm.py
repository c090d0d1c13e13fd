"""The vlm family (InternVL2): the ``pixel_embeds`` prefix of
``LM.prefill``, the vlm family's dense stack and ``serve.main`` against
the JAX package's, on the CPU, on internvl2-smoke (2 layers, d 64, 8
heads of 8 over 2 kv heads, SwiGLU, RoPE, 8 image tokens).

  * the config and the ParamDef tree leaf for leaf as JAX's (the dense
    tree), the parameter count at full width (19,861,260,288, the JAX
    registry's); ``init_params`` of the whole smoke tree bitwise JAX's in
    float32 and with ``dtype=bfloat16`` bitwise JAX's
    ``init_params(dtype=jnp.bfloat16)`` (each normal drawn in float32,
    then rounded), the way the full-width model is drawn for one card;
  * ``LM.prefill`` + 8 ``decode_step``s with random numpy pixel
    embeddings and with the launcher's zeros: float32 within 1e-5 of max
    |logit| and of every cache leaf's max (both packages within 3.7e-6 of
    the port run in float64, seen 2.9e-6 apart), identical greedy tokens;
    bfloat16 compute within 2e-2 (fed JAX's tokens; seen 1.8e-2), as the
    dense family's; ``index`` = S + n_image_tokens after the prefill;
  * the same on bfloat16 weights (both packages' ``init_params`` at
    bfloat16), bfloat16 compute, within 2e-2;
  * the prefix: without ``cache_len`` the cache is S + n_image_tokens
    long, the prompt's logits differ from those without the prefix, and
    a batch without ``pixel_embeds`` runs the dense stack alone, as
    JAX's;
  * ``serve.main(--arch internvl2_26b --smoke --device cpu)`` prints JAX
    ``serve.main``'s line and tokens at the same flags (float32 dtypes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as j_registry
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.tree import tree_map
from test_torch_encdec import (BF16_TOL, _batches, _cfgs, frontend,
                               init_params_bitwise, prefill_and_decode,
                               serve_main_makes_jax_tokens)
from test_torch_mla import _err, defs_match_and_draw_bitwise

ARCH = "internvl2_26b"
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_and_param_defs_as_jax():
    defs_match_and_draw_bitwise(ARCH, 12, 19_861_260_288)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_init_params_bitwise(dtype):
    init_params_bitwise(ARCH, dtype)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("zeros", [False, True], ids=["pixels", "zeros"])
def test_prefill_and_decode(exact, zeros):
    """8 decode steps (float32 1e-5 with identical tokens, bfloat16
    2e-2); ``index`` counts the image tokens."""
    _, tc = _cfgs(ARCH)
    tol = F32_TOL if exact else BF16_TOL
    tst, _ = prefill_and_decode(ARCH, exact, frontend(tc, 2, zeros), tol,
                                tol)
    assert set(tst) == {"index", "cache"}
    assert tst["cache"]["k"].shape[2] == 16 + 9 + tc.n_image_tokens


def test_bfloat16_weights_prefill_and_decode():
    _, tc = _cfgs(ARCH)
    defs = registry.build(tc).param_defs()
    tree = tree_map(lambda t: t.float().numpy(),
                    P.init_params(jr.key(0), defs, dtype=torch.bfloat16))
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    tp = tree_map(lambda t: t.to(torch.bfloat16),
                  convert.lm_params_from_arrays(tree, "cpu"))
    prefill_and_decode(ARCH, False, frontend(tc, 2), BF16_TOL, BF16_TOL,
                       params=(jp, tp))


def test_image_prefix():
    jc, tc = _cfgs(ARCH, True)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    params = P.init_params(jr.key(0), tlm.param_defs())
    tokens = jr.randint(jr.key(1), (2, 12), 0, tc.vocab_size)
    jb, tb = _batches(tokens, frontend(tc, 2))
    logits, state = tlm.prefill(params, tb)
    n = 12 + tc.n_image_tokens
    assert int(state["index"]) == n and state["cache"]["k"].shape[2] == n
    plain, plain_state = tlm.prefill(params, {"tokens": tokens})
    assert int(plain_state["index"]) == 12
    assert _err(plain, logits) > 1e-3
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), params))
    want = jax.jit(lambda p, b: jlm.prefill(p, b))(
        jp, {"tokens": jb["tokens"]})[0]
    assert _err(plain, want) <= F32_TOL


def test_serve_main_makes_jax_tokens(monkeypatch):
    serve_main_makes_jax_tokens(ARCH, monkeypatch)
