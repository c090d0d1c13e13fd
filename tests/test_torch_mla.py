"""The moe family on MLA attention (DeepSeek-V2-Lite): the port's
``models/mla.py``, the MLA branches of ``models/lm.py`` and
``serve.main`` against the JAX package's, on the CPU, on
deepseek-v2-lite-smoke (3 layers, the first dense; MLA with latent rank
32, qk head dim 16 + 8, v head dim 16; 8 routed experts + 2 shared,
top-2).

  * the config and the ParamDef tree (shape, axes, init, scale, dtype
    leaf for leaf) as JAX's; ``init_params`` bitwise JAX's draw on a
    leaf of each kind (JAX's eager draw compiles per shape, seconds a
    leaf: the whole tree is drawn bitwise in ``test_torch_lm.py`` and
    ``test_torch_moe.py``); the parameter count at full width
    (15,710,612,992, the JAX registry's).  The other tests draw with the
    port, hand JAX the numpy tree and the port ``convert``'s copy of it;
  * ``mla_apply``: the prefill (``return_kv``: the latent ``c_kv`` and
    the RoPE key) and 4 absorbed decode steps against a cache written in
    place, within 1e-5 of max |y| in float32 and 2e-2 in bfloat16; the
    caches within the same;
  * the prefill's attention goes to the flash kernel's entry point with
    q and k at head dim 24 and v at 16 (a recording stand-in for the
    kernel, as on the card), once per layer, never in decode or under
    autograd;
  * ``LM.prefill`` + 8 ``decode_step``s: float32 within 5e-5 of max
    |logit| and identical greedy tokens, bfloat16 within 2e-2 (fed JAX's
    tokens), the caches within the same, as the moe family's GQA tests
    hold them; in float32 on the serving launcher's weights and prompt,
    whose greedy tokens ``serve.main(--arch deepseek_v2_lite_16b --smoke
    --device cpu)`` then makes;
  * ``LM.loss`` and its aux terms in float32 within 1e-5;
  * ``LM.value_and_grad`` with and without remat against
    ``jax.value_and_grad(loss)`` leaf by leaf (the latent down- and
    up-projections, the RoPE key, the MoE leaves): float32 within 1e-4 of
    max |JAX leaf|, set from a float64 control (JAX's own float32
    gradient within 2.3e-5 of JAX's in float64), bfloat16 within 3e-2
    (the moe tests' allowance); every leaf non-zero, remat bitwise the
    plain backward; ``make_train_step`` over 3 AdamW steps with remat
    against JAX's jitted step, as ``test_torch_moe.py`` holds the moe
    family's (the helpers are shared with ``test_torch_hybrid.py`` and
    ``test_torch_xlstm.py``).

The JAX package pads v to the qk head dim in its prefill and slices the
output; the port attends at v's own width (the same values:
``test_torch_flash.py::test_separate_v_head_dim_matches_jax_padded``).
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.launch import steps as j_steps
from repro.models import mla as JMLA
from repro.models import registry as j_registry
from repro.models.params import is_def as j_is_def
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.config import TrainConfig
from repro_torch.launch import serve, steps
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMLA
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.tree import tree_map, tree_paths

ARCH = "deepseek_v2_lite_16b"
EXACT = dict(compute_dtype="float32", cache_dtype="float32",
             reduce_dtype="float32")


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


def _t(a):
    return convert.lm_params_from_arrays({"a": np.asarray(a)}, "cpu")["a"]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x).astype(jnp.float32))


def _err(got, want):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def defs_match_and_draw_bitwise(arch, n_leaves, full_count):
    """The config, the ParamDef trees leaf for leaf, ``init_params`` on
    one leaf of each init kind bitwise JAX's, the full parameter count.
    Shared with ``test_torch_hybrid.py``."""
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(registry, get)(arch)) == \
            dataclasses.asdict(getattr(j_registry, get)(arch))
    jdefs = j_registry.build(j_registry.get_smoke_config(arch)).param_defs()
    tdefs = registry.build(registry.get_smoke_config(arch)).param_defs()
    want = jax.tree_util.tree_leaves_with_path(jdefs, is_leaf=j_is_def)
    got = P._leaves_sorted(tdefs)
    assert len(want) == len(got) == n_leaves
    for (path, w), (tpath, g) in zip(want, got):
        assert tuple(k.key for k in path) == tpath
        assert (w.shape, w.axes, w.init, w.scale, np.dtype(w.dtype).name) \
            == (g.shape, g.axes, g.init, g.scale, str(g.dtype)[6:]), tpath
    params = P.init_params(jr.key(0), tdefs)
    drawn = {}
    for i, (tpath, g) in enumerate(got):
        if g.init in drawn or g.init in ("zeros", "ones"):
            continue
        w = jax.random.normal(jax.random.fold_in(jax.random.key(0), i),
                              g.shape) * np.float32(P._std_for(g))
        leaf = params
        for k in tpath:
            leaf = leaf[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(w),
                                      err_msg=str(tpath))
        drawn[g.init] = tpath
    assert set(drawn) == {"normal", "embed"}
    for init, value in (("zeros", 0.0), ("ones", 1.0)):
        leaves = [leaf for path, leaf in tree_paths(params)
                  if dict(got)[path].init == init]
        assert all(bool((leaf == value).all()) for leaf in leaves)
    assert registry.param_count(registry.get_smoke_config(arch)) == \
        j_registry.param_count(j_registry.get_smoke_config(arch))
    assert registry.param_count(registry.get_config(arch)) == \
        j_registry.param_count(j_registry.get_config(arch)) == full_count


def test_config_and_param_defs_as_jax():
    defs_match_and_draw_bitwise(ARCH, 31, 15_710_612_992)


def _cache(tc, kv, cache_len):
    """A (B, cache_len, ...) cache holding the prefill's latent and RoPE
    key, zero past S (JAX's ``to_cache``)."""
    defs = TMLA.mla_cache_defs(tc, kv["c_kv"].shape[0], cache_len)
    out = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype), defs)
    for name, buf in out.items():
        buf[:, :kv[name].shape[1]] = kv[name]
    return out


@pytest.mark.parametrize("exact", [True, False])
def test_mla_apply_matches_jax(exact):
    jc, tc = _cfgs(exact)
    jp, tp = both_params(jr.key(3), TMLA.mla_defs(tc))
    dt = jnp.float32 if exact else jnp.bfloat16
    tol = 1e-5 if exact else 2e-2
    a = np.random.default_rng(0).standard_normal((2, 20, 64))
    jx = jnp.asarray(a.astype(np.float32)).astype(dt)
    s = 16
    jy, jkv = jax.jit(lambda p, x: JMLA.mla_apply(
        p, jc, x, positions=jnp.arange(s), return_kv=True))(jp, jx[:, :s])
    ty, tkv = TMLA.mla_apply(tp, tc, _t(jx[:, :s]),
                             positions=torch.arange(s), return_kv=True)
    assert ty.dtype == _t(jx).dtype
    assert _err(ty, jy) <= tol
    for name in ("c_kv", "k_rope"):
        assert _err(tkv[name], jkv[name]) <= tol, name
    # absorbed decode, the port's cache written in place
    jcache = jax.tree.map(
        lambda v: jnp.pad(v, ((0, 0), (0, 24 - s), (0, 0))).astype(
            jnp.dtype(jc.cache_dtype)), jkv)
    tcache = _cache(tc, tkv, 24)
    step = jax.jit(lambda p, c, x, i: JMLA.mla_apply(
        p, jc, x, positions=i[None], cache=c, cache_index=i))
    for i in range(s, s + 4):
        idx = jnp.asarray(i, jnp.int32)
        jy, jcache = step(jp, jcache, jx[:, i:i + 1], idx)
        ty, out = TMLA.mla_apply(tp, tc, _t(jx[:, i:i + 1]),
                                 positions=torch.tensor([i]), cache=tcache,
                                 cache_index=torch.tensor(i,
                                                          dtype=torch.int32))
        assert out is tcache
        assert _err(ty, jy) <= tol, i
        for name in ("c_kv", "k_rope"):
            assert _err(tcache[name], jcache[name]) <= tol, (i, name)


def test_prefill_goes_to_the_flash_kernel_with_both_head_dims(monkeypatch):
    """The dispatch the card takes, with a recording stand-in for the
    kernel: once per layer in prefill at (Dqk, Dv) = (24, 16), never in
    decode or under autograd."""
    _, tc = _cfgs(True)
    lm = registry.build(tc)
    params = P.init_params(jr.key(0), lm.param_defs())
    calls = []

    def kernel(q, k, v, causal=True, window=0, softcap=0.0):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], causal))
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    monkeypatch.setattr(TL, "default_use_kernel", lambda t: True)
    monkeypatch.setattr(TL, "flash_attention", kernel)
    tokens = jr.randint(jr.key(1), (2, 16), 0, tc.vocab_size)
    _, state = lm.prefill(params, {"tokens": tokens}, cache_len=20)
    assert calls == [(24, 24, 16, True)] * tc.n_layers
    lm.decode_step(params, state, tokens[:, :1])
    lm.value_and_grad(params, {"tokens": tokens, "labels": tokens})
    assert len(calls) == tc.n_layers


def both_params(key, defs):
    """The port's draw as JAX's numpy tree (for JAX) and ``convert``'s
    copy of that tree (for the port).  Shared with
    ``test_torch_hybrid.py``."""
    tree = tree_map(lambda t: t.numpy(), P.init_params(key, defs))
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params_from_arrays(tree, "cpu"))


def _model(exact):
    jc, tc = _cfgs(exact)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp, tp = both_params(jr.key(0), tlm.param_defs())
    return jc, jlm, tlm, jp, tp


def prefill_and_decode(arch, cfgs, exact, prompt, steps, cache_len, tol):
    """``LM.prefill`` then ``steps`` greedy ``decode_step``s on JAX's
    tokens, the port's drawn weights (``init_params(key(0))``, the
    serving launcher's) given to both: logits within ``tol`` of max
    |logit|, the state's leaves within ``tol``, and in float32 the same
    greedy tokens, which are then ``serve.main``'s on the CPU (at
    ``prompt`` tokens and cache ``cache_len``, serve's prompt and cache
    when ``steps`` + 1 tokens are asked of it).  Shared with
    ``test_torch_hybrid.py``."""
    jc, tc = cfgs(exact)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp, tp = both_params(jr.key(0), tlm.param_defs())
    tokens = jr.randint(jr.key(1), (2, prompt), 0, tc.vocab_size)
    jlog, jst = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t},
                                                 cache_len=cache_len))(
        jp, jnp.asarray(tokens.numpy()))
    tlog, tst = tlm.prefill(tp, {"tokens": tokens}, cache_len=cache_len)
    decode = jax.jit(jlm.decode_step)
    greedy = []
    for step in range(steps + 1):
        assert _err(tlog, jlog) <= tol, step
        want = jax.tree_util.tree_leaves_with_path(jst)
        assert [tuple(k.key for k in path) for path, _ in want] == \
            [path for path, _ in tree_paths(tst)]
        for (path, w), (_, g) in zip(want, tree_paths(tst)):
            assert g.shape == w.shape and _err(g, w) <= tol, (step, path)
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None]
        greedy.append(np.asarray(jtok))
        if exact:
            np.testing.assert_array_equal(
                torch.argmax(tlog[:, -1], -1)[:, None].numpy(), greedy[-1])
        if step == steps:
            break
        jlog, jst = decode(jp, jst, jtok)
        tlog, tst = tlm.decode_step(tp, tst, _t(jtok).long())
    assert int(tst["index"]) == int(jst["index"]) == prompt + steps
    if exact:
        argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                str(prompt), "--tokens", str(steps + 1), "--device", "cpu",
                "--override", *(f"{k}={v}" for k, v in EXACT.items())]
        assert prompt + steps + 1 == cache_len
        with contextlib.redirect_stdout(io.StringIO()):
            got = serve.main(argv)
        np.testing.assert_array_equal(got.numpy(),
                                      np.concatenate(greedy, 1))
    return tst


@pytest.mark.parametrize("exact", [True, False])
def test_prefill_and_decode(exact):
    """8 decode steps (float32 tol 5e-5, bfloat16 2e-2) and, in float32,
    ``serve.main``'s tokens."""
    tst = prefill_and_decode(ARCH, _cfgs, exact, 16, 8, 25,
                             5e-5 if exact else 2e-2)
    assert set(tst) == {"index", "dense_cache", "cache"}
    for ckey in ("dense_cache", "cache"):
        assert set(tst[ckey]) == {"c_kv", "k_rope"}


def test_loss_with_aux_terms():
    jc, jlm, tlm, jp, tp = _model(True)
    tokens = jax.random.randint(jax.random.key(2), (2, 32), 0, jc.vocab_size)
    batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, 1)}
    jl, jm = jax.jit(jlm.loss)(jp, batch)
    tl, tm = tlm.loss(tp, {k: _t(v).long() for k, v in batch.items()})
    assert set(tm) == set(jm) == {"loss", "ce", "acc", "moe_aux", "moe_z",
                                  "moe_dropped"}
    for key in ("loss", "ce", "moe_aux", "moe_z"):
        assert _err(tm[key], jm[key]) <= 1e-5, key
    for key in ("acc", "moe_dropped"):
        assert float(tm[key]) == float(jm[key]), key


# -- training -----------------------------------------------------------------


def value_and_grad_per_leaf(cfgs, exact, n_leaves, tol, metric_keys,
                            whole_tol=None):
    """``LM.value_and_grad`` with and without remat against
    ``jax.value_and_grad(loss)`` on one (4, 32) synthetic batch, the
    port's drawn weights given to both: the metrics ``metric_keys``
    within 1e-5 (float32) or 1e-3 (bfloat16), every gradient leaf non-zero
    on both sides and within ``tol`` of max |JAX leaf|, the whole
    gradient (all leaves as one vector) within ``whole_tol`` of JAX's in
    relative L2 norm where it is given, and the remat gradient bitwise
    the plain one.  Returns the gradient's paths.  Shared with
    ``test_torch_hybrid.py`` and ``test_torch_xlstm.py``."""
    jc, tc = cfgs(exact)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp, tp = both_params(jr.key(0), tlm.param_defs())
    b = JDataset(jc.vocab_size, 32, 4).next_batch()
    (_, jm), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, b))
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    runs = []
    for remat in (False, True):
        (_, tm), tg = tlm.value_and_grad(tp, tb, remat=remat)
        runs.append(tg)
        for key in metric_keys:
            assert _err(tm[key], jm[key]) <= (1e-5 if exact else 1e-3), key
        want = jax.tree_util.tree_leaves_with_path(jg)
        got = tree_paths(tg)
        assert len(got) == len(want) == n_leaves
        for (path, w), (tpath, g) in zip(want, got):
            name = jax.tree_util.keystr(path)
            assert tuple(k.key for k in path) == tpath
            assert g.shape == w.shape, name
            assert float(np.abs(_np(w)).max()) > 0, name
            assert float(g.abs().max()) > 0, name
            assert _err(g, w) <= tol, (remat, name, _err(g, w))
        if whole_tol is not None:
            d = np.sqrt(sum(float(np.sum((_np(g).astype(np.float64) -
                                          _np(w)) ** 2))
                            for (_, w), (_, g) in zip(want, got)))
            n = np.sqrt(sum(float(np.sum(_np(w).astype(np.float64) ** 2))
                            for _, w in want))
            assert d <= whole_tol * n, (remat, d / n)
    for (_, a), (_, c) in zip(tree_paths(runs[0]), tree_paths(runs[1])):
        assert torch.equal(a, c)
    return [path for path, _ in tree_paths(runs[0])]


def train_step_matches_jax(cfgs, exact, loss_tol, ptol):
    """3 AdamW steps of ``make_train_step`` with remat (as the train
    launcher runs it) against JAX's jitted step, both from the port's
    drawn weights and zero moments: each step's loss within ``loss_tol``
    of JAX's (relative), the parameters after the third step absolutely
    within ``ptol(lr_sum)``, the sum of the three steps' rates.  In
    bfloat16 the loss is held against JAX's loss on the port's
    parameters of that step (the two trajectories' parameters drift by
    bf16 roundings, as ``test_torch_moe.py`` holds them).  Shared with
    ``test_torch_hybrid.py`` and ``test_torch_xlstm.py``."""
    jc, tc = cfgs(exact)
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=50,
              remat_policy="block")
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jstep = jax.jit(j_steps.make_train_step(jlm, JTrainConfig(**kw)))
    tstep = steps.make_train_step(tlm, TrainConfig(**kw))
    jp, tp = both_params(jr.key(0), tlm.param_defs())
    js = {"params": jp, "mu": jax.tree.map(jnp.zeros_like, jp),
          "nu": jax.tree.map(jnp.zeros_like, jp),
          "step": jnp.zeros((), jnp.int32)}
    ts = {"params": tp, "mu": tree_map(torch.zeros_like, tp),
          "nu": tree_map(torch.zeros_like, tp),
          "step": torch.zeros((), dtype=torch.int32)}
    jloss = jax.jit(jlm.loss)
    ds = JDataset(jc.vocab_size, 32, 4)
    lr_sum = 0.0
    for _ in range(3):
        b = ds.next_batch()
        jb = jax.tree.map(jnp.asarray, b)
        on_port = jloss(jax.tree.map(lambda t: jnp.asarray(np.array(t)),
                                     ts["params"]), jb)[1]
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, {k: torch.as_tensor(v) for k, v in b.items()})
        want = jm if exact else on_port
        assert abs(float(tm["loss"]) - float(want["loss"])) <= \
            loss_tol * abs(float(want["loss"]))
        lr_sum += float(jm["lr"])
    assert int(ts["step"]) == int(js["step"]) == 3
    want = jax.tree_util.tree_leaves_with_path(js["params"])
    for (path, w), (_, g) in zip(want, tree_paths(ts["params"])):
        d = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert d <= ptol(lr_sum), (jax.tree_util.keystr(path), d)


# float32 tolerance of the gradient, set from a float64 control before the
# port was compared: JAX's own float32 gradient on this config lies within
# 2.3e-5 of max |leaf| of JAX's in float64 (x64, every float32 cast of the
# model code made float64), leaf by leaf; two float32 implementations may
# each be that far off in opposite directions.  bfloat16: the moe tests'
# allowances (``test_torch_moe.py``), 3e-2 for the gradient.
GRAD_TOL = {True: 1e-4, False: 3e-2}


@pytest.mark.parametrize("exact", [True, False])
def test_value_and_grad_per_leaf(exact):
    """The gradient through MLA (the latent down- and up-projections, the
    RoPE key, the latent norm) and the MoE layer against JAX's, leaf by
    leaf, with and without remat."""
    paths = value_and_grad_per_leaf(
        _cfgs, exact, 31, GRAD_TOL[exact],
        ("loss", "ce", "moe_aux", "moe_z"))
    for stack in ("dense_layers", "layers"):
        for leaf in ("w_dkv", "kv_norm", "w_uk", "w_uv", "w_kr", "w_q"):
            assert (stack, "attn", leaf) in paths
    assert {p for p in paths if p[:2] == ("layers", "moe")} == {
        ("layers", "moe", k) for k in ("router", "w_gate", "w_up", "w_down")
    } | {("layers", "moe", "shared", k) for k in ("w_gate", "w_up",
                                                  "w_down")}


@pytest.mark.parametrize("exact", [True, False])
def test_train_step_matches_jax(exact):
    """3 AdamW steps with remat: float32 losses within 1e-5 and parameters
    within 1e-4, bfloat16 losses within 1e-3 of JAX's loss on the port's
    parameters and parameters within 2 x the rates' sum (the moe tests'
    allowances)."""
    train_step_matches_jax(_cfgs, exact, 1e-5 if exact else 1e-3,
                           (lambda s: 1e-4) if exact else (lambda s: 2 * s))
