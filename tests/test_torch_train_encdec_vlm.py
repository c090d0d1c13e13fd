"""Training the encdec (Whisper) and vlm (InternVL2) families: the port's
``LM.forward`` / ``LM.loss`` / ``LM.value_and_grad``,
``launch/steps.py::make_train_step`` and ``launch/train.py`` against the
JAX package's, on the CPU, on whisper-smoke (2 encoder + 2 decoder
layers, 32 audio frames) and internvl2-smoke (2 layers, 8 image tokens),
from the port's seeded weights (handed to JAX as numpy) and one numpy
batch: a (4, 32) synthetic token batch and seeded unit-normal
``audio_embeds`` / ``pixel_embeds``.

  * ``forward``'s logits (the vlm's over the image prefix and the text)
    and ``loss``'s metrics (the vlm's over the text alone);
  * ``value_and_grad`` with and without remat against
    ``jax.value_and_grad(lm.loss, has_aux=True)`` leaf by leaf, every
    leaf non-zero on both sides (the encoder's, ``enc_pos``, the cross
    attention's, the embedding's: the encoder output reaches the
    rematerialised decoder blocks as an argument), remat bitwise the
    plain backward;
  * ``make_train_step`` (remat, 2 microbatches, the frontend input split
    along dim 0 with the tokens) over 3 AdamW steps against JAX's
    jitted step, each parameter leaf's change held against JAX's;
  * under autograd the cross attention takes the plain path (a recording
    stand-in for the flash kernel sees no call), outside it the kernel;
  * ``train.main(--smoke --steps 3 --device cpu)`` prints the JAX
    launcher's losses (both feed zero frontend stubs).

Tolerances, of max |JAX| (per leaf for gradients).  float32, from a
float64 control (the port run with ``config._DTYPES["float32"]`` set to
``torch.float64`` and the tree cast; seeds 3 and 4 of the frontend): on
whisper-smoke JAX's float32 gradient lies up to 3.3e-4 of a leaf's max
from it and the port's up to 3.4e-4, the logits 1.0e-4 and 6.8e-5; on
internvl2-smoke 2.6e-5 and 6.7e-6.  Two float32 forms may each be that
far off, in opposite directions: whisper 2e-4 (logits) and 1e-3
(gradient), internvl2 5e-5 and 1e-4.  bfloat16: both packages' bf16
forward lies 0.18-0.68 of max |logit| from the float64 one (the seeded
weights' near one-hot attention amplifies every rounding), and the two
lie within 1e-2 of each other but where XLA's fusion rounds an encoder
output to the other neighbour (24 of the 8,192 in the test's batch):
then a position's logits move 3.7e-2 and a leaf's gradient 3.2e-2
(whisper, seed 3).  Held within 5e-2 per leaf, and the whole gradient
(all leaves as one vector) within 2e-2 in relative L2 norm (seen 1.3e-2
whisper, 6.4e-3 internvl2).  Losses within 1e-5 (float32) and 1e-3
(bfloat16), a train step's against JAX's loss on the port's parameters
of that step.  Over 3 steps the parameters are held absolutely:
internvl2 within 1e-4 (seen 3.4e-6); whisper, whose float32 gradients
differ by up to 3.4e-4 of a leaf's max, within 2 x the three rates'
sum, as ``test_torch_train.py`` holds bfloat16 (AdamW's normalised step
turns the rounding of a near-zero gradient element into as much as 2 lr
a step; seen 4.2e-4, 0.7 x the sum).  That bound alone would pass a leaf
the update left unchanged (off by about 1 x the sum), so each leaf's
change over the three steps is also held within ``CHANGE_TOL`` of JAX's
change in relative L2 norm: whisper 0.1 (seen 4.8e-2), internvl2 1e-3
(seen 1.2e-4); an unchanged leaf reads 1.
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import registry as j_registry
from repro_torch import random as jr
from repro_torch.config import TrainConfig
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import steps, train
from repro_torch.models import layers as TL
from repro_torch.models import registry
from repro_torch.models.lm import LM
from repro_torch.tree import tree_map, tree_paths
from test_torch_encdec import frontend
from test_torch_mla import EXACT, _err, _np, both_params

ARCHS = ("whisper_small", "internvl2_26b")
F32_TOL = {"whisper_small": {"logits": 2e-4, "grad": 1e-3},
           "internvl2_26b": {"logits": 5e-5, "grad": 1e-4}}
BF16_TOL = {"logits": 5e-2, "grad": 5e-2}
BF16_WHOLE = 2e-2
LOSS_TOL = {True: 1e-5, False: 1e-3}
# after 3 AdamW steps, absolutely, as a function of the three rates' sum
PARAM_TOL = {"whisper_small": lambda s: 2 * s,
             "internvl2_26b": lambda s: 1e-4}
# each leaf's change over the 3 steps, in relative L2 norm against JAX's
# change: seen 4.8e-2 (whisper) and 1.2e-4 (internvl2); a leaf left
# unchanged reads 1, one dropped step of the three at least 1/6
CHANGE_TOL = {"whisper_small": 0.1, "internvl2_26b": 1e-3}
BATCH, SEQ, SEED = 4, 32, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, exact):
    kw = EXACT if exact else {}
    return (dataclasses.replace(j_registry.get_smoke_config(arch), **kw),
            dataclasses.replace(registry.get_smoke_config(arch), **kw))


def _batch(cfg, ds=None):
    """A synthetic (BATCH, SEQ) token batch and the frontend input, numpy."""
    b = (ds or JDataset(cfg.vocab_size, SEQ, BATCH)).next_batch()
    b.update(frontend(cfg, BATCH, seed=SEED))
    return b


def _both(b):
    return (jax.tree.map(jnp.asarray, b),
            {k: torch.as_tensor(v) for k, v in b.items()})


def _model(arch, exact):
    jc, tc = _cfgs(arch, exact)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jp, tp = both_params(jr.key(0), tlm.param_defs())
    return jc, tc, jlm, tlm, jp, tp


def _tol(arch, exact, what):
    return F32_TOL[arch][what] if exact else BF16_TOL[what]


@pytest.mark.parametrize("exact", [True, False], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, exact):
    jc, tc, jlm, tlm, jp, tp = _model(arch, exact)
    jb, tb = _both(_batch(tc))
    jl, jaux = jax.jit(jlm.forward)(jp, jb)
    tl, taux = tlm.forward(tp, tb)
    assert tl.shape == (BATCH, tc.n_image_tokens + SEQ, tc.vocab_size)
    assert tl.dtype == torch.float32 and taux == {} and jaux == {}
    assert _err(tl, jl) <= _tol(arch, exact, "logits")
    _, jm = jax.jit(jlm.loss)(jp, jb)
    _, tm = tlm.loss(tp, tb)
    assert set(tm) == set(jm) == {"loss", "ce", "acc"}
    for key in ("loss", "ce"):
        assert _err(tm[key], jm[key]) <= LOSS_TOL[exact], key
    assert float(tm["acc"]) == float(jm["acc"])


@pytest.mark.parametrize("exact", [True, False], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_per_leaf(arch, exact):
    """With and without remat, leaf by leaf; every leaf non-zero."""
    jc, tc, jlm, tlm, jp, tp = _model(arch, exact)
    jb, tb = _both(_batch(tc))
    (_, jm), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(jp, jb)
    want = jax.tree_util.tree_leaves_with_path(jg)
    tol = _tol(arch, exact, "grad")
    runs = []
    for remat in (False, True):
        (_, tm), tg = tlm.value_and_grad(tp, tb, remat=remat)
        runs.append(tg)
        assert _err(tm["loss"], jm["loss"]) <= LOSS_TOL[exact]
        got = tree_paths(tg)
        assert [tuple(k.key for k in p) for p, _ in want] == \
            [p for p, _ in got]
        for (path, w), (tpath, g) in zip(want, got):
            assert g.shape == w.shape and g.dtype == torch.float32, tpath
            assert float(np.abs(_np(w)).max()) > 0, tpath
            assert float(g.abs().max()) > 0, tpath
            assert _err(g, w) <= tol, (remat, tpath, _err(g, w))
        if not exact:
            d = np.sqrt(sum(float(np.sum((_np(g).astype(np.float64)
                                          - _np(w)) ** 2))
                            for (_, w), (_, g) in zip(want, got)))
            n = np.sqrt(sum(float(np.sum(_np(w).astype(np.float64) ** 2))
                            for _, w in want))
            assert d <= BF16_WHOLE * n, (remat, d / n)
    for (path, a), (_, c) in zip(tree_paths(runs[0]), tree_paths(runs[1])):
        assert torch.equal(a, c), path
    paths = {p for p, _ in tree_paths(runs[0])}
    assert ("embed",) in paths
    if tc.family == "encdec":
        assert {"enc_pos", "enc_layers", "enc_norm"} <= {p[0] for p in paths}
        assert {p[2] for p in paths if p[:2] == ("dec_layers", "cross_attn")} \
            == {"wq", "wk", "wv", "wo"}


def _init_states(jp, tp):
    js = {"params": jp, "mu": jax.tree.map(jnp.zeros_like, jp),
          "nu": jax.tree.map(jnp.zeros_like, jp),
          "step": jnp.zeros((), jnp.int32)}
    ts = {"params": tp, "mu": tree_map(torch.zeros_like, tp),
          "nu": tree_map(torch.zeros_like, tp),
          "step": torch.zeros((), dtype=torch.int32)}
    return js, ts


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, monkeypatch, micro=2):
    """3 AdamW steps with remat at float32 against JAX's jitted step: each
    step's loss against JAX's loss on the port's parameters of that step;
    with 2 microbatches each sees half the batch's frontend input beside
    its tokens.  After the third step each parameter leaf is held
    absolutely (``PARAM_TOL``) and its change over the three steps
    within ``CHANGE_TOL`` of JAX's change in relative L2 norm, which a
    leaf left unchanged (1.0) or one dropped step (1/6 or more) fails."""
    jc, tc, jlm, tlm, jp, tp = _model(arch, True)
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=50,
              remat_policy="block", num_microbatches=micro)
    jstep = jax.jit(j_steps.make_train_step(jlm, JTrainConfig(**kw)))
    tstep = steps.make_train_step(tlm, TrainConfig(**kw))
    start = tree_map(torch.clone, tp)      # the step writes in place
    js, ts = _init_states(jp, tp)
    name = "audio_embeds" if tc.family == "encdec" else "pixel_embeds"
    seen = []
    vg = LM.value_and_grad

    def recording(self, params, batch, remat=False):
        seen.append((batch["tokens"], batch[name]))
        return vg(self, params, batch, remat=remat)
    monkeypatch.setattr(LM, "value_and_grad", recording)
    jloss = jax.jit(jlm.loss)
    ds = JDataset(jc.vocab_size, SEQ, BATCH)
    lr_sum = 0.0
    for _ in range(3):
        b = _batch(tc, ds)
        jb, tb = _both(b)
        on_port = jloss(tree_map(lambda t: jnp.asarray(np.array(t)),
                                 ts["params"]), jb)[1]
        js, jm = jstep(js, jb)
        lr_sum += float(jm["lr"])
        del seen[:]
        ts, tm = tstep(ts, tb)
        assert len(seen) == micro
        half = BATCH // micro
        for i, (tok, extra) in enumerate(seen):
            assert torch.equal(tok, tb["tokens"][i * half:(i + 1) * half])
            assert torch.equal(extra, tb[name][i * half:(i + 1) * half])
        assert abs(float(tm["loss"]) - float(on_port["loss"])) <= \
            LOSS_TOL[True] * abs(float(on_port["loss"]))
    assert int(ts["step"]) == int(js["step"]) == 3
    ptol = PARAM_TOL[arch](lr_sum)
    want = jax.tree_util.tree_leaves_with_path(js["params"])
    for (path, w), (_, g), (_, p0) in zip(want, tree_paths(ts["params"]),
                                          tree_paths(start)):
        key = jax.tree_util.keystr(path)
        g, w, p0 = g.numpy(), np.asarray(w), p0.numpy()
        d = float(np.abs(g - w).max())
        assert d <= ptol, (key, d)
        moved = (w - p0).astype(np.float64)
        off = float(np.linalg.norm(g - w) / np.linalg.norm(moved))
        assert off <= CHANGE_TOL[arch], (key, off)


def test_cross_attention_is_plain_under_autograd(monkeypatch):
    """A recording stand-in for the flash kernel, as on the card: the
    training gradient calls it never; ``forward`` without a recorded
    gradient calls it for each encoder block (causal, S = T) and twice
    for each decoder block (causal self attention; cross attention,
    non-causal, 32 queries against the 32 frames)."""
    _, tc, _, tlm, _, tp = _model("whisper_small", True)
    calls = []

    def kernel(q, k, v, causal=True, window=0, softcap=0.0):
        calls.append((q.shape[1], k.shape[1], causal))
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    monkeypatch.setattr(TL, "default_use_kernel", lambda t: True)
    monkeypatch.setattr(TL, "flash_attention", kernel)
    _, tb = _both(_batch(tc))
    for remat in (False, True):
        tlm.value_and_grad(tp, tb, remat=remat)
    assert calls == []
    with torch.no_grad():
        tlm.forward(tp, tb)
    t = tc.encoder_seq_len
    assert calls == [(t, t, True)] * tc.n_encoder_layers + \
        [(SEQ, SEQ, True), (SEQ, t, False)] * tc.n_layers


_LOSS = re.compile(r"step\s+(\d+)\s+loss ([\d.]+)")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_losses(arch, monkeypatch):
    """``train.main`` on the smoke config (bfloat16 compute, batch 8, seq
    128, the zero frontend stubs) prints JAX's launcher's losses at steps
    0 and 2, within 1e-3."""
    flags = ["--arch", arch, "--smoke", "--steps", "3"]
    monkeypatch.setattr("sys.argv", ["train"] + flags)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        j_train.main()
    want = {int(s): float(v) for s, v in _LOSS.findall(buf.getvalue())}
    rep = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(flags + ["--device", "cpu"], report=rep)
    got = {int(s): float(v) for s, v in _LOSS.findall(buf.getvalue())}
    assert set(want) == set(got) == {0, 2} and len(rep["losses"]) == 3
    for i, w in want.items():
        assert abs(rep["losses"][i] - w) <= 1e-3 * w, (i, rep["losses"], w)
    assert all(np.isfinite(rep["losses"]))
