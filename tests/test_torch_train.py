"""The LM training slice: the port's ``data``, ``optim``, ``LM.forward`` /
``LM.loss``, ``launch/steps.py`` and ``launch/train.py`` against the JAX
package's, on the CPU, from the same seeds and numpy inputs, on
``olmo_1b``'s smoke config (bfloat16 compute) and a float32 variant of
it (``F32``).

  * bitwise: ``SyntheticLMDataset`` batches, ``sgld_noise`` for given
    keys, rate and temperature, the EF-int8 tree (q, scales, error), each
    against JAX's jitted function (the LM engine's step runs jitted);
  * ``lr_schedule`` within 1 ulp of JAX's jitted schedule;
  * ``_xent``, ``forward`` logits, ``loss``, ``jax.value_and_grad``
    against ``torch.autograd`` per leaf, ``adamw_update`` from identical
    params and grads;
  * ``make_train_step`` over 3 steps against JAX's, with and without
    remat (the two bitwise within the port) and with 2 microbatches;
  * ``train.main``: the losses of JAX's launcher, and a killed-then-
    resumed run bitwise the uninterrupted one.

Tolerances (max |diff| over max |JAX|, unless said): float32 1e-5 for
logits, losses and the AdamW update from equal inputs, 1e-4 for the
gradients (XLA and PyTorch sum the matmuls and reductions in other
orders; the seeded weights' near one-hot attention amplifies that, seen
1.7e-5); bfloat16 2e-2 for logits and 3e-2 for gradients (bf16 operands
rounded where compiled XLA keeps float32 inside a fusion; seen 1.0e-2).
Over 3 train steps the params are compared absolutely: AdamW's
normalised step turns the rounding of a near-zero gradient element into
as much as 2 lr per step, so they are held within 2 x (the sum of the
three rates) in bfloat16 and 1e-4 in float32 (seen 6.8e-4 and 2.7e-5),
the losses within 1e-5 (float32) and 1e-3 (bfloat16) of JAX's.
"""
import contextlib
import dataclasses
import io
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import lm as j_lm
from repro.models import registry as j_registry
from repro.models.params import init_params as j_init_params
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro.optim import sgld as j_sgld
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.config import TrainConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import steps, train
from repro_torch.models import lm as t_lm
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.optim import adamw, compression, sgld
from repro_torch.tree import tree_paths

F32 = dict(compute_dtype="float32", cache_dtype="float32",
           reduce_dtype="float32")
DTYPES = {"bf16": {}, "f32": F32}
SEQ, BATCH = 32, 4


def _cfgs(dtype):
    kw = DTYPES[dtype]
    return (dataclasses.replace(j_registry.get_smoke_config("olmo_1b"), **kw),
            dataclasses.replace(registry.get_smoke_config("olmo_1b"), **kw))


def _tree(jtree):
    """A JAX tree as the port's (same keys, shapes, dtypes) on the CPU."""
    return convert.lm_train_state_from_arrays(
        jax.tree.map(np.asarray, jtree), "cpu")


def _leaves(tree):
    return [x for _, x in tree_paths(tree)]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(cfg, seed=0):
    return JDataset(cfg.vocab_size, SEQ, BATCH, seed=seed).next_batch()


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _key(jkey):
    return torch.tensor(np.asarray(jax.random.key_data(jkey)).astype(np.int64))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the machine's cores, and many-threaded matmuls in each
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(DTYPES))
def model(request):
    """JAX's jitted loss and gradient on seeded weights, and the port's
    model on the same weights."""
    jc, tc = _cfgs(request.param)
    jlm = j_registry.build(jc)
    jp = j_init_params(jax.random.key(0), jlm.param_defs())
    b = _batch(jc)
    (loss, mets), grads = jax.jit(jax.value_and_grad(
        jlm.loss, has_aux=True))(jp, jax.tree.map(jnp.asarray, b))
    logits, _ = jax.jit(jlm.forward)(jp, jax.tree.map(jnp.asarray, b))
    return dict(dtype=request.param, tc=tc, params=jp, batch=b, loss=loss,
                mets=mets, grads=grads, logits=logits)


# -- data and optimizer ----------------------------------------------------


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, host_id=1,
                                                   n_hosts=2)])
def test_synthetic_batches_bitwise(kw):
    want = JDataset(256, 16, 4, **kw)
    got = SyntheticLMDataset(256, 16, 4, **kw)
    for _ in range(3):
        w, g = want.next_batch(), got.next_batch()
        assert w.keys() == g.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("warm,total", [(10, 100), (100, 1000), (0, 7)])
def test_lr_schedule_within_one_ulp(warm, total):
    steps_ = np.arange(0, total + 30, dtype=np.int32)
    jcfg = JTrainConfig(learning_rate=3e-4, warmup_steps=warm,
                        total_steps=total)
    want = np.asarray(jax.jit(lambda s: j_adamw.lr_schedule(jcfg, s))(
        jnp.asarray(steps_)))
    got = adamw.lr_schedule(TrainConfig(learning_rate=3e-4,
                                        warmup_steps=warm,
                                        total_steps=total),
                            torch.tensor(steps_)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 1


def _param_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((3, 40, 7)).astype(np.float32),
                  "n": {}},
            "a": rng.standard_normal((130,)).astype(np.float32)}


@pytest.mark.parametrize("lr,temp", [(1.7e-3, 3.125e-5), (1e-4, 0.0),
                                     (3e-4, 3.73e-5)])
def test_sgld_noise_bitwise(lr, temp, monkeypatch):
    tree = _param_tree()
    key = jax.random.key(5)
    want = jax.jit(j_sgld.sgld_noise)(key, jax.tree.map(jnp.asarray, tree),
                                      jnp.float32(lr), jnp.float32(temp))
    args = (_key(key), _tree(tree), torch.tensor(np.float32(lr)),
            torch.tensor(np.float32(temp)))
    got = sgld.sgld_noise(*args)
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a leaf drawn in slices is bitwise the whole draw
    monkeypatch.setattr(P, "SLICE", 64)
    for g, w in zip(_leaves(sgld.sgld_noise(*args)), _leaves(got)):
        assert torch.equal(g, w)


def test_ef_int8_tree_bitwise():
    tree = _param_tree(1)
    err = {"b": {"w": 0.01 * _param_tree(2)["b"]["w"], "n": {}},
           "a": np.zeros(130, np.float32)}
    want = jax.jit(j_comp.ef_int8_compress_tree)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, err))
    got = compression.ef_int8_compress_tree(_tree(tree), _tree(err))
    for part_g, part_w in zip(got, want):
        for g, w in zip(_leaves(part_g), jax.tree.leaves(part_w)):
            assert g.dtype == convert._lm_leaf(w, "cpu").dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    deq = compression.ef_int8_decompress_tree(got[0], got[1])
    jdeq = j_comp.ef_int8_decompress_tree(want[0], want[1])
    for g, w in zip(_leaves(deq), jax.tree.leaves(jdeq)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_adamw_update_from_identical_inputs():
    """params, grads, mu, nu at step 4 (bias corrections away from 1),
    with a gradient above the clip norm; tolerance 1e-5 (see the module
    docstring)."""
    rng = np.random.default_rng(3)
    tree = _param_tree(4)
    grads = jax.tree.map(lambda x: (3 * rng.standard_normal(x.shape))
                         .astype(np.float32), tree)
    mu = jax.tree.map(lambda x: (0.1 * rng.standard_normal(x.shape))
                      .astype(np.float32), tree)
    nu = jax.tree.map(lambda x: (0.01 * rng.random(x.shape))
                      .astype(np.float32), tree)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    jst = j_adamw.AdamWState(jnp.int32(4), jax.tree.map(jnp.asarray, mu),
                             jax.tree.map(jnp.asarray, nu))
    wp, wst, wm = jax.jit(lambda p, g, s: j_adamw.adamw_update(
        JTrainConfig(**kw), p, g, s))(jax.tree.map(jnp.asarray, tree),
                                      jax.tree.map(jnp.asarray, grads), jst)
    gp, gst, gm = adamw.adamw_update(
        TrainConfig(**kw), _tree(tree), _tree(grads),
        adamw.AdamWState(torch.tensor(4, dtype=torch.int32), _tree(mu),
                         _tree(nu)))
    assert int(gst.step) == int(wst.step) == 5
    assert _rel(gm["grad_norm"], wm["grad_norm"]) <= 1e-6
    assert _rel(gm["lr"], wm["lr"]) <= 1.2e-7          # 1 ulp
    for got, want in ((gp, wp), (gst.mu, wst.mu), (gst.nu, wst.nu)):
        for g, w in zip(_leaves(got), jax.tree.leaves(want)):
            assert _rel(g, w) <= 1e-5


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_xent_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((3, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) < 0.6).astype(np.float32) if masked else None
    want = j_lm._xent(jnp.asarray(logits), jnp.asarray(labels),
                      None if mask is None else jnp.asarray(mask))
    got = t_lm._xent(torch.tensor(logits), torch.tensor(labels),
                     None if mask is None else torch.tensor(mask))
    assert _rel(got[0], want[0]) <= 1e-6
    assert float(got[1]) == float(want[1])


def test_forward_and_loss_match_jax(model):
    tol = 1e-5 if model["dtype"] == "f32" else 2e-2
    tlm = t_lm.LM(model["tc"])
    params, b = _tree(model["params"]), _tb(model["batch"])
    with torch.no_grad():
        logits, aux = tlm.forward(params, b)
        loss, mets = tlm.loss(params, b)
    assert aux == {} and logits.dtype == torch.float32
    assert _rel(logits, model["logits"]) <= tol
    assert _rel(loss, model["loss"]) <= tol
    assert float(mets["acc"]) == float(model["mets"]["acc"])


def test_value_and_grad_per_leaf(model):
    """``torch.autograd`` through the plain attention against
    ``jax.value_and_grad``, leaf by leaf, with and without remat."""
    tol = 1e-4 if model["dtype"] == "f32" else 3e-2
    tlm = t_lm.LM(model["tc"])
    for remat in (False, True):
        params = _tree(model["params"])
        leaves = [p.requires_grad_() for p in _leaves(params)]
        loss, _ = tlm.loss(params, _tb(model["batch"]), remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        want = jax.tree.leaves(model["grads"])
        assert len(grads) == len(want)
        for (path, _), g, w in zip(tree_paths(params), grads, want):
            assert g.shape == w.shape
            assert _rel(g, w) <= tol, path


# -- the train step and the launcher ---------------------------------------


def _run_steps(dtype, remat, micro, n=3):
    jc, tc = _cfgs(dtype)
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=50,
              num_microbatches=micro, remat_policy=remat)
    jstep = jax.jit(j_steps.make_train_step(j_registry.build(jc),
                                            JTrainConfig(**kw)))
    tstep = steps.make_train_step(registry.build(tc), TrainConfig(**kw))
    js = j_steps.init_train_state(jax.random.key(0), j_registry.build(jc))
    ts = steps.init_train_state(jr.key(0), registry.build(tc))
    for g, w in zip(_leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ds = JDataset(jc.vocab_size, SEQ, BATCH)
    losses, lrs = [], []
    for _ in range(n):
        b = ds.next_batch()
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, tm = tstep(ts, _tb(b))
        losses.append((float(tm["loss"]), float(jm["loss"])))
        lrs.append(float(jm["lr"]))
    return js, ts, losses, sum(lrs)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_train_step_matches_jax(dtype):
    """3 steps without remat, with remat (bitwise the first within the
    port) and with 2 microbatches, each against JAX's jitted step."""
    runs = {}
    for remat, micro in (("none", 1), ("block", 1), ("block", 2)):
        js, ts, losses, lr_sum = _run_steps(dtype, remat, micro)
        runs[(remat, micro)] = ts
        ltol, ptol = (1e-5, 1e-4) if dtype == "f32" else (1e-3, 2 * lr_sum)
        for got, want in losses:
            assert abs(got - want) <= ltol * abs(want), (remat, micro)
        assert int(ts["step"]) == int(js["step"]) == 3
        for g, w in zip(_leaves(ts["params"]), jax.tree.leaves(js["params"])):
            d = float(np.abs(g.numpy() - np.asarray(w)).max())
            assert d <= ptol, (remat, micro, d)
    for a, b in zip(_leaves(runs[("none", 1)]), _leaves(runs[("block", 1)])):
        assert torch.equal(a, b)


_LOSS = re.compile(r"step\s+(\d+)\s+loss ([\d.]+)")


def test_train_launcher_losses_and_bitwise_resume(tmp_path, monkeypatch):
    flags = ["--arch", "olmo_1b", "--smoke", "--steps", "5", "--batch", "4",
             "--seq", "32"]
    monkeypatch.setattr("sys.argv", ["train"] + flags)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        j_train.main()
    want = {int(s): float(v) for s, v in _LOSS.findall(buf.getvalue())}
    rep = {}
    full = train.main(flags + ["--device", "cpu", "--ckpt-dir",
                               str(tmp_path), "--ckpt-every", "1"],
                      report=rep)
    assert len(rep["losses"]) == 5 and set(want) == {0, 4}
    for i, w in want.items():
        assert abs(rep["losses"][i] - w) <= 1e-3 * w
    # a run killed after step 3: its later checkpoints are gone
    for step in (4, 5):
        shutil.rmtree(tmp_path / f"step-{step:08d}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        resumed = train.main(flags + ["--device", "cpu", "--ckpt-dir",
                                      str(tmp_path)], report=rep)
    assert "restored from step 3" in buf.getvalue()
    assert len(rep["losses"]) == 2
    for a, b in zip(_leaves(resumed), _leaves(full)):
        assert torch.equal(a, b)
