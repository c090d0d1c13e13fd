"""RE-SGLD: the port's ``LMEngine`` and ``repex_run --engine lm`` against
the JAX package's, on the CPU, on ``olmo_1b``'s smoke config (bfloat16
compute, what the CLI builds) and a float32 variant of it (``F32``).

  * ``init_state`` bitwise (parameters, zero moments and steps, the
    error-feedback tree);
  * one ``propagate`` step is bitwise the port's functional composition
    (``autograd`` gradient, EF-int8, ``adamw_update``, ``sgld_noise``),
    and a masked replica keeps its state bitwise;
  * ``propagate`` of JAX's jitted engine from the same state and keys
    (float32 variant):
    moments within 1e-4 of max |JAX| (the gradients' float32 rounding,
    seen 1.7e-5), parameters within 2 lr absolute (AdamW's first step is
    lr sign(g) for a gradient far above eps, so the rounding of a
    near-zero gradient element moves it by up to 2 lr; seen 1.5e-5
    against 2e-4), ``energy`` and ``cross_energy`` within 1e-5 of JAX's;
  * ``REMDDriver(LMEngine).run_fused`` makes JAX's decisions over 3
    cycles of 2 steps at R = 4 (the Metropolis margins printed on a
    difference), ``run`` makes them too, and under the "continue"
    policy the driver donates the state (the engine steps it in place):
    ``run_fused`` ends bitwise where ``run`` does, on the leaves it was
    handed, its backup the state; under the relaunch policy it donates
    nothing;
  * ``repex_run --engine lm`` prints the JAX CLI's lines (timings cut);
  * the attention routing: under autograd no flash kernel call, in an
    energy evaluation one per layer; the kernel refuses tensors that
    record a gradient.

The RE-SGLD example's ``--smoke`` preset runs in
``test_torch_examples.py``.
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

from repro.launch import repex_run as j_repex_run
from repro.models import registry as j_registry
from repro.models.lm_engine import LMEngine as JLMEngine
from repro.optim.adamw import lr_schedule as j_lr_schedule
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.core import REMDDriver
from repro_torch.core import exchange as tX
from repro_torch.core import failures as F
from repro_torch.core.ensemble import control_multiset_ok
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import repex_run
from repro_torch.models import layers as TL
from repro_torch.models import registry
from repro_torch.models.lm_engine import LMEngine
from repro_torch.optim import (adamw_update, ef_int8_compress_tree,
                               ef_int8_decompress_tree, sgld_noise)
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_map, tree_paths

F32 = dict(compute_dtype="float32", cache_dtype="float32",
           reduce_dtype="float32")
DTYPES = {"bf16": {}, "f32": F32}
CLI = ["--engine", "lm", "--dims", "temperature:4", "--cycles", "3",
       "--md-steps", "2", "--chunk", "3"]
_TIMING = re.compile(r"\s+t\s+[\d.]+ ms(/cycle)?")


def _cfgs(dtype):
    kw = DTYPES[dtype]
    return (dataclasses.replace(j_registry.get_smoke_config("olmo_1b"), **kw),
            dataclasses.replace(registry.get_smoke_config("olmo_1b"), **kw))


def _leaves(tree):
    return [x for _, x in tree_paths(tree)]


def _state(jstate):
    return convert.lm_train_state_from_arrays(
        jax.tree.map(np.asarray, jstate), "cpu")


def _keys(jkeys):
    return torch.tensor(np.asarray(jax.random.key_data(jkeys))
                        .astype(np.int64))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _lines(text: str):
    return [_TIMING.sub("", ln) for ln in text.splitlines()]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the machine's cores, and many-threaded matmuls in each
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cli():
    """JAX's ``repex_run --engine lm`` on ``CLI``: its printed lines and
    its driver (recorded as the launcher builds it)."""
    made = []

    class Recorder(j_repex_run.REMDDriver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(j_repex_run, "REMDDriver", Recorder)
    mp.setattr("sys.argv", ["repex_run"] + CLI)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            j_repex_run.main()
    finally:
        mp.undo()
    return _lines(buf.getvalue()), made[0]


@pytest.fixture(scope="module")
def port_cli():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        drv = repex_run.main(CLI + ["--device", "cpu"])
    return _lines(buf.getvalue()), drv


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


# -- the engine ------------------------------------------------------------


@pytest.mark.parametrize("compression", [False, True])
def test_init_state_bitwise(compression):
    jc, tc = _cfgs("bf16")
    want = JLMEngine(jc, grad_compression=compression).init_state(
        jax.random.key(7), 3)
    got = LMEngine(tc, grad_compression=compression,
                   device="cpu").init_state(jr.key(7), 3)
    assert sorted(got) == sorted(want)
    assert len(_leaves(got)) == len(jax.tree.leaves(want))
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == convert._lm_leaf(w, "cpu").dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ctrl(temps=(300.0, 350.0)):
    t = np.asarray(temps, np.float32)
    return {"temperature": t, "beta": (1.0 / (0.0019872 * t))
            .astype(np.float32)}


@pytest.mark.parametrize("compression", [False, True])
def test_step_is_the_functional_composition(compression):
    """Replica 0 takes one step, replica 1 is masked (``n_steps`` 0)."""
    _, tc = _cfgs("f32")
    eng = LMEngine(tc, grad_compression=compression, device="cpu")
    state = eng.init_state(jr.key(1), 2)
    ctrl = {k: torch.tensor(v) for k, v in _ctrl().items()}
    rngs = jr.split(jr.key(2), 2)
    out = eng.propagate(state, ctrl, torch.tensor([1, 0]), rngs, max_steps=1)

    def row(tree, r):
        return tree_map(lambda x: x[r], tree)
    params = row(state["params"], 0)
    _, grads = eng._grads(params, eng._batch(state["step"][0]))
    if compression:
        q, scales, err = ef_int8_compress_tree(grads, row(state["err"], 0))
        grads = ef_int8_decompress_tree(q, scales)
        for a, b in zip(_leaves(row(out["err"], 0)), _leaves(err)):
            assert torch.equal(a, b)
    # the update writes in place: hand it copies of the rows
    def copy(tree):
        return tree_map(torch.clone, tree)
    new_p, opt, mets = adamw_update(
        eng.tcfg, copy(params), grads,
        AdamWState(state["step"][0], copy(row(state["mu"], 0)),
                   copy(row(state["nu"], 0))))
    temp = ctrl["temperature"][0] * eng.noise_per_kelvin
    new_p = sgld_noise(jr.fold_in(rngs[0], 0), new_p, mets["lr"], temp)
    for got, want in ((out["params"], new_p), (out["mu"], opt.mu),
                      (out["nu"], opt.nu)):
        for a, b in zip(_leaves(row(got, 0)), _leaves(want)):
            assert torch.equal(a, b)
    assert out["step"].tolist() == [1, 0]
    for a, b in zip(_leaves(row(out, 1)), _leaves(row(state, 1))):
        assert torch.equal(a, b)
    # the functional engine leaves its input alone
    assert int(state["step"][0]) == 0


def test_propagate_and_energies_match_jax():
    """On the float32 variant (the bfloat16 config's energies drive
    ``test_run_fused_makes_jax_decisions``)."""
    jc, tc = _cfgs("f32")
    jeng, teng = JLMEngine(jc), LMEngine(tc, device="cpu")
    js = jeng.init_state(jax.random.key(3), 2)
    ctrl = _ctrl()
    jkeys = jax.random.split(jax.random.key(4), 2)
    jout = jax.jit(lambda s, c, n, k: jeng.propagate(s, c, n, k, 1))(
        js, jax.tree.map(jnp.asarray, ctrl), jnp.asarray([1, 1]), jkeys)
    tctrl = {k: torch.tensor(v) for k, v in ctrl.items()}
    tout = teng.propagate(_state(js), tctrl, torch.tensor([1, 1]),
                          _keys(jkeys), max_steps=1)
    lr = float(j_lr_schedule(jeng.tcfg, jnp.int32(1)))
    for name in ("mu", "nu"):
        for g, w in zip(_leaves(tout[name]), jax.tree.leaves(jout[name])):
            assert _rel(g, w) <= 1e-4, name
    for g, w in zip(_leaves(tout["params"]), jax.tree.leaves(jout["params"])):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 2 * lr
    assert tout["step"].tolist() == [1, 1]
    # energies of one state (JAX's output, converted)
    tol = 1e-5
    st = _state(jout)
    want = jax.jit(jeng.energy)(jout, jax.tree.map(jnp.asarray, ctrl))
    assert _rel(teng.energy(st, tctrl), want) <= tol
    grid = {"beta": np.asarray([1.6, 1.5, 1.4], np.float32)}
    want = jax.jit(jeng.cross_energy)(jout, jax.tree.map(jnp.asarray, grid))
    got = teng.cross_energy(st, {"beta": torch.tensor(grid["beta"])})
    assert got.shape == (2, 3) and _rel(got, want) <= tol


def _preset(cfg_cls):
    """The float32 smoke preset of the RE-SGLD example (2 layers, d_model
    128, vocab 2048), the model ``chip_smoke.py`` phase 34b runs."""
    return cfg_cls(name="pt-smoke", n_layers=2, d_model=128, n_heads=4,
                   n_kv_heads=4, d_ff=512, vocab_size=2048, **F32)


def test_smoke_preset_gradient_matches_jax():
    """One replica's gradient on the example's float32 smoke preset (B 8,
    S 64, pool batch 0), the port's ``_grads`` against JAX's
    ``value_and_grad``, per leaf within 1e-4 of max |JAX| (both float32,
    summed in other orders; seen 6.6e-5 in the worst leaf, wk).  The
    card's gradient is held against the CPU's on the same preset."""
    from repro.config import ModelConfig as JModelConfig
    from repro_torch.config import ModelConfig
    kw = dict(batch_size=8, seq_len=64, pool_batches=16)
    jeng = JLMEngine(_preset(JModelConfig), **kw)
    eng = LMEngine(_preset(ModelConfig), device="cpu", **kw)
    jstate = jeng.init_state(jax.random.key(0), 1)
    params = tree_map(lambda x: x[0], _state(jstate)["params"])
    _, grads = eng._grads(params, eng._batch(
        torch.zeros((), dtype=torch.int32)))
    (_, _), jgrads = jax.jit(jax.value_and_grad(jeng.lm.loss, has_aux=True))(
        jax.tree.map(lambda x: x[0], jstate["params"]),
        jax.tree.map(lambda x: x[0], jeng.pool))
    errs = {"/".join(path): _rel(g, w) for (path, g), w in
            zip(tree_paths(grads), jax.tree.leaves(jgrads))}
    print("gradient port vs JAX, max |diff| / max |jax|:", errs)
    assert len(errs) == len(jax.tree.leaves(jgrads))
    assert max(errs.values()) <= 1e-4, errs


def test_is_failed():
    _, tc = _cfgs("bf16")
    eng = LMEngine(tc, grad_compression=True, device="cpu")
    state = eng.init_state(jr.key(0), 3)
    assert eng.is_failed(state).tolist() == [False] * 3
    state["nu"]["layers"]["mlp"]["w_up"][1, 0, 2, 5] = float("inf")
    state["err"]["embed"][2, 7, 1] = float("nan")
    assert eng.is_failed(state).tolist() == [False, True, True]


# -- the driver and the CLI ------------------------------------------------


def test_run_fused_makes_jax_decisions(jax_cli, port_cli, monkeypatch):
    """The CLI's run_fused (3 cycles of 2 steps, R = 4, one chunk) on
    both packages; then the port's ``run`` from the same seed, and
    ``run_fused`` under the "continue" policy, which donates the state."""
    _, jdrv = jax_cli
    _, tdrv = port_cli
    seen = []
    orig = tX.metropolis

    def spy(delta, rng):
        seen.append((delta.clone(), tX.jr.uniform(rng, tuple(delta.shape))))
        return orig(delta, rng)

    jrows, trows = _rows(jdrv), _rows(tdrv)
    if not np.array_equal(jrows, trows):
        # replay the port's run to read the margins of its sweeps
        monkeypatch.setattr(tX, "metropolis", spy)
        drv = REMDDriver(tdrv.engine, tdrv.cfg, device="cpu")
        drv.run_fused(drv.init(), chunk_cycles=3)
        c = int(np.nonzero((jrows != trows).any(axis=1))[0][0])
        delta, u = seen[c]
        margin = torch.abs(u - torch.exp(torch.clamp_max(-delta, 0.0)))
        pytest.fail(f"assignment differs first at cycle {c}: jax "
                    f"{jrows[c]}, port {trows[c]}; Metropolis margins "
                    f"{margin.tolist()}")
    assert tdrv.acceptance_ratios() == jdrv.acceptance_ratios()
    assert len(tdrv.history) == 3

    cfg = tdrv.cfg
    run_drv = REMDDriver(tdrv.engine, cfg, device="cpu")
    run_out = run_drv.run(run_drv.init())
    assert np.array_equal(_rows(run_drv), trows)
    assert control_multiset_ok(run_out)

    assert not run_drv._donate          # the relaunch policy's backup
    cont = dataclasses.replace(cfg, relaunch_failed=False)
    drv = REMDDriver(tdrv.engine, cont, device="cpu")
    assert drv._donate
    ens0 = drv.init()
    handed = _leaves(ens0.state)
    out = drv.run_fused(ens0, chunk_cycles=3)
    assert np.array_equal(_rows(drv), trows)
    for a, b, h in zip(_leaves(out.state), _leaves(run_out.state), handed):
        assert torch.equal(a, b) and a is h
    # under "continue" the backup carry keeps the state's own leaves
    ens, backup, _ = F.detect_recover(tdrv.engine, out, "continue",
                                      out.state)
    assert all(a is b for a, b in zip(_leaves(backup), _leaves(ens.state)))


def test_repex_run_lm_prints_jax_lines(jax_cli, port_cli):
    jlines, _ = jax_cli
    tlines, tdrv = port_cli
    assert tlines == jlines
    assert "multiset ok: True" in tlines
    assert isinstance(tdrv.engine, LMEngine)
    assert tdrv.engine.cfg == registry.get_smoke_config("olmo_1b")


# -- the attention routing -------------------------------------------------


def test_autograd_never_reaches_the_flash_kernel(monkeypatch):
    """With the kernel route forced on (as on the card) and the kernel
    replaced by a recording stub: a ``loss.backward()`` calls no kernel
    and gives every leaf a gradient; an energy evaluation calls it once
    per layer and per replica."""
    calls = []

    def stub(q, k, v, **kw):
        assert not (torch.is_grad_enabled() and q.requires_grad)
        calls.append(q.shape)
        return fa_ref.attention(q, k, v, **kw)

    monkeypatch.setattr(TL, "default_use_kernel", lambda t: True)
    monkeypatch.setattr(fa_ops, "default_use_kernel", lambda t: True)
    monkeypatch.setattr(fa_ops, "flash_attention_kernel", stub)
    _, tc = _cfgs("f32")
    eng = LMEngine(tc, device="cpu")
    state = eng.init_state(jr.key(0), 2)
    params = tree_map(lambda x: x[0].clone().requires_grad_(),
                      state["params"])
    loss, _ = eng.lm.loss(params, eng._batch(state["step"][0]))
    loss.backward()
    assert calls == []
    for path, p in tree_paths(params):
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), path
    for name in ("wq", "wk", "wv"):
        assert bool(params["layers"]["attn"][name].grad[0].abs().sum() > 0)
    eng.energy(state, {"beta": torch.ones(2)})
    assert len(calls) == 2 * tc.n_layers


def test_flash_kernel_refuses_tensors_that_record_a_gradient():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention_kernel(q, k, k)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_kernel(q, k, k)
