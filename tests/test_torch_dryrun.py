"""``repro_torch.launch.dryrun`` against the JAX package's
``repro/launch/dryrun.py``, on the CPU.

The JAX module is never imported here: it sets ``XLA_FLAGS`` to 512 host
devices when imported, which would leak into every JAX child process a
later test starts.  Its ``TRAIN_OVERRIDES`` and its serving KV-replication
condition are read from its source with ``ast``.

  * ``TRAIN_OVERRIDES`` equals JAX's; ``serve_config``'s replication
    equals the one JAX's condition gives on JAX's own configs, for the
    10 archs x 4 cells;
  * ``argument_size_in_bytes`` (one device's shard bytes of the inputs)
    equals the shard bytes of JAX's abstract trees
    (``steps.abstract_train_state``, ``abstract_params_for_serve``,
    ``abstract_decode_state``, ``batch_shardings``) on JAX abstract
    meshes, exactly, for every arch x applicable cell x {16x16, 2x16x16};
  * the smoke configs of the dense and hybrid families trace OK at a
    small cell on a fake (2, 4) mesh (here) and (2, 2, 2) mesh
    (``test_torch_dryrun_mp.py``), the encdec and vlm families' on both
    (``test_torch_dryrun_frontends.py``, ``_frontends_mp.py``; split so
    each file stays under a minute), for the three step kinds, with
    every key present, and OLMo-1B's ``decode_32k`` at full width on
    the 16x16 mesh traces in under 10 s
    with the FLOPs and cache bytes its shapes give (a child process: a
    process group of the pytest process would refuse the fake world);
  * skips carry JAX's reason; a planted failure records ``ok: False``,
    its error and traceback and leaves ``shardctx`` cleared; ``--force``
    re-runs a cached cell; ``main`` exits 1 on a failure.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import config as j_config
from repro import sharding as j_shd
from repro.launch import steps as j_steps
from repro.models import registry as j_registry
from repro_torch import config
from repro_torch.launch import dryrun
from repro_torch.models import registry, shardctx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
JAX_DRYRUN = os.path.join(SRC, "repro", "launch", "dryrun.py")
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_source():
    with open(JAX_DRYRUN) as f:
        return ast.parse(f.read())


def _jax_train_overrides():
    for node in ast.walk(_jax_source()):
        if isinstance(node, ast.AnnAssign) and getattr(
                node.target, "id", None) == "TRAIN_OVERRIDES":
            return ast.literal_eval(node.value)
    raise AssertionError("TRAIN_OVERRIDES not found")


def _jax_kv_condition():
    """The test of the ``if`` in ``lower_cell`` that sets
    ``kv_replicate_to``, compiled to evaluate on (cell, cfg, tp,
    registry)."""
    for node in ast.walk(_jax_source()):
        if isinstance(node, ast.If) and "kv_replicate_to" in ast.unparse(
                node.body):
            return compile(ast.Expression(node.test), JAX_DRYRUN, "eval")
    raise AssertionError("the replication condition not found")


def _jax_serve_config(jcfg, cell, cond):
    if eval(cond, {"cell": cell, "cfg": jcfg, "tp": 16,
                   "registry": j_registry}):
        return dataclasses.replace(jcfg, kv_replicate_to=16)
    return jcfg


def test_train_overrides_are_jax():
    assert dryrun.TRAIN_OVERRIDES == _jax_train_overrides()


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_kv_replication_is_jax(arch):
    cond = _jax_kv_condition()
    seen = set()
    for jcell, cell in zip(j_config.SHAPE_CELLS, config.SHAPE_CELLS):
        want = _jax_serve_config(j_registry.get_config(arch), jcell,
                                 cond).kv_replicate_to
        got = dryrun.serve_config(registry.get_config(arch),
                                  cell).kv_replicate_to
        assert got == want, (arch, cell.name)
        seen.add(got)
    if arch in ("olmo_1b", "internvl2_26b"):
        # olmo's 16 kv heads need none; internvl2's 8 replicate to 16
        assert seen == ({0} if arch == "olmo_1b" else {0, 16})


# --- argument bytes against JAX's abstract trees -------------------------------


def _shard_bytes(leaves) -> int:
    total = 0
    for x in leaves:
        shape = (x.sharding.shard_shape(x.shape)
                 if getattr(x, "sharding", None) is not None else x.shape)
        total += int(np.prod(shape, dtype=np.int64)) * jnp.dtype(
            x.dtype).itemsize
    return total


def _jax_argument_bytes(arch, jcell, multi_pod, cond) -> int:
    """The shard bytes of the inputs JAX's ``lower_cell`` lowers."""
    jcfg = _jax_serve_config(j_registry.get_config(arch), jcell, cond)
    lm = j_registry.build(jcfg)
    mesh = AbstractMesh(*MESHES[multi_pod])
    specs = j_registry.input_specs(jcfg, jcell)

    def batch(batch_axes=None):
        sh = j_steps.batch_shardings(specs, mesh, multi_pod,
                                     batch_axes=batch_axes)
        return [jax.ShapeDtypeStruct(specs[k].shape, specs[k].dtype,
                                     sharding=sh[k]) for k in specs]
    if jcell.kind == "train":
        rules, batch_axes, _ = j_shd.pick_train_rules(jcfg.n_heads,
                                                      multi_pod)
        return (_shard_bytes(jax.tree.leaves(
            j_steps.abstract_train_state(lm, mesh, rules)))
            + _shard_bytes(batch(batch_axes)))
    if jcell.kind == "prefill":
        rules = j_shd.serve_rules_for(jcfg, multi_pod, decode=False)
        return (_shard_bytes(jax.tree.leaves(
            j_steps.abstract_params_for_serve(lm, mesh, rules)))
            + _shard_bytes(batch()))
    rules = j_shd.serve_rules_for(jcfg, multi_pod, decode=True)
    if jcell.global_batch == 1:
        rules = dict(rules)
        rules["batch"] = ((),)
    state = j_steps.abstract_decode_state(lm, jcell.global_batch,
                                          jcell.seq_len, mesh, rules)
    state["index"] = jax.ShapeDtypeStruct((), jnp.int32)
    return (_shard_bytes(jax.tree.leaves(
        j_steps.abstract_params_for_serve(lm, mesh, rules)))
        + _shard_bytes(jax.tree.leaves(state))
        + _shard_bytes([b for b in batch()]))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_argument_bytes_are_jax(arch):
    cond = _jax_kv_condition()
    n = 0
    for jcell, cell in zip(j_config.SHAPE_CELLS, config.SHAPE_CELLS):
        if registry.applicable(registry.get_config(arch), cell):
            continue
        for multi_pod in (False, True):
            mesh = dict(zip(*reversed(MESHES[multi_pod])))
            setup = dryrun.setup_cell(arch, cell, mesh)
            assert dryrun.argument_bytes(setup) == _jax_argument_bytes(
                arch, jcell, multi_pod, cond), (cell.name, multi_pod)
            n += 1
    assert n == (8 if registry.get_config(arch).subquadratic else 6)


# --- traced cells (a child process: the fake world) ---------------------------

# the dense and hybrid families here and in test_torch_dryrun_mp.py, the
# encdec and vlm families in test_torch_dryrun_frontends{,_mp}.py
SMOKE_ARCHS = ("olmo_1b", "recurrentgemma_9b")
FRONTEND_ARCHS = ("whisper_small", "internvl2_26b")

_TRACE = r"""
import json, sys, time
sys.path.insert(0, SRC)
import torch
torch.set_num_threads(1)
from repro_torch.config import SHAPE_CELLS, ShapeCell
from repro_torch.launch import dryrun
from repro_torch.models import registry

out = {}
for arch in SMOKE_ARCHS:
    cfg = registry.get_smoke_config(arch)
    extra = cfg.n_image_tokens if cfg.family == "vlm" else 0
    for cell in (ShapeCell("train_s", "train", 16 + extra, 8),
                 ShapeCell("prefill_s", "prefill", 16 + extra, 4),
                 ShapeCell("decode_s", "decode", 16, 4)):
        r = dryrun.lower_cell(arch, cell, "pod" in MESH, cfg=cfg,
                              mesh_shape=MESH)
        out[f"{arch}/{cell.kind}"] = r
if FULL:
    cell = next(c for c in SHAPE_CELLS if c.name == "decode_32k")
    t0 = time.perf_counter()
    out["full"] = dryrun.lower_cell("olmo_1b", cell, False)
    out["full_wall"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def trace_in_child(mesh: dict, full: bool, archs=SMOKE_ARCHS) -> dict:
    """The smoke cells of ``archs`` traced on a fake ``mesh`` (and
    OLMo-1B's ``decode_32k`` at full width when ``full``), in a child
    process."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = (f"SRC = {SRC!r}\nSMOKE_ARCHS = {archs!r}\n"
            f"MESH = {mesh!r}\nFULL = {full!r}\n"
            + textwrap.dedent(_TRACE))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


KEYS = {"arch", "cell", "mesh", "devices", "ok", "t_trace_s", "memory",
        "flops_per_device", "write_bytes_per_device", "collectives"}
MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
          "alias_size_in_bytes", "temp_size_in_bytes"}


def check_smoke_cells(traced: dict, arch: str, mesh: str) -> None:
    for kind in ("train", "prefill", "decode"):
        r = traced[f"{arch}/{kind}"]
        assert r["ok"] is True and set(r) == KEYS, kind
        assert r["mesh"] == mesh and r["devices"] == 8
        assert set(r["memory"]) == MEMORY
        assert set(r["collectives"]) == {"bytes_by_kind", "counts",
                                         "total_bytes"}
        assert r["flops_per_device"] > 0
        assert r["write_bytes_per_device"] > 0
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] > 0
        # the train step and decode write their state back in place
        if kind == "prefill":
            assert mem["alias_size_in_bytes"] == 0
        else:
            assert 0 < mem["alias_size_in_bytes"] \
                <= mem["argument_size_in_bytes"]
        coll = r["collectives"]
        assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values())


@pytest.fixture(scope="module")
def traced():
    return trace_in_child({"data": 2, "model": 4}, full=True)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_cells_trace(traced, arch):
    check_smoke_cells(traced, arch, "2x4")


def test_full_width_decode_cell(traced):
    r = traced["full"]
    assert r["ok"] is True and r["mesh"] == "16x16" and r["devices"] == 256
    # OLMo-1B decode at B 128 (8 a data rank), cache 32,768, one of 16
    # heads a model rank: the projections, the attention against the
    # cache and the unembedding's vocab shard
    d, hd, f, layers, v = 2048, 128, 8192 // 16, 16, 50304 // 16
    b, t = 8, 32768
    per_layer = (3 * 2 * b * d * hd + 2 * b * hd * d + 3 * 2 * b * d * f
                 + 2 * 2 * b * t * hd)
    assert r["flops_per_device"] == layers * per_layer + 2 * b * d * v
    assert r["memory"]["alias_size_in_bytes"] == (
        2 * layers * b * t * hd * 2)                   # k, v: bf16 shards
    assert traced["full_wall"] < 10


# --- skips, failures, the cache, main ---------------------------------------------


def test_skips_carry_jax_reason(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    n = 0
    for arch in registry.ARCH_IDS:
        for jcell, cell in zip(j_config.SHAPE_CELLS, config.SHAPE_CELLS):
            want = j_registry.applicable(j_registry.get_config(arch), jcell)
            assert registry.applicable(registry.get_config(arch),
                                       cell) == want
            if want:
                r = dryrun.run_cell(arch, cell.name, False)
                assert r["skipped"] == want and r["ok"] is None
                assert dryrun.status_line(r).startswith("[SKIP]")
                n += 1
    assert n == 8          # long_500k of the eight full-attention archs


def test_failure_is_recorded_and_clears_shardctx(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    calls = []

    def planted(arch, cell, multi_pod, **kw):
        calls.append(arch)
        shardctx.set_activation_sharding(("data",), "model",
                                         {"data": 16, "model": 16})
        raise RuntimeError("planted: no sharding strategy for aten.planted")
    monkeypatch.setattr(dryrun, "lower_cell", planted)
    r = dryrun.run_cell("olmo_1b", "train_4k", False)
    assert r["ok"] is False and r["mesh"] == "16x16"
    assert r["error"].startswith("RuntimeError: planted")
    assert "planted" in r["traceback"]
    assert shardctx._BATCH_AXES is None and shardctx._AXIS_SIZES == {}
    # cached: no second trace; --force traces again
    assert dryrun.run_cell("olmo_1b", "train_4k", False) == r
    assert len(calls) == 1
    dryrun.run_cell("olmo_1b", "train_4k", False, force=True)
    assert len(calls) == 2
    assert os.path.exists(tmp_path / "olmo_1b__train_4k__sp.json")
    assert dryrun.main(["--arch", "olmo_1b", "--cell", "train_4k",
                        "--force"]) == 1
    assert len(calls) == 3
    assert dryrun.main(["--arch", "olmo_1b", "--cell", "long_500k"]) == 0
