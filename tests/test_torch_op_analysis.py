"""``repro_torch.launch.op_analysis`` against the JAX package's
``repro/launch/hlo_analysis.py``, on the CPU.

  * FLOP parity: for each family's smoke config (olmo, deepseek-moe,
    deepseek-v2-lite, recurrentgemma, xlstm, whisper, internvl2) and each
    of train / prefill / decode at a small cell (B 2, S 16) on one
    device, the port's ``analyze(step, ...)["flops"]`` against
    ``hlo_analysis.analyze(jax.jit(step).lower(...).compile().as_text())``.
    Exact, after the family differences below, each counted from the
    configs (decode here; train and prefill in
    ``test_torch_op_analysis_{train,prefill}.py``, which import these
    helpers, so each file stays under a minute):
      - train, every family: JAX picks the label logit by a one-hot
        contraction, a ``dot`` of 2 B S V; the port's one-hot sum is
        elementwise (``lm._xent``);
      - MLA (deepseek-v2-lite), prefill and train: JAX pads v to the
        q/k head dim for its attention and slices the output, so its
        probs @ v is 2 B H S^2 (Dqk - Dv) a layer wider; train runs it
        four times (the forward, its remat, the two backward products);
      - xLSTM: JAX contracts the normaliser q . n (``"bhk,bhk->bh"``,
        2 B H dk a block and step), the closed form's n
        (``"bsh,bshk->bhk"``) and its weighting of k as ``dot``s, where
        the port multiplies and sums, so xLSTM is held within XLSTM_REL
        of JAX's count (the rest: those small contractions).  Prefill
        computes each mLSTM block's q, k, v, i, f projections once for
        ``mlstm_parallel`` and ``mlstm_final_state``, as XLA's CSE
        merges JAX's two, so nothing is taken out for them.
  * per-device FLOPs: on ``fake_world(256)``'s 16x16 mesh, a (4, 4096,
    2048) local block sharded on batch times a (2048, 512) local block
    sharded on columns counts 2 * 4 * 4096 * 2048 * 512 = 3.44e10, the
    local product (the DTensors' global product is 1.41e14);
  * collectives on a fake (data 2, model 4) mesh under JAX's names: a
    product whose operands are sharded on the same mesh dim along the
    contraction of one and the columns of the other makes one
    all-gather with its per-device bytes; Partial -> Replicate one
    all-reduce of the local bytes;
  * ``count_ops``: views and bookkeeping skipped, a 100-trip Python loop
    counted 100 times; ``op_count`` / ``op_budget_check``;
  * ``collective_budget`` equals ``WireCensus.budget()`` (the driver's
    wire ledger) on one chunk of a two-rank gloo ``run_sharded``.

The fake-world checks run in a child process: a process group of the
pytest process (another test's one-rank group) would refuse the fake
one.  One torch thread, so the file stays well under a minute.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import config as j_config
from repro.launch import hlo_analysis as j_hlo
from repro.launch import steps as j_steps
from repro.models import params as j_params
from repro.models import registry as j_registry
from repro_torch import config
from repro_torch.launch import op_analysis
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.tree import tree_map

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

FAMILIES = ("olmo_1b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
            "recurrentgemma_9b", "xlstm_1_3b", "whisper_small",
            "internvl2_26b")
B, S = 2, 16
XLSTM_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- FLOP parity with JAX ----------------------------------------------------


def _jax_flops(jcfg, kind, seq):
    jlm = j_registry.build(jcfg)

    def sds(defs, dtype=None):
        return jax.tree.map(
            lambda d: jax.ShapeDtypeStruct(
                d.shape, dtype if dtype is not None
                and jnp.issubdtype(d.dtype, jnp.floating) else d.dtype),
            defs, is_leaf=j_params.is_def)

    def batch(k):
        specs = j_registry.input_specs(
            jcfg, j_config.ShapeCell("c", k, seq, B))
        return {n: jax.ShapeDtypeStruct(v.shape, v.dtype)
                for n, v in specs.items()}
    if kind == "train":
        step = j_steps.make_train_step(jlm, j_config.TrainConfig())
        args = (sds(j_steps.make_train_state_defs(jlm)), batch("train"))
    elif kind == "prefill":
        step = j_steps.make_prefill_step(jlm, cache_len=seq)
        args = (sds(jlm.param_defs(), jnp.bfloat16), batch("prefill"))
    else:
        step = j_steps.make_decode_step(jlm)
        state = sds(jlm.decode_state_defs(B, seq))
        state["index"] = jax.ShapeDtypeStruct((), jnp.int32)
        args = (sds(jlm.param_defs(), jnp.bfloat16), state,
                jax.ShapeDtypeStruct((B, 1), jnp.int32))
    text = jax.jit(step).lower(*args).compile().as_text()
    return j_hlo.analyze(text)["flops"]


def _draw(defs, gen, dtype=None):
    def one(d):
        if not d.dtype.is_floating_point:
            return torch.zeros(d.shape, dtype=d.dtype)
        x = torch.randn(d.shape, generator=gen) * 0.02
        return x.to(dtype or d.dtype)
    return tree_map(one, defs)


def _batch(cfg, kind, seq, gen):
    specs = registry.input_specs(cfg, config.ShapeCell("c", kind, seq, B))
    return {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                              dtype=v.dtype)
                if v.dtype == torch.int32
                else torch.randn(v.shape, generator=gen, dtype=v.dtype))
            for k, v in specs.items()}


def _port_flops(cfg, kind, seq):
    lm = registry.build(cfg)
    gen = torch.Generator().manual_seed(0)
    if kind == "train":
        step = steps.make_train_step(lm, config.TrainConfig())
        args = (_draw(steps.make_train_state_defs(lm), gen),
                _batch(cfg, "train", seq, gen))
    elif kind == "prefill":
        step = steps.make_prefill_step(lm, cache_len=seq)
        args = (_draw(lm.param_defs(), gen, torch.bfloat16),
                _batch(cfg, "prefill", seq, gen))
    else:
        step = steps.make_decode_step(lm)
        state = _draw(lm.decode_state_defs(B, seq), gen)
        state["index"] = torch.tensor(seq // 2, dtype=torch.int32)
        args = (_draw(lm.param_defs(), gen, torch.bfloat16), state,
                torch.zeros((B, 1), dtype=torch.int32))
    return op_analysis.analyze(step, *args)["flops"]


def _family_difference(cfg, kind, seq) -> float:
    """JAX's count minus the port's from the differences the module
    docstring lists (xLSTM's contractions aside)."""
    diff = 0.0
    if kind == "train":
        text = seq - (cfg.n_image_tokens if cfg.family == "vlm" else 0)
        diff += 2 * B * text * cfg.vocab_size
    if cfg.attention == "mla" and kind != "decode":
        m = cfg.mla
        dqk = m.qk_nope_dim + m.qk_rope_dim
        per_layer = 2 * B * cfg.n_heads * seq * seq * (dqk - m.v_head_dim)
        diff += per_layer * cfg.n_layers * (4 if kind == "train" else 1)
    return diff


def check_flops(arch, kind):
    jcfg, tcfg = j_registry.get_smoke_config(arch), \
        registry.get_smoke_config(arch)
    seq = S + (tcfg.n_image_tokens if tcfg.family == "vlm" else 0)
    want = _jax_flops(jcfg, kind, seq)
    got = _port_flops(tcfg, kind, seq) + _family_difference(tcfg, kind, seq)
    assert got > 0
    if tcfg.family == "ssm":
        assert abs(got - want) <= XLSTM_REL * want, (got, want)
    else:
        assert got == want, (got, want, got - want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_flops_match_jax(arch):
    check_flops(arch, "decode")


# --- op census ------------------------------------------------------------------


def test_count_ops_skips_views_and_counts_every_trip():
    x = torch.ones(4, 8)

    def views(t):
        v = t.view(8, 4).t()[0].reshape(-1)
        return v.detach() * 2

    assert op_analysis.count_ops(views, x) == {"mul": 1}

    def loop(t):
        for _ in range(100):
            t = t + 1
        return t

    census = op_analysis.count_ops(loop, x)
    assert census == {"add": 100}
    total, c2 = op_analysis.op_count(loop, x)
    assert total == 100 and c2 == census
    assert op_analysis.op_budget_check(loop, x, budget=100)[0]
    ok, total, _ = op_analysis.op_budget_check(loop, x, budget=99)
    assert not ok and total == 100


class _StubDriver:
    """A graph of node kinds by id, read as ``op_analysis._Driver`` reads
    a captured CUDA graph: ``graphs`` maps a graph to its nodes, a node
    to its ``CUgraphNodeType``, ``children`` a child-graph node to its
    graph."""

    def __init__(self, graphs, kinds, children):
        self.graphs, self.kinds, self.children = graphs, kinds, children

    def nodes(self, graph):
        return self.graphs[graph]

    def kind(self, node):
        return self.kinds[node]

    def child(self, node):
        return self.children[node]


def test_graph_node_count_sorts_kinds_and_enters_child_graphs():
    """``count_launches`` counts the kernel nodes of a captured CUDA
    graph, memset and memcpy nodes apart, a child graph's nodes where it
    stands (CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset, 4 child
    graph, 5 empty, 7 event record)."""
    drv = _StubDriver({1: [10, 11, 12, 13, 14, 15], 2: [20, 21, 22]},
                      {10: 0, 11: 0, 12: 2, 13: 1, 14: 4, 15: 5,
                       20: 0, 21: 7, 22: 2},
                      {14: 2})
    assert op_analysis.count_nodes(drv, 1) == {
        "kernel": 3, "memcpy": 1, "memset": 2, "other": 2}


def test_count_launches_needs_a_capture(monkeypatch):
    """No CUDA, no count: the graph count raises rather than fall back
    to another reading (the profiler's sessions lost kernels)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        op_analysis.count_launches(lambda: torch.ones(3) + 1)


def test_analyze_counts_dots_writes_and_peak():
    a, b = torch.ones(3, 5), torch.ones(5, 7)

    def fn(a, b):
        return torch.relu(a @ b).sum()

    r = op_analysis.analyze(fn, a, b)
    assert r["flops"] == 2 * 3 * 7 * 5
    # mm (3, 7), relu (3, 7), sum (): float32
    assert r["write_bytes"] == 4 * (21 + 21 + 1)
    assert r["peak_bytes"] >= 4 * 21
    assert r["collective_total"] == 0 and r["collective_counts"] == {}


# --- the fake world: per-device flops, collectives ------------------------------

_FAKE_WORLD = r"""
import json, sys
sys.path.insert(0, SRC)
import torch
torch.set_num_threads(1)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import fake_world, make_host_mesh, \
    make_production_mesh

out = {}
fake = FakeTensorMode()
with fake_world(256):
    mesh = make_production_mesh(device="cpu")
    out["mesh"] = [list(mesh.shape), list(mesh.mesh_dim_names)]
    with fake:
        x, w = torch.empty(4, 4096, 2048), torch.empty(2048, 512)
    xd = DTensor.from_local(x, mesh, [Shard(0), Replicate()],
                            run_check=False)
    wd = DTensor.from_local(w, mesh, [Replicate(), Shard(1)],
                            run_check=False)
    out["flops"] = op_analysis.analyze(lambda a, b: a @ b, xd, wd)["flops"]
with fake_world(512):
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    out["mesh_mp"] = [list(mesh.shape), list(mesh.mesh_dim_names)]
with fake_world(8):
    mesh = make_host_mesh(2, 4, device="cpu")
    with fake:
        a, b = torch.empty(8, 4), torch.empty(16, 6)
        p = torch.empty(3, 5)
    # a's contracted dim and b's columns on the same mesh dim ("model")
    ad = DTensor.from_local(a, mesh, [Replicate(), Shard(1)],
                            run_check=False)
    bd = DTensor.from_local(b, mesh, [Replicate(), Shard(1)],
                            run_check=False)
    r = op_analysis.analyze(lambda u, v: u @ v, ad, bd)
    out["gather"] = [r["collective_counts"], r["collective_bytes"]]
    pd = DTensor.from_local(p, mesh, [Replicate(), Partial()],
                            run_check=False)
    r = op_analysis.analyze(
        lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), pd)
    out["reduce"] = [r["collective_counts"], r["collective_bytes"]]
try:
    with fake_world(2):
        with fake_world(2):
            pass
except RuntimeError as e:
    out["nested"] = str(e)[:40]
import torch.distributed as dist
out["after"] = dist.is_initialized()
print(json.dumps(out))
"""


def _child(code: str, timeout: int = 120) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c",
                           f"SRC = {SRC!r}\n" + textwrap.dedent(code)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_world_run():
    return _child(_FAKE_WORLD)


def test_production_meshes(fake_world_run):
    assert fake_world_run["mesh"] == [[16, 16], ["data", "model"]]
    assert fake_world_run["mesh_mp"] == [[2, 16, 16],
                                         ["pod", "data", "model"]]
    assert fake_world_run["nested"].startswith("fake_world: a process")
    assert fake_world_run["after"] is False


def test_flops_are_per_device(fake_world_run):
    assert fake_world_run["flops"] == 2 * 4 * 4096 * 2048 * 512 == 34359738368


def test_collectives_have_jax_names_and_per_device_bytes(fake_world_run):
    counts, nbytes = fake_world_run["gather"]
    assert counts == {"all-gather": 1}
    # one operand's model-sharded dim gathered: a (8, 16) or (16, 24)
    # float32 block
    assert nbytes["all-gather"] in (8 * 16 * 4, 16 * 24 * 4)
    assert fake_world_run["reduce"] == [{"all-reduce": 1},
                                        {"all-reduce": 3 * 5 * 4}]


# --- collective_budget is the wire ledger ----------------------------------------

_GLOO = r"""
import json, os, sys
sys.path.insert(0, SRC)
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import sharding as S
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.md import HarmonicEngine

rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method="file://" + INIT, rank=rank,
                        world_size=2)
mesh = make_replica_mesh(2, device="cpu")
K = 3


def driver():
    return REMDDriver(HarmonicEngine(device="cpu"),
                      RepExConfig(dimensions=(("temperature", 8),),
                                  md_steps_per_cycle=2, n_cycles=K),
                      device="cpu")


d = driver()
d.run_sharded(d.init(1), mesh=mesh, chunk_cycles=K)
ledger = d.last_wire.budget()
d = driver()
ens = S.shard_ensemble(d.init(1), mesh)
backup, fail_key = d._start_carry(ens)
backup = S.shard_state(backup, mesh, d.grid.n_ctrl)
got = op_analysis.collective_budget(d._chunk, ens, backup, fail_key, K, mesh)
ens = S.shard_ensemble(d.init(1), mesh)
backup, fail_key = d._start_carry(ens)
backup = S.shard_state(backup, mesh, d.grid.n_ctrl)
shapes = op_analysis.collective_shapes(d._chunk, ens, backup, fail_key, K,
                                       mesh)
dist.destroy_process_group()
print(json.dumps({"ledger": ledger, "got": got, "shapes": shapes}))
"""


def test_collective_budget_is_the_wire_ledger(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="2")
    code = (f"SRC = {SRC!r}\nINIT = {str(tmp_path / 'pg')!r}\n"
            + textwrap.dedent(_GLOO))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=120)
        assert p.returncode == 0, se[-3000:]
        outs.append(json.loads(so.strip().splitlines()[-1]))
    for o in outs:
        assert o["ledger"] and o["got"] == o["ledger"]
        for op, b in o["ledger"].items():
            rows = [s for s in o["shapes"] if s["op"] == op]
            assert len(rows) == b["count"]
            assert sum(s["bytes"] for s in rows) == b["bytes"]
    assert outs[0]["ledger"] == outs[1]["ledger"]
