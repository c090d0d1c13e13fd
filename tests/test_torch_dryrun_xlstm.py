"""The dry run of the ssm family (xLSTM), whose cells need three routes of
``models/shardctx.py`` on DTensors:

  * ``log_sigmoid``: the mLSTM's and sLSTM's forget gates on each rank's
    shard, forward and backward (DTensor has no strategy for
    ``log_sigmoid_backward``);
  * ``merged``: the group norm's head merge, whose backward splits the
    gradient's width again, made whole first where its split does not
    divide the heads (on the (2, 2, 4) mesh below the width is split 16
    ways into 2 heads; on xLSTM-1.3B's 2x16x16, 512 ways into 4);
  * ``recur_locally``: the sLSTM's time loop on each rank's plain shards
    (the step's 17 ops a step through DTensor's placement propagation
    took a 32,768-step prefill past the dry run's time limit); in a
    fake trace that records no gradient the loop is one step weighted
    by its trips (``recurrent._slstm_loop_weighted``), whose counts and
    peak equal the unrolled loop's; in a train trace the loop runs
    unrolled on meta twins of its inputs (``op_analysis.on_meta``),
    counted as on the fake tensors, without FakeTensor's dispatch.

xlstm-smoke's train, prefill and decode cells trace OK on a fake (2, 4)
mesh and on a fake (2, 2, 4) multi-pod mesh, each in a child process (a
process group of the pytest process would refuse the fake world); on
the (2, 2, 4) mesh the train cell fails without ``merged``, and the
sLSTM loop sees plain tensors, one loop a block and pass.  On plain
tensors each route is the plain op.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.nn.functional as F

from repro_torch.models import recurrent as R
from repro_torch.models import shardctx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESHES = {"2x4": {"data": 2, "model": 4},
          "2x2x4": {"pod": 2, "data": 2, "model": 4}}
SEQ = 16

_TRACE = r"""
import json, sys
sys.path.insert(0, SRC)
import torch
torch.set_num_threads(1)
from repro_torch.config import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.models import recurrent as R
from repro_torch.models import registry, shardctx

cfg = registry.get_smoke_config("xlstm_1_3b")
loops = []
plain_loop = getattr(R, "_slstm_loop", None)


def recording_loop(z, r):
    loops.append([type(z).__name__, type(r).__name__, z.shape[0]])
    return plain_loop(z, r)


def trace(cell):
    try:
        return dryrun.lower_cell("xlstm_1_3b", cell, "pod" in MESH, cfg=cfg,
                                 mesh_shape=MESH)
    except Exception as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


weighted = []
plain_weighted = R._slstm_loop_weighted


def recording_weighted(z, r, probe):
    weighted.append(z.shape[0])
    return plain_weighted(z, r, probe)


from repro_torch.launch import op_analysis
on_meta = []
plain_on_meta = op_analysis.on_meta


def recording_on_meta(probe, fn, *args):
    on_meta.append(args[0].shape[0])
    return plain_on_meta(probe, fn, *args)


R._slstm_loop = recording_loop
R._slstm_loop_weighted = recording_weighted
op_analysis.on_meta = recording_on_meta
out = {}
train = ShapeCell("train_s", "train", SEQ, 8)
prefill = ShapeCell("prefill_s", "prefill", SEQ, 4)
for cell in (train, prefill, ShapeCell("decode_s", "decode", SEQ, 4)):
    out[cell.kind] = trace(cell)
out["loops"] = list(loops)
out["weighted"] = list(weighted)
out["on_meta"] = list(on_meta)
# the prefill and train cells again with every sLSTM loop unrolled step
# by step on the fake tensors
found = op_analysis.fake_trace_probe
op_analysis.fake_trace_probe = lambda t: None
out["prefill_unrolled"] = trace(prefill)
out["train_unrolled"] = trace(train)
op_analysis.fake_trace_probe = found
# the prefill's collectives by the model line that issued them, at 2 and
# 4 chunks of the mLSTM's parallel form
for n in (2, 4):
    cell = ShapeCell("p", "prefill", n * cfg.recurrent.chunk_size, 4)
    r = dryrun.lower_cell("xlstm_1_3b", cell, "pod" in MESH, cfg=cfg,
                          mesh_shape=MESH, sites=True)
    out[f"sites{n}"] = r["collective_sites"]
if "pod" in MESH:
    shardctx.merged = lambda x, dim, outer: x
    out["without_merged"] = trace(train).get("error", "OK")
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    """Both meshes' children started together, then read."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for name, mesh in MESHES.items():
        code = (f"SRC = {SRC!r}\nMESH = {mesh!r}\nSEQ = {SEQ}\n"
                + textwrap.dedent(_TRACE))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_xlstm_smoke_cells_trace(traced, mesh, kind):
    r = traced[mesh][kind]
    assert r["ok"] is True, r.get("error")
    assert r["mesh"] == mesh
    assert r["devices"] == (8 if mesh == "2x4" else 16)
    assert r["flops_per_device"] > 0 and r["write_bytes_per_device"] > 0
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    if kind == "prefill":
        assert mem["alias_size_in_bytes"] == 0
    else:
        assert 0 < mem["alias_size_in_bytes"] \
            <= mem["argument_size_in_bytes"]


def test_the_uneven_split_occurs_without_merged(traced):
    assert "Cannot unflatten unevenly sharded tensor" in \
        traced["2x2x4"]["without_merged"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_slstm_loop_runs_on_plain_shards(traced, mesh):
    """The smoke config's 2 sLSTM blocks: in the train cell one loop a
    block forward and one again in its rematerialised backward, in
    prefill one a block; every loop on plain (fake) shards over the whole
    sequence."""
    loops = traced[mesh]["loops"]
    assert len(loops) == 2 * 2 + 2
    assert all(z == r == "FakeTensor" and s == SEQ for z, r, s in loops)


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_weighted_slstm_loop_counts_as_the_unrolled_loop(traced, mesh,
                                                         kind):
    """The prefill's sLSTM loops, one a block, are traced as one step
    weighted by its trips (``_slstm_loop_weighted``, JAX's while body
    weighted by its trip count); the train cell's, which record
    gradients, run unrolled on meta twins of their inputs
    (``op_analysis.on_meta``: the forward and its remat, 2 blocks x 2);
    either way the FLOPs, write bytes, peak and collectives equal those
    of the loops unrolled step by step on the fake tensors."""
    r = traced[mesh]
    assert r["weighted"] == [SEQ, SEQ]
    assert r["on_meta"] == [SEQ] * 4
    got, want = r[kind], r[f"{kind}_unrolled"]
    assert want["ok"] is True
    for key in ("flops_per_device", "write_bytes_per_device", "memory",
                "collectives"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_collectives_are_the_mlstm_chunks(traced, mesh):
    """The attribution of xLSTM's prefill collectives (a counted
    difference, PERF.md section 6): lines of ``mlstm_parallel``'s chunk
    loop issue all-gathers or reduce-scatters in every chunk (DTensor
    resolves the projections' partial sums, whose contraction the
    "model" axis splits, and gathers each chunk's scores, chunk by
    chunk): their counts double from 2 to 4 chunks.  At xLSTM-1.3B's
    prefill_32k (64 chunks) such lines carry most of the all-gather and
    reduce-scatter bytes; here the blocks' own collectives outweigh
    them."""
    two, four = traced[mesh]["sites2"], traced[mesh]["sites4"]
    per_chunk = {site: kinds for site, kinds in four.items()
                 if site.endswith(" mlstm_parallel") and site in two
                 and all(kind in two[site] and 2 * two[site][kind][0] == n
                         for kind, (n, _) in kinds.items())}
    kinds = {k for v in per_chunk.values() for k in v}
    assert "reduce-scatter" in kinds, four
    # at least one a chunk and mLSTM block (the smoke config has two)
    assert sum(n for v in per_chunk.values() for n, _ in v.values()) \
        >= 4 * 2


def test_routes_are_the_plain_ops_on_plain_tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=g)
    assert torch.equal(shardctx.log_sigmoid(x), F.logsigmoid(x))
    assert shardctx.merged(x, 2, 2) is x
    z = torch.randn(6, 2, 3, 4 * 4, generator=g)
    r = torch.randn(2, 4, 4 * 4, generator=g)
    h, state = shardctx.recur_locally(R._slstm_loop, z, r)
    want_h, want_state = R._slstm_loop(z, r)
    assert torch.equal(h, want_h) and h.shape == (2, 6, 3, 4)
    assert all(torch.equal(state[k], want_state[k]) for k in want_state)
