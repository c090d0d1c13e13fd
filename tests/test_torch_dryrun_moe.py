"""The moe family's MoE layers split over the data axis in the dry run.

deepseek-moe-smoke's prefill and decode cells (B 8) traced on a fake
(data 2, model 4) mesh and a fake (pod 2, data 2, model 4) mesh, each in
a child process (a process group of the pytest process would refuse the
fake world).  The batch rides ``"data"`` on the first and the flattened
``"pod+data"`` on the second, so a rank holds 4 rows and then 2:

  * the expert FFN (``moe._expert_ffn``) runs on each rank's rows and
    experts: its dispatch buffer's local shape is (B / data ranks,
    E / model ranks, cap, D) on both meshes (``shardctx.rows_locally``
    and ``experts_locally``, as XLA partitions the JAX package's
    vmapped einsums; eager DTensor gathered the batch whole for the
    token gather and merged it into the products' rows, so every data
    rank computed every row);
  * the FLOPs of the expert FFN per rank and the cell's per-rank FLOPs
    halve from the first mesh to the second, as a dense layer's do.

One torch thread; about 20 s.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESHES = {"2x4": {"data": 2, "model": 4},
          "2x2x4": {"pod": 2, "data": 2, "model": 4}}
B, SEQ = 8, 16

_TRACE = r"""
import json, sys
sys.path.insert(0, SRC)
import torch
torch.set_num_threads(1)
from repro_torch.config import ShapeCell
from repro_torch.launch import dryrun, op_analysis
from repro_torch.models import moe, registry

cfg = registry.get_smoke_config("deepseek_moe_16b")
bufs, inside, flops = [], [False], {"ffn": 0}
plain_ffn, plain_record = moe._expert_ffn, op_analysis.OpProbe._record


def ffn(buf, *ws):
    bufs.append(list(buf.shape))
    inside[0] = True
    try:
        return plain_ffn(buf, *ws)
    finally:
        inside[0] = False


def record(self, func, args, kwargs, out, outs):
    before = self.flops
    plain_record(self, func, args, kwargs, out, outs)
    if inside[0]:
        flops["ffn"] += self.flops - before


moe._expert_ffn = ffn
op_analysis.OpProbe._record = record
out = {}
for kind in ("prefill", "decode"):
    bufs.clear()
    flops["ffn"] = 0
    r = dryrun.lower_cell("deepseek_moe_16b", ShapeCell("c", kind, SEQ, B),
                          "pod" in MESH, cfg=cfg, mesh_shape=MESH)
    out[kind] = {"ok": r["ok"], "flops": r["flops_per_device"],
                 "ffn_flops": flops["ffn"], "bufs": list(bufs)}
out["experts"] = cfg.moe.num_experts
out["cap"] = {k: moe.capacity(cfg, s) for k, s in (("prefill", SEQ),
                                                    ("decode", 1))}
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
        code = (f"SRC = {SRC!r}\nMESH = {mesh!r}\nB = {B}\nSEQ = {SEQ}\n"
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


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_dispatch_buffer_is_split_over_data_and_experts(traced, mesh, kind):
    r = traced[mesh]
    assert r[kind]["ok"] is True
    rows = B // (2 if mesh == "2x4" else 4)
    # two MoE layers (the first of the smoke config's 3 is dense)
    assert r[kind]["bufs"] == [[rows, r["experts"] // 4, r["cap"][kind],
                                64]] * 2


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_moe_flops_per_rank_halve_with_the_data_split(traced, kind):
    one, two = traced["2x4"][kind], traced["2x2x4"][kind]
    assert one["ffn_flops"] > 0
    assert one["ffn_flops"] == 2 * two["ffn_flops"]
    assert one["flops"] == 2 * two["flops"]
