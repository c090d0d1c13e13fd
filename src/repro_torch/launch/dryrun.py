"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the host:
the port of the JAX package's ``repro/launch/dryrun.py``.

It checks that the distribution config is coherent without hardware.
For each cell the full step (train fwd + bwd + AdamW, prefill, decode)
runs once on the production mesh (16x16 single-pod, 2x16x16 multi-pod)
of a fake world of 256 or 512 ranks (``launch/mesh.fake_world``): every
leaf of the state, the weights and the batch is a DTensor whose local
shard is a ``FakeTensor`` (no storage), placed by the port's rule tables
(``sharding.NamedSharding.placements``), and the step's ops are read by
``launch/op_analysis`` on the local shards: per-device memory, FLOPs,
write bytes and the collectives DTensor issues.  It allocates nothing on
any device: the host traces, as JAX's dry run compiles for host CPU
devices.  So attention takes the plain path, the work JAX's HLO counts.

Per-cell choices are JAX's: ``TRAIN_OVERRIDES`` (tuned for TPU v5e's
memory; kept for parity, not tuned for the H100), the serving KV
replication (``serve_config``), the skips of ``registry.applicable``.

The result keys are JAX's where the quantity is the same:
``memory`` has ``argument_size_in_bytes`` (the per-device shard bytes of
the inputs), ``output_size_in_bytes``, ``alias_size_in_bytes`` (the
state the step writes back in place: the train state and the decode
cache, where JAX's launcher donates nothing) and ``temp_size_in_bytes``
(the high-water mark of the live bytes the step allocated, which the
card's ``max_memory_allocated`` above the bytes held before reads);
``flops_per_device``, ``write_bytes_per_device`` and ``collectives``.
The XLA-only keys (``generated_code_size_in_bytes``,
``flops_xla_unweighted``, ``hlo_lines``, ``total_bytes_tpu``) have no
counterpart and are left out; ``t_trace_s`` replaces ``t_lower_s`` and
``t_compile_s``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
Results are cached as JSON under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import sharding as shd
from repro_torch.config import SHAPE_CELLS, ShapeCell, TrainConfig
from repro_torch.launch import op_analysis
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import registry, shardctx
from repro_torch.models.lm import LM
from repro_torch.tree import tree_leaves, tree_map

OUT_DIR = "experiments/dryrun_torch"

# Per-arch training knobs for the big cells, the JAX package's (its
# microbatching keeps the rematerialised activations inside TPU v5e's
# memory); kept for parity.  Microbatching keeps (global_batch /
# microbatches) divisible by the batch-sharding group.
TRAIN_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "mistral_large_123b": {"num_microbatches": 4},
    "internvl2_26b": {"num_microbatches": 2},
    "nemotron_4_15b": {"num_microbatches": 2},
    "recurrentgemma_9b": {"num_microbatches": 2},
    "deepseek_v2_lite_16b": {"num_microbatches": 2},
    "deepseek_moe_16b": {"num_microbatches": 2},
}

TP = 16
# a cell whose trace runs longer fails (the xLSTM's sLSTM time loop runs
# a prefill's 32,768 steps op by op, where JAX compiles one scan)
TRACE_LIMIT_S = 1800.0


def serve_config(cfg, cell: ShapeCell):
    """vLLM-style KV-head replication for serving where the geometry
    allows it (tp % G == 0 and H % tp == 0) and the doubled cache still
    fits beside the weights (under 50e9 parameters): the cache then
    shards kv_heads over the model axis."""
    if (cell.kind in ("decode", "prefill")
            and cfg.attention in ("gqa", "local")
            and cfg.n_kv_heads % TP != 0 and TP % cfg.n_kv_heads == 0
            and cfg.n_heads % TP == 0
            and registry.param_count(cfg) < 50e9):
        return dataclasses.replace(cfg, kv_replicate_to=TP)
    return cfg


def mesh_name(mesh_shape: Dict[str, int]) -> str:
    return "x".join(str(n) for n in mesh_shape.values())


# ---------------------------------------------------------------------------
# fake DTensors
# ---------------------------------------------------------------------------


def placed(sds, device_mesh, make_local):
    """A DTensor of ``sds``'s global shape and dtype on ``device_mesh``,
    placed by its ``NamedSharding``, its local shard ``make_local(shape,
    dtype)``."""
    from torch.distributed.tensor import DTensor
    sharding = sds.sharding or shd.NamedSharding((), ())
    local = make_local(sharding.shard_shape(sds.shape), sds.dtype)
    return DTensor.from_local(local, device_mesh,
                              sharding.placements(device_mesh),
                              run_check=False, shape=torch.Size(sds.shape),
                              stride=shardctx.contiguous_stride(sds.shape))


def _shards(tree) -> list:
    """The local tensors of a tree (dicts, tuples) of DTensors or
    tensors."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in _pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """The bytes one device holds of a tree of DTensors (or tensors)."""
    return sum(t.numel() * t.element_size() for t in _shards(tree))


def aliased_bytes(out, inputs) -> int:
    """The bytes of ``out``'s shards that share storage with a shard of
    ``inputs``: the state a step wrote back in place."""
    held = {id(t.untyped_storage()) for t in _shards(inputs)}
    return sum(t.numel() * t.element_size() for t in _shards(out)
               if id(t.untyped_storage()) in held)


def _batch_abs(cfg, cell: ShapeCell, mesh_shape, multi_pod: bool,
               batch_axes=None):
    specs = registry.input_specs(cfg, cell)
    shardings = S.batch_shardings(specs, _Shape(mesh_shape), multi_pod,
                                  batch_axes=batch_axes)
    return tree_map(lambda sp, sh: dataclasses.replace(sp, sharding=sh),
                    specs, shardings)


@dataclasses.dataclass(frozen=True)
class _Shape:
    """A mesh's ``.shape`` (axis name -> size), the rule engine's view."""
    shape: Dict[str, int]


def dtensor_mesh(mesh_shape: Dict[str, int]):
    """The device mesh a cell is traced on, in the fake world running:
    the production mesh of ``mesh_shape``'s shape, and a multi-pod mesh's
    ("pod", "data") flattened into one dim "pod+data" (pod major).  Every
    rule table places pod and data together, so the placements are the
    same; DTensor then issues one collective over the pair, where two in
    turn would run, and its redistribution planner, which searches the
    placements of every mesh dim, stays tractable."""
    import warnings
    from torch.distributed.device_mesh import init_device_mesh
    if mesh_shape == {"data": 16, "model": 16}:
        return make_production_mesh(device="cpu")
    if "pod" in mesh_shape:
        if mesh_shape == {"pod": 2, "data": 16, "model": 16}:
            mesh = make_production_mesh(multi_pod=True, device="cpu")
        else:
            mesh = init_device_mesh("cpu", tuple(mesh_shape.values()),
                                    mesh_dim_names=tuple(mesh_shape))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mesh["pod", "data"]._flatten("pod+data")
            return mesh["pod+data", "model"]
    return init_device_mesh("cpu", tuple(mesh_shape.values()),
                            mesh_dim_names=tuple(mesh_shape))


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellSetup:
    """A cell's step and its abstract inputs (``step(*inputs)``) and the
    activation sharding to set for it."""
    step: Any
    inputs: tuple
    batch_axes: tuple
    model_axis: Optional[str]


def setup_cell(arch: str, cell: ShapeCell, mesh_shape: Dict[str, int],
               cfg=None) -> CellSetup:
    """The cell's step and its inputs as abstract trees (``sharding`` set
    on every leaf), with the activation sharding of ``shardctx`` to set,
    as the JAX dry run builds them.  ``cfg`` replaces the registry's
    config (a smoke config in the tests)."""
    multi_pod = "pod" in mesh_shape
    cfg = serve_config(cfg or registry.get_config(arch), cell)
    lm = LM(cfg)
    mesh = _Shape(mesh_shape)
    if cell.kind == "train":
        rules, batch_axes, model_axis = shd.pick_train_rules(
            cfg.n_heads, multi_pod)
        tcfg = TrainConfig(**TRAIN_OVERRIDES.get(arch, {}))
        step = S.make_train_step(lm, tcfg)
        state = S.abstract_train_state(lm, mesh, rules)
        batch = _batch_abs(cfg, cell, mesh_shape, multi_pod,
                           batch_axes=batch_axes)
        return CellSetup(step, (state, batch), batch_axes, model_axis)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if cell.kind == "prefill":
        rules = shd.serve_rules_for(cfg, multi_pod, decode=False)
        step = S.make_prefill_step(lm, cache_len=cell.seq_len)
        params = S.abstract_params_for_serve(lm, mesh, rules)
        batch = _batch_abs(cfg, cell, mesh_shape, multi_pod)
        # the state the prefill produces, in the layout decode consumes
        dec_rules = shd.serve_rules_for(cfg, multi_pod, decode=True)
        layout = S.abstract_decode_state(lm, cell.global_batch,
                                         cell.seq_len, mesh, dec_rules)
        step = _with_state_layout(step, layout)
        return CellSetup(step, (params, batch), batch_axes, "model")
    rules = shd.serve_rules_for(cfg, multi_pod, decode=True)
    if cell.global_batch == 1:
        rules = dict(rules)
        rules["batch"] = ((),)
    step = S.make_decode_step(lm)
    params = S.abstract_params_for_serve(lm, mesh, rules)
    state = S.abstract_decode_state(lm, cell.global_batch, cell.seq_len,
                                    mesh, rules)
    state["index"] = dataclasses.replace(state["index"], sharding=None)
    batch = _batch_abs(cfg, cell, mesh_shape, multi_pod)
    return CellSetup(step, (params, state, batch["tokens"]), batch_axes,
                     "model")


def argument_bytes(setup: CellSetup) -> int:
    """The bytes of one device's shards of the cell's inputs, from the
    abstract trees' placements."""
    total = 0
    for sds in (leaf for t in setup.inputs for leaf in tree_leaves(t)):
        shape = (sds.sharding.shard_shape(sds.shape) if sds.sharding
                 else sds.shape)
        n = 1
        for d in shape:
            n *= d
        total += n * torch.empty((), dtype=sds.dtype).element_size()
    return total


def _with_state_layout(step, layout):
    """``step`` with the decode state it creates placed as ``layout``
    says (``shardctx.state_layout``), as the JAX dry run pins the
    prefill's output to the layout decode consumes."""
    def run(*args):
        with shardctx.state_layout(layout):
            return step(*args)
    return run


def materialize(tree, device_mesh, make_local):
    """Abstract leaves (``ShapeDtypeStruct`` with a ``NamedSharding``) to
    DTensors on ``device_mesh``."""
    return tree_map(lambda s: placed(s, device_mesh, make_local), tree)


def measure(setup: CellSetup, inputs: tuple, mesh_shape: Dict[str, int],
            fake_modes=(), device=None, limit_s: Optional[float] = None,
            sites: bool = False) -> Dict[str, Any]:
    """Run the cell's step once on ``inputs`` (its inputs, DTensors on a
    mesh of ``mesh_shape``, or plain tensors) and read it: the memory,
    flops, write bytes and collectives of one device
    (``op_analysis.probe``'s ``fake_modes``, ``device`` and ``sites``:
    with ``sites``, each collective's model source line too, under
    ``"collective_sites"``); a trace longer than ``limit_s`` raises
    ``TimeoutError``."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_bytes = argument_bytes(setup)
    shardctx.set_activation_sharding(setup.batch_axes, setup.model_axis,
                                     mesh_shape)
    try:
        t0 = time.perf_counter()
        deadline = None if limit_s is None else t0 + limit_s
        with implicit_replication():
            try:
                out, probe = op_analysis.probe(setup.step, *inputs,
                                               fake_modes=fake_modes,
                                               device=device,
                                               deadline=deadline,
                                               sites=sites)
            except TimeoutError:
                raise TimeoutError(
                    f"the trace ran past {limit_s:.0f} s") from None
        t_trace = time.perf_counter() - t0
    finally:
        shardctx.clear()
    tot = op_analysis.totals(probe)
    extra = {"collective_sites": probe.sites} if sites else {}
    return {
        **extra,
        "t_trace_s": round(t_trace, 2),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": local_bytes(out),
                   "alias_size_in_bytes": aliased_bytes(out, inputs),
                   "temp_size_in_bytes": tot["peak_bytes"]},
        "flops_per_device": tot["flops"],
        "write_bytes_per_device": tot["write_bytes"],
        "collectives": {"bytes_by_kind": tot["collective_bytes"],
                        "counts": tot["collective_counts"],
                        "total_bytes": tot["collective_total"]},
    }


def lower_cell(arch: str, cell: ShapeCell, multi_pod: bool,
               cfg=None, mesh_shape: Optional[Dict[str, int]] = None,
               sites: bool = False) -> Dict[str, Any]:
    """Trace one cell on the production mesh (or ``mesh_shape``) of a
    fake world; ``cfg`` replaces the registry's config; ``sites`` as
    ``measure``'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if mesh_shape is None:
        mesh_shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
    n = 1
    for s in mesh_shape.values():
        n *= s
    setup = setup_cell(arch, cell, mesh_shape, cfg=cfg)
    # only the inputs' shards are made fake: the tensors a step makes from
    # them are fake too, while DTensor's own bookkeeping stays real
    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def make_local(shape, dtype):
        with fake:
            return torch.empty(shape, dtype=dtype)
    with fake_world(n):
        dm = dtensor_mesh(mesh_shape)
        inputs = tuple(materialize(t, dm, make_local) for t in setup.inputs)
        res = measure(setup, inputs, mesh_shape, fake_modes={id(fake)},
                      limit_s=TRACE_LIMIT_S, sites=sites)
    return {"arch": arch, "cell": cell.name, "mesh": mesh_name(mesh_shape),
            "devices": n, "ok": True, **res}


def run_cell(arch: str, cell_name: str, multi_pod: bool,
             force: bool = False, sites: bool = False) -> Dict[str, Any]:
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = f"{arch}__{cell_name}__{'mp' if multi_pod else 'sp'}"
    path = os.path.join(OUT_DIR, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if not sites or "collective_sites" in cached or not cached.get(
                "ok"):
            return cached
    cell = next(c for c in SHAPE_CELLS if c.name == cell_name)
    cfg = registry.get_config(arch)
    skip = registry.applicable(cfg, cell)
    mesh = "2x16x16" if multi_pod else "16x16"
    if skip:
        result: Dict[str, Any] = {"arch": arch, "cell": cell_name,
                                  "mesh": mesh, "ok": None, "skipped": skip}
    else:
        try:
            result = lower_cell(arch, cell, multi_pod, sites=sites)
        except Exception as e:  # noqa: BLE001 — record the failure
            result = {"arch": arch, "cell": cell_name, "mesh": mesh,
                      "ok": False, "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-4000:]}
        finally:
            shardctx.clear()
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def status_line(r: Dict[str, Any]) -> str:
    status = ("SKIP" if r.get("skipped")
              else "OK" if r.get("ok") else "FAIL")
    extra = ""
    if status == "OK":
        gb = r["memory"].get("temp_size_in_bytes", 0) / 2**30
        extra = (f"trace {r['t_trace_s']:7.1f}s  temp {gb:6.2f} GiB  "
                 f"coll {r['collectives']['total_bytes']/2**20:8.1f} MiB")
    elif status == "FAIL":
        extra = r["error"][:120]
    return (f"[{status:4s}] {r['arch']:24s} {r['cell']:12s} "
            f"{r['mesh']:8s} {extra}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sites", action="store_true",
                    help="attribute each collective to the model source "
                         "line that issued it; print the largest")
    args = ap.parse_args(argv)

    if args.all:
        jobs = [(a, c.name, mp)
                for a in registry.ARCH_IDS
                for c in SHAPE_CELLS
                for mp in (False, True)]
    else:
        if not (args.arch and args.cell):
            ap.error("--arch and --cell, or --all")
        jobs = [(args.arch, args.cell, args.multipod)]

    n_ok = n_skip = n_fail = 0
    for arch, cell, mp in jobs:
        r = run_cell(arch, cell, mp, force=args.force, sites=args.sites)
        line = status_line(r)
        n_ok += line.startswith("[OK")
        n_skip += line.startswith("[SKIP")
        n_fail += line.startswith("[FAIL")
        print(line, flush=True)
        for site, kinds in sorted(
                r.get("collective_sites", {}).items(),
                key=lambda kv: -sum(b for _, b in kv[1].values()))[:12]:
            print("    " + site + ": " + ", ".join(
                f"{k} {n} ({b / 2**20:.1f} MiB)"
                for k, (n, b) in kinds.items()))
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
