"""Train, prefill and decode steps and their placements: the port of the
JAX package's ``repro/launch/steps.py``.

``make_train_step`` builds the full fwd + bwd + AdamW step with optional
gradient-accumulation microbatching and per-block remat, as a plain
function of (state, batch) that updates the state in place; the
gradient is ``torch.autograd``'s.
``make_prefill_step`` and ``make_decode_step`` wrap ``LM.prefill`` and
``LM.decode_step``.  ``train_state_shardings``, ``abstract_train_state``,
``batch_shardings``, ``abstract_params_for_serve`` and
``abstract_decode_state`` describe where each leaf of the train state,
a batch, the serving weights and the decode state goes on a mesh under
``repro_torch.sharding``'s rules, allocating nothing (the records of
``models.params.abstract_params``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.config import TrainConfig
from repro_torch.models import params as PRM
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWState, adamw_update
from repro_torch.tree import tree_map


def make_train_state_defs(lm: LM):
    pdefs = lm.param_defs()
    return {
        "params": pdefs,
        "mu": pdefs,      # AdamW moments shaped like the params
        "nu": pdefs,
        "step": PRM.ParamDef((), (), "zeros", dtype=torch.int32),
    }


def init_train_state(rng: torch.Tensor, lm: LM):
    """Parameters drawn from ``rng`` (bitwise the JAX package's), zero
    moments and step, on ``rng``'s device."""
    params = PRM.init_params(rng, lm.param_defs())

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"params": params, "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=rng.device)}


def train_state_shardings(lm: LM, mesh, rules):
    return tree_map(lambda d: shd.sharding_for(mesh, rules, d.axes, d.shape),
                    make_train_state_defs(lm))


def abstract_train_state(lm: LM, mesh, rules):
    def mk(d: PRM.ParamDef):
        s = shd.sharding_for(mesh, rules, d.axes, d.shape)
        return PRM.ShapeDtypeStruct(d.shape, d.dtype, sharding=s)
    return tree_map(mk, make_train_state_defs(lm))


def batch_shardings(batch_specs, mesh, multi_pod: bool, batch_axes=None):
    """Each input's placement: dim 0 over the batch axes present in
    ``mesh`` where it divides them, else replicated."""
    axes = batch_axes or (("pod", "data") if multi_pod else ("data",))
    group = tuple(a for a in axes if a in mesh.shape)
    size = 1
    for a in group:
        size *= mesh.shape[a]
    mesh_shape = shd._mesh_shape(mesh)
    # a PartitionSpec's entry: one axis by its name, none as None
    entry = (group if len(group) > 1 else group[0]) if group else None

    def mk(spec):
        if spec.shape and spec.shape[0] % size == 0:
            return shd.NamedSharding(mesh_shape, (entry,))
        return shd.NamedSharding(mesh_shape, ())
    return tree_map(mk, batch_specs)


def make_train_step(lm: LM, tcfg: TrainConfig):
    """Returns step(state, batch) -> (state, metrics).  The step writes
    the new parameters and moments into ``state``'s tensors
    (``adamw_update``), so a state that fills most of the card steps
    without a second copy of itself; a caller that keeps the old state
    clones it first."""
    remat = tcfg.remat_policy != "none"
    M = tcfg.num_microbatches

    def grad_fn(params, batch):
        return lm.value_and_grad(params, batch, remat=remat)

    def step(state, batch):
        params = state["params"]
        if M <= 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            # M contiguous blocks of rows, as JAX's reshape to (M, B / M,
            # ...) makes them (a chunk, not a reshape: a batch sharded
            # over more ranks than M splits as a DTensor too)
            mb = {k: torch.chunk(v, M, 0) for k, v in batch.items()}
            # zeros placed as each leaf is (a DTensor's shard by shard)
            gsum = tree_map(lambda p: torch.zeros_like(p,
                                                       dtype=torch.float32),
                            params)
            metss = []
            for i in range(M):
                (_, mets), g = grad_fn(params, {k: v[i] for k, v in
                                                mb.items()})
                gsum = tree_map(lambda a, b: a + b, gsum, g)
                metss.append(mets)
            # the mean over microbatches: a division by the constant M,
            # which compiled XLA makes a multiplication by 1/M
            inv = float(np.float32(1.0) / np.float32(M))
            grads = tree_map(lambda g: g * inv, gsum)
            metrics = {k: torch.mean(torch.stack([m[k] for m in metss]))
                       for k in metss[0]}
        opt = AdamWState(state["step"], state["mu"], state["nu"])
        new_params, new_opt, opt_metrics = adamw_update(tcfg, params, grads,
                                                        opt)
        new_state = {"params": new_params, "mu": new_opt.mu,
                     "nu": new_opt.nu, "step": new_opt.step}
        return new_state, {**metrics, **opt_metrics}

    return step


# ---------------------------------------------------------------------------
# Serve (prefill / decode)
# ---------------------------------------------------------------------------


def abstract_params_for_serve(lm: LM, mesh, rules, dtype=torch.bfloat16):
    """Serving weights: ``dtype`` for the floating leaves, the serve
    rules' placements, nothing allocated."""
    def mk(d: PRM.ParamDef):
        s = shd.sharding_for(mesh, rules, d.axes, d.shape)
        dt = dtype if d.dtype.is_floating_point else d.dtype
        return PRM.ShapeDtypeStruct(d.shape, dt, sharding=s)
    return tree_map(mk, lm.param_defs())


def make_prefill_step(lm: LM, cache_len: Optional[int] = None):
    def step(params, batch):
        return lm.prefill(params, batch, cache_len=cache_len)
    return step


def make_decode_step(lm: LM):
    def step(params, state, tokens):
        return lm.decode_step(params, state, tokens)
    return step


def abstract_decode_state(lm: LM, batch: int, cache_len: int, mesh, rules):
    def mk(d: PRM.ParamDef):
        s = shd.sharding_for(mesh, rules, d.axes, d.shape)
        return PRM.ShapeDtypeStruct(d.shape, d.dtype, sharding=s)
    return tree_map(mk, lm.decode_state_defs(batch, cache_len))
