"""The train step: the port of the JAX package's ``repro/launch/steps.py``
(its training part).

``make_train_step`` builds the full fwd + bwd + AdamW step with optional
gradient-accumulation microbatching and per-block remat, as a plain
function of (state, batch); the gradient is ``torch.autograd``'s.  The
sharding helpers and the serving steps of the JAX module wait for the
LM's sharding slice (ROADMAP.md, queue 1 item 8); ``LM.prefill`` and
``LM.decode_step`` are the serving steps.
"""
from __future__ import annotations

import numpy as np
import torch

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


def make_train_step(lm: LM, tcfg: TrainConfig):
    """Returns step(state, batch) -> (state, metrics)."""
    remat = tcfg.remat_policy != "none"
    M = tcfg.num_microbatches

    def grad_fn(params, batch):
        return lm.value_and_grad(params, batch, remat=remat)

    def step(state, batch):
        params = state["params"]
        if M <= 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            def split(x):
                return x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
            mb = {k: split(v) for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
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
