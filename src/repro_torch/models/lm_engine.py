"""LMEngine — replica-exchange SGLD (parallel tempering) over LM
training: the port of the JAX package's ``repro/models/lm_engine.py``.

The engine-agnosticism payoff: the SAME RepEx driver that runs MD runs
an *ensemble of LM training replicas*.  Each replica trains the assigned
architecture with AdamW + Langevin noise scaled by its ladder
temperature; the 'energy' is the held-out loss scaled by beta, so the
Metropolis exchange moves hot (exploratory) replicas' temperatures onto
whichever parameters are currently worst: classic RE-SGLD.

propagate == n optimizer steps (the 'MD phase' of the paper).  The state
is the JAX package's tree, stacked over replicas: ``params``, ``mu``,
``nu`` (float32, the model's layer-stacked shapes behind a leading R),
``step`` (R,) int32, and with ``grad_compression`` the error-feedback
``err``.  Where the JAX package ``vmap``s the replicas, the port steps
them one at a time, so one replica's gradients (4.7 GB at OLMo-1B) are
alive at once, and walks the leaves one at a time through the clip, the
AdamW update, the noise and the mask of inactive steps (``jnp.where(
active, new, old)`` as a device select: no host read, so ``run_fused``
keeps its one sync per chunk).  The gradient is ``torch.autograd``'s
through the plain attention; the energy is the held-out loss under
``torch.no_grad``, which on the card runs the flash kernel.

``propagate(..., donate=True)`` writes each step into the state it is
given instead of a copy: four OLMo-1B replicas' state is 56.5 GB, and a
second copy does not fit on an 80 GB card.  The driver donates under
the "continue" recovery policy (``RepExConfig(relaunch_failed=False)``:
a failed replica is masked out of the ladder), where nothing reads the
pre-cycle state.

Optionally applies error-feedback int8 gradient compression inside the
step: the wire format a bandwidth-bound data-parallel mesh would ship.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import (adamw_leaf, bias_corrections,
                                     clip_scale, global_norm, lr_schedule)
from repro_torch.optim.compression import (ef_int8_compress_tree,
                                           ef_int8_decompress_tree,
                                           zero_error_tree)
from repro_torch.optim.sgld import add_noise, sgld_std
from repro_torch.tree import tree_leaves, tree_map, tree_paths


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class LMEngine:
    def __init__(self, cfg: ModelConfig, tcfg: Optional[TrainConfig] = None,
                 batch_size: int = 8, seq_len: int = 64,
                 pool_batches: int = 8, noise_per_kelvin: float = 1e-7,
                 energy_scale: float = 1.0, data_seed: int = 0,
                 grad_compression: bool = False, device="cuda"):
        """``device``: where the state lives (default ``"cuda"``; raises
        if CUDA is missing)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg or TrainConfig(learning_rate=1e-3, warmup_steps=10,
                                        total_steps=10_000)
        self.lm = LM(cfg)
        self.noise_per_kelvin = noise_per_kelvin
        self.energy_scale = energy_scale
        self.grad_compression = grad_compression
        ds = SyntheticLMDataset(cfg.vocab_size, seq_len, batch_size,
                                seed=data_seed)
        pool = [ds.next_batch() for _ in range(pool_batches)]
        self.pool = {k: torch.as_tensor(np.stack([b[k] for b in pool]),
                                        device=self.device)
                     for k in pool[0]}
        self.eval_batch = {k: torch.as_tensor(v, device=self.device)
                           for k, v in ds.next_batch().items()}

    # -- protocol ----------------------------------------------------------

    def init_state(self, rng: torch.Tensor, n_replicas: int):
        """Replica r's parameters are ``init_params(split(rng, R)[r])``,
        bitwise the JAX package's; moments and steps zero."""
        params = init_params(jr.split(rng, n_replicas), self.lm.param_defs())

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {"params": params, "mu": tree_map(zeros, params),
                 "nu": tree_map(zeros, params),
                 "step": torch.zeros(n_replicas, dtype=torch.int32,
                                     device=self.device)}
        if self.grad_compression:
            state["err"] = zero_error_tree(params)
        return state

    def _grads(self, params, batch):
        """(loss, gradient tree) of one replica's parameters on one batch,
        by ``torch.autograd`` (the attention on its plain path)."""
        (loss, _), grads = self.lm.value_and_grad(params, batch)
        return loss, grads

    def _batch(self, step: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Pool batch ``step % n_pool``, selected on the device."""
        n_pool = self.pool["tokens"].shape[0]
        idx = torch.remainder(step, n_pool).long().reshape(1)
        return {k: torch.index_select(v, 0, idx)[0]
                for k, v in self.pool.items()}

    def _step(self, state, r: int, temperature: torch.Tensor,
              key: torch.Tensor, active: torch.Tensor) -> None:
        """One optimizer step of replica ``r`` written into ``state``
        where ``active`` (a device bool) holds, leaf by leaf."""
        tcfg = self.tcfg
        step = state["step"][r]
        params = tree_map(lambda x: x[r], state["params"])
        _, grads = self._grads(params, self._batch(step))
        if self.grad_compression:
            err = tree_map(lambda x: x[r], state["err"])
            q, scales, new_err = ef_int8_compress_tree(grads, err)
            grads = ef_int8_decompress_tree(q, scales)
            for (path, e), (_, e2) in zip(tree_paths(err),
                                          tree_paths(new_err)):
                e.copy_(torch.where(active, e2, e))
        scale = clip_scale(global_norm(grads), tcfg.grad_clip)
        new_step = step + 1
        lr = lr_schedule(tcfg, new_step)
        bc1, bc2 = bias_corrections(tcfg, new_step)
        std = sgld_std(lr, temperature)
        pairs = tree_paths(params)
        keys = jr.split(key, len(pairs))
        for i, (path, p) in enumerate(pairs):
            g = _leaf(grads, path)
            m = _leaf(state["mu"], path)[r]
            v = _leaf(state["nu"], path)[r]
            p2, m2, v2 = adamw_leaf(tcfg, p, g * scale.to(g.dtype), m, v,
                                    lr, bc1, bc2)
            # tempered Langevin noise: the RepEx coupling
            p2 = add_noise(p2, keys[i], std)
            for dst, new in ((p, p2), (m, m2), (v, v2)):
                dst.copy_(torch.where(active, new, dst))
        step.copy_(torch.where(active, new_step, step))

    def propagate(self, state, ctrl, n_steps, rngs, max_steps: int,
                  stack: Optional[int] = None, donate: bool = False):
        """``n_steps[r]`` optimizer steps of replica r (at most
        ``max_steps``, the rest masked); step t draws its noise from
        ``fold_in(rngs[r], t)``.  ``stack`` changes nothing: every
        operation is per replica.  ``donate``: step ``state`` itself and
        return it (the module docstring)."""
        out = state if donate else tree_map(torch.clone, state)
        temps = ctrl["temperature"] * self.noise_per_kelvin
        for r in range(n_steps.shape[0]):
            for t in range(max_steps):
                self._step(out, r, temps[r], jr.fold_in(rngs[r], t),
                           t < n_steps[r])
        return out

    def _eval_loss(self, params) -> torch.Tensor:
        """The held-out loss of one replica's parameters, no gradient
        recorded."""
        with torch.no_grad():
            loss, _ = self.lm.loss(params, self.eval_batch)
        return loss

    def _losses(self, state) -> torch.Tensor:
        return torch.stack([
            self._eval_loss(tree_map(lambda x: x[r], state["params"]))
            for r in range(state["step"].shape[0])])

    def energy(self, state, ctrl):
        return ctrl["beta"] * self._losses(state) * self.energy_scale

    def cross_energy(self, state, ctrl_grid):
        losses = self._losses(state)                            # (R,)
        return (losses[:, None] * ctrl_grid["beta"][None, :]
                * self.energy_scale)

    def is_failed(self, state):
        r = state["step"].shape[0]
        bad = torch.zeros(r, dtype=torch.bool, device=self.device)
        for x in tree_leaves(state):
            if x.is_floating_point():
                bad = bad | ~torch.isfinite(x).reshape(r, -1).all(1)
        return bad
