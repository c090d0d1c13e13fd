"""Training launcher: the port of the JAX package's
``repro/launch/train.py``.

    PYTHONPATH=src python3 -m repro_torch.launch.train --arch olmo_1b \\
        --steps 5
    PYTHONPATH=src python3 -m repro_torch.launch.train --arch olmo_1b \\
        --smoke --steps 20 --ckpt-dir /tmp/ck --device cpu

The same flags and printed lines, plus ``--device`` (``cuda`` unless
asked): real steps of ``make_train_step`` (fwd + bwd + AdamW, remat per
block, microbatching) on synthetic data, with checkpoint and restart in
the port's checkpoint format.  A restart restores the newest intact
checkpoint and advances the data stream past the batches the restored
steps consumed, so a killed-then-resumed run is bitwise the
uninterrupted one (the JAX launcher starts its stream over).  Dense
family only.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import random as jr
from repro_torch.ckpt import CheckpointManager, load_checkpoint
from repro_torch.config import TrainConfig, apply_overrides
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.launch.serve import Clock
from repro_torch.models import registry
from repro_torch.models.lm import LM


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--override", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None, report: Optional[dict] = None):
    """Train; returns the final state.  ``report``, if a dict, receives
    ``losses`` (each step's loss), ``step_ms`` (each step's time: device
    time on CUDA), ``tokens`` (per step), ``init_s`` and ``peak_bytes``
    (CUDA only)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = apply_overrides(cfg, args.override)
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={cfg.name} params={registry.param_count(cfg):,} "
          f"devices={n_dev}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step = S.make_train_step(lm, tcfg)
    state = S.init_train_state(jr.key(tcfg.seed, dev), lm)
    mgr = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
           if args.ckpt_dir else None)
    start = 0
    if mgr and mgr.latest_step() is not None:
        state, start, _ = load_checkpoint(args.ckpt_dir, state)
        print(f"restored from step {start}")
    init_s = time.perf_counter() - t0

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                            seed=tcfg.seed)
    for _ in range(start):              # the batches the restored steps ate
        ds.next_batch()
    clock = Clock(dev)
    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in ds.next_batch().items()}
        clock.mark()
        state, metrics = step(state, batch)
        clock.mark()
        losses.append(metrics["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                  f"acc {float(metrics['acc']):.3f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"{(time.time()-t0):.1f}s", flush=True)
        if mgr:
            mgr.maybe_save(i + 1, state)
    print("done")
    if report is not None:
        times = clock.intervals_ms() if losses else []
        report.update(
            losses=[float(x) for x in losses], step_ms=times[::2],
            tokens=args.batch * args.seq, init_s=init_s,
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))
    return state


if __name__ == "__main__":
    main()
