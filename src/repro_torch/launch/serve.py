"""Serving launcher: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python3 -m repro_torch.launch.serve --arch olmo_1b \\
        --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python3 -m repro_torch.launch.serve --arch olmo_1b \\
        --smoke --device cpu
    PYTHONPATH=src python3 -m repro_torch.launch.serve \\
        --arch deepseek_moe_16b --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python3 -m repro_torch.launch.serve \\
        --arch deepseek_v2_lite_16b --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python3 -m repro_torch.launch.serve \\
        --arch recurrentgemma_9b --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python3 -m repro_torch.launch.serve \\
        --arch xlstm_1_3b --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python3 -m repro_torch.launch.serve \\
        --arch whisper_small --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python3 -m repro_torch.launch.serve \\
        --arch internvl2_26b --smoke --device cpu

The port of the JAX package's ``repro/launch/serve.py``: the same flags,
the same seeded weights (``init_params(key(0))``) and prompts
(``randint(key(1))``), the same frontend stubs, the same printed line
and tokens, plus ``--device`` (``cuda`` unless asked).  The decode index
stays on the device: no host read between tokens.  Runs every family
``LM`` serves: the dense architectures, ``--arch deepseek_moe_16b`` (moe
on GQA attention), ``--arch deepseek_v2_lite_16b`` (moe on MLA
attention: absorbed decode against the latent cache), ``--arch
recurrentgemma_9b`` (the hybrid family: a 2048-token ring buffer for its
local attention, whose window must divide the prompt length when the
prompt is longer), ``--arch xlstm_1_3b`` (the ssm family: mLSTM and sLSTM
states, no attention), ``--arch whisper_small`` (encdec: float32 zero
``audio_embeds`` of (batch, 1500, d) for the stub audio frontend) and
``--arch internvl2_26b`` (vlm: float32 zero ``pixel_embeds`` of (batch,
256, d) prepended for the stub vision frontend; its 19.86e9 float32
parameters, 74 GiB, do not fit one 80 GB card beside a prefill, so a
full-width run on one card passes bfloat16 weights drawn by
``init_params(key(0), defs, dtype=torch.bfloat16)`` as ``params``).
Each name also runs with ``--smoke --device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import random as jr
from repro_torch.config import apply_overrides
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.lm import LM
from repro_torch.models.params import init_params


class Clock:
    """Marks on the device's timeline (CUDA events, read after the run)
    or on the host clock (the CPU runs synchronously)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def frontend_stubs(cfg, batch: int, device) -> dict:
    """The JAX launcher's stand-ins for the frontends the configs leave
    out: float32 zero ``audio_embeds`` (batch, encoder_seq_len, d) for the
    encdec family, zero ``pixel_embeds`` (batch, n_image_tokens, d) for
    the vlm family; nothing for the others."""
    if cfg.family == "encdec":
        return {"audio_embeds": torch.zeros(
            (batch, cfg.encoder_seq_len, cfg.d_model), device=device)}
    if cfg.family == "vlm":
        return {"pixel_embeds": torch.zeros(
            (batch, cfg.n_image_tokens, cfg.d_model), device=device)}
    return {}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--override", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None, params=None, report: Optional[dict] = None
         ) -> torch.Tensor:
    """Returns the generated (batch, tokens) int64 tensor.

    ``params``, if given, are used instead of drawing them (a caller that
    serves twice draws once).  ``report``, if a dict, receives
    ``params``, ``init_s`` (the draw), ``prefill_ms``, ``decode_ms`` (one
    per decode step; device time on CUDA), ``logits`` (each step's
    (batch, vocab) float32 logits) and ``peak_bytes`` (CUDA only)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = apply_overrides(cfg, args.override)
    lm = LM(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if params is None:
        params = init_params(jr.key(0, dev), lm.param_defs())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0

    prompt = jr.randint(jr.key(1, dev), (args.batch, args.prompt_len), 0,
                        cfg.vocab_size)
    cache_len = args.prompt_len + args.tokens + cfg.n_image_tokens
    clock = Clock(dev)
    keep = []

    t0 = time.perf_counter()
    clock.mark()
    logits, state = lm.prefill(
        params, {"tokens": prompt, **frontend_stubs(cfg, args.batch, dev)},
        cache_len=cache_len)
    clock.mark()
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    out = [tok]
    keep.append(logits[:, -1])
    for _ in range(args.tokens - 1):
        logits, state = lm.decode_step(params, state, tok)
        clock.mark()
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out.append(tok)
        keep.append(logits[:, -1])
    gen = torch.cat(out, dim=1)
    times = clock.intervals_ms()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} generated {tuple(gen.shape)} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print(gen.cpu().numpy())
    if report is not None:
        report.update(
            params=params, init_s=init_s, prefill_ms=times[0],
            decode_ms=times[1:], logits=keep,
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))
    return gen


if __name__ == "__main__":
    main()
