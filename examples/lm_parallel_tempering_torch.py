"""End-to-end driver on the PyTorch port: parallel-tempered LM ensemble
training (RE-SGLD), the port's counterpart of ``lm_parallel_tempering.py``.

The engine-agnosticism payoff: the SAME RepEx driver that runs MD drives an
ensemble of language-model training replicas.  Four replicas of an
OLMo-family model train on the synthetic Zipf-Markov corpus with tempered
SGLD noise; every cycle the Metropolis exchange reassigns temperatures so
the hottest (most exploratory) replica sits on the worst parameters.

Presets (the JAX example's): --smoke ~0.8M params, 40 optimizer steps;
default ~19M params, 200 steps; --paper ~124M params, 300 steps.
``--device cpu`` runs on the CPU (default: the card); ``--steps K`` sets
the optimizer steps per cycle (default: the preset's).

    PYTHONPATH=src python examples/lm_parallel_tempering_torch.py \\
        [--smoke|--paper] [--device cpu] [--steps K]
"""
import argparse
import time

import numpy as np

from repro_torch.config import ModelConfig, RepExConfig, TrainConfig
from repro_torch.core import REMDDriver
from repro_torch.core.ensemble import control_multiset_ok
from repro_torch.models import registry
from repro_torch.models.lm_engine import LMEngine


def model_config(preset: str) -> ModelConfig:
    if preset == "smoke":
        return ModelConfig(name="pt-smoke", n_layers=2, d_model=128,
                           n_heads=4, n_kv_heads=4, d_ff=512,
                           vocab_size=2048, compute_dtype="float32")
    if preset == "paper":
        return ModelConfig(name="pt-124m", n_layers=12, d_model=768,
                           n_heads=12, n_kv_heads=12, d_ff=3072,
                           vocab_size=32768, compute_dtype="float32")
    return ModelConfig(name="pt-19m", n_layers=6, d_model=384, n_heads=6,
                       n_kv_heads=6, d_ff=1536, vocab_size=8192,
                       compute_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=0,
                    help="optimizer steps per cycle (0: the preset's)")
    args = ap.parse_args(argv)
    preset = "smoke" if args.smoke else "paper" if args.paper else "default"
    cfg = model_config(preset)
    steps_per_cycle = args.steps or {"smoke": 10, "default": 25,
                                     "paper": 30}[preset]
    n_cycles = {"smoke": 4, "default": 8, "paper": 10}[preset]

    engine = LMEngine(
        cfg,
        tcfg=TrainConfig(learning_rate=3e-3, warmup_steps=20,
                         total_steps=5000, weight_decay=0.01),
        batch_size=8, seq_len=64, pool_batches=16,
        noise_per_kelvin=3e-9,       # ladder T in K -> SGLD temperature
        device=args.device,
    )
    rcfg = RepExConfig(
        engine="lm",
        dimensions=(("temperature", 4),),
        md_steps_per_cycle=steps_per_cycle,
        n_cycles=n_cycles,
        pattern="synchronous",
    )
    driver = REMDDriver(engine, rcfg, device=args.device)
    n_params = registry.param_count(cfg)
    print(f"preset={preset}  params/replica={n_params/1e6:.1f}M  "
          f"replicas=4  steps/cycle={steps_per_cycle}")

    ens = driver.init()
    losses0 = engine._losses(ens.state).cpu().numpy()
    print(f"initial eval losses: {np.round(losses0, 3)}")
    t0 = time.time()
    ens = driver.run(ens, verbose=True)
    losses1 = engine._losses(ens.state).cpu().numpy()

    print(f"\nwall: {time.time() - t0:.0f}s")
    print(f"final eval losses:   {np.round(losses1, 3)}")
    print(f"mean loss: {losses0.mean():.3f} -> {losses1.mean():.3f} "
          f"({'improved' if losses1.mean() < losses0.mean() else 'NOT improved'})")
    print("acceptance:", driver.acceptance_ratios())
    print("multiset ok:", control_multiset_ok(ens))
    temps = driver.grid.values["temperature"].cpu().numpy()
    print("final temperature of each replica:",
          np.round(temps[ens.assignment.cpu().numpy()], 1))


if __name__ == "__main__":
    main()
