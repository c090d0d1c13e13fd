"""Model registry: the ported architectures, their configs, ``build`` and
the parameter count."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.models.params import param_count as _count_defs

# the dense architectures of the JAX package's registry; the others wait
# for their families (ROADMAP.md, queue 1 item 8)
ARCH_IDS = ("mistral_large_123b", "phi3_medium_14b", "olmo_1b",
            "nemotron_4_15b")


def normalize(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = normalize(arch)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def build(cfg: ModelConfig) -> LM:
    return LM(cfg)


def param_count(cfg: ModelConfig) -> int:
    return _count_defs(LM(cfg).param_defs())
