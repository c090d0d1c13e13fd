"""Model registry: the architectures, their configs, ``build``, the
parameter count and the dry-run matrix's input specs."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

import torch

from repro_torch.config import ModelConfig, ShapeCell
from repro_torch.models.lm import LM
from repro_torch.models.params import ShapeDtypeStruct
from repro_torch.models.params import param_count as _count_defs

# every architecture of the JAX package's registry: dense, moe on GQA and
# MLA attention, hybrid, ssm, encdec (whisper_small) and vlm
# (internvl2_26b), each served and trained
ARCH_IDS = ("mistral_large_123b", "phi3_medium_14b", "olmo_1b",
            "nemotron_4_15b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
            "recurrentgemma_9b", "xlstm_1_3b", "whisper_small",
            "internvl2_26b")


def normalize(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = normalize(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}: {ARCH_IDS}")
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


def input_specs(cfg: ModelConfig, cell: ShapeCell,
                batch_override: Optional[int] = None) -> Dict[str, Any]:
    """``ShapeDtypeStruct`` stand-ins for every model input of a shape
    cell; nothing is allocated.  The modality frontends are stubs: whisper
    gets precomputed frame embeddings, internvl precomputed patch
    embeddings, whose positions the cell's length counts."""
    b = batch_override or cell.global_batch
    s = cell.seq_len
    i32, f32 = torch.int32, torch.float32
    if cell.kind in ("train", "prefill"):
        text = s
        specs: Dict[str, Any] = {}
        if cfg.family == "vlm":
            text = s - cfg.n_image_tokens
            specs["pixel_embeds"] = ShapeDtypeStruct(
                (b, cfg.n_image_tokens, cfg.d_model), f32)
        if cfg.family == "encdec":
            specs["audio_embeds"] = ShapeDtypeStruct(
                (b, cfg.encoder_seq_len, cfg.d_model), f32)
        specs["tokens"] = ShapeDtypeStruct((b, text), i32)
        if cell.kind == "train":
            specs["labels"] = ShapeDtypeStruct((b, text), i32)
        return specs
    # decode: one new token against a cache or state of length seq_len
    return {"tokens": ShapeDtypeStruct((b, 1), i32)}


def applicable(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """None if the (arch x cell) runs; else the reason it is skipped."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 524k dense-attention decode is the "
                "defining non-goal; skipped per assignment")
    return None
