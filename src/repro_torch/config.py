"""Configuration of one replica-exchange simulation, of one language
model and of its training.

The port keeps its own copies of the JAX package's ``RepExConfig``,
``TrainConfig`` and ``ModelConfig`` (same fields, same defaults) and of
``apply_overrides``, so that it imports nothing of that package.  dtype
fields stay strings (``"bfloat16"``, ``"float32"``); ``torch_dtype``
maps them.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    num_microbatches: int = 1         # gradient accumulation inside the step
    remat_policy: str = "block"       # none | block | dots_saveable
    seed: int = 0
    grad_compression: str = "none"    # none | int8_ef (error-feedback int8)
    zero_sharding: bool = True        # FSDP-shard params/opt over data axis


@dataclass(frozen=True)
class RepExConfig:
    """Configuration of one replica-exchange simulation (the paper's input)."""
    engine: str = "md"                # md | lj | lm
    # Exchange dimensions, in exchange order.  Each entry: (type, n_windows)
    # type in {"temperature", "umbrella", "salt"} — the paper's T/U/S.
    dimensions: Tuple[Tuple[str, int], ...] = (("temperature", 8),)
    t_min: float = 273.0
    t_max: float = 373.0
    umbrella_k: float = 0.02          # kcal/mol/deg^2, paper's force constant
    salt_min: float = 0.0
    salt_max: float = 1.0
    md_steps_per_cycle: int = 100     # paper: 6000 (sander), we scale down
    n_cycles: int = 10
    pattern: str = "synchronous"      # synchronous | asynchronous
    execution_mode: str = "auto"      # auto | mode1 | mode2
    cores_per_replica: int = 1        # model-axis shard per replica
    exchange_scheme: str = "neighbor" # neighbor (DEO) | matrix (Gibbs)
    # Sharded-exchange wire protocol (run_sharded only): halo | gather
    exchange_comm: str = "halo"
    async_window: float = 0.5         # fraction of replicas ready per window
    seed: int = 0
    # failure handling
    detect_failures: bool = True
    relaunch_failed: bool = True
    # Escalation budget for the relaunch policy: 0 = unlimited relaunches
    # (the default); B > 0 escalates a replica failing B consecutive
    # cycles to reinit-from-peer-rung, and after 2B to continue-degraded.
    relaunch_budget: int = 0

    @property
    def n_replicas(self) -> int:
        n = 1
        for _, w in self.dimensions:
            n *= w
        return n


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0              # routed experts
    num_shared_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2
    first_dense_layers: int = 1       # DeepSeek: layer 0 is dense


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0              # 0 = full-rank q projection (V2-Lite)


@dataclass(frozen=True)
class RecurrentConfig:
    """Recurrent-block parameters (RG-LRU / xLSTM families)."""
    kind: str = "rg_lru"              # rg_lru | mlstm | slstm
    conv_width: int = 4
    lru_width: int = 0                # 0 -> d_model
    block_pattern: Tuple[str, ...] = ()   # per-layer types, repeated cyclically
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    slstm_every: int = 8              # xLSTM[7:1]: one sLSTM per 8 blocks
    chunk_size: int = 256             # chunkwise-parallel mLSTM


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"             # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192
    # --- norm / activation flavour ---
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparametric_ln
    activation: str = "swiglu"        # swiglu | geglu | relu2 | gelu
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    use_rope: bool = True
    pos_embed: str = "rope"           # rope | learned | none
    logit_softcap: float = 0.0
    # --- attention flavour ---
    attention: str = "gqa"            # gqa | mla | local
    window_size: int = 0              # local attention window (0 = full)
    attn_impl: str = "xla"            # xla | flash (pallas)
    # Serving: replicate KV heads up to the TP degree (vLLM-style).
    kv_replicate_to: int = 0
    # --- optional sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    # --- encoder/decoder (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500       # whisper 30 s of audio @ 50 Hz
    # --- vlm (internvl) ---
    n_image_tokens: int = 0           # prepended stub patch embeddings
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    # dtype of row-parallel matmul outputs (the JAX package's cross-device
    # partial-sum reduces)
    reduce_dtype: str = "bfloat16"
    # --- subquadratic? (decides long_500k applicability) ---
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string as a torch dtype."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Overrides
# ---------------------------------------------------------------------------


def _coerce(value: str, target: Any) -> Any:
    if dataclasses.is_dataclass(target):
        raise ValueError(f"cannot override dataclass field with {value!r}")
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        return tuple(json.loads(value))
    return value


def apply_overrides(cfg: Any, overrides: Sequence[str]) -> Any:
    """Apply ``a.b.c=value`` dotted overrides to a (frozen) dataclass tree."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like key=value")
        key, _, value = item.partition("=")
        key = key.lstrip("-")
        parts = key.split(".")
        cfg = _apply_one(cfg, parts, value)
    return cfg


def _apply_one(cfg: Any, parts: Sequence[str], value: str) -> Any:
    head, rest = parts[0], parts[1:]
    current = getattr(cfg, head)
    if rest:
        new = _apply_one(current, rest, value)
    else:
        new = _coerce(value, current)
    return dataclasses.replace(cfg, **{head: new})
