"""Mistral-Large-Instruct-2407 (123B dense).

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768, RoPE + SwiGLU.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab_size=32768, max_seq_len=131072,
        norm="rmsnorm", activation="swiglu", rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256, max_seq_len=512,
        norm="rmsnorm", activation="swiglu",
    )
