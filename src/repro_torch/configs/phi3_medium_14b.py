"""Phi-3-medium (14B dense). [arXiv:2404.14219; unverified]

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, RoPE SwiGLU GQA.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
        d_ff=17920, vocab_size=100352, max_seq_len=131072,
        norm="rmsnorm", activation="swiglu", rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=256, max_seq_len=512,
        norm="rmsnorm", activation="swiglu",
    )
