"""Nemotron-4-15B. [arXiv:2402.16819; unverified]

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
Distinctive: squared-ReLU MLP (no gating), GQA, RoPE.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=256000, max_seq_len=4096,
        norm="layernorm", activation="relu2", rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=256, vocab_size=512, max_seq_len=512,
        norm="layernorm", activation="relu2",
    )
