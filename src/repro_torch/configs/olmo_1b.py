"""OLMo-1B. [arXiv:2402.00838; hf]

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
Distinctive: non-parametric LayerNorm (no learnable affine), SwiGLU,
tied embeddings.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab_size=50304, max_seq_len=4096,
        norm="nonparametric_ln", activation="swiglu", tie_embeddings=True,
        rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=512,
        norm="nonparametric_ln", activation="swiglu", tie_embeddings=True,
    )
