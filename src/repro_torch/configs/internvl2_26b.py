"""InternVL2-26B. [arXiv:2404.16821; hf]

InternViT frontend is a STUB per the assignment (``input_specs`` provides
precomputed, projected patch embeddings).  LM backbone = InternLM2-20B:
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553, SwiGLU + RoPE.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92553, max_seq_len=32768,
        norm="rmsnorm", activation="swiglu", rope_theta=1e6,
        n_image_tokens=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256, max_seq_len=512,
        norm="rmsnorm", activation="swiglu", n_image_tokens=8,
    )
