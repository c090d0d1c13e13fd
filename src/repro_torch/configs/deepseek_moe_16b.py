"""DeepSeekMoE-16B. [arXiv:2401.06066; hf]

28L d_model=2048 16H (GQA kv=16) fine-grained MoE: 2 shared + 64 routed
experts top-6, d_ff_expert=1408, vocab=102400, first layer dense.
"""
from repro_torch.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", attention="gqa",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab_size=102400, max_seq_len=16384,
        norm="rmsnorm", activation="swiglu", rope_theta=1e4,
        moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                      d_ff_expert=1408, first_dense_layers=1),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke", family="moe", attention="gqa",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=256, max_seq_len=512,
        norm="rmsnorm", activation="swiglu",
        moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2,
                      d_ff_expert=96, first_dense_layers=1),
    )
