"""DeepSeek-V2-Lite (16B MoE, MLA attention). [arXiv:2405.04434; hf]

27L d_model=2048, MLA with kv_lora_rank=512 (qk_nope 128 + qk_rope 64,
v 128), MoE: 2 shared + 64 routed experts, top-6, d_ff_expert=1408,
vocab=102400, first layer dense.
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", attention="mla",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400, max_seq_len=32768,
        norm="rmsnorm", activation="swiglu", rope_theta=1e4,
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                      d_ff_expert=1408, first_dense_layers=1),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe", attention="mla",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256, max_seq_len=512,
        norm="rmsnorm", activation="swiglu",
        mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2,
                      d_ff_expert=96, first_dense_layers=1),
    )
