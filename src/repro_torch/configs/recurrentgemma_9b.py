"""RecurrentGemma-9B (Griffin). [arXiv:2402.19427; unverified]

38 blocks d_model=4096, pattern (RG-LRU, RG-LRU, local-attn) — attention
1:2 — 12 full groups + 2 tail recurrent blocks.  Local attention window
2048, MQA (kv=1), GeGLU d_ff=12288, logit softcap 30.
Sub-quadratic -> ``long_500k`` runs (attention cache is a 2048 ring
buffer; RG-LRU state is O(1) in context).
"""
from repro_torch.config import ModelConfig, RecurrentConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid", attention="local",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000, max_seq_len=524288,
        norm="rmsnorm", activation="geglu", rope_theta=1e4,
        window_size=2048, logit_softcap=30.0, subquadratic=True,
        recurrent=RecurrentConfig(kind="rg_lru", conv_width=4, lru_width=0),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid", attention="local",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=512,
        norm="rmsnorm", activation="geglu", window_size=16,
        logit_softcap=30.0, subquadratic=True,
        recurrent=RecurrentConfig(kind="rg_lru", conv_width=4, lru_width=0),
    )
