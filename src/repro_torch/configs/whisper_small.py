"""Whisper-small. [arXiv:2212.04356; unverified]

Enc-dec, 12L encoder + 12L decoder, d_model=768 12H d_ff=3072 vocab=51865.
The conv audio frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings (B, 1500, 768).
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        n_layers=12, n_encoder_layers=12, encoder_seq_len=1500,
        d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=51865, max_seq_len=32768,
        norm="layernorm", activation="gelu", pos_embed="learned",
        use_rope=False, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, n_encoder_layers=2, encoder_seq_len=32,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=512,
        norm="layernorm", activation="gelu", pos_embed="learned",
        use_rope=False, tie_embeddings=True,
    )
