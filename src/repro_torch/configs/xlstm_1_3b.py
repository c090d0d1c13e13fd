"""xLSTM-1.3B. [arXiv:2405.04517; unverified]

48 blocks, d_model=2048, 4 heads; sLSTM + mLSTM blocks in a 7:1 mix
(xLSTM[7:1]): each unit of 8 blocks = 7 mLSTM + 1 sLSTM.  No separate FFN
(d_ff=0): mLSTM blocks carry a 2x up-projection, sLSTM blocks a 4/3 GeGLU.
Sub-quadratic -> the ``long_500k`` cell runs (decode state is O(1) in
context length).
"""
from repro_torch.config import ModelConfig, RecurrentConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, max_seq_len=524288,
        norm="layernorm", activation="gelu", use_rope=False,
        pos_embed="none", subquadratic=True,
        recurrent=RecurrentConfig(kind="mlstm", conv_width=4,
                                  mlstm_proj_factor=2.0,
                                  slstm_proj_factor=4.0 / 3.0,
                                  slstm_every=8, chunk_size=512),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab_size=256, max_seq_len=512,
        norm="layernorm", activation="gelu", use_rope=False,
        pos_embed="none", subquadratic=True,
        recurrent=RecurrentConfig(kind="mlstm", conv_width=4,
                                  mlstm_proj_factor=2.0,
                                  slstm_every=2, chunk_size=16),
    )
