"""xlstm-125m — sLSTM + mLSTM blocks (xLSTM[~7:1] mix), d_ff=0.

[arXiv:2405.04517; unverified] — blocks carry their own projections
(mLSTM proj factor 2, sLSTM post-proj factor 4/3); no separate MLP.
sLSTM blocks at depths 3 and 9 (pattern period 6).
"""
from repro_torch.configs.base import ArchConfig, MIXER_MLSTM

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    norm="layernorm",
    mlp="none",
    pos="none",
    mixer_default=MIXER_MLSTM,
    slstm_at=(3, 9),
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)
