"""gemma2-2b — local/global alternating attention, logit softcapping.

[arXiv:2408.00118; hf] — head_dim 256, GeGLU, pre+post RMSNorm,
embedding scaling, attn softcap 50, final softcap 30, local window 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    norm="rmsnorm",
    mlp="geglu",
    pos="rope",
    rope_theta=10_000.0,
    local_global_period=2,
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_block_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    query_scale=0.0625,  # 1/sqrt(256)
    source="arXiv:2408.00118; hf",
)
