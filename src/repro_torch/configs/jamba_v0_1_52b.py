"""jamba-v0.1-52b — hybrid Mamba+attention (1:7 interleave), MoE 16 experts top-2.

[arXiv:2403.19887; hf] — attention every 8th layer (offset 4), MoE every 2nd
layer (offset 1), no positional encoding (Mamba carries position).
"""
from repro_torch.configs.base import ArchConfig, MIXER_MAMBA

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    norm="rmsnorm",
    mlp="swiglu",
    pos="none",
    mixer_default=MIXER_MAMBA,
    attn_layer_period=8,
    attn_layer_offset=4,
    num_experts=16,
    top_k=2,
    expert_layer_period=2,
    expert_layer_offset=1,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    source="arXiv:2403.19887; hf",
)
