"""mixtral-8x22b — sparse MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    norm="rmsnorm",
    mlp="swiglu",
    pos="rope",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    num_experts=8,
    top_k=2,
    source="arXiv:2401.04088; hf",
)
