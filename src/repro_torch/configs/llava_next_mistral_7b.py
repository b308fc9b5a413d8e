"""llava-next-mistral-7b — Mistral-7B backbone, anyres vision frontend stubbed.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — the vision tower/anyres
tiling is a frontend stub: ``input_specs()`` supplies precomputed patch
embeddings of width d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    norm="rmsnorm",
    mlp="swiglu",
    pos="rope",
    rope_theta=1_000_000.0,
    input_mode="embeddings",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
