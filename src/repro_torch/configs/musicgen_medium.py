"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] — MHA (kv=24), LayerNorm + GELU, sinusoidal positions,
4 parallel codebook output heads; the EnCodec frontend is a stub:
``input_specs()`` supplies precomputed frame embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    norm="layernorm",
    mlp="gelu",
    pos="sincos",
    input_mode="embeddings",
    num_output_heads=4,
    source="arXiv:2306.05284; hf",
)
