"""granite-20b — dense llama-arch code model with MQA (kv=1).

[arXiv:2405.04324; hf] — gpt-bigcode lineage: multi-query attention,
LayerNorm + GELU MLP, learned absolute positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",
    mlp="gelu",
    pos="learned",
    max_position_embeddings=8192,
    source="arXiv:2405.04324; hf",
)
