"""Logical -> mesh sharding rules per (arch x shape kind x mesh) (the JAX
package's ``launch/sharding.py``).

Scheme, as in the reference:
  * train   — DP over ("pod", "data"), FSDP (ZeRO-3) weight sharding over
    "data", Megatron TP over "model"; MoE expert-parallel over "model".
  * prefill — batch over "data", TP over "model"; weights replicated over
    "data" (but the experts) for latency; sequence-parallel attention for
    archs whose head count does not divide the model axis.
  * decode  — batch over "data"; KV caches sequence-sharded over "model"
    (the flash-decode combine); long_500k shards the KV sequence over
    ("data", "model").

Pure logic over axis names and sizes: the mesh may be a ``DeviceMesh`` or
an abstract one (``launch/mesh.py``).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import ShardingRules, axis_names, mesh_axis_size


def heads_divisible(arch: ArchConfig, mesh) -> bool:
    tp = mesh_axis_size(mesh, "model") if mesh else 1
    return arch.num_heads % tp == 0


def make_rules(arch: ArchConfig, shape: ShapeConfig, mesh) -> ShardingRules:
    if mesh is None:
        return ShardingRules()
    multi_pod = "pod" in axis_names(mesh)
    dp = ("pod", "data") if multi_pod else ("data",)
    head_mode = heads_divisible(arch, mesh)

    rules = ShardingRules({
        # Weights.
        "ff": "model",
        "ff2": "model",
        "vocab": "model",
        "expert": "model",  # EP over the tensor axis (batch stays on data)
        "expert_in": "data",  # expert d_model dim FSDP-sharded
        "expert_ff": None,
        "kv_heads": None,  # kv heads replicated across TP (GQA < tp)
        "heads": "model" if head_mode else None,
        "heads_fused": "model",  # fused h * dh always divides the TP axis
        "kv_fused": "model",
        "head_dim": None,
        "layers": None,
        # Activations.
        "act_batch": dp,
        "act_embed": None,
        "act_seq": None,
        # KV cache.
        "kv_batch": "data",
        "kv_seq": "model",
    })

    if shape.kind == "train":
        rules["embed"] = "data"  # FSDP / ZeRO-3 over the data axis
        rules["batch"] = dp
        if not head_mode:
            rules["attn_seq"] = "model"  # sequence-parallel attention
    else:
        # Serving: non-expert weights replicated over data for latency.
        rules["embed"] = None
        rules["batch"] = ("data",)
        if not head_mode and shape.kind == "prefill":
            rules["attn_seq"] = "model"

    if shape.kind == "decode":
        if shape.global_batch < mesh_axis_size(mesh, "data"):
            # long_500k: a batch of 1 shards the KV sequence over all.
            rules["kv_batch"] = None
            rules["act_batch"] = None
            rules["batch"] = None
            rules["kv_seq"] = ("data", "model")
    return rules
