"""Architecture & shape configuration dataclasses (a copy of the JAX
package's framework-free ``configs/base.py``).

Every assigned architecture gets one module defining an ``ArchConfig`` with the
exact published hyperparameters; ``reduced()`` derives a small same-family config
for CPU smoke tests. ``ShapeConfig`` describes the assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

MIXER_ATTENTION = "attention"
MIXER_MAMBA = "mamba"
MIXER_MLSTM = "mlstm"
MIXER_SLSTM = "slstm"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Declarative model description consumed by ``repro_torch.models.transformer``."""

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # Norm / MLP / positional choices.
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | geglu | gelu | none
    pos: str = "rope"  # rope | learned | sincos | none
    rope_theta: float = 10_000.0
    max_position_embeddings: int = 1_048_576

    # Attention variants.
    sliding_window: Optional[int] = None  # SWA on every attention layer
    local_global_period: int = 0  # >0: alternate local(window)/global layers
    local_window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    post_block_norm: bool = False  # gemma2-style post norms
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model)

    # Layer pattern (which mixer at which depth).
    mixer_default: str = MIXER_ATTENTION
    attn_layer_period: int = 1  # attention every k-th layer when default!=attention
    attn_layer_offset: int = 0
    slstm_at: Tuple[int, ...] = ()

    # Mixture-of-Experts.
    num_experts: int = 0
    top_k: int = 0
    expert_layer_period: int = 1
    expert_layer_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # Mamba (S6).
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # xLSTM.
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # IO.
    input_mode: str = "tokens"  # tokens | embeddings (vlm/audio frontend stub)
    num_output_heads: int = 1  # musicgen: 4 codebook heads
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""  # provenance note from the assignment

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def mixer_for_layer(self, i: int) -> str:
        if self.mixer_default == MIXER_ATTENTION:
            return MIXER_ATTENTION
        if self.mixer_default == MIXER_MAMBA:
            if i % self.attn_layer_period == self.attn_layer_offset:
                return MIXER_ATTENTION
            return MIXER_MAMBA
        if self.mixer_default == MIXER_MLSTM:
            return MIXER_SLSTM if i in self.slstm_at else MIXER_MLSTM
        raise ValueError(self.mixer_default)

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts <= 0:
            return False
        return i % self.expert_layer_period == self.expert_layer_offset

    def is_local_layer(self, i: int) -> bool:
        """gemma2-style alternation: even layers local, odd layers global."""
        if self.local_global_period <= 0:
            return False
        return i % self.local_global_period == 0

    def layer_signature(self, i: int) -> tuple:
        return (self.mixer_for_layer(i), self.is_moe_layer(i), self.is_local_layer(i))

    def pattern_period(self) -> int:
        """Smallest p dividing num_layers with a repeating layer signature."""
        for p in range(1, self.num_layers + 1):
            if self.num_layers % p:
                continue
            if all(
                self.layer_signature(i) == self.layer_signature(i % p)
                for i in range(self.num_layers)
            ):
                return p
        return self.num_layers

    # ------------------------------------------------------------ param counts
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, h = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.num_output_heads * self.vocab_size * d
        if self.pos == "learned":
            total += self.max_position_embeddings * d
        for i in range(self.num_layers):
            mixer = self.mixer_for_layer(i)
            if mixer == MIXER_ATTENTION:
                total += d * h * (n_q + 2 * n_kv) + n_q * h * d
            elif mixer == MIXER_MAMBA:
                d_in = self.mamba_expand * d
                total += d * 2 * d_in  # in_proj
                total += d_in * self.mamba_d_conv  # conv
                total += d_in * (2 * self.mamba_d_state + 1)  # B,C,dt proj (x-dep)
                total += d_in * self.mamba_d_state  # A
                total += d_in * 2  # D, dt bias
                total += d_in * d  # out proj
            elif mixer == MIXER_MLSTM:
                d_in = int(self.mlstm_proj_factor * d)
                total += d * 2 * d_in + 3 * d_in * d_in + d_in * d + 4 * d_in
            elif mixer == MIXER_SLSTM:
                d_in = d
                total += 4 * d_in * d_in + 4 * d_in  # recurrent gates
                pf = self.slstm_proj_factor
                total += int(d_in * d_in * pf * 2)  # up/down proj
            if self.mlp != "none" and self.d_ff > 0:
                n_mat = 3 if self.mlp in ("swiglu", "geglu") else 2
                ff = n_mat * d * self.d_ff
                if self.is_moe_layer(i):
                    total += self.num_experts * ff + d * self.num_experts
                else:
                    total += ff
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if self.num_experts <= 0:
            return self.param_count()
        total = self.param_count()
        n_mat = 3 if self.mlp in ("swiglu", "geglu") else 2
        ff = n_mat * self.d_model * self.d_ff
        n_moe = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        total -= n_moe * (self.num_experts - self.top_k) * ff
        return total

    # ------------------------------------------------------------------ reduced
    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        period = self.pattern_period()
        n_layers = max(period, 2 if period == 1 else period)
        slstm_at = tuple(i for i in range(n_layers) if i in {x % period for x in self.slstm_at})
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            mamba_d_state=8,
            max_position_embeddings=512,
            slstm_at=slstm_at,
            dtype="float32",
        )


TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = (
    ShapeConfig("train_4k", 4_096, 256, TRAIN),
    ShapeConfig("prefill_32k", 32_768, 32, PREFILL),
    ShapeConfig("decode_32k", 32_768, 128, DECODE),
    ShapeConfig("long_500k", 524_288, 1, DECODE),
)
SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


def supports_long_context(arch: ArchConfig) -> bool:
    """long_500k needs sub-quadratic attention (SWA/local/SSM/hybrid)."""
    if arch.mixer_default != MIXER_ATTENTION:
        return True  # ssm / hybrid / xlstm
    return arch.sliding_window is not None or arch.local_global_period > 0


def supports_shape(arch: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return supports_long_context(arch)
    return True


def flops_per_token(arch: ArchConfig, training: bool) -> float:
    """MODEL_FLOPS: 6·N·D rule (dense) / 6·N_active·D (MoE); 2·N for inference."""
    n = arch.active_param_count() - arch.vocab_size * arch.d_model  # non-embedding
    mult = 6.0 if training else 2.0
    return mult * n


def attention_flops(arch: ArchConfig, seq_len: int, training: bool) -> float:
    """Quadratic attention term per sequence (both QK^T and AV einsums)."""
    total = 0.0
    for i in range(arch.num_layers):
        if arch.mixer_for_layer(i) != MIXER_ATTENTION:
            continue
        window = None
        if arch.sliding_window is not None:
            window = arch.sliding_window
        if arch.local_global_period and arch.is_local_layer(i):
            window = arch.local_window
        eff = seq_len if window is None else min(window, seq_len)
        # causal: ~ S*eff/2 when eff==S else S*eff
        pairs = seq_len * eff / (2 if window is None else 1)
        flops = 2 * 2 * pairs * arch.num_heads * arch.resolved_head_dim
        total += flops * (3 if training else 1)
    return total
