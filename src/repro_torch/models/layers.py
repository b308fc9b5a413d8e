"""Shared building blocks of the LMs: norms, positions, activations, MLPs
(the JAX package's ``models/layers.py``).

Norms, rope and sincos positions compute in fp32 and cast back to the
input's dtype, as the reference does. ``jax.nn.gelu`` is the tanh
approximation, so every GELU here is ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ParamDef, constrain, gathered


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_defs(cfg: ArchConfig, d: int):
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDef((d,), (None,), init="zeros",
                                  dtype=torch.float32)}
    return {
        "scale": ParamDef((d,), (None,), init="ones", dtype=torch.float32),
        "bias": ParamDef((d,), (None,), init="zeros", dtype=torch.float32),
    }


def apply_norm(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def softcap(x: torch.Tensor, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ------------------------------------------------------------------- positions
def _inverse_freqs(half: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [*shape] -> (sin, cos) [*shape, head_dim/2], fp32."""
    inv = _inverse_freqs(head_dim // 2, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; sin/cos broadcastable [..., S, 1, D/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sincos_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    inv = _inverse_freqs(d_model // 2, 10_000.0, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------------------ MLPs
def mlp_defs(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    dt = param_dtype(cfg)
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": ParamDef((d, f), ("embed", "ff"), dtype=dt),
            "w_up": ParamDef((d, f), ("embed", "ff"), dtype=dt),
            "w_down": ParamDef((f, d), ("ff", "embed"), dtype=dt),
        }
    if cfg.mlp == "gelu":
        return {
            "w_up": ParamDef((d, f), ("embed", "ff"), dtype=dt),
            "b_up": ParamDef((f,), ("ff",), init="zeros", dtype=dt),
            "w_down": ParamDef((f, d), ("ff", "embed"), dtype=dt),
            "b_down": ParamDef((d,), (None,), init="zeros", dtype=dt),
        }
    raise ValueError(cfg.mlp)


def mlp_forward(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]."""
    up = gathered(params["w_up"], "embed", "ff")
    down = gathered(params["w_down"], "ff", "embed")
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ gathered(params["w_gate"], "embed", "ff")
        u = x @ up
        act = (F.silu(g) if cfg.mlp == "swiglu"
               else F.gelu(g, approximate="tanh"))
        h = constrain(act * u, "act_batch", "act_seq", "ff")
        return h @ down
    h = F.gelu(x @ up + params["b_up"], approximate="tanh")
    h = constrain(h, "act_batch", "act_seq", "ff")
    return h @ down + params["b_down"]
