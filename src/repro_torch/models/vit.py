"""ViT-B/32 and ViT-B/16 (paper Table III) in PyTorch.

Functional, over a parameter dict with the JAX package's structure and key
names (``patch``, ``cls``, ``pos``, ``blocks[i].{ln1, qkv, proj, ln2, fc1,
fc2}``, ``final_ln``, ``head``; dense weights [in, out]). Images come in as
NHWC. Attention goes through ``kernels.ops.flash_attention`` (non-causal):
the hand-written kernel for a CUDA tensor, its plain version for a CPU one.

Details of the reference kept exactly:

* a patch vector is (row, column, channel): the image is reshaped to
  [b, h/p, p, w/p, p, 3] and transposed (0, 1, 3, 2, 4, 5);
* qkv is reshaped [b, n, 3, heads, dh], the 3 before the heads;
* LayerNorm uses the population variance and eps 1e-6;
* the GELU is the tanh approximation (``jax.nn.gelu``'s default);
* the cls token is tiled over the batch and ``pos`` sliced to the tokens.

The reference divides the logits by ``dh ** 0.5``; the kernel multiplies
by ``dh ** -0.5``. For dh = 16 and 64 both are exact powers of two.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map


def _dense_def(gen: torch.Generator, cin: int,
               cout: int) -> Dict[str, torch.Tensor]:
    return {"w": torch.randn((cin, cout), generator=gen) * cin ** -0.5,
            "b": torch.zeros((cout,))}


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def _ln_def(d: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,)), "bias": torch.zeros((d,))}


def init_vit(gen: torch.Generator, cfg: VisionConfig,
             device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random weights from ``gen`` (a CPU generator, so a seed gives the same
    weights on every device), moved to ``device``."""
    d = cfg.d_model
    n_patches = (cfg.img_size // cfg.patch) ** 2
    params: Dict[str, Any] = {
        "patch": _dense_def(gen, cfg.patch * cfg.patch * 3, d),
        "cls": torch.randn((1, 1, d), generator=gen) * 0.02,
        "pos": torch.randn((1, n_patches + 1, d), generator=gen) * 0.02,
        "final_ln": _ln_def(d),
        "head": _dense_def(gen, d, cfg.num_classes),
    }
    params["blocks"] = [{
        "ln1": _ln_def(d),
        "qkv": _dense_def(gen, d, 3 * d),
        "proj": _dense_def(gen, d, d),
        "ln2": _ln_def(d),
        "fc1": _dense_def(gen, d, cfg.d_ff),
        "fc2": _dense_def(gen, cfg.d_ff, d),
    } for _ in range(cfg.num_layers)]
    if device is not None:
        params = tree_map(lambda p: p.to(device), params)
    return params


def vit_forward(params, images: torch.Tensor,
                cfg: VisionConfig) -> torch.Tensor:
    """images [B,H,W,3] -> logits [B,C]."""
    b, h, w, _ = images.shape
    p = cfg.patch
    x = images.reshape(b, h // p, p, w // p, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = _dense(x.reshape(b, (h // p) * (w // p), p * p * 3), params["patch"])
    x = torch.cat([params["cls"].expand(b, -1, -1), x], dim=1)
    x = x + params["pos"][:, : x.shape[1]]
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    for bp in params["blocks"]:
        y = _ln(x, bp["ln1"])
        qkv = _dense(y, bp["qkv"]).reshape(b, -1, 3, nh, dh)
        y = ops.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                causal=False)
        x = x + _dense(y.reshape(b, -1, cfg.d_model), bp["proj"])
        y = _ln(x, bp["ln2"])
        x = x + _dense(F.gelu(_dense(y, bp["fc1"]), approximate="tanh"),
                       bp["fc2"])
    x = _ln(x, params["final_ln"])
    return _dense(x[:, 0], params["head"])


def vit_flops(cfg: VisionConfig) -> float:
    n = (cfg.img_size // cfg.patch) ** 2 + 1
    d, f = cfg.d_model, cfg.d_ff
    per_layer = 2 * n * (4 * d * d + 2 * d * f) + 2 * 2 * n * n * d
    total = cfg.num_layers * per_layer
    total += 2 * n * cfg.patch * cfg.patch * 3 * d
    total += 2 * d * cfg.num_classes
    return total


def vit_param_count(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
