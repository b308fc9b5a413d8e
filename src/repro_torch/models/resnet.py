"""ResNet / WideResNet (paper Table III students and teachers) in PyTorch.

Functional, over a parameter dict with the JAX package's structure and key
names. Conv weights stay in the reference's HWIO layout inside the tree
(so MX quantization blocks them along the same axis) and are permuted to
OIHW only at the ``F.conv2d`` call. Images come in as NHWC, as in the
reference; the body runs NCHW. GroupNorm replaces BatchNorm, as there.

Two details of the reference that torch does not do by default:

* XLA's "SAME" padding is asymmetric under stride 2 — pad (total//2,
  total - total//2) — so it is applied with an explicit ``F.pad``
  (torch's ``padding=`` is symmetric); the 224-px max-pool pads with -inf.
* GroupNorm's variance is the population variance (ddof 0).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.tree import tree_leaves, tree_map

_STAGES = {
    18: ((2, 2, 2, 2), "basic"),
    34: ((3, 4, 6, 3), "basic"),
    50: ((3, 4, 6, 3), "bottleneck"),
    101: ((3, 4, 23, 3), "bottleneck"),
}


def block_plan(cfg: VisionConfig) -> List[Tuple[str, int, int, int, int]]:
    """[(kind, cin, mid, cout, stride), ...] — static, derived from config."""
    stages, kind = _STAGES[cfg.depth]
    plan = []
    cin = cfg.base
    for stage, n_blocks in enumerate(stages):
        base = cfg.base * (2 ** stage)
        if kind == "bottleneck":
            mid, cout = base * cfg.width_mult, base * 4
        else:
            mid, cout = base * cfg.width_mult, base * cfg.width_mult
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            plan.append((kind, cin, mid, cout, stride))
            cin = cout
    return plan


def _conv_def(gen: torch.Generator, cin: int, cout: int,
              ksize: int) -> torch.Tensor:
    scale = (ksize * ksize * cin) ** -0.5
    return torch.randn((ksize, ksize, cin, cout), generator=gen) * scale


def _gn_def(c: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((c,)), "bias": torch.zeros((c,))}


def _same_pads(size: int, ksize: int, stride: int) -> Tuple[int, int]:
    """XLA "SAME": out = ceil(size/stride); the extra pad goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + ksize - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, ksize: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pads(x.shape[2], ksize, stride)
    left, right = _same_pads(x.shape[3], ksize, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x NCHW, w HWIO (the tree's layout)."""
    x = _pad_same(x, w.shape[0], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _gn(x: torch.Tensor, p: Dict[str, torch.Tensor],
        groups: int = 8) -> torch.Tensor:
    n, c, h, w = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(n, g, c // g, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + 1e-5)
    return (xg.reshape(n, c, h, w) * p["scale"][:, None, None]
            + p["bias"][:, None, None])


def init_resnet(gen: torch.Generator, cfg: VisionConfig,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random weights from ``gen`` (a CPU generator, so a seed gives the same
    weights on every device), moved to ``device``."""
    plan = block_plan(cfg)
    params: Dict[str, Any] = {
        "stem": _conv_def(gen, 3, cfg.base, 7 if cfg.img_size > 64 else 3),
        "stem_gn": _gn_def(cfg.base),
    }
    blocks: List[Dict[str, Any]] = []
    for kind, cin, mid, cout, stride in plan:
        bp: Dict[str, Any] = {}
        if kind == "basic":
            bp["conv1"] = _conv_def(gen, cin, mid, 3)
            bp["gn1"] = _gn_def(mid)
            bp["conv2"] = _conv_def(gen, mid, cout, 3)
            bp["gn2"] = _gn_def(cout)
        else:
            bp["conv1"] = _conv_def(gen, cin, mid, 1)
            bp["gn1"] = _gn_def(mid)
            bp["conv2"] = _conv_def(gen, mid, mid, 3)
            bp["gn2"] = _gn_def(mid)
            bp["conv3"] = _conv_def(gen, mid, cout, 1)
            bp["gn3"] = _gn_def(cout)
        if stride != 1 or cin != cout:
            bp["proj"] = _conv_def(gen, cin, cout, 1)
            bp["proj_gn"] = _gn_def(cout)
        blocks.append(bp)
    params["blocks"] = blocks
    cfinal = plan[-1][3]
    params["head_w"] = (torch.randn((cfinal, cfg.num_classes), generator=gen)
                        * cfinal ** -0.5)
    params["head_b"] = torch.zeros((cfg.num_classes,))
    if device is not None:
        params = tree_map(lambda p: p.to(device), params)
    return params


def resnet_forward(params, images: torch.Tensor,
                   cfg: VisionConfig) -> torch.Tensor:
    """images [B,H,W,3] -> logits [B,C]."""
    big = images.shape[1] > 64
    x = images.permute(0, 3, 1, 2)
    x = _conv(x, params["stem"], stride=2 if big else 1)
    x = F.relu(_gn(x, params["stem_gn"]))
    if big:
        x = F.max_pool2d(_pad_same(x, 3, 2, value=float("-inf")), 3, 2)
    for bp, (kind, cin, mid, cout, stride) in zip(params["blocks"],
                                                  block_plan(cfg)):
        resid = x
        if kind == "basic":
            y = F.relu(_gn(_conv(x, bp["conv1"], stride), bp["gn1"]))
            y = _gn(_conv(y, bp["conv2"]), bp["gn2"])
        else:
            y = F.relu(_gn(_conv(x, bp["conv1"]), bp["gn1"]))
            y = F.relu(_gn(_conv(y, bp["conv2"], stride), bp["gn2"]))
            y = _gn(_conv(y, bp["conv3"]), bp["gn3"])
        if "proj" in bp:
            resid = _gn(_conv(x, bp["proj"], stride), bp["proj_gn"])
        x = F.relu(resid + y)
    x = x.mean(dim=(2, 3))
    return x @ params["head_w"] + params["head_b"]


def resnet_flops(cfg: VisionConfig) -> float:
    """Forward-pass MACs*2 at cfg.img_size (conv + fc terms)."""
    h = w = cfg.img_size
    total = 0.0
    stem_k = 7 if cfg.img_size > 64 else 3
    stride0 = 2 if cfg.img_size > 64 else 1
    h, w = h // stride0, w // stride0
    total += 2 * stem_k * stem_k * 3 * cfg.base * h * w
    if cfg.img_size > 64:
        h, w = h // 2, w // 2
    for kind, cin, mid, cout, stride in block_plan(cfg):
        h2, w2 = h // stride, w // stride
        if kind == "basic":
            total += 2 * 9 * cin * mid * h2 * w2
            total += 2 * 9 * mid * cout * h2 * w2
        else:
            total += 2 * cin * mid * h * w
            total += 2 * 9 * mid * mid * h2 * w2
            total += 2 * mid * cout * h2 * w2
        if stride != 1 or cin != cout:
            total += 2 * cin * cout * h2 * w2
        h, w = h2, w2
    total += 2 * block_plan(cfg)[-1][3] * cfg.num_classes
    return total


def resnet_param_count(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
