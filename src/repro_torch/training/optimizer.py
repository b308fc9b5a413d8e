"""Optimizers (SGD-momentum — the paper's retraining choice — and AdamW)
and the LR schedule (the JAX package's ``training/optimizer.py``); fp32
moments whatever the params' dtype (bf16 params keep fp32 moments).

The reference's ``apply_updates`` is a pure function of trees, and its
train step donates the old state. The port updates in place instead, leaf
by leaf: each parameter and its moments are rewritten where they lie, so a
step needs one leaf's temporaries beside params, moments and gradients
(full-width gemma2-2b in fp32 holds 4 x 10.46 GB of those; a tree-wide
functional update would add another 42 GB). The arithmetic per element is
the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import is_dtensor
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | sgd
    lr: float = 3e-4
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def schedule(step, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32 as the reference computes it:
    a 0-d fp32 CPU tensor."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=f32) * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params, cfg: OptimizerConfig):
    def f32(p):  # laid out as p (a DTensor's moments are DTensors)
        return torch.zeros_like(p, dtype=torch.float32)

    if cfg.name == "sgd":
        return {"mu": tree_map(f32, params)}
    return {"mu": tree_map(f32, params), "nu": tree_map(f32, params)}


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in fp32. A DTensor sums its local part and the ranks' parts
    over each mesh dim that splits it (DTensor cannot flatten a dim split
    unevenly, such as the sLSTM's d_up of 85 over 2 ranks)."""
    if not is_dtensor(x):
        x32 = x.float().reshape(-1)
        return torch.dot(x32, x32)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    x32 = x.to_local().float().reshape(-1)
    sq = DTensor.from_local(torch.dot(x32, x32), mesh, [
        Partial() if isinstance(p, Shard) else Replicate()
        for p in x.placements])
    return sq.redistribute(mesh, [Replicate()] * mesh.ndim)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), in fp32, on the leaves' device."""
    total = None
    for x in tree_leaves(tree):
        sq = _square_sum(x)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, step, cfg: OptimizerConfig):
    """Returns (params, state, metrics): ``params`` and ``state`` updated
    in place, leaf by leaf (module docstring); metrics ``lr`` and
    ``grad_norm`` as 0-d tensors (no host sync)."""
    p_leaves = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    if len(p_leaves) != len(g_leaves):
        raise ValueError("params and grads differ in structure")
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else None)
    lr_f = float(lr)  # an fp32 value: exact as a Python scalar

    def clipped(g):
        return g.float() if scale is None else g.float() * scale

    mu_leaves = tree_leaves(state["mu"])
    if cfg.name == "sgd":
        for p, g, m in zip(p_leaves, g_leaves, mu_leaves):
            m.mul_(cfg.momentum).add_(clipped(g))
            p.copy_(p.float() - lr_f * m)
        return params, state, {"lr": lr, "grad_norm": gnorm}

    f32 = torch.float32
    t = torch.tensor(float(step) + 1.0, dtype=f32)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = float(1 - torch.tensor(b1, dtype=f32) ** t)
    c2 = float(1 - torch.tensor(b2, dtype=f32) ** t)
    for p, g, m, v in zip(p_leaves, g_leaves, mu_leaves,
                          tree_leaves(state["nu"])):
        g32 = clipped(g)
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        upd = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
        if cfg.weight_decay:
            upd.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float() - lr_f * upd)
    return params, state, {"lr": lr, "grad_norm": gnorm}
