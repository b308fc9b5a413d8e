"""Gradient machinery (the JAX package's ``training/grad.py``):
microbatched accumulation (sequential over microbatches, so peak
activation memory is one microbatch) and int8 error-feedback gradient
compression.

``compressed_cross_pod_mean`` all-reduces over a mesh's pod axis and is
ROADMAP item 10c, as is the reference's ``constrain_grads`` (ZeRO-2
sharding constraints): on one card both are the identity.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) with grads in the params' structure and dtype;
    a parameter the loss does not use gets zeros, as ``jax.grad`` gives."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    metrics = tree_map(lambda m: m.detach(), metrics)
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def microbatched_grads(loss_fn: Callable, params, batch,
                       num_microbatches: int):
    """loss_fn(params, microbatch) -> (loss, metrics). Returns (loss,
    metrics, mean grads). With one microbatch the grads keep the params'
    dtype; otherwise they are accumulated in fp32 over the microbatches
    (a loop in place of the reference's ``lax.scan``) and divided by their
    count, and loss and metrics are the microbatches' means."""
    if num_microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch)

    def split(x, i):
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch {b} not divisible into "
                             f"{num_microbatches} microbatches")
        n = b // num_microbatches
        return x[i * n:(i + 1) * n]

    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_acc, metrics_acc = None, None
    for i in range(num_microbatches):
        mb = tree_map(lambda x: split(x, i), batch)
        loss, metrics, grads = _value_and_grad(loss_fn, params, mb)
        for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
            a.add_(g.float())
        del grads
        loss = loss / num_microbatches
        metrics = tree_map(lambda m: m / num_microbatches, metrics)
        if loss_acc is None:
            loss_acc, metrics_acc = loss, metrics
        else:
            loss_acc = loss_acc + loss
            metrics_acc = tree_map(lambda a, m: a + m, metrics_acc, metrics)
    for a in tree_leaves(acc):
        a.div_(num_microbatches)
    return loss_acc, metrics_acc, acc


def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization: returns (q, scale, new_err)."""
    g32 = g.float() + err
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.float() * scale
    return q, scale, new_err
