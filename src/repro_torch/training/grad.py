"""Gradient machinery (the JAX package's ``training/grad.py``):
microbatched accumulation (sequential over microbatches, so peak
activation memory is one microbatch), the ZeRO-2 ``constrain_grads`` hook,
and int8 error-feedback gradient compression with its cross-pod mean.

Over a mesh the params are DTensors: each gradient comes back laid out as
its parameter is (a partial sum is reduced to it), so the optimizer
updates every rank's part in place.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import counts
from repro_torch.distributed import is_dtensor
from repro_torch.tree import tree_leaves, tree_map


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) with grads in the params' structure, dtype
    and layout; a parameter the loss does not use gets zeros, as
    ``jax.grad`` gives."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else _like_param(g, p)
              for p, g in zip(leaves, grads))
    metrics = tree_map(lambda m: m.detach(), metrics)
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def microbatched_grads(loss_fn: Callable, params, batch,
                       num_microbatches: int,
                       constrain_grads: Optional[Callable] = None):
    """loss_fn(params, microbatch) -> (loss, metrics). Returns (loss,
    metrics, mean grads). With one microbatch the grads keep the params'
    dtype; otherwise they are accumulated in fp32 over the microbatches
    (a loop in place of the reference's ``lax.scan``) and divided by their
    count, and loss and metrics are the microbatches' means.
    ``constrain_grads`` (ZeRO-2): a tree -> tree layout applied to the
    gradients and to the accumulator after each microbatch, so that it
    lives sharded (``launch/steps.py``'s ``zero2_gather``)."""
    if num_microbatches <= 1:
        loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        if constrain_grads is not None:
            grads = constrain_grads(grads)
        return loss, metrics, grads

    def split(x, i):
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch {b} not divisible into "
                             f"{num_microbatches} microbatches")
        n = b // num_microbatches
        return x[i * n:(i + 1) * n]

    acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    if constrain_grads is not None:
        acc = constrain_grads(acc)
    loss_acc, metrics_acc = None, None
    for i in counts.repeat(num_microbatches):
        mb = tree_map(lambda x: split(x, i), batch)
        loss, metrics, grads = _value_and_grad(loss_fn, params, mb)
        if constrain_grads is not None:
            grads = constrain_grads(grads)
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


def compressed_cross_pod_mean(grads, err_state, mesh, pod_axis: str = "pod"):
    """The mean of every rank's gradients over the mesh's ``pod_axis``,
    crossing it at 8 bits: per leaf, ``compress_int8`` with its error
    state, an all-reduce SUM of the dequantized leaf over the pod group,
    a divide by the pod count. Returns (grads, new error state); the
    quantization error is re-injected at the next step, as in the
    reference. The leaves are this rank's own tensors (the reduction
    within a pod has happened)."""
    npods = mesh.size(mesh.mesh_dim_names.index(pod_axis))
    group = mesh.get_group(pod_axis)

    mean, errs = [], []
    for g, err in zip(tree_leaves(grads), tree_leaves(err_state)):
        q, scale, new_err = compress_int8(g, err)
        total = q.float() * scale
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean.append(total / npods)
        errs.append(new_err)
    mean, errs = iter(mean), iter(errs)
    return (tree_map(lambda _: next(mean), grads),
            tree_map(lambda _: next(errs), grads))
