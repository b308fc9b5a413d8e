"""MX precision as a training and serving feature (the JAX package's
``core/mx.py``).

* ``mx_dense`` — a matmul whose forward runs at a configurable MX precision
  (MX6 for inference/labeling, MX9 for retraining, the paper's §IV
  operating points) through the FUSED GEMM (``ops.mx_matmul_fused``), with
  a straight-through backward through the BACKWARD PAIR
  (``ops.mx_matmul_bwd_pair``): dX and dW from ONE launch.
* ``mx_dense_prequant`` — weight-resident serving against a weight stored
  once in rhs layout (``ops.mx_quantize_rhs``), through
  ``ops.mx_matmul_prequant``; ``activation_quant`` — straight-through
  activation fake-quant.
* ``quantize_tree`` — fake-quant: fp32 trees carrying the MX rounding,
  consumed by the unmodified forward.
* ``quantize_tree_mx`` / ``dequantize_tree_mx`` — the RESIDENT form: weight
  leaves stored as actual MX representations (int8 mantissas + shared
  exponents, ~3.5× smaller than fp32); ``dequantize_tree_mx`` reproduces
  ``quantize_tree``'s output bit for bit. ``ServingParamsCache``
  (core/kernel.py) keeps these resident. A tree takes one quantize and one
  dequantize call (``ops.mx_quantize_many`` / ``mx_dequantize_many``): on
  the card one launch each, whatever its number of leaves.

Everything goes through ``kernels.ops``: on the card the hand-written MX
kernels, on the CPU their plain versions. A leaf is flattened to
``[-1, shape[-1]]`` before quantizing, exactly as in the reference; since
the port keeps conv weights in HWIO, blocks run along the output channel
as they do there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import MXTensor
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-kernel MX precisions (paper §IV step 2)."""

    inference: str = "mx6"
    labeling: str = "mx6"
    retraining: str = "mx9"
    backward: str = "mx9"


DEFAULT_POLICY = PrecisionPolicy()


def _quantizable(p, min_size: int) -> bool:
    return (isinstance(p, torch.Tensor) and p.dim() >= 2
            and p.numel() >= min_size and p.is_floating_point())


def quantize_tree(params, precision: str, min_size: int = 1024):
    """Fake-quant every >=2D weight leaf of at least ``min_size`` elements
    to ``precision`` (the retraining master copy stays fp32): the round
    trip through the resident form, one quantize and one dequantize launch
    for the whole tree on the card."""
    return dequantize_tree_mx(quantize_tree_mx(params, precision, min_size))


@dataclasses.dataclass(frozen=True)
class MXLeaf:
    """A weight leaf held in its RESIDENT quantized MX form: ``q`` is the
    MX representation of the leaf flattened to [-1, last_dim] and padded
    to a 16 multiple; ``shape``/``dtype``/``k`` record what the exact round
    trip back to the fake-quant leaf needs."""

    q: MXTensor
    shape: tuple
    dtype: torch.dtype
    k: int


def quantize_tree_mx(params, precision: str, min_size: int = 1024):
    """Quantize every weight leaf :func:`quantize_tree` would touch into its
    RESIDENT MX representation (``MXLeaf``): one ``ops.mx_quantize_many``
    call for all of them, so on the card one launch, each leaf's fields
    views of arenas shared by the tree. Other leaves come back as the same
    objects."""
    leaves = tree_leaves(params)
    picked = [_quantizable(p, min_size) for p in leaves]
    qs = iter(ops.mx_quantize_many(
        [p for p, take in zip(leaves, picked) if take], precision))
    out = iter([MXLeaf(next(qs), tuple(p.shape), p.dtype, int(p.shape[-1]))
                if take else p for p, take in zip(leaves, picked)])
    return tree_map(lambda _: next(out), params)


def dequantize_tree_mx(qtree):
    """Expand a :func:`quantize_tree_mx` tree back to the fake-quant fp32
    serving tree — bit-identical to ``quantize_tree`` on the source — in
    one ``ops.mx_dequantize_many`` call (one launch on the card). An
    ``MXLeaf``, a dataclass, is a leaf of the tree functions."""
    leaves = tree_leaves(qtree)
    mx = [p for p in leaves if isinstance(p, MXLeaf)]
    ys = iter(ops.mx_dequantize_many([p.q for p in mx], [p.shape for p in mx],
                                     [p.dtype for p in mx]))
    out = iter([next(ys) if isinstance(p, MXLeaf) else p for p in leaves])
    return tree_map(lambda _: next(out), qtree)


class _MXDense(torch.autograd.Function):
    """``mx_dense``'s forward (one fused GEMM at ``fwd_prec``) and backward
    (one backward-pair launch at ``bwd_prec``), as the reference's
    ``custom_vjp`` (``_mx_dense_fwd`` / ``_mx_dense_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, fwd_prec, bwd_prec):
        ctx.save_for_backward(x, w)
        ctx.bwd_prec = bwd_prec
        shape = x.shape
        y = ops.mx_matmul_fused(x.reshape(-1, shape[-1]), w, fwd_prec,
                                fwd_prec)
        return y.reshape(*shape[:-1], w.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        shape = x.shape
        g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
        # dX = g @ W^T ; dW = X^T @ g — ONE backward-pair launch.
        dx, dw = ops.mx_matmul_bwd_pair(g2, x.reshape(-1, shape[-1]), w,
                                        ctx.bwd_prec)
        return dx.reshape(shape).to(x.dtype), dw.to(w.dtype), None, None


def mx_dense(x: torch.Tensor, w: torch.Tensor, fwd_prec: str = "mx9",
             bwd_prec: str = "mx9") -> torch.Tensor:
    """x [..., K] @ w [K, N] with MX quantization of both operands, fused
    into the GEMM. Differentiable: the backward quantizes the incoming
    cotangent and the saved operands at ``bwd_prec`` (straight-through
    estimator), the paper's MX9 retraining path (§V-C)."""
    return _MXDense.apply(x, w, fwd_prec, bwd_prec)


def mx_dense_prequant(x: torch.Tensor, qw: MXTensor,
                      fwd_prec: str = "mx6") -> torch.Tensor:
    """Weight-resident serving matmul: ``x [..., K]`` against a weight
    already stored in rhs layout (``ops.mx_quantize_rhs(w, precision)``).
    Bit-identical to ``mx_dense(x, w, fwd_prec, ...)``'s forward, with no
    weight quantization per call. Serving only — no gradient."""
    shape = x.shape
    y = ops.mx_matmul_prequant(x.reshape(-1, shape[-1]), qw, fwd_prec)
    return y.reshape(*shape[:-1], y.shape[-1]).to(x.dtype)


def activation_quant(x: torch.Tensor,
                     precision: Optional[str]) -> torch.Tensor:
    """Straight-through activation fake-quant (identity gradient)."""
    if precision is None:
        return x
    y = ops.mx_quant_dequant(x, precision)
    return x + (y - x).detach()
