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
  (core/kernel.py) keeps these resident.

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
from repro_torch.tree import tree_map


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
    to ``precision`` (the retraining master copy stays fp32)."""
    def q(p):
        if not _quantizable(p, min_size):
            return p
        return ops.mx_quant_dequant(p, precision)

    return tree_map(q, params)


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


def _dequant_leaf(leaf: MXLeaf) -> torch.Tensor:
    y = ops.mx_dequantize(leaf.q)
    if y.shape[-1] != leaf.k:
        y = y[:, : leaf.k]
    return y.reshape(leaf.shape).to(leaf.dtype)


def quantize_tree_mx(params, precision: str, min_size: int = 1024):
    """Quantize every weight leaf :func:`quantize_tree` would touch into its
    RESIDENT MX representation (``MXLeaf``)."""
    def q(p):
        if not _quantizable(p, min_size):
            return p
        return MXLeaf(ops.mx_quantize(p, precision), tuple(p.shape), p.dtype,
                      int(p.shape[-1]))

    return tree_map(q, params)


def dequantize_tree_mx(qtree):
    """Expand a :func:`quantize_tree_mx` tree back to the fake-quant fp32
    serving tree — bit-identical to ``quantize_tree`` on the source."""
    return tree_map(lambda p: _dequant_leaf(p) if isinstance(p, MXLeaf)
                    else p, qtree, is_leaf=lambda p: isinstance(p, MXLeaf))


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
