"""MX precision for serving weights (the serving half of the JAX package's
``core/mx.py``).

* ``quantize_tree`` — fake-quant: fp32 trees carrying the MX rounding,
  consumed by the unmodified forward.
* ``quantize_tree_mx`` / ``dequantize_tree_mx`` — the RESIDENT form: weight
  leaves stored as actual MX representations (int8 mantissas + shared
  exponents, ~3.5× smaller than fp32); ``dequantize_tree_mx`` reproduces
  ``quantize_tree``'s output bit for bit. ``ServingParamsCache``
  (core/kernel.py) keeps these resident.

Every leaf goes through ``kernels.ops``: on the card the hand-written MX
kernels, on the CPU their plain versions. A leaf is flattened to
``[-1, shape[-1]]`` before quantizing, exactly as in the reference; since
the port keeps conv weights in HWIO, blocks run along the output channel
as they do there.
"""
from __future__ import annotations

import dataclasses

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
