"""Plain PyTorch versions of the port's kernels (the MX half of the JAX
package's ``kernels/ref.py``).

MX (micro-exponent block floating point), as in the paper's §V-B:
  - blocks of 16 address-adjacent values along the last axis share an
    8-bit exponent E = the largest fp32 exponent in the block;
  - sub-blocks of 2 values carry a 1-bit micro-exponent, set when *both*
    exponents are < E (the sub-block scale drops by one, recovering one
    mantissa bit);
  - mantissas are sign-magnitude with 2 (MX4), 4 (MX6) or 7 (MX9) bits.

These functions are what the CUDA kernels (``kernels/csrc/mx_quantize.cu``)
are held to, bitwise, and what ``kernels/ops.py`` serves for a CPU tensor.
They run on any device. Two choices pin the numerics down exactly:

* Zero and fp32 denormal inputs both count as zero: exponent ``EXP_MIN``
  and mantissa 0. XLA treats denormal inputs as zero (on the TPU, and on
  the CPU the reference's tests run on), so the reference's ``x == 0.0``
  holds for them; the port states the rule instead of relying on the
  floating-point mode. Masking zeros also avoids ``0 * inf`` (the scale of
  an all-zero block overflows for mx6/mx9), whose NaN the reference
  flushes through its int8 cast and torch leaves undefined.
* Scales are exact powers of two, built from exponent bits (``_pow2``).
  The reference computes them with ``jnp.exp2``, which XLA lowers to
  ``exp(x·ln2)`` in fp32 and which is exact only for small exponents; the
  two agree wherever that ``exp2`` is exact (|n| ≤ 12), which covers
  weights and activations of ordinary magnitude.
"""
from __future__ import annotations

import dataclasses

import torch

BLOCK = 16
SUBBLOCK = 2
MANTISSA_BITS = {"mx4": 2, "mx6": 4, "mx9": 7}
EXP_MIN = -126


@dataclasses.dataclass
class MXTensor:
    """Quantized tensor: blocks of 16 along the LAST axis."""

    mantissa: torch.Tensor  # int8, same shape as source [..., K]
    exponent: torch.Tensor  # int8, [..., K//16] (shared, unbiased)
    mx_bits: torch.Tensor  # uint8, [..., K//16] (bit i = sub-block i flag)
    precision: str


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """Unbiased fp32 exponent, elementwise, as int32; zero and denormals
    give ``EXP_MIN`` (biased exponent field 0 counts as 1)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    field = torch.bitwise_and(torch.bitwise_right_shift(bits, 23), 0xFF)
    return torch.clamp(field, min=1) - 127


def _is_zero(x: torch.Tensor) -> torch.Tensor:
    """True for ±0 and fp32 denormals (exponent field 0)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_and(bits, 0x7F800000) == 0


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """Exact ``2**n`` in fp32 for an integer tensor: inf above 127,
    denormals from -127 to -149, zero below."""
    n = n.to(torch.int32)
    normal = torch.bitwise_left_shift(torch.clamp(n, -126, 127) + 127, 23)
    denormal = torch.bitwise_left_shift(torch.ones_like(n),
                                        torch.clamp(n + 149, 0, 22))
    out = torch.where(n >= -126, normal, denormal).view(torch.float32)
    out = torch.where(n > 127, torch.full_like(out, float("inf")), out)
    return torch.where(n < -149, torch.zeros_like(out), out)


def mx_quantize_ref(x: torch.Tensor, precision: str) -> MXTensor:
    """Quantize along the last axis (must be divisible by 16)."""
    mb = MANTISSA_BITS[precision]
    *lead, k = x.shape
    if k % BLOCK:
        raise ValueError(f"last dim {k} not divisible by {BLOCK}")
    nb = k // BLOCK
    xb = x.to(torch.float32).reshape(*lead, nb, BLOCK)
    e = _exponent(xb)
    e_shared = e.amax(dim=-1)  # [..., nb]
    e_sub = e.reshape(*lead, nb, BLOCK // SUBBLOCK, SUBBLOCK).amax(dim=-1)
    mx = (e_sub < e_shared[..., None]).to(torch.int32)  # [..., nb, 8]
    shifts = torch.arange(BLOCK // SUBBLOCK, dtype=torch.int32,
                          device=x.device)
    mx_packed = torch.bitwise_left_shift(mx, shifts).sum(dim=-1)
    e_eff = e_shared[..., None] - mx
    scale = _pow2((mb - 1) - e_eff)  # [..., nb, 8]
    xs = xb.reshape(*lead, nb, BLOCK // SUBBLOCK, SUBBLOCK)
    m = torch.clamp(torch.round(xs.abs() * scale[..., None]), 0, 2 ** mb - 1)
    m = torch.where(_is_zero(xs), torch.zeros_like(m), m * torch.sign(xs))
    return MXTensor(m.to(torch.int8).reshape(*lead, k),
                    e_shared.to(torch.int8), mx_packed.to(torch.uint8),
                    precision)


def mx_dequantize_ref(q: MXTensor) -> torch.Tensor:
    mb = MANTISSA_BITS[q.precision]
    *lead, k = q.mantissa.shape
    m = q.mantissa.to(torch.float32).reshape(
        *lead, k // BLOCK, BLOCK // SUBBLOCK, SUBBLOCK)
    sub = torch.arange(BLOCK // SUBBLOCK, dtype=torch.int32,
                       device=q.mantissa.device)
    mx = torch.bitwise_and(
        torch.bitwise_right_shift(q.mx_bits.to(torch.int32)[..., None], sub),
        1)  # [..., k/16, 8]
    e_eff = q.exponent.to(torch.int32)[..., None] - mx
    x = m * _pow2(e_eff - (mb - 1))[..., None]
    return x.reshape(*lead, k)


def mx_quant_dequant_ref(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Fake-quant: the numerical effect of storing x in MX."""
    return mx_dequantize_ref(mx_quantize_ref(x, precision)).to(x.dtype)
