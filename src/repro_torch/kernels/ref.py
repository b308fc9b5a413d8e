"""Plain PyTorch versions of the port's kernels (the MX quantize and GEMM
oracles of the JAX package's ``kernels/ref.py``, and the attention that its
Pallas flash-attention kernel computes; see the section at the end).

MX (micro-exponent block floating point), as in the paper's §V-B:
  - blocks of 16 address-adjacent values along the last axis share an
    8-bit exponent E = the largest fp32 exponent in the block;
  - sub-blocks of 2 values carry a 1-bit micro-exponent, set when *both*
    exponents are < E (the sub-block scale drops by one, recovering one
    mantissa bit);
  - mantissas are sign-magnitude with 2 (MX4), 4 (MX6) or 7 (MX9) bits.

These functions are what the CUDA kernels (``kernels/csrc/*.cu``) are held
to — the quantize and dequantize kernels bitwise, the GEMMs and the
attention within fp32 summation order — and what ``kernels/ops.py`` serves
for a CPU tensor. They run on any device. Two choices pin the MX numerics
down exactly:

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

from repro_torch.device import set_fp32_precision

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


# ------------------------------------------------------------ MX GEMMs ---
# The plain versions of the four GEMM kernels (csrc/mx_gemm.cu): quantize
# with the functions above, dequantize, then ONE float32 matmul with TF32
# off. Every GEMM goes through ``_matmul_nt`` on contiguous dequantized
# operands, so two of these functions that quantize to the same operands
# give the same bits: fused == unfused == prequant, and the pair == two
# fused GEMMs, as in the reference. The kernels sum in another order; the
# products of dequantized MX values are exact in fp32, so the two differ
# only by summation order, within ``gemm_error_limits``.


def _matmul_nt(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [N, K]^T in full float32 (TF32 off, process-wide, as
    everywhere in the port)."""
    set_fp32_precision()
    return torch.matmul(a.contiguous(), b_nk.contiguous().T)


U = 2.0 ** -24  # fp32 unit roundoff
TYPICAL_C = 4.0  # the typical limit's factor (PERF.md: set from chip runs)


def gemm_error_limits(aq: torch.Tensor, bq_nk: torch.Tensor):
    """The two elementwise limits on the difference between two fp32 GEMMs
    of the same dequantized operands ``aq [M, Kp]`` and ``bq_nk [N, Kp]``,
    as a pair of [M, N] tensors:

    * worst: ``2·Kp·u·(|A_q| @ |B_q|)``, which holds for any two summation
      orders of the same exact products;
    * typical: ``TYPICAL_C·sqrt(Kp)·u·sqrt(A_q² @ B_q²)``. Rounding errors
      of either sign add like a random walk, so for zero-mean operands
      (N(0,1) inputs and cotangents) the difference grows like u·Kp·σ,
      with σ² the mean squared product.

    The worst limit grows like Kp·Σ|ab| while a zero-mean result grows like
    sqrt(Kp)·σ, so over a long contraction (the pair's dW contracts over
    M) it is far above the result and would pass an all-zero or wrongly
    quantized output; the typical limit does not."""
    kp = aq.shape[1]
    worst = 2 * kp * U * _matmul_nt(aq.abs(), bq_nk.abs())
    typical = TYPICAL_C * kp ** 0.5 * U * _matmul_nt(aq * aq,
                                                     bq_nk * bq_nk).sqrt()
    return worst, typical


def mx_matmul_split_ref(aq: torch.Tensor, bq_nk: torch.Tensor,
                        chunks) -> torch.Tensor:
    """The kernels' split of a long contraction, in plain PyTorch: one
    fp32 matmul of the dequantized operands ``aq [M, Kp]`` and
    ``bq_nk [N, Kp]`` per contraction chunk ``[lo, hi)`` of ``chunks``
    (``mx_matmul.split_chunks``), then the partials added in the fixed
    order s = 0..S-1 (csrc/mx_gemm.cu::split_reduce_kernel)."""
    out = None
    for lo, hi in chunks:
        part = _matmul_nt(aq[:, lo:hi], bq_nk[:, lo:hi])
        out = part if out is None else out + part
    return out


def mx_matmul_ref(lhs: MXTensor, rhs: MXTensor) -> torch.Tensor:
    """[M, K] @ [N, K]^T -> [M, N] fp32 (both quantized along K)."""
    return _matmul_nt(mx_dequantize_ref(lhs), mx_dequantize_ref(rhs))


def mx_matmul_fp_ref(a: torch.Tensor, b: torch.Tensor, precision_a: str,
                     precision_b: str) -> torch.Tensor:
    """fp inputs a [M, K], b [K, N] -> quantize both along K, matmul fp32
    (K must be a multiple of 16)."""
    return mx_matmul_ref(mx_quantize_ref(a, precision_a),
                         mx_quantize_ref(b.T, precision_b))


def mx_matmul_fused_ref(a: torch.Tensor, b: torch.Tensor, precision_a: str,
                        precision_b: str) -> torch.Tensor:
    """The fused GEMM's plain version: numerically ``mx_matmul_fp_ref``."""
    return mx_matmul_fp_ref(a, b, precision_a, precision_b)


def mx_matmul_bwd_pair_ref(g1: torch.Tensor, wt: torch.Tensor,
                           xt: torch.Tensor, g2: torch.Tensor,
                           precision: str):
    """Both gradient GEMMs of ``y = x @ w``: ``dX = q(g1) @ q(wt)`` and
    ``dW = q(xt) @ q(g2)``; ``g1``/``g2`` are the cotangent padded for each
    GEMM's contraction axis (N for dX, M for dW)."""
    return (mx_matmul_fp_ref(g1, wt, precision, precision),
            mx_matmul_fp_ref(xt, g2, precision, precision))


def mx_pair_stage_ref(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      precision: str):
    """The backward pair's conversion stage (``csrc/mx_gemm.cu::
    pair_stage_kernel``) in plain PyTorch: g [M, N], x [M, K], w [K, N] ->
    the bf16 operands, each quantized and dequantized along one axis in
    its source's row layout, the contraction zero-padded to a multiple of
    16: ``gn`` = q_N(g) [M, Np] and ``wn`` = q_N(w) [K, Np] (along the
    rows), ``xt`` = q_M(x) [Mp, K] and ``gt`` = q_M(g) [Mp, N] (down the
    columns). The kernel's ``xt`` and ``gt`` have rows of a pitch rounded
    up to 8 (``mx_fused.pair_stage_shapes``); their first K and N columns
    are these. A dequantized MX value is exact in bf16. (The kernel keeps
    -0 where a negative input's mantissa rounds to zero, this version +0:
    equal values, and neither changes a sum.)"""
    def along_rows(t: torch.Tensor) -> torch.Tensor:
        t = torch.nn.functional.pad(t.to(torch.float32),
                                    (0, (-t.shape[1]) % BLOCK)).contiguous()
        return mx_quant_dequant_ref(t, precision).to(torch.bfloat16)

    return {"gn": along_rows(g), "wn": along_rows(w),
            "xt": along_rows(x.T).T.contiguous(),
            "gt": along_rows(g.T).T.contiguous()}


def mx_matmul_prequant_ref(a: torch.Tensor, qb: MXTensor,
                           precision_a: str) -> torch.Tensor:
    """``a [M, K]`` quantized on the fly @ a resident rhs-layout weight
    (mantissa [K, N], planes [K/16, N]), which is only dequantized."""
    qb_t = MXTensor(qb.mantissa.T, qb.exponent.T, qb.mx_bits.T, qb.precision)
    return mx_matmul_ref(mx_quantize_ref(a, precision_a), qb_t)


# ------------------------------------------------------ flash attention ---
# The plain version of the attention kernel (csrc/flash_attention.cu). It
# computes what the JAX package's Pallas kernel computes
# (kernels/flash_attention.py::_attn_kernel), which differs from the JAX
# oracle ``ref.flash_attention_ref`` in two ways, and the port follows the
# kernel in both:
#
# * a query row i sits at position ``q_offset + i``; the oracle ignores
#   ``q_offset`` and puts it at ``i + Skv - Sq``;
# * a row with no unmasked key comes out 0 (masked probabilities are
#   zeroed and the normalizer is floored at 1e-30); the oracle's softmax
#   over an all-``NEG_INF`` row averages v.
#
# Order of operations, as in the kernel: the logits in fp32 (float64
# inputs stay float64), times ``scale``, then the softcap
# ``softcap * tanh(s / softcap)``, then the mask with ``NEG_INF``; the
# output is cast to q's dtype.

NEG_INF = -1e30  # the Pallas kernel's mask value


def attention_mask(sq: int, skv: int, *, causal: bool, window, q_offset: int,
                   device=None) -> torch.Tensor:
    """[Sq, Skv] bool: True where query row i (position ``q_offset + i``)
    may attend to key j."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _masked_logits(q, k, *, causal, window, softcap, scale, q_offset):
    """Logits [B, Kv, G, Sq, Skv] masked with ``NEG_INF``, the mask [Sq,
    Skv], tanh(s / softcap) (or None) and the resolved scale. Query head h
    uses kv head h // G."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    scale = d ** -0.5 if scale is None else float(scale)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    set_fp32_precision()
    qg = q.to(ct).reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(ct)) * scale
    tanh = None
    if softcap is not None:
        tanh = torch.tanh(s / softcap)
        s = softcap * tanh
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    return torch.where(mask, s, NEG_INF), mask, tanh, scale


def _attention_scores(q, k, *, causal, window, softcap, scale, q_offset):
    """Unnormalized probabilities P̃ [B, Kv, G, Sq, Skv], their row sums
    (floored at 1e-30), tanh(s / softcap) (or None) and the resolved
    scale."""
    s, mask, tanh, scale = _masked_logits(
        q, k, causal=causal, window=window, softcap=softcap, scale=scale,
        q_offset=q_offset)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    return p, p.sum(-1, keepdim=True).clamp_min(1e-30), tanh, scale


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None, softcap=None,
                        scale=None, q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Skv, Kv, D] -> [B, Sq, H, D] in q's dtype:
    ``(P̃ @ v) / l``, as the kernel divides its accumulator at the end."""
    b, sq, h, d = q.shape
    p, l, _, _ = _attention_scores(q, k, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, v.to(p.dtype)) / l
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, ranges, *, causal: bool = True,
                              window=None, softcap=None, scale=None,
                              q_offset: int = 0) -> torch.Tensor:
    """The kernel's kv split (csrc/flash_attention.cu) in plain PyTorch:
    the partials of :func:`flash_attention_partials` merged by
    :func:`combine_partials`."""
    return combine_partials(flash_attention_partials(
        q, k, v, ranges, causal=causal, window=window, softcap=softcap,
        scale=scale, q_offset=q_offset), q)


def flash_attention_partials(q, k, v, ranges, *, causal: bool = True,
                             window=None, softcap=None, scale=None,
                             q_offset: int = 0):
    """The split's first launch: for each non-empty piece ``[lo, hi)`` of
    ``ranges`` (``flash_attention.split_ranges``) the partial (m_s, l_s,
    O_s) over its keys — m_s, l_s [B, Kv, G, Sq, 1], O_s [B, Kv, G, Sq, D]
    unnormalized; a row with no key in the piece has m_s = NEG_INF, l_s =
    0, O_s = 0."""
    s, mask, _, _ = _masked_logits(q, k, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)
    vf = v.to(s.dtype)
    parts = []
    for lo, hi in ranges:
        s_piece = s[..., lo:hi]
        m_s = s_piece.amax(-1, keepdim=True)
        p = torch.where(mask[:, lo:hi], torch.exp(s_piece - m_s), 0.0)
        parts.append((m_s, p.sum(-1, keepdim=True),
                      torch.einsum("bkgqt,btkd->bkgqd", p, vf[:, lo:hi])))
    return parts


def combine_partials(parts, q: torch.Tensor) -> torch.Tensor:
    """The split's second launch: the partials merged in the fixed order
    s = 0..S-1, m = max m_s, l = Σ l_s·e^(m_s − m), O = Σ O_s·e^(m_s − m) /
    max(l, 1e-30), as [B, Sq, H, D] in q's dtype. A row whose every piece
    has l = 0 comes out 0."""
    m = torch.stack([m_s for m_s, _, _ in parts]).amax(0)
    l, o = 0.0, 0.0
    for m_s, l_s, o_s in parts:
        w = torch.exp(m_s - m)
        l, o = l + l_s * w, o + o_s * w
    o = o / torch.as_tensor(l).clamp_min(1e-30)
    b, sq, h, d = q.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, do, *, causal: bool = True, window=None,
                            softcap=None, scale=None, q_offset: int = 0):
    """(dq, dk, dv) of :func:`flash_attention_ref` for the output cotangent
    ``do``, from P recomputed with the same mask, softcap and scale:
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − rowsum(dO ⊙ O)) — the row sum
    taken as rowsum(P ⊙ dP), the same sum — chained through the softcap's
    tanh′ = 1 − tanh² and the scale; the G query heads of a kv head are
    summed into its dK and dV."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    p, l, tanh, scale = _attention_scores(q, k, causal=causal, window=window,
                                          softcap=softcap, scale=scale,
                                          q_offset=q_offset)
    p = p / l
    ct = p.dtype
    qg = q.to(ct).reshape(b, sq, kvh, h // kvh, d)
    dog = do.to(ct).reshape(b, sq, kvh, h // kvh, d)
    kf, vf = k.to(ct), v.to(ct)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, dog)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dog, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if tanh is not None:
        ds = ds * (1 - tanh * tanh)
    ds = ds * scale
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, kf).reshape(b, sq, h, d)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
