"""Public entries of the port's MX kernels (the MX quantize and GEMM
entries of the JAX package's ``kernels/ops.py``).

The path is chosen by the tensor's device, never by a setting:

* a CUDA tensor goes to the hand-written kernel (``mx_quantize.py``,
  ``mx_matmul.py``, ``mx_fused.py``) — or the call raises; nothing falls
  back to the plain version;
* a CPU tensor goes to the plain PyTorch version (``ref.py``), which is
  what the CPU tests compare with the JAX package.

``kernel_stats()`` records which path served every call (``"cuda"`` or
``"plain"``), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import mx_fused as _mf
from repro_torch.kernels import mx_matmul as _mm
from repro_torch.kernels import mx_quantize as _mq
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import BLOCK, MXTensor

# Process-wide dispatch counters; every read-modify-write holds the lock so
# concurrent callers never lose an increment.
_stats_lock = threading.Lock()
_kernel_stats: Dict[str, Dict[str, int]] = {}


def _count(op: str, path: str) -> None:
    with _stats_lock:
        by_path = _kernel_stats.setdefault(op, {})
        by_path[path] = by_path.get(path, 0) + 1


def kernel_stats() -> Dict[str, Dict[str, int]]:
    """Per-op dispatch counters since the last reset: ``{op: {path: n}}``
    with ``path`` in ("cuda", "plain")."""
    with _stats_lock:
        return {op: dict(paths) for op, paths in _kernel_stats.items()}


def reset_kernel_stats() -> None:
    with _stats_lock:
        _kernel_stats.clear()


def _path(t: torch.Tensor) -> str:
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no MX kernel for device {t.device}")


def _gemm_path(*ts: torch.Tensor) -> str:
    """The path of a GEMM whose operands must share one device."""
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("GEMM operands on different devices: "
                         f"{[str(t.device) for t in ts]}")
    return _path(ts[0])


def _pad_last(x: torch.Tensor, multiple: int):
    pad = (-x.shape[-1]) % multiple
    if pad:
        x = F.pad(x, (0, pad))
    return x, pad


def mx_quantize(x: torch.Tensor, precision: str) -> MXTensor:
    """Quantize along the last axis (zero-padded to a multiple of 16); the
    result covers the padded width, as in the reference."""
    x2, _ = _pad_last(x.reshape(-1, x.shape[-1]), BLOCK)
    path = _path(x2)
    if path == "cuda":
        q = _mq.mx_quantize_cuda(x2, precision)
    else:
        q = _ref.mx_quantize_ref(x2, precision)
    _count("mx_quantize", path)
    return q


def mx_dequantize(q: MXTensor) -> torch.Tensor:
    path = _path(q.mantissa)
    if path == "cuda":
        y = _mq.mx_dequantize_cuda(q)
    else:
        y = _ref.mx_dequantize_ref(q)
    _count("mx_dequantize", path)
    return y


def mx_quant_dequant(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Fake-quant round trip: the numerical effect of storing x in MX."""
    shape = x.shape
    y = mx_dequantize(mx_quantize(x, precision))
    if y.shape[-1] != shape[-1]:
        y = y[:, : shape[-1]]
    return y.reshape(shape).to(x.dtype)


# GEMMs. K is zero-padded to a multiple of 16 with blocks aligned from
# k = 0, as in the reference's ref-mode branches (zero pads quantize to
# zero and add nothing). The plain path pads explicitly; the CUDA kernels
# mask k >= K themselves, so the card makes no padded copy. The reference's
# 8/128 Pallas padding and tile helpers are TPU tiling: the kernels mask
# ragged M and N edges themselves.


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def _transposed(q: MXTensor) -> MXTensor:
    """An MXTensor quantized along the last axis, [N, Kp] -> the rhs
    layout [Kp, N] (planes [Kp/16, N]), contiguous."""
    return MXTensor(q.mantissa.T.contiguous(), q.exponent.T.contiguous(),
                    q.mx_bits.T.contiguous(), q.precision)


def mx_matmul(a: torch.Tensor, b: torch.Tensor, precision_a: str = "mx6",
              precision_b: str = "mx6") -> torch.Tensor:
    """a [M, K] @ b [K, N] with both operands MX-quantized along K — the
    UNFUSED chain: the operands are quantized by ``mx_quantize`` and
    stored, then the GEMM dequantizes them. Prefer
    :func:`mx_matmul_fused` on the hot path."""
    path = _gemm_path(a, b)
    a, pad = _pad_last(a, BLOCK)
    b = _pad_rows(b, pad)
    qa = mx_quantize(a, precision_a)
    if path == "cuda":
        out = _mm.mx_matmul_cuda(qa, mx_quantize_rhs(b, precision_b))
    else:  # the plain version takes the rhs as [N, Kp], quantized along K
        out = _ref.mx_matmul_ref(qa, mx_quantize(b.T, precision_b))
    _count("mx_matmul", path)
    return out


def mx_matmul_fused(a: torch.Tensor, b: torch.Tensor,
                    precision_a: str = "mx6",
                    precision_b: str = "mx6") -> torch.Tensor:
    """Fused quantize→matmul: a [M, K] @ b [K, N] → fp32 [M, N], both
    operands quantized per 16-block along K inside the GEMM — one launch.
    Bit-identical to :func:`mx_matmul` on either path."""
    path = _gemm_path(a, b)
    if path == "cuda":
        out = _mf.mx_matmul_fused_cuda(a, b, precision_a, precision_b)
    else:
        a, pad = _pad_last(a, BLOCK)
        out = _ref.mx_matmul_fused_ref(a, _pad_rows(b, pad), precision_a,
                                       precision_b)
    _count("mx_matmul_fused", path)
    return out


def mx_matmul_bwd_pair(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                       precision: str = "mx9"):
    """Both gradients of ``y = x @ w`` in ONE launch: ``g [M, N]``
    (cotangent), ``x [M, K]`` (saved input), ``w [K, N]`` (weight) →
    ``(dx [M, K], dw [K, N])`` fp32. Bit-identical on either path to

        dx = mx_matmul_fused(g, w.T, precision, precision)
        dw = mx_matmul_fused(x.T, g, precision, precision)

    (the two GEMMs quantize g along different axes — N for dX, M for dW —
    and each quantizes its own view)."""
    m, n = g.shape
    k = w.shape[0]
    if tuple(x.shape) != (m, k) or w.shape[1] != n:
        raise ValueError(f"expected g [M, N], x [M, K], w [K, N], got "
                         f"{tuple(g.shape)}, {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    path = _gemm_path(g, x, w)
    if path == "cuda":
        dx, dw = _mf.mx_matmul_bwd_pair_cuda(g, x, w, precision)
    else:
        g1, padn = _pad_last(g, BLOCK)
        xt, padm = _pad_last(x.T, BLOCK)
        dx, dw = _ref.mx_matmul_bwd_pair_ref(g1, _pad_rows(w.T, padn), xt,
                                             _pad_rows(g, padm), precision)
    _count("mx_matmul_bwd_pair", path)
    return dx, dw


def mx_quantize_rhs(b: torch.Tensor, precision: str) -> MXTensor:
    """Quantize ``b [K, N]`` along K — the contraction axis — into the rhs
    layout the GEMMs read (mantissa [Kp, N], exponents / micro-exponent
    bits [Kp/16, N]; Kp = K padded up to a 16 multiple). This is the
    RESIDENT serving format: quantize a weight once, then feed
    :func:`mx_matmul_prequant` with no per-call weight quantization."""
    return _transposed(mx_quantize(b.T, precision))


def mx_matmul_prequant(a: torch.Tensor, qb: MXTensor,
                       precision_a: str = "mx6") -> torch.Tensor:
    """``a [M, K]`` @ an ALREADY-QUANTIZED weight ``qb`` (rhs layout, from
    :func:`mx_quantize_rhs`) → fp32 [M, N]; the activations are quantized
    inside the GEMM. Bit-identical to ``mx_matmul_fused(a, b, precision_a,
    qb.precision)`` for ``qb = mx_quantize_rhs(b, ...)``: MX quantization
    is idempotent."""
    m, k = a.shape
    kq = qb.mantissa.shape[0]
    if not (kq % BLOCK == 0 and k <= kq < k + BLOCK):
        raise ValueError(f"weight K {kq} does not cover activation K {k}")
    path = _gemm_path(a, qb.mantissa)
    if path == "cuda":
        out = _mf.mx_matmul_prequant_cuda(a, qb, precision_a)
    else:
        out = _ref.mx_matmul_prequant_ref(_pad_last(a, BLOCK)[0], qb,
                                          precision_a)
    _count("mx_matmul_prequant", path)
    return out
