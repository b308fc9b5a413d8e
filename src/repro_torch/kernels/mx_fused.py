"""Wrappers of the hand-written CUDA GEMMs that quantize in-tile
(``csrc/mx_gemm.cu``).

* ``mx_matmul_fused_cuda`` replaces the JAX package's Pallas TPU kernel
  ``kernels/mx_fused.py::mx_matmul_fused`` (``_fused_kernel``): both fp32
  operands quantized per 16-block along K inside the GEMM — the
  ``mx_dense`` forward.
* ``mx_matmul_bwd_pair_cuda`` replaces ``mx_fused.py::mx_matmul_bwd_pair``
  (``_bwd_pair_kernel``): ``dX = q(g) @ q(W^T)`` and ``dW = q(X^T) @ q(g)``
  — the ``mx_dense`` backward. A stage launch (``pair_stage_cuda``)
  converts each operand once for each axis it is quantized along, into
  bf16 operands laid out for the GEMM (``pair_stage_shapes``; a dequantized
  MX value is exact in bf16), and one launch (``pair_gemm_cuda``) runs both
  GEMMs on them.
* ``mx_matmul_prequant_cuda`` replaces ``mx_fused.py::mx_matmul_prequant``
  (``_prequant_kernel``): the activation quantized in-tile, a resident
  rhs-layout weight only dequantized — ``mx_dense_prequant``.

Their plain versions are ``kernels/ref.py::mx_matmul_fused_ref``,
``mx_matmul_bwd_pair_ref`` and ``mx_matmul_prequant_ref``; bounds and
design are in the source's header. fp16/bf16 operands are widened to fp32
here (exact), as the reference does with ``astype(float32)``; fp32
operands of the fused and prequant GEMMs are read through their strides,
so a transposed view costs no copy. K need not be a multiple of 16: the
kernels zero-pad it themselves, with blocks aligned from k = 0. Every
launch takes its GEMM's split of the contraction (``fused_plan``,
``pair_plans``: ``mx_matmul.gemm_split_plan`` of the GEMM's shape), with
the fp32 workspace of the partials allocated here, as are the pair's
staged bf16 operands.

Only a CUDA tensor reaches these wrappers (``kernels/ops.py`` routes a CPU
tensor to the plain version); they raise on anything they do not take and
when the launch reports an error — there is no fallback.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import mx_quantize as _mq
from repro_torch.kernels.mx_matmul import (check_dims, gemm_split_plan,
                                           plan_args, require_planes)
from repro_torch.kernels.ref import BLOCK, MANTISSA_BITS, MXTensor


def fused_plan(m: int, n: int, k: int) -> Tuple[int, int]:
    """The split of the contraction of a [m, k] @ [k, n] GEMM: that of
    the fused, the prequant and the unfused kernel alike."""
    return gemm_split_plan(m, n, -(-k // BLOCK) * BLOCK)


def pair_plans(m: int, n: int, k: int):
    """The splits of the pair's dX [m, k] (contracted over n) and dW
    [k, n] (over m) for g [m, n]: those of fused(g, w^T) and
    fused(x^T, g), so the pair equals the two fused GEMMs bitwise."""
    return fused_plan(m, k, n), fused_plan(k, n, m)


def pair_stage_shapes(m: int, n: int, k: int):
    """Shapes of the pair's staged bf16 operands for g [m, n], x [m, k]
    and w [k, n], each in its source's row layout: ``gn`` = q_N(g)
    [m, Np] and ``wn`` = q_N(w) [k, Np], dX's lhs and rhs with the
    contraction N along a row; ``xt`` = q_M(x) [Mp, Kq] and ``gt`` = q_M(g)
    [Mp, Nq], dW's lhs and rhs with the contraction M down the rows. Np
    and Mp (n and m rounded up to 16, zero-padded) are the contractions
    that ``pair_plans`` splits; Kq and Nq (k and n rounded up to 8) are row
    pitches of 16 bytes' multiples, the columns past k and n unused."""
    def up(v: int, to: int) -> int:
        return -(-v // to) * to

    return {"gn": (m, up(n, BLOCK)), "wn": (k, up(n, BLOCK)),
            "xt": (up(m, BLOCK), up(k, 8)), "gt": (up(m, BLOCK), up(n, 8))}


def _f32(t: torch.Tensor, what: str) -> torch.Tensor:
    """A 2-D fp32 operand on the card (fp16/bf16 widened, exact)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dim() != 2:
        raise ValueError(f"{what}: expected a 2-D tensor, got "
                         f"{tuple(t.shape)}")
    if t.dtype in (torch.float16, torch.bfloat16):
        t = t.float()
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: expected a floating tensor, got {t.dtype}")
    return t


def mx_matmul_fused_cuda(a: torch.Tensor, b: torch.Tensor, precision_a: str,
                         precision_b: str) -> torch.Tensor:
    """a [M, K] @ b [K, N] -> fp32 [M, N], both quantized along K inside
    the GEMM."""
    a = _f32(a, "mx_matmul_fused_cuda a")
    b = _f32(b, "mx_matmul_fused_cuda b")
    if a.shape[1] != b.shape[0] or a.device != b.device:
        raise ValueError(f"expected a [M, K] and b [K, N] on one device, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    check_dims(m, n, k)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    split, _ws = plan_args(m, n, fused_plan(m, n, k), a.device)
    lib = _mq.load()
    code = _mq.launch(
        lib.mx_gemm_fused, a.device, a.data_ptr(), a.stride(0), a.stride(1),
        MANTISSA_BITS[precision_a], b.data_ptr(), b.stride(0), b.stride(1),
        MANTISSA_BITS[precision_b], out.data_ptr(), m, n, k, *split)
    _mq.check(lib, code, "mx_matmul_fused")
    if m * n:
        _mq.count_launch("mx_matmul_fused")
    return out


def pair_stage_cuda(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    precision: str) -> Dict[str, torch.Tensor]:
    """The pair's conversion stage alone: g [M, N], x [M, K], w [K, N] on
    the card (copied to row-major fp32 where they are not) -> the four
    bf16 operands of ``pair_stage_shapes``, each value quantized and
    dequantized once."""
    g = _f32(g, "mx_matmul_bwd_pair_cuda g").contiguous()
    x = _f32(x, "mx_matmul_bwd_pair_cuda x").contiguous()
    w = _f32(w, "mx_matmul_bwd_pair_cuda w").contiguous()
    (m, n), k = g.shape, w.shape[0]
    if x.shape != (m, k) or w.shape != (k, n):
        raise ValueError(f"expected g [M, N], x [M, K], w [K, N], got "
                         f"{tuple(g.shape)}, {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.device != g.device or w.device != g.device:
        raise ValueError("g, x and w on different devices")
    check_dims(m, n, k)
    stage = {name: torch.empty(shape, dtype=torch.bfloat16, device=g.device)
             for name, shape in pair_stage_shapes(m, n, k).items()}
    lib = _mq.load()
    code = _mq.launch(
        lib.mx_pair_stage, g.device, g.data_ptr(), x.data_ptr(),
        w.data_ptr(), MANTISSA_BITS[precision],
        *(stage[name].data_ptr() for name in ("gn", "wn", "xt", "gt")),
        m, n, k)
    _mq.check(lib, code, "mx_matmul_bwd_pair (stage)")
    return stage


def pair_gemm_cuda(stage: Dict[str, torch.Tensor], m: int, n: int,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair's two GEMMs alone, on staged operands: dx [M, K] = gn @
    wn^T and dw [K, N] = xt^T @ gt, fp32, split by ``pair_plans``."""
    dev = stage["gn"].device
    for name, shape in pair_stage_shapes(m, n, k).items():
        t = stage[name]
        _mq.require(t, torch.bfloat16, f"mx_matmul_bwd_pair staged {name}")
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"staged {name}: expected {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    dx = torch.empty((m, k), dtype=torch.float32, device=dev)
    dw = torch.empty((k, n), dtype=torch.float32, device=dev)
    plan_dx, plan_dw = pair_plans(m, n, k)
    split_dx, _ws_dx = plan_args(m, k, plan_dx, dev)
    split_dw, _ws_dw = plan_args(k, n, plan_dw, dev)
    lib = _mq.load()
    code = _mq.launch(
        lib.mx_gemm_bwd_pair, dev,
        *(stage[name].data_ptr() for name in ("gn", "wn", "xt", "gt")),
        dx.data_ptr(), dw.data_ptr(), m, n, k, *split_dx, *split_dw)
    _mq.check(lib, code, "mx_matmul_bwd_pair")
    return dx, dw


def mx_matmul_bwd_pair_cuda(g: torch.Tensor, x: torch.Tensor,
                            w: torch.Tensor,
                            precision: str) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Both gradients of ``y = x @ w``: g [M, N], x [M, K], w [K, N] ->
    (dx [M, K], dw [K, N]) fp32, through the conversion stage and the
    staged GEMMs."""
    stage = pair_stage_cuda(g, x, w, precision)
    (m, n), k = g.shape, w.shape[0]
    dx, dw = pair_gemm_cuda(stage, m, n, k)
    if m * k + k * n:
        _mq.count_launch("mx_matmul_bwd_pair")
    return dx, dw


def mx_matmul_prequant_cuda(a: torch.Tensor, qb: MXTensor,
                            precision_a: str) -> torch.Tensor:
    """a [M, K] quantized in-tile @ a resident rhs-layout weight (mantissa
    [Kp, N] with Kp = 16 * ceil(K / 16), planes [Kp/16, N]) -> fp32
    [M, N]."""
    a = _f32(a, "mx_matmul_prequant_cuda a")
    rm = qb.mantissa
    m, k = a.shape
    if rm.dim() != 2 or rm.shape[0] != -(-k // BLOCK) * BLOCK:
        raise ValueError(f"expected a [M, K] and a weight mantissa "
                         f"[16 * ceil(K / 16), N], got {tuple(a.shape)} and "
                         f"{tuple(rm.shape)}")
    kp, n = rm.shape
    check_dims(m, n, kp)
    _mq.require(rm, torch.int8, "mx_matmul_prequant_cuda weight mantissa")
    if rm.device != a.device:
        raise ValueError("a and the weight on different devices")
    require_planes(qb, kp // BLOCK, n, "mx_matmul_prequant_cuda weight")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    split, _ws = plan_args(m, n, fused_plan(m, n, k), a.device)
    lib = _mq.load()
    code = _mq.launch(
        lib.mx_gemm_prequant, a.device, a.data_ptr(), a.stride(0),
        a.stride(1), MANTISSA_BITS[precision_a], rm.data_ptr(),
        qb.exponent.data_ptr(), qb.mx_bits.data_ptr(),
        MANTISSA_BITS[qb.precision], out.data_ptr(), m, n, k, *split)
    _mq.check(lib, code, "mx_matmul_prequant")
    if m * n:
        _mq.count_launch("mx_matmul_prequant")
    return out
