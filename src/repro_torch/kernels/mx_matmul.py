"""Wrapper of the hand-written CUDA GEMM over two stored MX tensors
(``csrc/mx_gemm.cu::mx_gemm_mx``).

``mx_matmul_cuda`` replaces the JAX package's Pallas TPU kernel
``kernels/mx_matmul.py::mx_matmul`` (``_matmul_kernel``): the UNFUSED
GEMM, whose operands were quantized by an earlier launch and are only
dequantized in-tile. Its plain version is ``kernels/ref.py::mx_matmul_ref``;
its bound and design are in the source's header. The build, the launch
counters and the shared checks live in ``mx_quantize.py``.

Only a CUDA tensor reaches this wrapper (``kernels/ops.py`` routes a CPU
tensor to the plain version); it raises on anything it does not take and
when the launch reports an error — there is no fallback.

``gemm_split_plan`` is the split of long contractions that all four GEMM
kernels share: a pure function of the GEMM's shape, so two kernels that
compute the same product split it alike and agree bit for bit.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.device import SMS
from repro_torch.kernels import mx_quantize as _mq
from repro_torch.kernels.ref import BLOCK, MANTISSA_BITS, MXTensor

INT32_MAX = 2 ** 31 - 1
TILE_M = 128  # rows of the GEMM kernel's output tile: two warpgroups of 64
WAVE_CTAS = SMS  # one GEMM CTA an SM (its operand ring fills shared memory)
MIN_CHUNK_BLOCKS = 32  # at least 512 of the contraction per (tile, chunk)


def tile_n(n: int) -> int:
    """Columns of the GEMM kernel's output tile for an output N wide (the
    width of its wgmma, csrc/mx_gemm.cu::narrow): 64 for N <= 64, else
    128."""
    return 64 if n <= 64 else 128


def gemm_tiles(m: int, n: int) -> int:
    """Output tiles (TILE_M x tile_n(n)) of an [m, n] GEMM."""
    return -(-m // TILE_M) * -(-n // tile_n(n))


def gemm_split_plan(m: int, n: int, kp: int) -> Tuple[int, int]:
    """(S, chunk): the contraction [0, kp) of an [m, n] output, kp a
    multiple of 16, cut into S chunks of ``chunk`` (a multiple of 16; the
    last may be shorter). S = 1 where the output's tiles fill at least
    half the card; otherwise as many chunks as keep the (tile, chunk)
    units within one wave of WAVE_CTAS persistent CTAs, so that each CTA
    takes at most one, each at least MIN_CHUNK_BLOCKS MX blocks long."""
    blocks = kp // BLOCK
    splits = min(WAVE_CTAS // gemm_tiles(m, n), blocks // MIN_CHUNK_BLOCKS)
    if splits < 2:
        return 1, kp
    chunk_blocks = -(-blocks // splits)
    return -(-blocks // chunk_blocks), chunk_blocks * BLOCK


def split_chunks(kp: int, splits: int, chunk: int) -> List[Tuple[int, int]]:
    """The [lo, hi) contraction ranges of a plan, in the order s = 0..S-1."""
    return [(s * chunk, min(kp, (s + 1) * chunk)) for s in range(splits)]


def plan_args(m: int, n: int, plan: Tuple[int, int],
              device: torch.device):
    """The (S, chunk, workspace pointer) a GEMM launch takes for an [m, n]
    output split by ``plan``, and the fp32 workspace of the S partials
    [S, m, n] (None where S = 1: the tiles write the output directly),
    which the caller keeps alive until the launch is queued."""
    splits, chunk = plan
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=device)
          if splits > 1 else None)
    return (splits, chunk, 0 if ws is None else ws.data_ptr()), ws


def check_dims(*dims: int) -> None:
    """The kernels take M, N and K as 32-bit ints."""
    if max(dims) > INT32_MAX:
        raise ValueError(f"GEMM dimension above 2**31 - 1: {dims}")


def require_planes(q: MXTensor, rows: int, cols: int, what: str) -> None:
    """Exponent (int8) and bits (uint8) planes of shape [rows, cols],
    contiguous, on the mantissa's device."""
    for plane, dtype, name in ((q.exponent, torch.int8, "exponent"),
                               (q.mx_bits, torch.uint8, "mx_bits")):
        if tuple(plane.shape) != (rows, cols):
            raise ValueError(f"{what} {name}: expected {(rows, cols)}, got "
                             f"{tuple(plane.shape)}")
        _mq.require(plane, dtype, f"{what} {name}")
        if plane.device != q.mantissa.device:
            raise ValueError(f"{what}: planes and mantissa on different "
                             "devices")


def mx_matmul_cuda(lhs: MXTensor, rhs: MXTensor) -> torch.Tensor:
    """``lhs`` [M, Kp] quantized along K (planes [M, Kp/16], K-last) @
    ``rhs`` [Kp, N] quantized along K (planes [Kp/16, N], K-first) ->
    fp32 [M, N] on the card."""
    lm, rm = lhs.mantissa, rhs.mantissa
    if lm.dim() != 2 or rm.dim() != 2 or lm.shape[1] != rm.shape[0]:
        raise ValueError(f"expected lhs [M, Kp] and rhs [Kp, N], got "
                         f"{tuple(lm.shape)} and {tuple(rm.shape)}")
    (m, kp), n = lm.shape, rm.shape[1]
    if kp % BLOCK:
        raise ValueError(f"Kp = {kp} is not a multiple of {BLOCK}")
    check_dims(m, n, kp)
    _mq.require(lm, torch.int8, "mx_matmul_cuda lhs mantissa")
    _mq.require(rm, torch.int8, "mx_matmul_cuda rhs mantissa")
    if rm.device != lm.device:
        raise ValueError("lhs and rhs on different devices")
    require_planes(lhs, m, kp // BLOCK, "mx_matmul_cuda lhs")
    require_planes(rhs, kp // BLOCK, n, "mx_matmul_cuda rhs")
    out = torch.empty((m, n), dtype=torch.float32, device=lm.device)
    split, _ws = plan_args(m, n, gemm_split_plan(m, n, kp), lm.device)
    lib = _mq.load()
    code = _mq.launch(
        lib.mx_gemm_mx, lm.device, lm.data_ptr(), lhs.exponent.data_ptr(),
        lhs.mx_bits.data_ptr(), MANTISSA_BITS[lhs.precision], rm.data_ptr(),
        rhs.exponent.data_ptr(), rhs.mx_bits.data_ptr(),
        MANTISSA_BITS[rhs.precision], out.data_ptr(), m, n, kp, *split)
    _mq.check(lib, code, "mx_matmul")
    if m * n:
        _mq.count_launch("mx_matmul")
    return out
