"""The tolerance the port's MX GEMMs are held to, shared by its tests.

A product of two dequantized MX values has at most 8 + 8 significant bits,
so it is exact in fp32, and two GEMMs over the same quantized operands can
differ only in the order of summation. Two fp32 summation orders of the
same exact terms differ by at most ``2·Kp·2⁻²⁴·(|A_q| @ |B_q|)``
elementwise (Kp = K padded to 16; A_q, B_q the dequantized operands), and
for zero-mean operands by at most the typical limit
``TYPICAL_C·sqrt(Kp)·2⁻²⁴·sqrt(A_q² @ B_q²)``
(``repro_torch.kernels.ref.gemm_error_limits``); both are checked.
"""
import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import gemm_error_limits


def pad16(x: np.ndarray) -> np.ndarray:
    """Zero-pad the last axis to a multiple of 16."""
    pad = (-x.shape[-1]) % 16
    return np.pad(x, [(0, 0), (0, pad)]) if pad else x


def qd(x: np.ndarray, precision: str) -> np.ndarray:
    """The port's dequantized 2-D operand, quantized along the last axis
    (padded to 16)."""
    return ops.mx_quant_dequant(torch.from_numpy(np.ascontiguousarray(
        pad16(x))), precision).numpy()


def gemm_excess(port, other, aq: np.ndarray, bq_nk: np.ndarray):
    """The largest excess of ``|port - other|`` over each limit, as
    (worst, typical); a value <= 0 means that limit holds everywhere."""
    port, other = np.asarray(port, np.float64), np.asarray(other, np.float64)
    assert port.shape == other.shape == (aq.shape[0], bq_nk.shape[0])
    err = np.abs(port - other)
    limits = gemm_error_limits(torch.from_numpy(np.asarray(aq, np.float32)),
                               torch.from_numpy(np.asarray(bq_nk,
                                                           np.float32)))
    return tuple(float((err - lim.double().numpy()).max()) for lim in limits)


def assert_gemm_close(port, other, aq: np.ndarray, bq_nk: np.ndarray) -> None:
    """``port`` and ``other`` are two summation orders of ``aq @ bq_nk^T``
    (operands padded to Kp along their last axis)."""
    assert np.isfinite(np.asarray(port)).all()
    worst, typical = gemm_excess(port, other, aq, bq_nk)
    assert worst <= 0, worst
    assert typical <= 0, typical
