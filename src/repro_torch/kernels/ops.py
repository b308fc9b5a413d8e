"""Public entries of the port's MX kernels (the MX-quantize half of the JAX
package's ``kernels/ops.py``).

The path is chosen by the tensor's device, never by a setting:

* a CUDA tensor goes to the hand-written kernel (``mx_quantize.py``) — or
  the call raises; nothing falls back to the plain version;
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
