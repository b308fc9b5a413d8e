"""Device resolution for every entry point of the port.

Entry points (``CLSystemSpec``, ``CLSession``, ``make_vision_model``, the
kernels) take a ``device`` argument and run on ``cuda`` unless the caller
asks for the CPU. A request for ``cuda`` on a host without a card raises:
the port never carries on quietly on the CPU.

This is also where the port sets its numerics, process-wide, for every
device it returns: TF32 is switched off for matmuls and cuDNN convolutions,
so the card computes in full fp32 like the reference, which pins
``jax_default_matmul_precision`` to float32; and cuDNN runs only its
deterministic algorithms, chosen without benchmarking, so a retraining run
on the card repeats bit for bit like the reference's XLA runs (a
convolution's weight gradient otherwise sums its tiles with atomics, in an
order that changes from run to run). Nothing turns either off.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"
# Streaming multiprocessors of an H100 SXM: the kernels' split plans
# (mx_matmul.gemm_split_plan, flash_attention.attention_plan) size their
# grids for it.
SMS = 132

DeviceLike = Union[str, torch.device, None]


def set_fp32_precision() -> None:
    """Full fp32 for float32 matmuls and convolutions (TF32 off). The
    cuDNN flag defaults to True in PyTorch; both are process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_deterministic() -> None:
    """cuDNN's deterministic algorithms only, and no benchmarking (which
    may pick another algorithm from run to run); both process-wide."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises when ``cuda`` is asked for and no
    card is present; sets fp32 precision and deterministic cuDNN for every
    device it returns."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain CPU path")
    set_fp32_precision()
    set_deterministic()
    return dev

