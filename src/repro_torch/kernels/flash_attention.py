"""Wrapper of the hand-written CUDA attention kernel
(``csrc/flash_attention.cu``).

``flash_attention_cuda`` replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention`` (``_attn_kernel``): forward
GQA attention over q [B, Sq, H, D] and k/v [B, Skv, Kv, D], fp32 or bf16,
with causal, sliding-window, softcap, scale and ``q_offset`` options. Its
plain version is ``kernels/ref.py::flash_attention_ref``; the source's
header gives the bound and the design. The kernel is built into the one
library of ``mx_quantize.py`` and counts its launches in the same counters,
under ``"flash_attention"``.

The kernel reads q, k and v and writes the output through their (batch,
sequence, head) strides, with the head dimension contiguous, so the ViT's
q/k/v — strided slices of one qkv tensor — cost no copy; a tensor whose
last axis is not contiguous is copied first. Ragged Sq and Skv are masked
in the kernel. The Pallas tile sizes ``qb`` / ``kvb`` and ``interpret``
are TPU tiling and are not ported.

Only a CUDA tensor reaches this wrapper (``kernels/ops.py`` routes a CPU
tensor to the plain version); it raises on anything the kernel does not
take and when the launch reports an error — there is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import mx_quantize as _mq

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_BATCH_HEADS = 65535  # the grid's y dimension


def _operand(t: torch.Tensor, what: str) -> torch.Tensor:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dim() != 4:
        raise ValueError(f"{what}: expected [B, S, heads, D], got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{what}: expected float32 or bfloat16, got "
                         f"{t.dtype}")
    return t if t.stride(3) == 1 else t.contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Skv, Kv, D] on the card -> [B, Sq, H, D]
    in q's dtype (contiguous); query head h reads kv head h // (H / Kv)."""
    q = _operand(q, "flash_attention_cuda q")
    k = _operand(k, "flash_attention_cuda k")
    v = _operand(v, "flash_attention_cuda v")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape
            or kvh == 0 or h % kvh):
        raise ValueError(f"expected q [B, Sq, H, D] and k, v [B, Skv, Kv, D] "
                         f"with Kv dividing H, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share a dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v on different devices")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b * h > _MAX_BATCH_HEADS:
        raise ValueError(f"B * H = {b * h} above {_MAX_BATCH_HEADS}")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _mq.load()
    code = _mq.launch(
        lib.flash_attention_fwd, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16), b, h,
        kvh, sq, skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], scale, int(softcap is not None),
        0.0 if softcap is None else float(softcap), int(causal),
        int(window is not None), 0 if window is None else int(window),
        int(q_offset))
    _mq.check(lib, code, "flash_attention")
    if out.numel():
        _mq.count_launch("flash_attention")
    return out
