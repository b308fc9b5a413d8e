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

``attention_plan`` chooses the kv split: where the CTAs of 64 query rows
cannot fill the card and the kv range is long, the range is cut into S
pieces, each CTA computes a partial over its piece, and a second kernel
merges the partials in the fixed order s = 0..S-1
(``ref.flash_attention_split_ref`` is its plain version). The plan is a
pure function of the shapes and options, so a call repeats bit for bit;
the launch counter counts one ``"flash_attention"`` per call.

Only a CUDA tensor reaches this wrapper (``kernels/ops.py`` routes a CPU
tensor to the plain version); it raises on anything the kernel does not
take and when the launch reports an error — there is no fallback.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import SMS
from repro_torch.kernels import mx_quantize as _mq

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_BATCH_HEADS = 65535  # the grid's y dimension
BQ = 64  # query rows per CTA (csrc/flash_attention.cu kBQ)
WAVE_CTAS = 2 * SMS  # CTAs the card holds at D = 256 (two per SM)
SPLIT_KEYS = 64  # piece boundaries fall on kv tiles (kBK divides 64)
MIN_SPLIT_TILES = 4  # at least 256 keys per piece


class AttentionPlan(NamedTuple):
    """The kv split: piece s holds keys [lo + s * length, + length)."""

    splits: int
    lo: int
    length: int


def kv_range(sq: int, skv: int, *, causal: bool, window: Optional[int],
             q_offset: int) -> Tuple[int, int]:
    """[lo, hi): the keys some query row may see (row i at position
    ``q_offset + i`` sees keys ``pos - window < j <= pos`` where the
    options ask for it); lo == hi when no row sees a key."""
    lo = 0 if window is None else max(0, q_offset - window + 1)
    hi = min(skv, q_offset + sq) if causal else skv
    return lo, max(lo, hi)


def attention_plan(b: int, h: int, sq: int, skv: int, *, causal: bool,
                   window: Optional[int] = None,
                   q_offset: int = 0) -> AttentionPlan:
    """S = 1 where the B * H * ceil(Sq / 64) CTAs fill the card or the kv
    range is short; otherwise enough pieces of at least MIN_SPLIT_TILES
    kv tiles for WAVE_CTAS CTAs in all."""
    lo, hi = kv_range(sq, skv, causal=causal, window=window,
                      q_offset=q_offset)
    lo = lo // SPLIT_KEYS * SPLIT_KEYS
    ctas = b * h * -(-sq // BQ)
    tiles = -(-(hi - lo) // SPLIT_KEYS)
    splits = 1
    if ctas < SMS:
        splits = min(-(-WAVE_CTAS // ctas), tiles // MIN_SPLIT_TILES)
    if splits <= 1:
        return AttentionPlan(1, 0, skv)
    per = -(-tiles // splits)
    return AttentionPlan(-(-tiles // per), lo, per * SPLIT_KEYS)


def split_ranges(plan: AttentionPlan, skv: int) -> List[Tuple[int, int]]:
    """The [lo, hi) keys of each piece, in the order s = 0..S-1."""
    return [(min(skv, plan.lo + s * plan.length),
             min(skv, plan.lo + (s + 1) * plan.length))
            for s in range(plan.splits)]


def _operand(t: torch.Tensor, what: str) -> torch.Tensor:
    """The tensor itself where the kernel can read it through its strides
    (D contiguous, every row 16-byte aligned for cp.async), else a
    contiguous copy."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dim() != 4:
        raise ValueError(f"{what}: expected [B, S, heads, D], got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{what}: expected float32 or bfloat16, got "
                         f"{t.dtype}")
    size = t.element_size()
    aligned = t.data_ptr() % 16 == 0 and all(
        st * size % 16 == 0 for st in t.stride()[:3])
    return t if t.stride(3) == 1 and aligned else t.contiguous()


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
    plan = attention_plan(b, h, sq, skv, causal=causal, window=window,
                          q_offset=q_offset)
    part_o = part_ml = None
    if plan.splits > 1:
        part_o = torch.empty((plan.splits, b * h, sq, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((plan.splits, b * h, sq, 2),
                              dtype=torch.float32, device=q.device)
    lib = _mq.load()
    code = _mq.launch(
        lib.flash_attention_fwd, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16), b, h,
        kvh, sq, skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], scale, int(softcap is not None),
        0.0 if softcap is None else float(softcap), int(causal),
        int(window is not None), 0 if window is None else int(window),
        int(q_offset), *plan, 0 if part_o is None else part_o.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr())
    _mq.check(lib, code, "flash_attention")
    if out.numel():
        _mq.count_launch("flash_attention")
    return out
