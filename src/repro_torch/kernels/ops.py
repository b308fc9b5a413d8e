"""Public entries of the port's kernels (the MX quantize, MX GEMM and
flash-attention entries of the JAX package's ``kernels/ops.py``).

The path is chosen by the tensor's device, never by a setting:

* a CUDA tensor goes to the hand-written kernel (``mx_quantize.py``,
  ``mx_matmul.py``, ``mx_fused.py``, ``flash_attention.py``) — or the call
  raises; nothing falls back to the plain version;
* a CPU tensor goes to the plain PyTorch version (``ref.py``), which is
  what the CPU tests compare with the JAX package.

``kernel_stats()`` records which path served every call (``"cuda"`` or
``"plain"``), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import counts
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mx_fused as _mf
from repro_torch.kernels import mx_matmul as _mm
from repro_torch.kernels import mx_quantize as _mq
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import BLOCK, MXTensor

# Process-wide dispatch counters; every read-modify-write holds the lock so
# concurrent callers never lose an increment. Each thread also keeps its
# own per-path totals (never reset), so a caller can tell which path served
# the calls it made itself while other threads issue work too.
_stats_lock = threading.Lock()
_kernel_stats: Dict[str, Dict[str, int]] = {}
_thread_paths = threading.local()


def _count(op: str, path: str) -> None:
    with _stats_lock:
        by_path = _kernel_stats.setdefault(op, {})
        by_path[path] = by_path.get(path, 0) + 1
    mine = getattr(_thread_paths, "totals", None)
    if mine is None:
        mine = _thread_paths.totals = {}
    mine[path] = mine.get(path, 0) + 1


def thread_path_totals() -> Dict[str, int]:
    """Calls served per path (``"cuda"`` / ``"plain"``) on the calling
    thread since it started; :func:`reset_kernel_stats` leaves them.

    The trace recorder reads these, not :func:`kernel_stats`'s
    process-wide sum: a program is issued on the thread that records it,
    and under the manager's ``parallel_shards`` other shards' threads
    launch kernels at the same time, which must not leak into its path."""
    return dict(getattr(_thread_paths, "totals", None) or {})


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
    raise ValueError(f"no MX kernel or attention kernel for device "
                     f"{t.device}")


def _shared_path(*ts: torch.Tensor) -> str:
    """The path of an op whose operands must share one device."""
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("operands on different devices: "
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


def mx_quantize_many(leaves: Sequence[torch.Tensor],
                     precision: str) -> List[MXTensor]:
    """:func:`mx_quantize` of every leaf (each flattened to [-1, K], the
    result covering K padded to 16), on the card in ONE launch for up to
    ``mx_quantize.MAX_LEAVES`` leaves, each result a view of arenas shared
    by all; on the CPU the plain version leaf by leaf. Leaves on different
    devices raise. ``kernel_stats`` counts one call per launch."""
    if not leaves:
        return []
    path = _shared_path(*leaves)
    plan = _mq.plan_many([x.shape for x in leaves])
    if path == "cuda":
        qs = _mq.mx_quantize_many_cuda(leaves, precision, plan)
    else:
        qs = [_ref.mx_quantize_ref(
            _pad_last(x.reshape(-1, x.shape[-1]), BLOCK)[0], precision)
            for x in leaves]
    for _ in range(plan.launches):
        _count("mx_quantize", path)
    return qs


def mx_dequantize_many(qs: Sequence[MXTensor],
                       shapes: Sequence[Sequence[int]],
                       dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
    """The inverse of :func:`mx_quantize_many`: ``qs[i]`` back to a tensor
    of ``shapes[i]`` (its real width ``shapes[i][-1]``, the padding
    dropped) and ``dtypes[i]``, on the card in ONE launch for up to
    ``mx_quantize.MAX_LEAVES`` leaves (fp32 results are views of one
    arena), on the CPU the plain version leaf by leaf."""
    if not qs:
        return []
    path = _shared_path(*qs)  # MXTensor.device: no plane is read
    plan = _mq.plan_many(shapes)
    if path == "cuda":
        ys = _mq.mx_dequantize_many_cuda(qs, shapes, plan)
    else:
        ys = [_ref.mx_dequantize_ref(q)[:, : shape[-1]].reshape(shape)
              for q, shape in zip(qs, shapes)]
    for _ in range(plan.launches):
        _count("mx_dequantize", path)
    return [y if y.dtype == dtype else y.to(dtype)
            for y, dtype in zip(ys, dtypes)]


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
    path = _shared_path(a, b)
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
    path = _shared_path(a, b)
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
    path = _shared_path(g, x, w)
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
    path = _shared_path(a, qb.mantissa)
    if path == "cuda":
        out = _mf.mx_matmul_prequant_cuda(a, qb, precision_a)
    else:
        out = _ref.mx_matmul_prequant_ref(_pad_last(a, BLOCK)[0], qb,
                                          precision_a)
    _count("mx_matmul_prequant", path)
    return out


class _FlashAttention(torch.autograd.Function):
    """Attention whose forward is the kernel (the plain version for a CPU
    tensor) and whose backward is plain PyTorch
    (``ref.flash_attention_bwd_ref``), recomputing P from the saved q and
    k. The JAX package has no Pallas backward for attention — XLA
    differentiates the ViT's einsum attention — so neither has the port.

    Under ``torch.func.vmap`` (a fleet serving every lane's ViT in one
    program) the :meth:`vmap` rule folds the vmapped axis into the
    kernel's own batch axis B, runs the same kernel (or plain version)
    once, and unfolds the result.

    With ``lse`` the forward also returns the rows' log-sum-exp, which is
    not differentiable."""

    @staticmethod
    def forward(q, k, v, path, opts, lse):
        if path == "cuda":
            return _fa.flash_attention_cuda(q, k, v, return_lse=lse, **opts)
        if path == "fake":
            return _fa.flash_attention_fake(q, k, v, return_lse=lse, **opts)
        return _ref.flash_attention_ref(q, k, v, return_lse=lse, **opts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, _path, opts, lse = inputs
        ctx.save_for_backward(q, k, v)
        ctx.opts = opts
        if lse:
            ctx.mark_non_differentiable(output[1])

    @staticmethod
    def vmap(info, in_dims, q, k, v, path, opts, lse):
        def fold(t, dim):
            t = (t.unsqueeze(0).expand(info.batch_size, *t.shape)
                 if dim is None else t.movedim(dim, 0))
            return t.reshape(-1, *t.shape[2:])

        def unfold(t):
            return t.reshape(info.batch_size, -1, *t.shape[1:])

        q, k, v = (fold(t, d) for t, d in zip((q, k, v), in_dims[:3]))
        out = _FlashAttention.apply(q, k, v, path, opts, lse)
        if lse:
            return (unfold(out[0]), unfold(out[1])), (0, 0)
        return unfold(out), 0

    @staticmethod
    def backward(ctx, do, *_lse_grad):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _ref.flash_attention_bwd_ref(q, k, v, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0, return_lse: bool = False):
    """Flash attention; q [B, Sq, H, D], k/v [B, Skv, Kv, D] -> [B, Sq, H,
    D] in q's dtype, differentiable. Query row i sits at position
    ``q_offset + i``, as in the Pallas kernel (see ``ref.py``). With
    ``return_lse``: (out, lse [B, Sq, H] fp32), the rows' log-sum-exp from
    the kernel (-inf for a row with no key; not differentiable). The
    Pallas tile sizes ``qb`` / ``kvb`` and ``interpret`` are TPU tiling and
    are not ported.

    Fake tensors (a dry run's, ``launch/counting.py``) take the fake path:
    outputs of the kernel's shapes and dtypes, nothing run and nothing
    counted in :func:`kernel_stats`. Under a counter the call counts as
    the kernel (``counts.kernel``): its FLOPs and bytes, not those of the
    plain version's operations."""
    path = _shared_path(q, k, v)
    if path != "cuda" and isinstance(q, FakeTensor):
        path = "fake"
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset)
    if counts.active():
        out = _counted_attention(q, k, v, path, opts, return_lse)
    else:
        out = _FlashAttention.apply(q, k, v, path, opts, return_lse)
    if path != "fake":
        _count("flash_attention", path)
    return out


def _counted_attention(q, k, v, path: str, opts: dict, return_lse: bool):
    """:func:`flash_attention`'s call under the installed counter: it
    counts as the kernel, its FLOPs (``attention_flops``), q, k and v read
    and the output (and lse) written."""
    b, sq, h, _ = q.shape
    flops = _fa.attention_flops(tuple(q.shape), k.shape[1],
                                causal=opts["causal"], window=opts["window"],
                                q_offset=opts["q_offset"])
    nbytes = (2 * q.numel() * q.element_size()
              + k.numel() * k.element_size() + v.numel() * v.element_size()
              + (4 * b * sq * h if return_lse else 0))
    with counts.kernel("flash_attention", flops, nbytes, (q, k, v)):
        return _FlashAttention.apply(q, k, v, path, opts, return_lse)
