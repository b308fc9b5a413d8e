"""GQA attention of the LMs (the JAX package's ``models/attention.py``):
sliding-window / local-global variants, logit softcapping, and decode
against a head-major ring-buffer KV cache [B, Kv, L, D].

Every attention goes through ``ops.flash_attention``: the hand-written
kernel for a CUDA tensor (or the call raises), its plain version for a CPU
tensor. The reference's own jnp chunked attention and its flash-decode are
not ported block by block; the kernel computes the same function, with the
same mask ``pos - window < j <= pos`` and the softcap applied after the
scale.

Decode fits the kernel's positional mask as follows. The ring of a layer
holds ``cap = min(capacity, window)`` slots; position p lives in slot
``p % cap``. After the new token at position t is written, the ring holds
positions ``max(0, t - cap + 1) .. t`` in slots ``[0, min(t + 1, cap))``,
and every one of them is inside the window (cap <= window). So at step t
the valid keys are exactly that filled prefix, and decode is one
non-causal, unwindowed kernel call over ``k_cache[:, :, :n]`` read through
its strides (D contiguous, no copy). Only the summation order differs from
the reference, which masks by the slots' positions. The contract: decode
at position t follows a prefill (or decode steps) that filled positions
0 .. t - 1.

The cache is written in place (the reference returns new arrays and
donates the old ones): a decode or prefill call updates the cache it is
given and returns it.

Under a mesh of more than one rank and its rules (``distributed.py``) the
tensors are DTensors and attention runs on each rank's part:

* ``sharded_flash_decode`` — the ring is sharded over the ``kv_seq`` axes:
  rank r holds slots [r·L/R, (r+1)·L/R), and its valid keys are those
  slots within the filled prefix. Each rank runs the kernel over its valid
  slots for (out, lse) (``decode_shard``; a rank with none launches
  nothing), and ``merge_decode_shards`` combines: lse_g = max lse, w =
  e^(lse − lse_g), out = Σ w·out / Σ w, the max and sums all-reduced over
  the ``kv_seq`` groups. Only the rank owning slot t % L writes the new
  token's K/V.
* ``seq_parallel_flash`` — q, k and v are sharded over the sequence on
  the ``attn_seq`` axes (archs whose heads do not divide the model axis);
  each rank all-gathers K/V (a DTensor redistribute, so the train step
  differentiates through it) and runs the kernel on its queries with
  ``q_offset`` = its first position (``seq_shard``).
* otherwise attention runs on each rank's heads (``local_attention``).

On one rank, or without rules, every one of them is the local call, bit
for bit.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import (
    ParamDef,
    PartitionSpec,
    constrain,
    current_mesh,
    current_rules,
    gathered,
    is_dtensor,
    local_range,
    mesh_axis_size,
    placements,
    spec_axes,
)
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, param_dtype, rope_freqs


# --------------------------------------------------------------------- params
def attn_defs(cfg: ArchConfig):
    """QKV/O weights with fused (heads * head_dim) output dims, as in the
    reference."""
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    dt = param_dtype(cfg)
    return {
        "wq": ParamDef((d, h * dh), ("embed", "heads_fused"), dtype=dt),
        "wk": ParamDef((d, kv * dh), ("embed", "kv_fused"), dtype=dt),
        "wv": ParamDef((d, kv * dh), ("embed", "kv_fused"), dtype=dt),
        "wo": ParamDef((h * dh, d), ("heads_fused", "embed"), dtype=dt),
    }


def effective_window(cfg: ArchConfig, layer_idx: int) -> Optional[int]:
    if cfg.local_global_period and cfg.is_local_layer(layer_idx):
        return cfg.local_window
    return cfg.sliding_window


def _qscale(cfg: ArchConfig) -> float:
    return cfg.query_scale or cfg.resolved_head_dim ** -0.5


def cache_slot(t: int, capacity: int) -> int:
    return t % capacity


def ring_capacity(window: Optional[int], capacity: int) -> int:
    return min(capacity, window) if window is not None else capacity


# ------------------------------------------------------------------ attention
def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, t: int, *,
                 logit_softcap: Optional[float], scale: float) -> torch.Tensor:
    """One new token per sequence: q [B, 1, H, D] against the ring cache
    [B, Kv, L, D] after position t was written -> [B, 1, H, D]. The valid
    keys are the filled prefix ``[0, min(t + 1, L))`` (module docstring),
    so the kernel runs non-causal and unwindowed over it."""
    n = min(t + 1, k_cache.shape[2])
    return ops.flash_attention(
        q, k_cache[:, :, :n].transpose(1, 2),
        v_cache[:, :, :n].transpose(1, 2), causal=False, window=None,
        softcap=logit_softcap, scale=scale)


def decode_shard(q: torch.Tensor, k_slots: torch.Tensor,
                 v_slots: torch.Tensor, n: int, *,
                 logit_softcap: Optional[float], scale: float):
    """One shard of a sequence-sharded decode: q [B, 1, H, D] against the
    first ``n`` slots of the shard's slice [B, Kv, L_r, D] of the ring ->
    (out [B, 1, H, D] in q's dtype, lse [B, 1, H] fp32), both from the
    kernel. With no valid slot nothing launches: out 0, lse -inf."""
    if n <= 0:
        b, sq, h, _ = q.shape
        return torch.zeros_like(q), torch.full(
            (b, sq, h), float("-inf"), dtype=torch.float32, device=q.device)
    return ops.flash_attention(
        q, k_slots[:, :, :n].transpose(1, 2),
        v_slots[:, :, :n].transpose(1, 2), causal=False, window=None,
        softcap=logit_softcap, scale=scale, return_lse=True)


def merge_decode_shards(out: torch.Tensor, lse: torch.Tensor,
                        reduce_max: Callable, reduce_sum: Callable):
    """Shards' (out, lse) -> the attention over all their keys, in out's
    dtype: lse_g = reduce_max(lse), w = e^(lse − lse_g) (0 for a shard
    with no key), Σ w·out / Σ w with Σ = ``reduce_sum``. The reductions
    are all-reduces over the shards' group (``sharded_flash_decode``) or
    over a leading axis of stacked shard results. A row with no key in
    any shard comes out 0."""
    lse_g = reduce_max(lse)
    w = torch.where(lse > float("-inf"), torch.exp(lse - lse_g), 0.0)
    num = reduce_sum(out.float() * w[..., None])
    den = reduce_sum(w)
    return (num / den.clamp_min(1e-30)[..., None]).to(out.dtype)


def _all_reduce(x: torch.Tensor, op, groups) -> torch.Tensor:
    x = x.clone()
    for group in groups:
        dist.all_reduce(x, op=op, group=group)
    return x


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for size in reversed(shape):
        stride.append(acc)
        acc *= size
    return tuple(reversed(stride))


def _from_local(local: torch.Tensor, like, pls):
    """A DTensor on ``like``'s mesh from this rank's ``local`` part
    (made contiguous), laid out by ``pls``, of ``like``'s global shape."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), like.device_mesh, pls,
                              shape=like.shape,
                              stride=_contiguous_stride(like.shape))


def _batch_placements(ref) -> list:
    """``ref``'s batch split (Shard(0) where it has one), replicated on
    every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in ref.placements]


def sharded_flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, t: int, *,
                         logit_softcap: Optional[float],
                         scale: float) -> torch.Tensor:
    """:func:`flash_decode` over a ring sharded on the ``kv_seq`` axes of
    the current rules (module docstring); a plain cache, or one whose
    ``kv_seq`` axes hold one rank, is the local call."""
    if not is_dtensor(k_cache):
        return flash_decode(q, k_cache, v_cache, t,
                            logit_softcap=logit_softcap, scale=scale)
    mesh = k_cache.device_mesh
    rules = current_rules()
    seq = spec_axes(rules.get("kv_seq")) if rules else ()
    pls = _batch_placements(k_cache)
    q_local = q.redistribute(mesh, pls).to_local()
    k_local, v_local = k_cache.to_local(), v_cache.to_local()
    if mesh_axis_size(mesh, seq) == 1:
        out = flash_decode(q_local, k_local, v_local, t,
                           logit_softcap=logit_softcap, scale=scale)
        return _from_local(out, q, pls)
    lo, length = local_range(k_cache, 2)
    n = max(0, min(min(t + 1, k_cache.shape[2]) - lo, length))
    out, lse = decode_shard(q_local, k_local, v_local, n,
                            logit_softcap=logit_softcap, scale=scale)
    groups = [mesh.get_group(a) for a in seq]
    out = merge_decode_shards(
        out, lse, lambda x: _all_reduce(x, dist.ReduceOp.MAX, groups),
        lambda x: _all_reduce(x, dist.ReduceOp.SUM, groups))
    return _from_local(out, q, pls)


def seq_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              offset: int, *, window: Optional[int],
              logit_softcap: Optional[float], scale: float) -> torch.Tensor:
    """One rank's part of :func:`seq_parallel_flash`: its queries q [B,
    S_r, H, D] at positions ``offset``.. against the whole sequence's k / v
    [B, S, Kv, D], causal, through the kernel."""
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               softcap=logit_softcap, scale=scale,
                               q_offset=offset)


def seq_parallel_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: Optional[int], logit_softcap: Optional[float],
                       scale: float) -> torch.Tensor:
    """Context-parallel causal attention for archs whose heads do not
    divide the model axis: q / k / v [B, S, heads, D] sharded over the
    sequence on the ``attn_seq`` axes, K/V all-gathered (differentiably),
    each rank's queries through :func:`seq_shard`. The output stays
    sequence-sharded. Plain tensors, or no ``attn_seq`` rule: the local
    call."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rules = current_rules()
    seq = rules.get("attn_seq") if rules else None
    if not is_dtensor(q) or seq is None:
        return local_attention(q, k, v, window=window,
                               logit_softcap=logit_softcap, scale=scale)
    mesh = q.device_mesh
    pls = placements(PartitionSpec(rules.get("act_batch"), seq, None, None),
                     mesh)

    def on_seq(p):
        return isinstance(p, Shard) and p.dim == 1

    whole = [Replicate() if on_seq(p) else p for p in pls]
    grads = [Partial() if on_seq(p) else p for p in pls]
    q_s = q.redistribute(mesh, pls)
    k_f, v_f = (x.redistribute(mesh, pls).redistribute(mesh, whole)
                for x in (k, v))
    offset, _ = local_range(q_s, 1)
    out = seq_shard(q_s.to_local(), k_f.to_local(grad_placements=grads),
                    v_f.to_local(grad_placements=grads), offset,
                    window=window, logit_softcap=logit_softcap, scale=scale)
    return _from_local(out, q, pls)


def _kv_for_heads(kv: torch.Tensor, h0: int, hl: int, g: int):
    """The kv heads [B, S, Kv', D] that query heads h0 .. h0 + hl - 1 read
    (head h reads kv head h // g), laid out for the kernel's grouping."""
    lo, hi = h0 // g, (h0 + hl - 1) // g + 1
    if h0 % g == 0 and hl % g == 0 or hi - lo == 1:
        return kv[:, :, lo:hi]
    idx = torch.arange(h0, h0 + hl, device=kv.device) // g
    return kv.index_select(2, idx)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int], logit_softcap: Optional[float],
                    scale: float) -> torch.Tensor:
    """Causal attention through the kernel. DTensors run on each rank's
    batch rows and query heads against the kv heads those read, the whole
    sequence on every rank; the output keeps q's split."""
    if not is_dtensor(q):
        return ops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=logit_softcap, scale=scale)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    q_pls = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
             for p in q.placements]
    q = q.redistribute(mesh, q_pls)
    kv_pls = _batch_placements(q)
    grads = [Partial() if isinstance(p, Shard) and p.dim == 2 else kv
             for p, kv in zip(q_pls, kv_pls)]
    h0, hl = local_range(q, 2)
    g = q.shape[2] // k.shape[2]
    k_l, v_l = (_kv_for_heads(x.redistribute(mesh, kv_pls).to_local(
        grad_placements=grads), h0, hl, g) for x in (k, v))
    out = ops.flash_attention(q.to_local(), k_l, v_l, causal=True,
                              window=window, softcap=logit_softcap,
                              scale=scale)
    return _from_local(out, q, q_pls)


# --------------------------------------------------------------- full forward
def split_heads(t: torch.Tensor, n: int, dh: int, logical: str):
    """t [B, S, n·dh] -> [B, S, n, dh] laid out as (act_batch, act_seq,
    ``logical``, None). A DTensor whose fused dim is split over a number
    of ranks that does not divide the n heads (gemma2-2b's 8 heads over a
    model axis of 16) is gathered on that dim first: DTensor cannot
    unflatten a split that cuts a head."""
    from torch.distributed.tensor import Shard

    b, s, _ = t.shape
    if is_dtensor(t):
        ranks = 1
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == 2:
                ranks *= t.device_mesh.size(i)
        if n % ranks:
            t = constrain(t, "act_batch", "act_seq", None)
    return constrain(t.reshape(b, s, n, dh), "act_batch", "act_seq", logical,
                     None)


def attention_forward(params, x: torch.Tensor, cfg: ArchConfig,
                      layer_idx: int, *, positions: torch.Tensor, mode: str,
                      cache: Optional[dict] = None,
                      t: Optional[int] = None, rope=None):
    """x [B, S, D] -> (y [B, S, D], cache or None).

    ``positions`` [S] are the tokens' positions (decode: [1] holding t);
    ``mode`` is train | prefill | decode; decode also takes the position
    ``t`` as an int and the layer's ``cache`` ({"k", "v": [B, Kv, L, D],
    "pos": [L]}), which it updates in place. Prefill lays its K/V out into
    ``cache`` (``attn_cache_defs``' layout), in place, when one is given.
    ``rope`` = (sin, cos) [1, S, 1, D/2] may be passed
    precomputed (the model computes it once per forward). Under a mesh's
    rules the sequence-sharded variants run where the rules ask for them,
    as in the reference."""
    window = effective_window(cfg, layer_idx)
    scale = _qscale(cfg)
    dh = cfg.resolved_head_dim
    b, s, _ = x.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    q = constrain(x @ gathered(params["wq"], "embed", "heads_fused"),
                  "act_batch", "act_seq", "heads_fused")
    k = constrain(x @ gathered(params["wk"], "embed", "kv_fused"),
                  "act_batch", "act_seq", "kv_fused")
    v = constrain(x @ gathered(params["wv"], "embed", "kv_fused"),
                  "act_batch", "act_seq", "kv_fused")
    q = split_heads(q, h, dh, "heads")
    k = split_heads(k, kvh, dh, "kv_heads")
    v = split_heads(v, kvh, dh, "kv_heads")

    if cfg.pos == "rope":
        if rope is None:
            sin, cos = rope_freqs(positions, dh, cfg.rope_theta)
            rope = (sin[None, :, None, :], cos[None, :, None, :])
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)

    new_cache = None
    if mode == "decode":
        with torch.no_grad():
            write_slot(cache, k, v, t)
        out = sharded_flash_decode(q, cache["k"], cache["v"], t,
                                   logit_softcap=cfg.attn_softcap,
                                   scale=scale)
        new_cache = cache
    else:
        rules = current_rules()
        if rules and rules.get("attn_seq"):
            out = seq_parallel_flash(q, k, v, window=window,
                                     logit_softcap=cfg.attn_softcap,
                                     scale=scale)
        else:
            out = local_attention(q, k, v, window=window,
                                  logit_softcap=cfg.attn_softcap,
                                  scale=scale)
        if mode == "prefill" and cache is not None:
            new_cache = prefill_cache(cfg, k, v, window, cache)

    out = constrain(out.reshape(b, s, h * dh), "act_batch", "act_seq",
                    "heads_fused")
    y = out @ gathered(params["wo"], "heads_fused", "embed")
    return y, new_cache


def _cache_local(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """(k, v [B, S, Kv, D] and the cache's k, v, pos as this rank holds
    them, the global index of its first slot): a sharded cache's local
    slots with k / v aligned to its batch split; else the tensors
    themselves and 0."""
    if not is_dtensor(cache["k"]):
        return k, v, cache["k"], cache["v"], cache["pos"], 0
    pls = _batch_placements(cache["k"])
    k, v = (x.redistribute(x.device_mesh, pls).to_local() for x in (k, v))
    lo, _ = local_range(cache["k"], 2)
    return (k, v, cache["k"].to_local(), cache["v"].to_local(),
            cache["pos"].to_local(), lo)


@torch.no_grad()
def write_slot(cache: dict, k: torch.Tensor, v: torch.Tensor, t: int):
    """Write the new token's k / v [B, 1, Kv, D] and position ``t`` into
    slot t % L of the ring, in place; on a sharded ring only the rank
    holding that slot writes."""
    k, v, kc, vc, pos, lo = _cache_local(cache, k, v)
    slot = cache_slot(t, cache["k"].shape[2]) - lo
    if 0 <= slot < kc.shape[2]:
        kc[:, :, slot] = k[:, 0].to(kc.dtype)
        vc[:, :, slot] = v[:, 0].to(vc.dtype)
        pos[slot] = t


def ring_positions(s: int, cap: int, slots: torch.Tensor) -> torch.Tensor:
    """The position each of ``slots`` holds after a prefill of s
    positions into a ring of ``cap`` slots: the last ``cap`` positions,
    p in slot p % cap; -1 where a slot is unfilled."""
    if s >= cap:
        return s - 1 - (s - 1 - slots) % cap
    return torch.where(slots < s, slots, -1)


@torch.no_grad()
def prefill_cache(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int], out: dict) -> dict:
    """Lay prefilled K/V [B, S, Kv, D] out, in place, into ``out``, the
    ring-buffer, head-major decode cache {"k", "v": [B, Kv, L, D], "pos":
    [L]} that ``attn_cache_defs`` sizes (L = ``ring_capacity(window,
    capacity)``): position p in slot p % L, the last L positions kept;
    unfilled slots zero with pos -1. A sharded ring fills each rank's own
    slots. Returns ``out``. (The reference returns a new cache of
    ``capacity``; the port's caller owns it.)"""
    s = k.shape[1]
    cap = out["k"].shape[2]
    if ring_capacity(window, cap) != cap:
        raise ValueError(f"cache holds {cap} slots, more than the layer's "
                         f"window of {window}")
    k, v, kc, vc, pos, lo = _cache_local(out, k, v)
    slots = torch.arange(lo, lo + kc.shape[2], device=k.device)
    held = ring_positions(s, cap, slots)
    filled = (held >= 0)[:, None]
    for dst, src in ((kc, k), (vc, v)):
        src = src.transpose(1, 2)  # [B, Kv, S, D]
        dst.copy_(torch.where(filled, src.index_select(2, held.clamp_min(0)),
                              0))
    pos.copy_(held)
    return out


def attn_cache_defs(cfg: ArchConfig, layer_idx: int, batch: int,
                    capacity: int):
    cap = ring_capacity(effective_window(cfg, layer_idx), capacity)
    kvh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = param_dtype(cfg)
    return {
        "k": ParamDef((batch, kvh, cap, dh),
                      ("kv_batch", "kv_heads_cache", "kv_seq", None),
                      init="zeros", dtype=dt),
        "v": ParamDef((batch, kvh, cap, dh),
                      ("kv_batch", "kv_heads_cache", "kv_seq", None),
                      init="zeros", dtype=dt),
        "pos": ParamDef((cap,), ("kv_seq",), init="const", scale=-1,
                        dtype=torch.int32),
    }
