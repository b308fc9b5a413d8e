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
given and returns it. ``sharded_flash_decode`` and ``seq_parallel_flash``
(sequence-sharded variants under a mesh's rules) are ROADMAP item 10c; on
one card they are the local calls below.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ParamDef
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


# --------------------------------------------------------------- full forward
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
    precomputed (the model computes it once per forward)."""
    window = effective_window(cfg, layer_idx)
    scale = _qscale(cfg)
    dh = cfg.resolved_head_dim
    b, s, _ = x.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kvh, dh)
    v = (x @ params["wv"]).reshape(b, s, kvh, dh)

    if cfg.pos == "rope":
        if rope is None:
            sin, cos = rope_freqs(positions, dh, cfg.rope_theta)
            rope = (sin[None, :, None, :], cos[None, :, None, :])
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)

    new_cache = None
    if mode == "decode":
        with torch.no_grad():
            slot = cache_slot(t, cache["k"].shape[2])
            cache["k"][:, :, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, :, slot] = v[:, 0].to(cache["v"].dtype)
            cache["pos"][slot] = t
        out = flash_decode(q, cache["k"], cache["v"], t,
                           logit_softcap=cfg.attn_softcap, scale=scale)
        new_cache = cache
    else:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_softcap, scale=scale)
        if mode == "prefill" and cache is not None:
            new_cache = prefill_cache(cfg, k, v, window, cache)

    y = out.reshape(b, s, h * dh) @ params["wo"]
    return y, new_cache


@torch.no_grad()
def prefill_cache(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int], out: dict) -> dict:
    """Lay prefilled K/V [B, S, Kv, D] out, in place, into ``out``, the
    ring-buffer, head-major decode cache {"k", "v": [B, Kv, L, D], "pos":
    [L]} that ``attn_cache_defs`` sizes (L = ``ring_capacity(window,
    capacity)``): position p in slot p % L, the last L positions kept;
    unfilled slots zero with pos -1. Returns ``out``. (The reference
    returns a new cache of ``capacity``; the port's caller owns it.)"""
    s = k.shape[1]
    cap = out["k"].shape[2]
    if ring_capacity(window, cap) != cap:
        raise ValueError(f"cache holds {cap} slots, more than the layer's "
                         f"window of {window}")
    positions = torch.arange(s, dtype=torch.int32, device=k.device)
    for key, src in (("k", k), ("v", v)):
        dst = out[key]
        src = src.transpose(1, 2)  # [B, Kv, S, D]
        if s >= cap:  # the last cap positions, rotated to slots p % cap
            shift = s % cap
            dst[:, :, shift:] = src[:, :, s - cap:s - shift]
            dst[:, :, :shift] = src[:, :, s - shift:]
        else:
            dst[:, :, :s] = src
            dst[:, :, s:] = 0
    pos = out["pos"]
    if s >= cap:
        shift = s % cap
        pos[shift:] = positions[s - cap:s - shift]
        pos[:shift] = positions[s - shift:]
    else:
        pos[:s] = positions
        pos[s:] = -1
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
