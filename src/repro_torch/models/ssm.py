"""Mamba (S6) mixer, the selective state-space layer (the JAX package's
``models/ssm.py``).

Training and prefill run a chunked scan: a loop over ``MAMBA_CHUNK``-token
chunks of the sequence carrying the SSM state [B, di, ds], and inside each
chunk a log-depth doubling scan of the recurrence h_t = dA_t h_{t-1} +
dBx_t (the reference's ``associative_scan``; the two trees differ in
summation order only). In training each chunk runs under
``torch.utils.checkpoint``, as the reference ``jax.checkpoint``s its chunk
body, so neither pass holds [B, S, di, ds]: only a chunk's [B, chunk, di,
ds] lives at a time. Decode is one recurrent step.

The cache ({"conv": [B, d_conv - 1, di] in the config's dtype, "ssm":
[B, di, ds] fp32}) is written in place with ``copy_``: the model hands
each layer views of its stacked cache leaves (``models/transformer.py``).

Across ranks (a DTensor x) the layer is tensor-parallel over d_inner
("ff"), as ``mamba_defs`` and ``mamba_cache_defs`` lay it out: each model
rank runs ``mamba_rank`` on its channels (the in-projections, the conv,
``w_dt_up``, ``dt_bias``, ``a_log``, ``d_skip``, the scan, the gate and
its cache channels stay local). Three contractions run over the split
d_inner: ``w_bc`` and ``w_dt_down``, whose per-token results are summed
over the ranks once a layer call ahead of the chunk loop, and ``w_out``,
whose terms the ranks sum into y. The one-rank path keeps its per-chunk
projections, bit for bit as before.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import counts
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import (
    ParamDef,
    constrain,
    is_dtensor,
    run_mixer,
    term,
)
from repro_torch.models.layers import param_dtype

MAMBA_CHUNK = 32  # tokens per scan chunk (read at call time)


def _dt_rank(cfg: ArchConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def mamba_defs(cfg: ArchConfig):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dtr = _dt_rank(cfg)
    dt = param_dtype(cfg)
    return {
        "w_in_x": ParamDef((d, di), ("embed", "ff"), dtype=dt),
        "w_in_z": ParamDef((d, di), ("embed", "ff"), dtype=dt),
        "conv_w": ParamDef((dc, di), (None, "ff"), dtype=dt, scale=0.5),
        "conv_b": ParamDef((di,), ("ff",), init="zeros", dtype=dt),
        "w_bc": ParamDef((di, 2 * ds), ("ff", None), dtype=dt),
        "w_dt_down": ParamDef((di, dtr), ("ff", None), dtype=dt),
        "w_dt_up": ParamDef((dtr, di), (None, "ff"), dtype=dt),
        "dt_bias": ParamDef((di,), ("ff",), init="const", scale=-4.0,
                            dtype=torch.float32),
        "a_log": ParamDef((di, ds), ("ff", None), init="const", scale=0.0,
                          dtype=torch.float32),
        "d_skip": ParamDef((di,), ("ff",), init="ones", dtype=torch.float32),
        "w_out": ParamDef((di, d), ("ff", "embed"), dtype=dt),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over the sequence: x [B, S, di], w [dc, di]
    -> (y [B, S, di], the last dc - 1 input rows). Decode passes the
    cache's rows [B, dc - 1, di], cast to x's dtype; otherwise the
    sequence is zero-padded. The taps sum in the reference's order."""
    dc = w.shape[0]
    if conv_state is not None:
        xx = torch.cat([conv_state.to(x.dtype), x], 1)
    else:
        xx = F.pad(x, (0, 0, dc - 1, 0))
    s = x.shape[1]
    y = xx[:, 0:s] * w[0]
    for i in range(1, dc):
        y = y + xx[:, i:i + s] * w[i]
    return y + b, (xx[:, -(dc - 1):] if dc > 1 else None)


def last_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last n rows of x [B, S, di], zero-padded in front when S < n
    (the conv cache a prefill leaves)."""
    return F.pad(x, (0, 0, n, 0))[:, -n:]


def _ssm_inputs(params, xc: torch.Tensor, proj=None):
    """xc [B, S, di] -> (dA, dBx [B, S, di, ds], c_in [B, S, ds]), fp32.
    ``proj`` [B, S, 2 ds + dt_rank] fp32, the per-token projections
    [xc @ w_bc | xc @ w_dt_down] summed over the model ranks
    (``mamba_rank``), stands in for xc's own."""
    if proj is None:
        bc = (xc @ params["w_bc"]).float()
        dt_low = xc @ params["w_dt_down"]
    else:  # rounded to xc's dtype, as its own projections would be
        n = params["w_bc"].shape[1]
        bc, dt_low = proj[..., :n].to(xc.dtype).float(), proj[
            ..., n:].to(xc.dtype)
    b_in, c_in = bc.chunk(2, dim=-1)
    dt = (dt_low @ params["w_dt_up"]).float()
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
    # where the two differ by log1p(e^-20) < 2.1e-9, below fp32's step.
    dt = F.softplus(dt + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    dA = torch.exp(dt[..., None] * a)
    dBx = dt[..., None] * b_in[:, :, None, :] * xc.float()[..., None]
    return dA, dBx, c_in


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over dim 1 of (a, b) under (a1, b1) o (a2, b2) =
    (a2 a1, a2 b1 + b2), by doubling: after it, b_t = h_t from h = 0 and
    a_t = prod_{u <= t} a_u."""
    n, off = a.shape[1], 1
    while off < n:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def _chunk(params, h0: torch.Tensor, xc: torch.Tensor, proj=None):
    """One chunk: h0 [B, di, ds], xc [B, L, di] (``proj`` its rows of the
    summed projections, or None) -> (h_L, y [B, L, di])."""
    dA, dBx, c_in = _ssm_inputs(params, xc, proj)
    a_cum, b_cum = _scan(dA, dBx)
    h = a_cum * h0[:, None] + b_cum
    y = torch.einsum("bsdn,bsn->bsd", h, c_in)
    y = y + xc.float() * params["d_skip"]
    return h[:, -1], y


def _decode_step(params, xc: torch.Tensor, cache: dict, proj=None):
    """One recurrent step from ``cache["ssm"]``, written in place ->
    y [B, 1, di] fp32."""
    dA, dBx, c_in = _ssm_inputs(params, xc, proj)
    h = dA[:, 0] * cache["ssm"] + dBx[:, 0]
    y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None]
    y = y + xc.float() * params["d_skip"]
    cache["ssm"].copy_(h)
    return y


def _chunk_loop(params, xc: torch.Tensor, mode: str, proj=None):
    """The chunked scan over xc [B, S, di] from h = 0 -> (h_S, y [B, S,
    di] fp32); each chunk under ``checkpoint`` in training."""
    b, s, di = xc.shape
    csz = MAMBA_CHUNK if s % MAMBA_CHUNK == 0 else s
    remat = mode == "train" and torch.is_grad_enabled()
    h = xc.new_zeros((b, di, params["a_log"].shape[1]), dtype=torch.float32)
    ys = []
    for i in counts.repeat(s // csz, ys):
        c = i * csz
        part = (xc[:, c:c + csz],) + (() if proj is None
                                      else (proj[:, c:c + csz],))
        if remat:
            h, y_c = checkpoint(_chunk, params, h, *part,
                                use_reentrant=False)
        else:
            h, y_c = _chunk(params, h, *part)
        ys.append(y_c)
    return h, torch.cat(counts.full(ys, s // csz), 1)


def mamba_forward(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                  cache: Optional[dict] = None):
    """x [B, S, D] -> (y [B, S, D], cache or None). Decode reads and
    prefill fills ``cache`` in place (module docstring). A DTensor x runs
    tensor-parallel over d_inner (``mamba_rank`` on each rank)."""
    if is_dtensor(x):
        y = run_mixer(functools.partial(mamba_rank, cfg=cfg, mode=mode),
                      params, mamba_defs(cfg), x, cache,
                      mamba_cache_defs(cfg, 1))
        return y, (cache if mode != "train" else None)
    xi = constrain(x @ params["w_in_x"], "act_batch", "act_seq", "ff")
    z = x @ params["w_in_z"]

    if mode == "decode":
        xc, conv_state = causal_conv(xi, params["conv_w"], params["conv_b"],
                                     cache["conv"])
        xc = F.silu(xc)
        y = _decode_step(params, xc, cache)
        cache["conv"].copy_(conv_state)
    else:
        xc, _ = causal_conv(xi, params["conv_w"], params["conv_b"])
        xc = F.silu(xc)
        h, y = _chunk_loop(params, xc, mode)
        if mode == "prefill" and cache is not None:
            cache["conv"].copy_(last_rows(xi, cfg.mamba_d_conv - 1))
            cache["ssm"].copy_(h)

    y = (y * F.silu(z.float())).to(x.dtype)
    y = constrain(y, "act_batch", "act_seq", "ff")
    return y @ params["w_out"], (cache if mode != "train" else None)


def mamba_rank(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
               cache: Optional[dict] = None):
    """One model rank's Mamba layer (a per-rank body of
    ``distributed.py``): ``params`` hold its share of d_inner ("ff", every
    leaf but ``w_dt_down``'s and ``w_bc``'s second dim) and the whole of
    the rest, x [B, S, D] is whole over the model axis, and ``cache`` holds
    its channels, read and written in place. A generator: it yields its
    term of the per-token projections [xc @ w_bc | xc @ w_dt_down] (its
    channels' share of two contractions over d_inner, ``distributed.term``)
    once a call, not once a chunk, and resumes with their sum over the
    ranks. Returns (its term of y [B, S, D], fp32; y is the sum over the
    ranks in x's dtype)."""
    xi = x @ params["w_in_x"]
    z = x @ params["w_in_z"]
    conv_state = cache["conv"] if mode == "decode" else None
    xc, new_conv = causal_conv(xi, params["conv_w"], params["conv_b"],
                               conv_state)
    xc = F.silu(xc)
    proj = yield term(xc, torch.cat([params["w_bc"], params["w_dt_down"]],
                                    1))
    if mode == "decode":
        y = _decode_step(params, xc, cache, proj)
        cache["conv"].copy_(new_conv)
    else:
        h, y = _chunk_loop(params, xc, mode, proj)
        if mode == "prefill" and cache is not None:
            cache["conv"].copy_(last_rows(xi, cfg.mamba_d_conv - 1))
            cache["ssm"].copy_(h)
    y = (y * F.silu(z.float())).to(x.dtype)
    return (term(y, params["w_out"]),)


def mamba_cache_defs(cfg: ArchConfig, batch: int):
    di = cfg.mamba_expand * cfg.d_model
    return {
        "conv": ParamDef((batch, cfg.mamba_d_conv - 1, di),
                         ("kv_batch", None, "ff"), init="zeros",
                         dtype=param_dtype(cfg)),
        "ssm": ParamDef((batch, di, cfg.mamba_d_state),
                        ("kv_batch", "ff", None), init="zeros",
                        dtype=torch.float32),
    }
