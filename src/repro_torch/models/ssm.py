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
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ParamDef, constrain
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


def _ssm_inputs(params, xc: torch.Tensor):
    """xc [B, S, di] -> (dA, dBx [B, S, di, ds], c_in [B, S, ds]), fp32."""
    bc = (xc @ params["w_bc"]).float()
    b_in, c_in = bc.chunk(2, dim=-1)
    dt = ((xc @ params["w_dt_down"]) @ params["w_dt_up"]).float()
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


def _chunk(params, h0: torch.Tensor, xc: torch.Tensor):
    """One chunk: h0 [B, di, ds], xc [B, L, di] -> (h_L, y [B, L, di])."""
    dA, dBx, c_in = _ssm_inputs(params, xc)
    a_cum, b_cum = _scan(dA, dBx)
    h = a_cum * h0[:, None] + b_cum
    y = torch.einsum("bsdn,bsn->bsd", h, c_in)
    y = y + xc.float() * params["d_skip"]
    return h[:, -1], y


def mamba_forward(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                  cache: Optional[dict] = None):
    """x [B, S, D] -> (y [B, S, D], cache or None). Decode reads and
    prefill fills ``cache`` in place (module docstring)."""
    b, s, d = x.shape
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state

    xi = constrain(x @ params["w_in_x"], "act_batch", "act_seq", "ff")
    z = x @ params["w_in_z"]

    if mode == "decode":
        xc, conv_state = causal_conv(xi, params["conv_w"], params["conv_b"],
                                     cache["conv"])
        xc = F.silu(xc)
        dA, dBx, c_in = _ssm_inputs(params, xc)
        h = dA[:, 0] * cache["ssm"] + dBx[:, 0]
        y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None]
        y = y + xc.float() * params["d_skip"]
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(h)
    else:
        xc, _ = causal_conv(xi, params["conv_w"], params["conv_b"])
        xc = F.silu(xc)
        csz = MAMBA_CHUNK if s % MAMBA_CHUNK == 0 else s
        remat = mode == "train" and torch.is_grad_enabled()
        h = x.new_zeros((b, di, ds), dtype=torch.float32)
        ys = []
        for c in range(0, s, csz):
            xc_c = xc[:, c:c + csz]
            if remat:
                h, y_c = checkpoint(_chunk, params, h, xc_c,
                                    use_reentrant=False)
            else:
                h, y_c = _chunk(params, h, xc_c)
            ys.append(y_c)
        y = torch.cat(ys, 1)
        if mode == "prefill" and cache is not None:
            cache["conv"].copy_(last_rows(xi, cfg.mamba_d_conv - 1))
            cache["ssm"].copy_(h)

    y = (y * F.silu(z.float())).to(x.dtype)
    y = constrain(y, "act_batch", "act_seq", "ff")
    return y @ params["w_out"], (cache if mode != "train" else None)


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
