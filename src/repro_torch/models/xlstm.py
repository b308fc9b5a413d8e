"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) (the JAX
package's ``models/xlstm.py``).

The mLSTM runs chunkwise-parallel: a loop over ``MLSTM_CHUNK``-token
chunks carrying the state (C [B, H, dv, dk], n [B, H, dk]), and inside a
chunk a masked, decayed q·k product over the chunk plus the carried
state's contribution; in training each chunk runs under
``torch.utils.checkpoint``, as the reference ``jax.checkpoint``s it. The
input gate is soft-capped at ``IGATE_CAP`` and the forget gates are
sigmoids whose log-cumsums are <= 0, in place of the paper's running-max
stabilizer, as in the reference. Decode is one recurrent step. The sLSTM
runs its recurrence one step at a time over the sequence, with the
paper's max stabilizer m (starting at -1e9).

Caches ({"conv", "C", "n"} for the mLSTM, {"c", "n", "h", "m"} fp32 for
the sLSTM; the reference's layouts, so caches cross between the packages)
are written in place with ``copy_``: the model hands each layer views of
its stacked cache leaves (``models/transformer.py``). ``torch.maximum``
stands where the reference has ``jnp.maximum``: both split the gradient
equally at a tie.
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
from repro_torch.models.ssm import causal_conv, last_rows

MLSTM_CHUNK = 256  # tokens per mLSTM chunk (read at call time)
IGATE_CAP = 8.0
SLSTM_GATES = ("z", "i", "f", "o")


# ------------------------------------------------------------------ mLSTM ---
def mlstm_defs(cfg: ArchConfig):
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    h = cfg.num_heads
    dc = 4
    dt = param_dtype(cfg)
    f32 = torch.float32
    return {
        "w_in_x": ParamDef((d, di), ("embed", "ff"), dtype=dt),
        "w_in_z": ParamDef((d, di), ("embed", "ff"), dtype=dt),
        "conv_w": ParamDef((dc, di), (None, "ff"), dtype=dt, scale=0.5),
        "conv_b": ParamDef((di,), ("ff",), init="zeros", dtype=dt),
        "w_q": ParamDef((di, di), ("ff", "ff2"), dtype=dt),
        "w_k": ParamDef((di, di), ("ff", "ff2"), dtype=dt),
        "w_v": ParamDef((di, di), ("ff", "ff2"), dtype=dt),
        "w_i": ParamDef((di, h), ("ff", None), dtype=f32),
        "b_i": ParamDef((h,), (None,), init="zeros", dtype=f32),
        "w_f": ParamDef((di, h), ("ff", None), dtype=f32),
        "b_f": ParamDef((h,), (None,), init="const", scale=3.0, dtype=f32),
        "gn_scale": ParamDef((di,), ("ff",), init="ones", dtype=f32),
        "w_out": ParamDef((di, d), ("ff", "embed"), dtype=dt),
    }


def _floor1(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, x.new_ones(()))


def _mlstm_chunk(C, n, q, k, v, lf, li):
    """One chunk. C [B, H, dv, dk], n [B, H, dk]; q, k, v [B, L, H, dh]
    fp32; lf (log forget), li (log input) [B, L, H] -> (C, n, h [B, L, H,
    dh])."""
    b_cum = lf.cumsum(1)  # [B, L, H], <= 0, decreasing
    w_in = torch.exp(b_cum)  # decay from the chunk's start
    L = q.shape[1]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    # A[t, s] = (q_t . k_s) exp(b_t - b_s + li_s) for s <= t; masked to
    # -inf before the exp, so no masked entry overflows.
    decay = b_cum[:, :, None, :] - b_cum[:, None, :, :] + li[:, None, :, :]
    decay = decay.masked_fill(~mask[None, :, :, None], -math.inf)
    d_mat = torch.exp(decay)  # [B, t, s, H]
    qk = torch.einsum("bthd,bshd->btsh", q, k)
    h_intra = torch.einsum("btsh,bshd->bthd", qk * d_mat, v)
    h_inter = torch.einsum("bthk,bhvk->bthv", q * w_in[..., None], C)
    n_intra = torch.einsum("btsh,bshd->bthd", d_mat, k)
    n_t = w_in[..., None] * n[:, None] + n_intra  # [B, L, H, dk]
    denom = _floor1(torch.einsum("bthd,bthd->bth", n_t, q).abs())
    h = (h_intra + h_inter) / denom[..., None]
    w_end = torch.exp(b_cum[:, -1:] - b_cum + li)  # [B, L, H]
    f_end = torch.exp(b_cum[:, -1])  # [B, H]
    C = f_end[:, :, None, None] * C + torch.einsum(
        "blh,blhv,blhk->bhvk", w_end, v, k)
    n = f_end[..., None] * n + torch.einsum("blh,blhk->bhk", w_end, k)
    return C, n, h


def _mlstm_step(C, n, q, k, v, lf, li):
    """One decode step. q, k, v [B, H, dh]; lf, li [B, H]."""
    f = torch.exp(lf)[..., None, None]
    i = torch.exp(li)[..., None, None]
    C = f * C + i * torch.einsum("bhv,bhk->bhvk", v, k)
    n = f[..., 0] * n + i[..., 0] * k
    denom = _floor1(torch.einsum("bhk,bhk->bh", n, q).abs())
    h = torch.einsum("bhvk,bhk->bhv", C, q) / denom[..., None]
    return C, n, h


def _group_rms(h: torch.Tensor, scale: torch.Tensor, nh: int):
    """Per-head RMS norm (the reference's GroupNorm stand-in). h [..., di]
    fp32, eps 1e-6 inside the rsqrt."""
    shp = h.shape
    hh = h.reshape(shp[:-1] + (nh, shp[-1] // nh))
    var = hh.square().mean(-1, keepdim=True)
    hh = hh * torch.rsqrt(var + 1e-6)
    return hh.reshape(shp) * scale


def mlstm_forward(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                  cache: Optional[dict] = None):
    """x [B, S, D] -> (y [B, S, D], cache or None). q and k come from the
    conv's output, v from its input; k is scaled by dh^-1/2 in the
    config's dtype."""
    b, s, d = x.shape
    di = int(cfg.mlstm_proj_factor * d)
    nh = cfg.num_heads
    dh = di // nh

    xi = constrain(x @ params["w_in_x"], "act_batch", "act_seq", "ff")
    z = x @ params["w_in_z"]
    conv_state = cache["conv"] if mode == "decode" else None
    xc, new_conv = causal_conv(xi, params["conv_w"], params["conv_b"],
                               conv_state)
    xc = F.silu(xc)

    def proj(w, src):
        return (src @ w).reshape(b, -1, nh, dh)

    q = proj(params["w_q"], xc).float()
    k = (proj(params["w_k"], xc) / math.sqrt(dh)).float()
    v = proj(params["w_v"], xi).float()
    xc32 = xc.float()
    lf = F.logsigmoid(xc32 @ params["w_f"] + params["b_f"])
    li = IGATE_CAP * torch.tanh((xc32 @ params["w_i"] + params["b_i"])
                                / IGATE_CAP)

    if mode == "decode":
        C, n, hh = _mlstm_step(cache["C"], cache["n"], q[:, 0], k[:, 0],
                               v[:, 0], lf[:, 0], li[:, 0])
        h = hh[:, None]  # [B, 1, H, dh]
        cache["conv"].copy_(new_conv)
        cache["C"].copy_(C)
        cache["n"].copy_(n)
    else:
        csz = MLSTM_CHUNK if s % MLSTM_CHUNK == 0 else s
        remat = mode == "train" and torch.is_grad_enabled()
        C = x.new_zeros((b, nh, dh, dh), dtype=torch.float32)
        n = x.new_zeros((b, nh, dh), dtype=torch.float32)
        hs = []
        for c in range(0, s, csz):
            part = [t[:, c:c + csz] for t in (q, k, v, lf, li)]
            if remat:
                C, n, h_c = checkpoint(_mlstm_chunk, C, n, *part,
                                       use_reentrant=False)
            else:
                C, n, h_c = _mlstm_chunk(C, n, *part)
            hs.append(h_c)
        h = torch.cat(hs, 1)
        if mode == "prefill" and cache is not None:
            cache["conv"].copy_(last_rows(xi, params["conv_w"].shape[0] - 1))
            cache["C"].copy_(C)
            cache["n"].copy_(n)

    h = _group_rms(h.reshape(b, -1, di), params["gn_scale"], nh)
    y = (h * F.silu(z.float())).to(x.dtype)
    return y @ params["w_out"], (cache if mode != "train" else None)


def mlstm_cache_defs(cfg: ArchConfig, batch: int):
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    nh = cfg.num_heads
    dh = di // nh
    return {
        "conv": ParamDef((batch, 3, di), ("kv_batch", None, "ff"),
                         init="zeros", dtype=param_dtype(cfg)),
        "C": ParamDef((batch, nh, dh, dh), ("kv_batch", None, None, None),
                      init="zeros", dtype=torch.float32),
        "n": ParamDef((batch, nh, dh), ("kv_batch", None, None),
                      init="zeros", dtype=torch.float32),
    }


# ------------------------------------------------------------------ sLSTM ---
def slstm_defs(cfg: ArchConfig):
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    du = int(cfg.slstm_proj_factor * d)
    dt = param_dtype(cfg)
    defs = {}
    for g in SLSTM_GATES:
        defs[f"w_{g}"] = ParamDef((d, d), ("embed", "ff2"), dtype=dt)
        defs[f"r_{g}"] = ParamDef((h, dh, dh), (None, None, None),
                                  dtype=torch.float32, scale=dh ** -0.5)
        defs[f"b_{g}"] = ParamDef(
            (d,), (None,), init="const" if g == "f" else "zeros",
            scale=3.0 if g == "f" else None, dtype=torch.float32)
    defs["gn_scale"] = ParamDef((d,), (None,), init="ones",
                                dtype=torch.float32)
    defs["w_up1"] = ParamDef((d, du), ("embed", "ff"), dtype=dt)
    defs["w_up2"] = ParamDef((d, du), ("embed", "ff"), dtype=dt)
    defs["w_down"] = ParamDef((du, d), ("ff", "embed"), dtype=dt)
    return defs


def _slstm_step(r_all, state, gates_x, dh: int):
    """state (c, n, h, m) each [B, H, dh]; gates_x [B, H, 4 dh], the
    z, i, f, o input preactivations side by side; r_all [H, dh, 4 dh],
    the four recurrent matrices side by side (one product a step)."""
    c, n, h, m = state
    pre = gates_x + torch.einsum("bhd,hde->bhe", h, r_all)
    zt, it, ft, ot = pre.split(dh, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(lf + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = torch.maximum(f_p * n + i_p, n.new_full((), 1e-6))
    h_new = o * c_new / n_new
    return c_new, n_new, h_new, m_new


def slstm_forward(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                  cache: Optional[dict] = None):
    """x [B, S, D] -> (y [B, S, D], cache or None)."""
    b, s, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    gx = torch.cat([((x @ params[f"w_{g}"]).float() + params[f"b_{g}"])
                    .reshape(b, s, nh, dh) for g in SLSTM_GATES], -1)
    r_all = torch.cat([params[f"r_{g}"] for g in SLSTM_GATES], -1)

    if mode == "decode":
        state = tuple(cache[key] for key in ("c", "n", "h", "m"))
        state = _slstm_step(r_all, state, gx[:, 0], dh)
        hs = state[2][:, None]
        for key, new in zip(("c", "n", "h", "m"), state):
            cache[key].copy_(new)
    else:
        zeros = x.new_zeros((b, nh, dh), dtype=torch.float32)
        state = (zeros, zeros, zeros, torch.full_like(zeros, -1e9))
        outs = []
        for t in range(s):
            state = _slstm_step(r_all, state, gx[:, t], dh)
            outs.append(state[2])
        hs = torch.stack(outs, 1)  # [B, S, H, dh]
        if mode == "prefill" and cache is not None:
            for key, new in zip(("c", "n", "h", "m"), state):
                cache[key].copy_(new)

    h = _group_rms(hs.reshape(b, -1, d), params["gn_scale"], nh).to(x.dtype)
    # Post up / down projection (GeGLU, factor 4/3); jax.nn.gelu is the
    # tanh approximation.
    y = (F.gelu(h @ params["w_up1"], approximate="tanh")
         * (h @ params["w_up2"]))
    y = constrain(y, "act_batch", "act_seq", "ff")
    return y @ params["w_down"], (cache if mode != "train" else None)


def slstm_cache_defs(cfg: ArchConfig, batch: int):
    nh = cfg.num_heads
    dh = cfg.d_model // nh

    def sdef(init="zeros", scale=None):
        return ParamDef((batch, nh, dh), ("kv_batch", None, None),
                        init=init, scale=scale, dtype=torch.float32)
    return {"c": sdef(), "n": sdef(), "h": sdef(),
            "m": sdef(init="const", scale=-1e9)}
