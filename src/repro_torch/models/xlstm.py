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

Across ranks (a DTensor x) both mixers follow the reference's layout:
their in- and out-projections are tensor-parallel over "model" ("ff" /
"ff2"), and the recurrences' weights and state (the mLSTM's C and n, the
sLSTM's ``r_*`` and c, n, h, m) are replicated. Each model rank's body
(``mlstm_rank``, ``slstm_rank``) computes its share of the projections
into the recurrence, the ranks sum them, every rank runs the recurrence
whole, alike, and each keeps its own channels of the output for its term
of the out-projection. (Splitting the heads instead would keep the
recurrence local, but it would lay the state out otherwise than the
reference does.)
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
    model_range,
    run_mixer,
    term,
)
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


def _group_rms(h: torch.Tensor, scale: torch.Tensor, nh: int, lo: int = 0):
    """Per-head RMS norm (the reference's GroupNorm stand-in). h [..., di]
    fp32, eps 1e-6 inside the rsqrt. A ``scale`` narrower than h (a
    rank's channels) takes h's channels ``lo`` .. after the norm."""
    shp = h.shape
    hh = h.reshape(shp[:-1] + (nh, shp[-1] // nh))
    var = hh.square().mean(-1, keepdim=True)
    hh = hh * torch.rsqrt(var + 1e-6)
    hh = hh.reshape(shp)
    if scale.shape[-1] != shp[-1]:
        hh = hh[..., lo:lo + scale.shape[-1]]
    return hh * scale


def _mlstm_recurrence(q, k, v, lf, li, *, mode: str, cache=None):
    """The mLSTM over q, k, v [B, S, H, dh] and the log gates [B, S, H]
    (fp32): one step from ``cache``'s C and n in decode, else the chunk
    loop from zero; decode and a prefill with a cache write C and n in
    place. -> h [B, S, H, dh]."""
    if mode == "decode":
        C, n, hh = _mlstm_step(cache["C"], cache["n"], q[:, 0], k[:, 0],
                               v[:, 0], lf[:, 0], li[:, 0])
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        return hh[:, None]  # [B, 1, H, dh]
    b, s, nh, dh = q.shape
    csz = MLSTM_CHUNK if s % MLSTM_CHUNK == 0 else s
    remat = mode == "train" and torch.is_grad_enabled()
    C = q.new_zeros((b, nh, dh, dh))
    n = q.new_zeros((b, nh, dh))
    hs = []
    for i in counts.repeat(s // csz, hs):
        c = i * csz
        part = [t[:, c:c + csz] for t in (q, k, v, lf, li)]
        if remat:
            C, n, h_c = checkpoint(_mlstm_chunk, C, n, *part,
                                   use_reentrant=False)
        else:
            C, n, h_c = _mlstm_chunk(C, n, *part)
        hs.append(h_c)
    if mode == "prefill" and cache is not None:
        cache["C"].copy_(C)
        cache["n"].copy_(n)
    return torch.cat(counts.full(hs, s // csz), 1)


def mlstm_forward(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                  cache: Optional[dict] = None):
    """x [B, S, D] -> (y [B, S, D], cache or None). q and k come from the
    conv's output, v from its input; k is scaled by dh^-1/2 in the
    config's dtype. A DTensor x runs tensor-parallel (``mlstm_rank``)."""
    if is_dtensor(x):
        lo, _ = model_range(x.device_mesh, int(cfg.mlstm_proj_factor
                                               * cfg.d_model))
        y = run_mixer(functools.partial(mlstm_rank, cfg=cfg, mode=mode,
                                        lo=lo),
                      params, mlstm_defs(cfg), x, cache,
                      mlstm_cache_defs(cfg, 1))
        return y, (cache if mode != "train" else None)
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

    h = _mlstm_recurrence(q, k, v, lf, li, mode=mode, cache=cache)
    if mode == "decode":
        cache["conv"].copy_(new_conv)
    elif mode == "prefill" and cache is not None:
        cache["conv"].copy_(last_rows(xi, params["conv_w"].shape[0] - 1))

    h = _group_rms(h.reshape(b, -1, di), params["gn_scale"], nh)
    y = (h * F.silu(z.float())).to(x.dtype)
    return y @ params["w_out"], (cache if mode != "train" else None)


def mlstm_rank(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
               cache: Optional[dict] = None, lo: int = 0):
    """One model rank's mLSTM layer (a per-rank body of
    ``distributed.py``): ``params`` hold its channels ``lo`` .. of d_inner
    ("ff": the in-projections, the conv, the rows of ``w_q`` / ``w_k`` /
    ``w_v`` / ``w_i`` / ``w_f``, ``gn_scale``, ``w_out``'s rows), x [B, S,
    D] is whole, ``cache`` its conv channels and the whole C and n. A
    generator: it yields its term of [q | k | v | f | i] (its channels'
    share of five contractions over d_inner, ``distributed.term``) once a
    call and resumes with their sum, then runs the recurrence whole, as
    every rank does alike (C and n are replicated over the model axis, as
    the reference lays them out), and keeps its own channels of h for the
    gate and the out-projection. Returns (its term of y [B, S, D],
    fp32)."""
    b, s, d = x.shape
    di = int(cfg.mlstm_proj_factor * d)
    nh = cfg.num_heads
    dh = di // nh

    xi = x @ params["w_in_x"]
    z = x @ params["w_in_z"]
    conv_state = cache["conv"] if mode == "decode" else None
    xc, new_conv = causal_conv(xi, params["conv_w"], params["conv_b"],
                               conv_state)
    xc = F.silu(xc)
    xc32 = xc.float()
    full = yield torch.cat([term(xc, params["w_q"]), term(xc, params["w_k"]),
                            term(xi, params["w_v"]), xc32 @ params["w_f"],
                            xc32 @ params["w_i"]], -1)
    q, k, v, f_pre, i_pre = full.split([di, di, di, nh, nh], -1)

    def heads(t):  # rounded to the activations' dtype, as a projection
        return t.to(x.dtype).reshape(b, -1, nh, dh)

    q = heads(q).float()
    k = (heads(k) / math.sqrt(dh)).float()
    v = heads(v).float()
    lf = F.logsigmoid(f_pre + params["b_f"])
    li = IGATE_CAP * torch.tanh((i_pre + params["b_i"]) / IGATE_CAP)

    h = _mlstm_recurrence(q, k, v, lf, li, mode=mode, cache=cache)
    if mode == "decode":
        cache["conv"].copy_(new_conv)
    elif mode == "prefill" and cache is not None:
        cache["conv"].copy_(last_rows(xi, params["conv_w"].shape[0] - 1))

    h = _group_rms(h.reshape(b, -1, di), params["gn_scale"], nh, lo)
    y = (h * F.silu(z.float())).to(x.dtype)
    return (term(y, params["w_out"]),)


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


def _slstm_recurrence(r_all, gx, *, mode: str, cache=None):
    """The sLSTM over gx [B, S, H, 4 dh] (fp32): one step from ``cache``
    in decode, else step by step from zero (m at -1e9); decode and a
    prefill with a cache write it in place. -> h [B, S, H, dh]."""
    b, s, nh, dh4 = gx.shape
    dh = dh4 // 4
    if mode == "decode":
        state = tuple(cache[key] for key in ("c", "n", "h", "m"))
        state = _slstm_step(r_all, state, gx[:, 0], dh)
        for key, new in zip(("c", "n", "h", "m"), state):
            cache[key].copy_(new)
        return state[2][:, None]
    zeros = gx.new_zeros((b, nh, dh))
    state = (zeros, zeros, zeros, torch.full_like(zeros, -1e9))
    outs = []
    for t in counts.repeat(s, outs):
        state = _slstm_step(r_all, state, gx[:, t], dh)
        outs.append(state[2])
    if mode == "prefill" and cache is not None:
        for key, new in zip(("c", "n", "h", "m"), state):
            cache[key].copy_(new)
    return torch.stack(counts.full(outs, s), 1)  # [B, S, H, dh]


def _slstm_up(params, hs: torch.Tensor, x: torch.Tensor, nh: int):
    """The head-wise norm of h [B, S, H, dh] and the post up projection
    (GeGLU, factor 4/3; jax.nn.gelu is the tanh approximation) to
    whichever share of d_up ``params`` hold."""
    b, d = x.shape[0], x.shape[-1]
    h = _group_rms(hs.reshape(b, -1, d), params["gn_scale"], nh).to(x.dtype)
    return (F.gelu(h @ params["w_up1"], approximate="tanh")
            * (h @ params["w_up2"]))


def slstm_forward(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                  cache: Optional[dict] = None):
    """x [B, S, D] -> (y [B, S, D], cache or None). A DTensor x runs
    tensor-parallel (``slstm_rank``)."""
    if is_dtensor(x):
        lo, _ = model_range(x.device_mesh, cfg.d_model)
        y = run_mixer(functools.partial(slstm_rank, cfg=cfg, mode=mode,
                                        lo=lo),
                      params, slstm_defs(cfg), x, cache,
                      slstm_cache_defs(cfg, 1))
        return y, (cache if mode != "train" else None)
    b, s, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    gx = torch.cat([((x @ params[f"w_{g}"]).float() + params[f"b_{g}"])
                    .reshape(b, s, nh, dh) for g in SLSTM_GATES], -1)
    r_all = torch.cat([params[f"r_{g}"] for g in SLSTM_GATES], -1)
    hs = _slstm_recurrence(r_all, gx, mode=mode, cache=cache)
    y = constrain(_slstm_up(params, hs, x, nh), "act_batch", "act_seq", "ff")
    return y @ params["w_down"], (cache if mode != "train" else None)


def slstm_rank(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
               cache: Optional[dict] = None, lo: int = 0):
    """One model rank's sLSTM layer (a per-rank body of
    ``distributed.py``): ``params`` hold its columns ``lo`` .. of the four
    gate projections ("ff2") and its share of d_up ("ff": ``w_up1`` /
    ``w_up2``'s columns, ``w_down``'s rows), and the whole recurrent
    matrices, biases and norm; x [B, S, D] is whole, ``cache`` the whole
    state. A generator: it yields its gate preactivations [B, S, 4, D]
    (fp32) zero outside its columns and resumes with their sum over the
    ranks, the whole preactivations; then runs the recurrence whole, as
    every rank does alike (its weights and state are replicated over the
    model axis, as the reference lays them out), and its share of the
    up / down projection. Returns (its term of y [B, S, D], fp32)."""
    b, s, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    cols = params["w_z"].shape[1]
    gx = torch.stack([(x @ params[f"w_{g}"]).float()
                      + params[f"b_{g}"][lo:lo + cols]
                      for g in SLSTM_GATES], 2)  # [B, S, 4, cols]
    gx = yield F.pad(gx, (lo, d - lo - cols))
    gx = gx.reshape(b, s, 4, nh, dh).transpose(2, 3).reshape(b, s, nh,
                                                             4 * dh)
    r_all = torch.cat([params[f"r_{g}"] for g in SLSTM_GATES], -1)
    hs = _slstm_recurrence(r_all, gx, mode=mode, cache=cache)
    return (term(_slstm_up(params, hs, x, nh), params["w_down"]),)


def slstm_cache_defs(cfg: ArchConfig, batch: int):
    nh = cfg.num_heads
    dh = cfg.d_model // nh

    def sdef(init="zeros", scale=None):
        return ParamDef((batch, nh, dh), ("kv_batch", None, None),
                        init=init, scale=scale, dtype=torch.float32)
    return {"c": sdef(), "n": sdef(), "h": sdef(),
            "m": sdef(init="const", scale=-1e9)}
