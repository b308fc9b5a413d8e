"""Composable decoder LM (the JAX package's ``models/transformer.py``):
Block(mixer, mlp) stacks grouped by the config's repeating pattern period
(dense 1, gemma2 2, xlstm 6, jamba 8).

Each block's mixer is attention, Mamba (``models/ssm.py``), mLSTM or sLSTM
(``models/xlstm.py``) as ``cfg.mixer_for_layer`` says, and its FFN an MLP
or, where ``cfg.is_moe_layer``, a Mixture-of-Experts (``models/moe.py``)
whose load-balancing ``aux`` the model sums over the layers and the loss
adds, as the reference does.

Parameters for each period position are stacked [n_groups, ...], as in the
reference, so trees cross between the packages leaf for leaf. The
reference scans over the groups; the port loops over them, reading each
group's slice of the stacked leaves (``unbind`` views: in training their
gradients are stacked back once per leaf). In train mode ``remat`` wraps
each group in ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
with nothing saveable), and the loss's chunked cross-entropy checkpoints
each chunk, so neither the forward nor the backward holds [B, S, V] logits.

Caches are written in place, unlike the reference, which returns new ones:
``hidden`` hands each block views of its group's slice of the stacked cache
leaves (``leaf[g]``), and every mixer writes its new state into those views
(``copy_``, or indexed assignment for the attention ring). A mixer that
rebound a cache entry instead would lose the state silently. On a mesh
of several ranks the caches are DTensors laid out by their defs
(``init_caches``); each mixer writes its rank's part of them, and ``aux``
is a replicated DTensor, summed over the layers as on one rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import counts
from repro_torch.configs.base import (
    ArchConfig,
    MIXER_ATTENTION,
    MIXER_MAMBA,
    MIXER_MLSTM,
    MIXER_SLSTM,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import (
    ParamDef,
    constrain,
    gathered,
    init_params,
    init_placed,
    is_dtensor,
    local_range,
    param_shapes,
    param_specs,
    stack_defs,
)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (
    apply_norm,
    mlp_defs,
    mlp_forward,
    norm_defs,
    param_dtype,
    rope_freqs,
    sincos_positions,
    softcap,
)
from repro_torch.tree import tree_map

CE_CHUNK = 1024


# ----------------------------------------------------------------- param defs
_MIXERS = {  # mixer -> (param defs, forward, cache defs); attention apart
    MIXER_MAMBA: (ssm_lib.mamba_defs, ssm_lib.mamba_forward,
                  ssm_lib.mamba_cache_defs),
    MIXER_MLSTM: (xlstm_lib.mlstm_defs, xlstm_lib.mlstm_forward,
                  xlstm_lib.mlstm_cache_defs),
    MIXER_SLSTM: (xlstm_lib.slstm_defs, xlstm_lib.slstm_forward,
                  xlstm_lib.slstm_cache_defs),
}


def _block_defs(cfg: ArchConfig, pos: int) -> Dict[str, Any]:
    mixer = cfg.mixer_for_layer(pos)
    defs: Dict[str, Any] = {
        "norm1": norm_defs(cfg, cfg.d_model),
        "mixer": (attn.attn_defs(cfg) if mixer == MIXER_ATTENTION
                  else _MIXERS[mixer][0](cfg))}
    if cfg.post_block_norm:
        defs["post_norm1"] = norm_defs(cfg, cfg.d_model)
    if cfg.mlp != "none" and cfg.d_ff > 0:
        defs["norm2"] = norm_defs(cfg, cfg.d_model)
        defs["ffn"] = (moe_lib.moe_defs(cfg) if cfg.is_moe_layer(pos)
                       else mlp_defs(cfg))
        if cfg.post_block_norm:
            defs["post_norm2"] = norm_defs(cfg, cfg.d_model)
    return defs


def _block_forward(bp, x, cfg: ArchConfig, pos: int, *, mode: str,
                   positions, cache, t, rope):
    """-> (x, aux): the block's output and its MoE FFN's ``aux`` (None
    without one)."""
    mixer = cfg.mixer_for_layer(pos)
    h = apply_norm(bp["norm1"], x, cfg)
    if mixer == MIXER_ATTENTION:
        y, _ = attn.attention_forward(
            bp["mixer"], h, cfg, pos, positions=positions, mode=mode,
            cache=cache, t=t, rope=rope)
    else:
        y, _ = _MIXERS[mixer][1](bp["mixer"], h, cfg, mode=mode, cache=cache)
    if cfg.post_block_norm:
        y = apply_norm(bp["post_norm1"], y, cfg)
    # The mixer's out-projection leaves a partial sum over "model": it is
    # reduced here, before the FFN's norm; left partial, every rank would
    # run the whole FFN width on its term.
    x = constrain(x + y, "act_batch", "act_seq", "act_embed")
    aux = None
    if "ffn" in bp:
        h = apply_norm(bp["norm2"], x, cfg)
        if cfg.is_moe_layer(pos):
            y, aux = moe_lib.moe_forward(bp["ffn"], h, cfg,
                                         no_drop=(mode == "decode"))
        else:
            y = mlp_forward(bp["ffn"], h, cfg)
        if cfg.post_block_norm:
            y = apply_norm(bp["post_norm2"], y, cfg)
        x = x + y
    return constrain(x, "act_batch", "act_seq", "act_embed"), aux


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``x.argmax(-1)``, the first index of the largest value. Over a
    DTensor split on its last dim, each rank takes its own part's first
    largest and its offset (``local_range``), and two reductions over the
    dims that split it (the largest value, then the least index holding
    it) give the same index: DTensor's own argmax works its offsets out
    with tensors, which a dry run's fake tensors cannot read."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    last = x.ndim - 1
    split = [i for i, p in enumerate(x.placements if is_dtensor(x) else ())
             if isinstance(p, Shard) and p.dim % x.ndim == last]
    if not split:
        return x.argmax(-1)
    mesh = x.device_mesh
    off, _ = local_range(x, last)
    vals, idx = x.to_local().max(-1)

    def reduced(local, op):
        pls = [Partial(op) if i in split else p
               for i, p in enumerate(x.placements)]
        whole = [Replicate() if i in split else p
                 for i, p in enumerate(x.placements)]
        return DTensor.from_local(local, mesh, pls).redistribute(
            mesh, whole).to_local()

    top = reduced(vals, "max")
    cand = torch.where(vals == top, idx + off, x.shape[-1])
    pls = [Replicate() if i in split else p
           for i, p in enumerate(x.placements)]
    return DTensor.from_local(reduced(cand, "min"), mesh, pls)


def _unbind(tree, n: int):
    """A stacked tree -> n trees of the leaves' slices (views)."""
    leaves = []
    tree_map(lambda leaf: leaves.append(leaf.unbind(0)), tree)
    out = []
    for g in range(n):
        it = iter([parts[g] for parts in leaves])
        out.append(tree_map(lambda _: next(it), tree))
    return out


# ---------------------------------------------------------------------- model
@dataclasses.dataclass
class LMModel:
    """``device`` defaults to ``cuda`` (raising without a card); a string
    or ``None`` is resolved by ``resolve_device``."""
    cfg: ArchConfig
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def period(self) -> int:
        return self.cfg.pattern_period()

    @property
    def n_groups(self) -> int:
        return self.cfg.num_layers // self.period

    # ----------------------------------------------------------------- params
    def param_defs(self):
        cfg = self.cfg
        dt = param_dtype(cfg)
        defs: Dict[str, Any] = {
            "embed": ParamDef((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), dtype=dt, scale=1.0),
            "final_norm": norm_defs(cfg, cfg.d_model),
        }
        if cfg.pos == "learned":
            defs["pos_embed"] = ParamDef(
                (cfg.max_position_embeddings, cfg.d_model), (None, "embed"),
                dtype=dt, scale=0.02)
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef(
                (cfg.num_output_heads, cfg.d_model, cfg.vocab_size),
                (None, "embed", "vocab"), dtype=dt)
        defs["blocks"] = tuple(
            stack_defs([_block_defs(cfg, pos)] * self.n_groups)
            for pos in range(self.period))
        return defs

    def init(self, gen: torch.Generator):
        """Random weights drawn from ``gen`` (on the generator's device:
        a CUDA generator makes a full-width init on the card), placed on
        the model's device."""
        return init_params(self.param_defs(), gen, self.device)

    def param_shapes(self):
        """The tree of meta tensors: each leaf's shape and dtype."""
        return param_shapes(self.param_defs())

    def param_specs(self):
        return param_specs(self.param_defs())

    # ----------------------------------------------------------------- embeds
    def _as_tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        return x.to(self.device)

    def embed(self, params, inputs, positions: torch.Tensor, mode: str):
        cfg = self.cfg
        inputs = self._as_tensor(inputs)
        if cfg.input_mode == "embeddings":
            x = inputs.to(param_dtype(cfg))
        else:
            x = gathered(params["embed"], "vocab", "embed")[inputs.long()]
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.d_model)
        if cfg.pos == "learned":
            x = x + params["pos_embed"][positions][None]
        elif cfg.pos == "sincos":
            x = x + sincos_positions(positions, cfg.d_model)[None].to(x.dtype)
        return x

    # ---------------------------------------------------------------- forward
    def _positions(self, positions, mode: str):
        """(positions [S] on the device, decode position t or None)."""
        if mode == "decode":
            t = int(positions)
            return torch.full((1,), t, dtype=torch.long,
                              device=self.device), t
        return self._as_tensor(positions).long(), None

    def hidden(self, params, inputs, *, mode: str, positions, caches=None,
               remat: bool = True):
        """inputs: tokens [B,S] / embeds [B,S,D]; decode: [B,1]/[B,1,D] with
        ``positions`` the int position t. Returns (x [B,S,D], the caches
        (updated in place) or None, aux)."""
        cfg = self.cfg
        positions, t = self._positions(positions, mode)
        x = constrain(self.embed(params, inputs, positions, mode),
                      "act_batch", "act_seq", "act_embed")
        rope = None
        if cfg.pos == "rope":
            sin, cos = rope_freqs(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
            rope = (sin[None, :, None, :], cos[None, :, None, :])
        period, n = self.period, self.n_groups
        blocks = [_unbind(params["blocks"][p], n) for p in range(period)]
        group_caches = None
        if caches is not None:
            group_caches = [[tree_map(lambda leaf: leaf[g], caches[p])
                             for g in range(n)] for p in range(period)]

        def group_body(x, g):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for p in range(period):
                cache = None if group_caches is None else group_caches[p][g]
                x, a = _block_forward(blocks[p][g], x, cfg, p, mode=mode,
                                      positions=positions, cache=cache, t=t,
                                      rope=rope)
                if a is not None:
                    aux = aux + a
            return x, aux

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in counts.repeat(n):
            if remat and mode == "train" and torch.is_grad_enabled():
                x, a = checkpoint(group_body, x, g, use_reentrant=False)
            else:
                x, a = group_body(x, g)
            aux = aux + a
        x = apply_norm(params["final_norm"], x, cfg)
        return x, (caches if mode != "train" else None), aux

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """x [B,S,D] -> [B,S,nH,V] in the params' dtype. The tied head
        multiplies by ``embed`` transposed as a view (no copy)."""
        if self.cfg.tie_embeddings:
            return (x @ gathered(params["embed"], "vocab", "embed").t())[
                :, :, None]
        return torch.einsum("bsd,hdv->bshv", x,
                            gathered(params["head"], None, "embed", "vocab"))

    def head_matrix(self, params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].t()[None]  # [1, D, V], a view
        return params["head"]  # [nH, D, V]

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """x [B,S,D] -> [B,S,nH,V] fp32 (nH == 1 squeezed to [B,S,V])."""
        out = softcap(self._head(params, x).float(), self.cfg.final_softcap)
        if self.cfg.num_output_heads == 1:
            out = out[:, :, 0]
        return out

    # ------------------------------------------------------------------ steps
    def _ce_chunk(self, params, xc, lc, mc):
        """(Σ nll, Σ correct) of one chunk: xc [B,c,D], lc [B,c,nH],
        mc [B,c]."""
        logits = softcap(self._head(params, xc).float(),
                         self.cfg.final_softcap)
        logits = constrain(logits, "act_batch", "act_seq", None, "vocab")
        lse = torch.logsumexp(logits, dim=-1)  # [B,c,nH]
        # The gather over a vocab-sharded DTensor is a masked partial sum:
        # reduced here, while it has the gather's shape.
        picked = constrain(torch.gather(logits, -1, lc[..., None]),
                           "act_batch", "act_seq", None, None)[..., 0]
        nll = (lse - picked).mean(-1) * mc
        correct = (argmax_last(logits) == lc).all(-1) * mc
        return nll.sum(), correct.sum()

    def loss(self, params, batch, *, remat: bool = True):
        """batch: inputs [B,S] (tokens) / [B,S,D] (embeds), labels [B,S] or
        [B,S,nH], optional mask [B,S]. Cross-entropy chunked over the
        sequence at ``CE_CHUNK`` (never [B,S,V] logits)."""
        labels = self._as_tensor(batch["labels"]).long()
        b, s = labels.shape[:2]
        x, _, aux = self.hidden(params, batch["inputs"], mode="train",
                                positions=torch.arange(s), remat=remat)
        mask = batch.get("mask")
        mask = (torch.ones((b, s), dtype=torch.float32, device=x.device)
                if mask is None else self._as_tensor(mask).float())
        if labels.ndim == 2:
            labels = labels[..., None]
        csz = CE_CHUNK if s % CE_CHUNK == 0 else s
        head = {k: params[k] for k in ("embed", "head") if k in params}
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        correct = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in counts.repeat(s // csz):
            c = i * csz
            args = (head, x[:, c:c + csz], labels[:, c:c + csz],
                    mask[:, c:c + csz])
            if torch.is_grad_enabled():
                nll, corr = checkpoint(self._ce_chunk, *args,
                                       use_reentrant=False)
            else:
                nll, corr = self._ce_chunk(*args)
            nll_sum = nll_sum + nll
            correct = correct + corr
        denom = mask.sum().clamp_min(1.0)
        loss = nll_sum / denom + aux
        metrics = {"loss": loss, "nll": nll_sum / denom, "aux": aux,
                   "accuracy": correct / denom}
        return loss, metrics

    @torch.no_grad()
    def prefill(self, params, inputs, *, cache_capacity: int):
        """Run prefill; returns (last logits [B,(nH,)V], caches)."""
        inputs = self._as_tensor(inputs)
        s = inputs.shape[1]
        x, caches, _ = self.hidden(
            params, inputs, mode="prefill", positions=torch.arange(s),
            caches=self.init_caches(inputs.shape[0], cache_capacity),
            remat=False)
        return self.logits(params, x[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, params, inputs, t: int, caches):
        """One token: inputs [B,1] / [B,1,D] at position ``t``; ``caches``
        are updated in place and returned."""
        x, caches, _ = self.hidden(params, inputs, mode="decode",
                                   positions=t, caches=caches, remat=False)
        return self.logits(params, x)[:, 0], caches

    # ------------------------------------------------------------------ cache
    def cache_defs(self, batch: int, capacity: int):
        caches = []
        for pos in range(self.period):
            mixer = self.cfg.mixer_for_layer(pos)
            cd = (attn.attn_cache_defs(self.cfg, pos, batch, capacity)
                  if mixer == MIXER_ATTENTION
                  else _MIXERS[mixer][2](self.cfg, batch))
            caches.append(stack_defs([cd] * self.n_groups))
        return tuple(caches)

    def init_caches(self, batch: int, capacity: int):
        """Empty caches on the model's device, laid out by their specs
        under the current rules and mesh, each rank making its own part
        alone (``distributed.init_placed``: a whole prefill cache is many
        times a card's memory)."""
        return init_placed(self.cache_defs(batch, capacity), self.device)


def make_model(cfg: ArchConfig, device: DeviceLike = None) -> LMModel:
    """An LM on ``device`` (default ``cuda``; raises without a card)."""
    return LMModel(cfg, device)


def init_cache_defs(cfg: ArchConfig, batch: int, capacity: int):
    """The ParamDef tree of the decode caches (the model's
    ``cache_defs``), without a device."""
    return LMModel(cfg, "meta").cache_defs(batch, capacity)
