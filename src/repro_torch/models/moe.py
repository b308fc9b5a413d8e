"""Top-k Mixture-of-Experts with grouped capacity routing and expert
fission (virtual experts) (the JAX package's ``models/moe.py``).

* **Grouped routing** — tokens route in groups of ``MOE_GROUP`` tokens of
  a row when the row's length is a multiple of it (and not in decode),
  else the row is one group; each expert takes at most ``capacity`` tokens
  of a group, in (token, k) order, and the rest are dropped.
* **Expert fission** — the experts' weights may hold r virtual experts per
  expert (each a d_ff slice: exact for SwiGLU, the down projections sum).
  ``moe_forward`` reads r from the weights' shape. ``expert_split_factor``
  picks r from the expert axis of the current mesh and rules (mixtral's
  8 experts become 16 virtual experts on a 16-way axis); without a mesh
  it is 1.
* **Expert parallelism** — on DTensors (``moe_sharded``) each model rank
  runs ``moe_rank``, the layer's per-rank body: it routes its data
  shard's tokens with the whole router (gathered over the data axes: every
  model rank of a shard routes from the same logits, bit for bit), keeps
  the picks of the virtual experts it holds (its share over "model",
  gathered over the data axes only: FSDP), runs those, and combines them
  into its term of y, which the ranks sum over "model". Capacity stays per
  routing group. With one rank's whole expert range, ``moe_rank`` is the
  one-rank layer bit for bit.

The reference dispatches and combines with one-hot einsums over [tokens,
experts, capacity]. The port computes the same function with indices: a
token's kept (expert, position) slots are filled by ``index_copy`` and
read back by a gather, so the work is O(tokens), not O(tokens x
capacity). Each slot holds one token, so the dispatch is exact, and the
combine sums the same k gated terms in another order.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import (
    ParamDef,
    current_mesh,
    current_rules,
    is_dtensor,
    local_range,
    mesh_axis_size,
    partial_over_model,
    per_rank,
    rank_placements,
    split_dims,
    token_placements,
)
from repro_torch.models.layers import param_dtype

MOE_GROUP = 512  # tokens per routing group (read at call time)


def expert_split_factor(cfg: ArchConfig) -> int:
    """Virtual experts per expert: the smallest r with num_experts * r
    divisible by the expert axis's size (and r dividing d_ff) under the
    current rules and mesh; 1 without them, or where no r up to the
    axis's size fits."""
    rules, mesh = current_rules(), current_mesh()
    ep = mesh_axis_size(mesh, rules.get("expert")) if (rules and mesh) else 1
    r = 1
    while (cfg.num_experts * r) % ep or cfg.d_ff % r:
        r += 1
        if r > ep:
            return 1
    return r


def moe_defs(cfg: ArchConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    r = expert_split_factor(cfg)
    ev, fv = e * r, f // r
    dt = param_dtype(cfg)
    return {
        "router": ParamDef((d, e), ("embed", None), dtype=torch.float32),
        "w_gate": ParamDef((ev, d, fv), ("expert", "expert_in", "expert_ff"),
                           dtype=dt),
        "w_up": ParamDef((ev, d, fv), ("expert", "expert_in", "expert_ff"),
                         dtype=dt),
        "w_down": ParamDef((ev, fv, d), ("expert", "expert_ff", "expert_in"),
                           dtype=dt),
    }


def route(logits: torch.Tensor, cfg: ArchConfig, *, no_drop: bool):
    """Top-k routing of one batch of groups: logits [b, s, e] fp32 ->
    (gates [b, s, k] fp32, zero where dropped; expert indices [b, s, k];
    capacity positions [b, s, k]; keep mask [b, s, k]; aux, the
    load-balancing loss; capacity).

    As the reference: the k largest probabilities in descending order
    (``torch.topk`` sorted; on an exact tie the order may differ from
    ``jax.lax.top_k``'s lower-index-first), renormalized; ``aux`` over all
    tokens before the drop; a token's position in its expert is the count
    of earlier (token, k) picks of that expert, flattened token-major; a
    pick at or past ``capacity`` is dropped."""
    b, s, e = logits.shape
    k = cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    onehot = F.one_hot(gate_idx, e)  # [b, s, k, e] int64
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(2).float().mean(dim=(0, 1))
    aux = e * (me * ce).sum() * cfg.router_aux_coef

    # Python float arithmetic, as the reference's.
    capacity = s if no_drop else max(1, int(cfg.capacity_factor * s * k / e))
    flat = onehot.reshape(b, s * k, e)
    before = (flat.cumsum(1) - flat).reshape(b, s, k, e)
    pos = torch.gather(before, -1, gate_idx[..., None])[..., 0]
    keep = pos < capacity
    gates = gate_vals * keep
    return gates, gate_idx, pos, keep, aux, capacity


def moe_rank(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor, w_down: torch.Tensor, cfg: ArchConfig, *,
             first: int = 0, no_drop: bool = False, lead: bool = True,
             token_shards: int = 1):
    """One rank's MoE FFN (the per-rank body of ``distributed.py``): x [B,
    S, D] its tokens, whole over the model axis; ``router`` whole; its
    virtual experts ``first`` .. ``first + nv - 1`` of ``w_gate`` / ``w_up``
    [nv, D, F / r] and ``w_down`` [nv, F / r, D]. Every rank routes its
    tokens alike (the same x, the same router: the same logits bit for
    bit), keeps the picks whose expert has a virtual expert here, and runs
    those. Returns (its term of y [B, S, D] fp32, the sum over the model
    axis being the layer's output before the cast to x's dtype; ``aux``
    over its own tokens; stats [2, E], its term of the mean router
    probability and pick count per expert over all tokens: its tokens'
    means over ``token_shards``, zero but on the ``lead`` model rank).
    With the whole expert range on one rank this is ``moe_forward``'s
    computation, bit for bit."""
    b0, s0, d = x.shape
    gs = MOE_GROUP if (s0 % MOE_GROUP == 0 and not no_drop) else s0
    b, s = b0 * (s0 // gs), gs
    x = x.reshape(b, s, d)
    e, k = cfg.num_experts, cfg.top_k
    nv = w_gate.shape[0]
    r = cfg.d_ff // w_gate.shape[-1]  # virtual experts per expert
    p0, p1 = first // r, (first + nv - 1) // r + 1  # experts held in part
    n = p1 - p0

    logits = x.float() @ router
    gates, idx, pos, keep, aux, cap = route(logits, cfg, no_drop=no_drop)
    # Every rank builds the same graph (a rank's backward issues its
    # collectives in graph order, which must agree across ranks): the
    # stats of a rank but the lead are its own times 0.
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    ce = F.one_hot(idx, e).sum(2).float().mean(dim=(0, 1))
    stats = torch.stack([me, ce]) * (1.0 / token_shards if lead else 0.0)

    # Dispatch: slot (expert, position) of each group takes its one token;
    # dropped picks, and picks of experts held elsewhere, go to a spare
    # slot past the last, which is cut off.
    held = keep if n == e else keep & (idx >= p0) & (idx < p1)
    slot = torch.where(held, (idx - p0) * cap + pos, n * cap)  # [b, s, k]
    slot = (slot + torch.arange(b, device=x.device)[:, None, None]
            * (n * cap + 1)).reshape(-1)
    src = x[:, :, None].expand(b, s, k, d).reshape(-1, d)
    xe = x.new_zeros(b * (n * cap + 1), d).index_copy(0, slot, src)
    xe = xe.reshape(b, n * cap + 1, d)[:, :n * cap].reshape(b, n, cap, d)
    lo = first - p0 * r  # the first held virtual expert among n * r
    if r > 1:  # each expert's tokens go to its r virtual experts
        xe = xe.repeat_interleave(r, dim=1)
        if nv != n * r:
            xe = xe[:, lo:lo + nv]
    g = torch.einsum("becd,edf->becf", xe, w_gate)
    u = torch.einsum("becd,edf->becf", xe, w_up)
    ye = torch.einsum("becf,efd->becd", F.silu(g) * u, w_down)
    if r > 1:  # a token's expert output sums its virtual experts'
        if nv != n * r:
            ye = F.pad(ye, (0, 0, 0, 0, lo, n * r - nv - lo))
        ye = ye.reshape(b, n, r, cap, d).sum(2)

    # Combine: each pick's expert output (the spare slot is zero) times
    # its gate rounded to the activations' dtype, summed over k in fp32,
    # as the reference's combine einsum.
    ye = torch.cat([ye.reshape(b, n * cap, d), ye.new_zeros(b, 1, d)], 1)
    picked = ye.reshape(-1, d).index_select(0, slot).reshape(b, s, k, d)
    y = (picked.float() * gates.to(x.dtype).float()[..., None]).sum(2)
    return y.reshape(b0, s0, d), aux, stats


def balance_loss(stats: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``aux`` from the mean router probability and pick count per expert
    over all tokens (``moe_rank``'s stats summed over the ranks)."""
    return cfg.num_experts * (stats[0] * stats[1]).sum() \
        * cfg.router_aux_coef


def moe_forward(params, x: torch.Tensor, cfg: ArchConfig, *,
                no_drop: bool = False):
    """x [B, S, D] -> (y [B, S, D], aux). Routing groups are
    ``MOE_GROUP``-token slices of each row (module docstring). A DTensor
    x runs expert-parallel (``moe_sharded``)."""
    if is_dtensor(x):
        return moe_sharded(params, x, cfg, no_drop=no_drop)
    y, aux, _ = moe_rank(x, params["router"], params["w_gate"],
                         params["w_up"], params["w_down"], cfg,
                         no_drop=no_drop)
    return y.to(x.dtype), aux


def moe_sharded(params, x: torch.Tensor, cfg: ArchConfig, *,
                no_drop: bool = False):
    """``moe_forward`` on DTensors, expert-parallel as ``moe_defs`` lays
    it out (module docstring). ``aux`` is formed from the router
    statistics summed over all ranks: the mean over all tokens of the
    probabilities and of the picks, then their product."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = x.device_mesh
    tokens = token_placements(x)
    split = split_dims(tokens, mesh)
    experts = rank_placements(mesh, ("expert", "expert_in", "expert_ff"))
    whole = [Replicate()] * mesh.ndim
    w_gate = params["w_gate"].redistribute(mesh, experts)
    first, _ = local_range(w_gate, 0)
    model = mesh.mesh_dim_names.index("model")
    body = functools.partial(
        moe_rank, cfg=cfg, first=first, no_drop=no_drop,
        lead=mesh.get_coordinate()[model] == 0,
        token_shards=math.prod(mesh.size(i) for i in split if i != model))
    y, _, stats = per_rank(
        body, mesh,
        [(x, tokens), (params["router"], whole), (w_gate, experts),
         (params["w_up"], experts), (params["w_down"], experts)],
        [partial_over_model(tokens, mesh), None,
         [Partial() if i in split else p for i, p in enumerate(whole)]],
        tokens)
    y = y.redistribute(mesh, tokens).to(x.dtype)
    return y, balance_loss(stats.redistribute(mesh, whole), cfg)
