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

The reference dispatches and combines with one-hot einsums over [tokens,
experts, capacity]. The port computes the same function with indices: a
token's kept (expert, position) slots are filled by ``index_copy`` and
read back by a gather, so the work is O(tokens), not O(tokens x
capacity). Each slot holds one token, so the dispatch is exact, and the
combine sums the same k gated terms in another order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import (
    ParamDef,
    constrain,
    current_mesh,
    current_rules,
    mesh_axis_size,
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


def moe_forward(params, x: torch.Tensor, cfg: ArchConfig, *,
                no_drop: bool = False):
    """x [B, S, D] -> (y [B, S, D], aux). Routing groups are
    ``MOE_GROUP``-token slices of each row (module docstring)."""
    b0, s0, d = x.shape
    gs = MOE_GROUP if (s0 % MOE_GROUP == 0 and not no_drop) else s0
    b, s = b0 * (s0 // gs), gs
    x = x.reshape(b, s, d)
    e, k = cfg.num_experts, cfg.top_k
    ev = params["w_gate"].shape[0]
    r = ev // e

    logits = x.float() @ params["router"]
    gates, idx, pos, keep, aux, cap = route(logits, cfg, no_drop=no_drop)

    # Dispatch: slot (expert, position) of each group takes its one token;
    # dropped picks go to a spare slot past the last, which is cut off.
    slot = torch.where(keep, idx * cap + pos, e * cap)  # [b, s, k]
    slot = (slot + torch.arange(b, device=x.device)[:, None, None]
            * (e * cap + 1)).reshape(-1)
    src = x[:, :, None].expand(b, s, k, d).reshape(-1, d)
    xe = x.new_zeros(b * (e * cap + 1), d).index_copy(0, slot, src)
    xe = xe.reshape(b, e * cap + 1, d)[:, :e * cap].reshape(b, e, cap, d)
    if r > 1:  # each expert's tokens go to its r virtual experts
        xe = xe.repeat_interleave(r, dim=1)
    xe = constrain(xe, "act_batch", "expert", None, None)
    g = torch.einsum("becd,edf->becf", xe, params["w_gate"])
    u = torch.einsum("becd,edf->becf", xe, params["w_up"])
    h = constrain(F.silu(g) * u, "act_batch", "expert", None, "expert_ff")
    ye = torch.einsum("becf,efd->becd", h, params["w_down"])
    ye = constrain(ye, "act_batch", "expert", None, None)
    if r > 1:  # a token's expert output sums its virtual experts'
        ye = ye.reshape(b, e, r, cap, d).sum(2)

    # Combine: each pick's expert output (the spare slot is zero) times
    # its gate rounded to the activations' dtype, summed over k in fp32
    # and rounded once, as the reference's combine einsum.
    ye = torch.cat([ye.reshape(b, e * cap, d), ye.new_zeros(b, 1, d)], 1)
    picked = ye.reshape(-1, d).index_select(0, slot).reshape(b, s, k, d)
    y = (picked.float() * gates.to(x.dtype).float()[..., None]).sum(2)
    return y.to(x.dtype).reshape(b0, s0, d), aux
