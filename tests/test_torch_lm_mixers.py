"""The port's MoE, Mamba, mLSTM and sLSTM layers (``repro_torch.models.moe``,
``ssm``, ``xlstm``) against the JAX package's, run live on the reference's
own weights carried across: each layer in train mode (output and every
gradient, of the parameters and of the input), prefill (output and the
cache it leaves) and decode (output and the cache it updates, from the
reference's prefilled cache). ``MOE_GROUP``, ``MAMBA_CHUNK`` and
``MLSTM_CHUNK`` are patched to 8 in both packages and the sequence is 32
long, so the loops over several routing groups and scan chunks are held to
the reference's, not only the one-chunk case. Also: ``route`` on the
reference's logits at a capacity factor that drops tokens (indices,
positions and keep mask exactly), and
``tests/test_sharding.py::test_moe_fission_numerically_exact`` ported
(virtual experts == unsplit experts).

Tolerances (``tests/_torch_lm.py``): fp32 summation order, RTOL = 2e-5 of
the reference's scale; gradients GRAD_RTOL = 1e-3; routing exact. A tie
among the router's top-k probabilities would leave the pick order to the
sort, so the routing test fails on one, saying so."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import is_param_def
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.tree import tree_map

from _torch_lm import (GRAD_RTOL, close, grads_close,  # noqa: F401
                       one_torch_thread, port_value_and_grad, reduced,
                       trees_close)

S, PIECE = 32, 8  # sequence length; group / chunk size patched in


@pytest.fixture
def small_pieces(monkeypatch):
    for mod in (jmoe, tmoe):
        monkeypatch.setattr(mod, "MOE_GROUP", PIECE)
    for mod in (jssm, tssm):
        monkeypatch.setattr(mod, "MAMBA_CHUNK", PIECE)
    for mod in (jxlstm, txlstm):
        monkeypatch.setattr(mod, "MLSTM_CHUNK", PIECE)


# layer -> (arch, reference module / defs / forward / cache defs, port's)
LAYERS = {
    "moe": ("mixtral-8x7b", jmoe.moe_defs, jmoe.moe_forward, None,
            tmoe.moe_defs, tmoe.moe_forward, None),
    "mamba": ("jamba-v0.1-52b", jssm.mamba_defs, jssm.mamba_forward,
              jssm.mamba_cache_defs, tssm.mamba_defs, tssm.mamba_forward,
              tssm.mamba_cache_defs),
    "mlstm": ("xlstm-125m", jxlstm.mlstm_defs, jxlstm.mlstm_forward,
              jxlstm.mlstm_cache_defs, txlstm.mlstm_defs,
              txlstm.mlstm_forward, txlstm.mlstm_cache_defs),
    "slstm": ("xlstm-125m", jxlstm.slstm_defs, jxlstm.slstm_forward,
              jxlstm.slstm_cache_defs, txlstm.slstm_defs,
              txlstm.slstm_forward, txlstm.slstm_cache_defs),
}


def _setup(layer: str, seed: int, **over):
    """(ref cfg, port cfg, ref params, port params, x [2, S + 2, D] numpy)."""
    arch, jdefs, _, _, tdefs, _, _ = LAYERS[layer]
    jcfg, tcfg = reduced(arch, **over)
    jp = jax_init_params(jdefs(jcfg), jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert set(tp) == set(tdefs(tcfg))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S + 2, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _forward(layer, which, params, x, cfg, mode, cache=None):
    """(y, aux or None, cache) of the reference (``which`` 0) or port (1)."""
    fwd = LAYERS[layer][2 if which == 0 else 5]
    if layer == "moe":
        y, aux = fwd(params, x, cfg, no_drop=(mode == "decode"))
        return y, aux, None
    y, cache = fwd(params, x, cfg, mode=mode, cache=cache)
    return y, None, cache


@pytest.mark.parametrize("layer", list(LAYERS))
def test_train_matches_reference(layer, small_pieces):
    """Train mode over 4 groups / chunks: the output, MoE's aux, and the
    gradients of sum(y·w) (+ aux) with respect to every parameter and the
    input (the chunk checkpoints' recompute included)."""
    jcfg, tcfg, jp, tp, x = _setup(layer, seed=1)
    x = x[:, :S]
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux, _ = _forward(layer, 0, p, xx, jcfg, "train")
        return jnp.sum(y * w) + (0.0 if aux is None else aux), (y, aux)

    (jl, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    def tloss(live):
        y, aux, _ = _forward(layer, 1, live["p"], live["x"], tcfg, "train")
        loss = (y * torch.from_numpy(w)).sum() + (0.0 if aux is None
                                                  else aux)
        return loss, {"y": y, "aux": aux}

    tl, tout, tg = port_value_and_grad(
        tloss, {"p": tp, "x": torch.from_numpy(x)})
    close(tout["y"], jy, what=f"{layer} train output")
    if jaux is not None:
        close(tout["aux"], jaux, what="aux")
    close(tl, jl, what="loss")
    grads_close(tg["p"], jgp)
    close(tg["x"], jgx, GRAD_RTOL, what="input gradient")


def _port_cache(layer, cfg, batch):
    return tree_map(lambda d: d.initialize(None, "cpu"),
                    LAYERS[layer][6](cfg, batch), is_leaf=is_param_def)


@pytest.mark.parametrize("layer", ["mamba", "mlstm", "slstm"])
def test_prefill_and_decode_match_reference(layer, small_pieces):
    """Prefill 32 tokens (4 chunks) into a zero cache, in place: output and
    every cache leaf; then 2 decode steps from the reference's prefilled
    cache: outputs and the caches updated in place."""
    jcfg, tcfg, jp, tp, x = _setup(layer, seed=3)
    jy, _, jc = _forward(layer, 0, jp, jnp.asarray(x[:, :S]), jcfg,
                         "prefill")
    cache = _port_cache(layer, tcfg, 2)
    with torch.no_grad():
        ty, _, tc = _forward(layer, 1, tp, torch.from_numpy(x[:, :S]), tcfg,
                             "prefill", cache)
    assert tc is cache
    close(ty, jy, what=f"{layer} prefill output")
    trees_close(tc, jc)

    tc = params_from_numpy(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    for t in (S, S + 1):
        jy, _, jc = _forward(layer, 0, jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                             "decode", jc)
        with torch.no_grad():
            ty, _, same = _forward(layer, 1, tp, torch.from_numpy(
                x[:, t:t + 1]), tcfg, "decode", tc)
        assert same is tc
        close(ty, jy, what=f"{layer} decode output t={t}")
        trees_close(tc, jc)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_moe_serving_modes_match_reference(mode, small_pieces):
    """MoE in prefill (4 routing groups of 8, capacity 5 of a group's 16
    picks: tokens drop) and in decode (one token, no drop): output and
    aux."""
    jcfg, tcfg, jp, tp, x = _setup("moe", seed=4)
    x = x[:, :S] if mode == "prefill" else x[:, :1]
    if mode == "prefill":
        logits = torch.from_numpy(x).reshape(8, PIECE, -1) @ tp["router"]
        assert not bool(tmoe.route(logits, tcfg, no_drop=False)[3].all())
    jy, jaux, _ = _forward("moe", 0, jp, jnp.asarray(x), jcfg, mode)
    with torch.no_grad():
        ty, taux, _ = _forward("moe", 1, tp, torch.from_numpy(x), tcfg, mode)
    close(ty, jy, what=f"moe {mode} output")
    close(taux, jaux, what="aux")


def _jax_route(logits, cfg, no_drop: bool):
    """The reference's routing, ``src/repro/models/moe.py:82-100`` line for
    line, on its own logits: (gates, indices, positions, keep, aux)."""
    b, s, e = logits.shape
    k = cfg.top_k
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    me = jnp.mean(probs, axis=(0, 1))
    ce = jnp.mean(jnp.sum(jax.nn.one_hot(gate_idx, e, dtype=jnp.float32),
                          axis=2), axis=(0, 1))
    aux = e * jnp.sum(me * ce) * cfg.router_aux_coef
    capacity = s if no_drop else max(1, int(cfg.capacity_factor * s * k / e))
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(b, s * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(b, s, k, e)
    pos = jnp.sum(pos * onehot, axis=-1).astype(jnp.int32)
    keep = pos < capacity
    return gate_vals * keep, gate_idx, pos, keep, aux, probs


def _no_ties(probs, k: int):
    """Fail, saying so, where the reference's top-k pick order is a tie."""
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1][..., :k + 1]
    ties = int((np.diff(top, axis=-1) == 0).sum())
    assert ties == 0, (f"{ties} ties among the router's top-{k + 1} "
                       "probabilities: the pick order of a tie is undefined "
                       "in torch.topk; choose other inputs")


@pytest.mark.parametrize("capacity_factor,no_drop",
                         [(0.5, False), (1.25, False), (1.25, True)])
def test_route_matches_reference(capacity_factor, no_drop):
    """``route`` on the reference's router logits (2 x 32 tokens, 4
    experts, top 2): indices, capacity positions and keep mask exactly,
    gates and aux within RTOL; at 0.5 and 1.25 tokens are dropped."""
    jcfg, tcfg, jp, tp, x = _setup("moe", seed=5,
                                   capacity_factor=capacity_factor)
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x[:, :S]), jp["router"])
    jg, ji, jpos, jkeep, jaux, probs = _jax_route(logits, jcfg, no_drop)
    _no_ties(probs, jcfg.top_k)
    gates, idx, pos, keep, aux, cap = tmoe.route(
        torch.from_numpy(np.array(logits)), tcfg, no_drop=no_drop)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if no_drop or capacity_factor < 1:  # capacity 32 / 8 of 64 picks
        assert bool(keep.all()) == no_drop
    assert cap == (S if no_drop else
                   max(1, int(capacity_factor * S * 2 / 4)))
    close(gates, jg, what="gates")
    close(aux, jaux, what="aux")


def _split_experts(w: np.ndarray, r: int, ff_axis: int) -> np.ndarray:
    """[e, d, f] -> [e r, d, f / r] (ff_axis 2) or [e, f, d] -> [e r, f / r,
    d] (ff_axis 1): each expert's r d_ff slices as virtual experts."""
    if ff_axis == 2:
        e, d, f = w.shape
        return w.reshape(e, d, r, f // r).transpose(0, 2, 1, 3).reshape(
            e * r, d, f // r)
    e, f, d = w.shape
    return w.reshape(e * r, f // r, d)


def test_moe_fission_numerically_exact():
    """``tests/test_sharding.py::test_moe_fission_numerically_exact`` on
    the port (its limits, rtol 2e-4, atol 2e-5): 2-way virtual experts ==
    the unsplit experts under the same routing; and the port's virtual
    experts against the reference's on the same split weights (RTOL)."""
    jcfg, tcfg, jp, tp, x = _setup("moe", seed=6, capacity_factor=16.0)
    x = x[:, :8]
    with torch.no_grad():
        y_ref, aux_ref = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    npp = {k: np.asarray(v) for k, v in jp.items()}
    split = {"router": npp["router"],
             "w_gate": _split_experts(npp["w_gate"], 2, 2),
             "w_up": _split_experts(npp["w_up"], 2, 2),
             "w_down": _split_experts(npp["w_down"], 2, 1)}
    with torch.no_grad():
        y_v, aux_v = tmoe.moe_forward(params_from_numpy(split, "cpu"),
                                      torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y_ref.numpy(), y_v.numpy(), rtol=2e-4,
                               atol=2e-5)
    assert float(aux_v) == float(aux_ref)
    jy_v, _ = jmoe.moe_forward({k: jnp.asarray(v) for k, v in split.items()},
                               jnp.asarray(x), jcfg)
    close(y_v, jy_v, what="virtual experts vs the reference's")
    assert tmoe.expert_split_factor(tcfg) == 1  # no mesh -> no fission
