"""The port's expert-parallel MoE layer across ranks against the JAX
package's ``moe_forward`` run live and against the port's own 1-rank
layer: reduced mixtral-8x7b's MoE FFN (4 experts, top 2, d 64, d_ff 128,
fp32) on a (data, model) = (2, 2) mesh in one 4-rank gloo world
(``tests/_torch_worlds.py::expert_parallel``), under the train rules (the
router FSDP-sharded over "data", the experts over "model" and their d_model
over "data") and the decode rules. ``MOE_GROUP`` is patched to 8 in both
packages, so each 32-token row routes in 4 groups and tokens drop at the
capacity factor of 1.25.

Tolerances (``tests/_torch_lm.py``): fp32 summation order, RTOL = 2e-5 of
each tensor's scale for y and ``aux``, GRAD_RTOL = 1e-3 for the gradients
(the router's included). Routing is discrete: each data shard's model
ranks route from the same logits, but the reference sums a logit in
another order, so a token whose k-th and (k+1)-th router probabilities lie
within ROUTE_GAP could route otherwise. y is compared over the tokens
above the gap, the gradients' cotangent is zero on the tokens under it, and
the count under it is held to MAX_NEAR_TIES."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import init_params as jax_init_params
from repro.models import moe as jmoe
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.tree import tree_map

from _torch_lm import (GRAD_RTOL, close, one_torch_thread,  # noqa: F401
                       reduced)
from _torch_worlds import run_world

WORLD = 4  # (data, model) = (2, 2)
B, S, GROUP = 4, 32, 8
# fp32 logits of 64-term dot products move by ~1e-7 under another
# summation order, and the probabilities (each <= 1) by no more: a margin
# 100x that cannot flip. At ~uniform margins on [0, 1/2], 128 tokens put
# ~3e-3 tokens under it, so more than MAX_NEAR_TIES says the routing is
# unstable, not unlucky.
ROUTE_GAP = 1e-5
MAX_NEAR_TIES = 2


def margins(logits: np.ndarray, k: int) -> np.ndarray:
    """Per token, the gap between its k-th and (k+1)-th router
    probability."""
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top = -np.sort(-p, axis=-1)
    return top[..., k - 1] - top[..., k]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and the port's 1-rank layer in this process, the
    (2, 2) world in four: train (output, aux, gradients of sum(y·w) +
    aux) and decode (one token a row, no drop)."""
    jcfg, tcfg = reduced("mixtral-8x7b")
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jmoe.moe_defs(jcfg),
                                    jax.random.PRNGKey(7)))
    rng = np.random.default_rng(27)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    gap = margins(x @ params["router"], jcfg.top_k)
    held = gap > ROUTE_GAP
    w = (rng.normal(size=x.shape) * held[..., None]).astype(np.float32)
    d = tmp_path_factory.mktemp("expert_parallel")
    inputs = {"x": x, "w": w, "group": np.array(GROUP),
              **{f"p_{k}": v for k, v in params.items()}}
    np.savez(d / "inputs.npz", **inputs)

    saved = jmoe.MOE_GROUP, tmoe.MOE_GROUP
    jmoe.MOE_GROUP = tmoe.MOE_GROUP = GROUP
    try:
        def jloss(p):
            y, aux = jmoe.moe_forward(p, jnp.asarray(x), jcfg)
            return jnp.sum(y * w) + aux, (y, aux)

        (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                         params))
        jdec, jdec_aux = jmoe.moe_forward(params, jnp.asarray(x[:, :1]),
                                          jcfg, no_drop=True)
        live = tree_map(lambda t: t.requires_grad_(True),
                        params_from_numpy(params, "cpu"))
        ty, taux = tmoe.moe_forward(live, torch.from_numpy(x), tcfg)
        ((ty * torch.from_numpy(w)).sum() + taux).backward()
        with torch.no_grad():
            tdec, tdec_aux = tmoe.moe_forward(
                params_from_numpy(params, "cpu"), torch.from_numpy(x[:, :1]),
                tcfg, no_drop=True)
    finally:
        jmoe.MOE_GROUP, tmoe.MOE_GROUP = saved
    run_world("expert_parallel", WORLD, d, inputs=str(d / "inputs.npz"))
    return {
        "held": held, "gap": gap,
        "ref": {"train_y": np.asarray(jy), "train_aux": np.asarray(jaux),
                "decode_y": np.asarray(jdec),
                "decode_aux": np.asarray(jdec_aux),
                **{f"train_g_{k}": np.asarray(v) for k, v in jg.items()}},
        "one": {"train_y": ty.detach().numpy(),
                "train_aux": taux.detach().numpy(),
                "decode_y": tdec.numpy(), "decode_aux": tdec_aux.numpy(),
                **{f"train_g_{k}": v.grad.numpy() for k, v in live.items()}},
        "world": dict(np.load(d / "port_ep.npz")),
        "ranks": [dict(np.load(d / f"ep_{r}.npz")) for r in range(WORLD)]}


def test_routing_margins(runs):
    """At most MAX_NEAR_TIES of the 128 tokens sit within ROUTE_GAP of
    a tie (the tokens the comparisons below leave out)."""
    under = int((~runs["held"]).sum())
    assert under <= MAX_NEAR_TIES, (
        f"{under} tokens within {ROUTE_GAP} of a routing tie (smallest "
        f"margin {runs['gap'].min():.3g})")


@pytest.mark.parametrize("against", ["ref", "one"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_output_and_aux_across_ranks(runs, kind, against):
    """y over the tokens clear of a routing tie, and ``aux`` (its two
    means summed over the data ranks before their product), within RTOL
    of the reference's and of the 1-rank port's."""
    got, want = runs["world"], runs[against]
    held = runs["held"] if kind == "train" else runs["held"][:, :1]
    close(got[f"{kind}_y"][held], want[f"{kind}_y"][held],
          what=f"{kind} y against {against}")
    close(got[f"{kind}_aux"], want[f"{kind}_aux"],
          what=f"{kind} aux against {against}")


@pytest.mark.parametrize("against", ["ref", "one"])
def test_train_gradients_across_ranks(runs, against):
    """The gradients of sum(y·w) + aux, the router's (gathered over "data"
    for the step, its gradient reduce-scattered back) and every expert
    weight's, within GRAD_RTOL."""
    got, want = runs["world"], runs[against]
    for k in ("router", "w_gate", "w_up", "w_down"):
        close(got[f"train_g_{k}"], want[f"train_g_{k}"], GRAD_RTOL,
              f"gradient of {k} against {against}")


def test_each_rank_runs_its_own_experts(runs):
    """Every call of the per-rank body on each rank saw its own 2 of the 4
    experts (the first at 2 x its model coordinate), whole in d_model and
    d_ff: the expert einsums ran on ev / tp experts. No rank holds the
    whole expert weights: each keeps half the experts and half of d_model
    (FSDP over "data")."""
    for rank in runs["ranks"]:
        model = int(rank["coord"][1])
        seen = rank["seen"]
        assert len(seen) == 2  # the train and the decode call
        for call in seen:
            assert tuple(call) == (2, 64, 128, 2, 128, 64, 2 * model)
    got = runs["world"]
    assert tuple(got["train_local_w_gate"]) == (2, 32, 128)
    assert tuple(got["train_local_w_down"]) == (2, 128, 32)
    assert tuple(got["train_local_router"]) == (32, 4)
