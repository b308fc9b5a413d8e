"""The port's Mamba, mLSTM and sLSTM layers tensor-parallel across ranks,
and its MoE layer with expert fission, against the JAX package's layers
run live and against the port's own 1-rank layers: one 2-rank gloo world
at (data, model) = (1, 2) (``tests/_torch_worlds.py::tp_mixers``).

- reduced jamba-v0.1-52b's Mamba layer (d_inner 128 split 64 / 64 over
  "model"; the caches' channels too) and reduced xlstm-125m's mLSTM and
  sLSTM layers (their projections split over "model", the recurrences and
  their state replicated, as the reference lays them out): train mode
  (output and the gradient of every parameter), then under the decode
  rules a 32-token prefill into a zero cache laid out over the ranks and 4
  decode steps against it (outputs and the final cache);
- reduced mixtral-8x7b's MoE layer replaced to 3 experts, which the 2-way
  expert axis splits into 6 virtual experts of d_ff 64
  (``expert_split_factor`` r = 2): the reference's r = 1 weights carried
  across by ``convert.experts_to_virtual``, held to the reference's r = 1
  layer (output, aux, the gradients, the reference's split the same way);
- each rank's per-rank bodies saw only its own experts and channels.

``MOE_GROUP``, ``MAMBA_CHUNK`` and ``MLSTM_CHUNK`` are patched to 8 in both
packages (4 routing groups and scan chunks a row). Tolerances
(``tests/_torch_lm.py``): fp32 summation order, RTOL = 2e-5 of each
tensor's scale; gradients GRAD_RTOL = 1e-3 (``grads_close``: the sLSTM's
input-gate bias, whose gradient is rounding alone, against its ``w_i``'s
scale). The layers run on the reference's own per-layer init, as in
``tests/test_torch_lm_mixers.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.convert import experts_to_virtual, params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm

from _torch_lm import (GRAD_RTOL, close, grads_close,  # noqa: F401
                       one_torch_thread, reduced)
from _torch_worlds import _mixer_chain, run_world

WORLD = 2  # (data, model) = (1, 2)
B, S, STEPS, PIECE = 2, 32, 4, 8
LAYERS = {  # layer -> (arch, the reference's defs, forward, cache defs)
    "mamba": ("jamba-v0.1-52b", jssm.mamba_defs, jssm.mamba_forward,
              jssm.mamba_cache_defs),
    "mlstm": ("xlstm-125m", jxlstm.mlstm_defs, jxlstm.mlstm_forward,
              jxlstm.mlstm_cache_defs),
    "slstm": ("xlstm-125m", jxlstm.slstm_defs, jxlstm.slstm_forward,
              jxlstm.slstm_cache_defs),
}


def _reference_chain(layer: str, jcfg, params, data) -> dict:
    """The reference layer, jitted: train output and gradients of sum(y·w);
    a prefill into a zero cache and ``STEPS`` decode steps from its
    caches."""
    _, defs, fwd, cdefs = LAYERS[layer]
    p = jax.tree_util.tree_map(jnp.asarray, params)

    @jax.jit
    def train(pp, x, w):
        def loss(q):
            y, _ = fwd(q, x, jcfg, mode="train")
            return jnp.sum(y * w), y
        return jax.value_and_grad(loss, has_aux=True)(pp)

    (_, y), g = train(p, data["x"], data["w"])
    out = {"train_y": np.asarray(y),
           **{f"g_{k}": np.asarray(v) for k, v in g.items()}}
    y, cache = jax.jit(lambda pp, x: fwd(pp, x, jcfg, mode="prefill"))(
        p, data["x"])
    out["prefill_y"] = np.asarray(y)
    decode = jax.jit(lambda pp, x, c: fwd(pp, x, jcfg, mode="decode",
                                          cache=c))
    for t in range(STEPS):
        y, cache = decode(p, data["steps"][:, t:t + 1], cache)
        out[f"decode_y{t}"] = np.asarray(y)
    out.update({f"cache_{k}": np.asarray(v, np.float32)
                for k, v in cache.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mods = (jmoe, tmoe, jssm, tssm, jxlstm, txlstm)
    names = ("MOE_GROUP", "MAMBA_CHUNK", "MLSTM_CHUNK")
    saved = [(m, n, getattr(m, n)) for m in mods for n in names
             if hasattr(m, n)]
    for m, n, _ in saved:
        setattr(m, n, PIECE)
    inputs = {"piece": np.array(PIECE)}
    ref, one = {}, {}
    try:
        for seed, (layer, (arch, defs, _, _)) in enumerate(LAYERS.items()):
            jcfg, tcfg = reduced(arch)
            params = jax.tree_util.tree_map(np.asarray, jax_init_params(
                defs(jcfg), jax.random.PRNGKey(seed)))
            rng = np.random.default_rng(270 + seed)
            data = {k: rng.normal(size=(B, n, jcfg.d_model)).astype(
                np.float32) for k, n in (("x", S), ("w", S), ("steps",
                                                             STEPS))}
            inputs.update({f"{layer}/{k}": v for k, v in data.items()})
            inputs.update({f"{layer}/p_{k}": v for k, v in params.items()})
            ref[layer] = _reference_chain(layer, jcfg, params, data)
            one[layer] = {}
            _mixer_chain(layer, tcfg, params_from_numpy(params, "cpu"), data,
                         None, one[layer])
        jcfg, tcfg = reduced("mixtral-8x7b", num_experts=3)
        params = jax.tree_util.tree_map(np.asarray, jax_init_params(
            jmoe.moe_defs(jcfg), jax.random.PRNGKey(9)))
        rng = np.random.default_rng(279)
        x = rng.normal(size=(B, 16, jcfg.d_model)).astype(np.float32)
        w = rng.normal(size=x.shape).astype(np.float32)
        inputs.update({"fission/x": x, "fission/w": w,
                       **{f"fission/p_{k}": v for k, v in params.items()}})

        def jloss(p):
            y, aux = jmoe.moe_forward(p, jnp.asarray(x), jcfg)
            return jnp.sum(y * w) + aux, (y, aux)

        (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                         params))
        ref["fission"] = {"y": np.asarray(jy), "aux": np.asarray(jaux),
                          "g": {k: np.asarray(v) for k, v in jg.items()}}
    finally:
        for m, n, v in saved:
            setattr(m, n, v)
    d = tmp_path_factory.mktemp("tp_mixers")
    np.savez(d / "inputs.npz", **inputs)
    run_world("tp_mixers", WORLD, d, inputs=str(d / "inputs.npz"))
    return {"ref": ref, "one": one, "world": dict(np.load(
        d / "port_tp.npz")), "ranks": [dict(np.load(d / f"tp_{r}.npz"))
                                       for r in range(WORLD)]}


def _world(runs, layer: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in runs["world"].items()
            if k.startswith(layer + "/")}


@pytest.mark.parametrize("layer", list(LAYERS))
def test_train_across_ranks(runs, layer):
    """Train mode on 2 ranks: the output within RTOL and every parameter's
    gradient within GRAD_RTOL of the reference's and of the 1-rank
    port's."""
    got = _world(runs, layer)
    for against in ("ref", "one"):
        want = runs[against][layer]
        close(got["train_y"], want["train_y"], what=f"{layer} train y "
              f"against {against}")
        grads_close({k[2:]: torch.from_numpy(got[k]) for k in got
                     if k.startswith("g_")},
                    {k[2:]: want[k] for k in want if k.startswith("g_")})


@pytest.mark.parametrize("layer", list(LAYERS))
def test_prefill_and_decode_against_sharded_caches(runs, layer):
    """A prefill into the cache laid out over the ranks (the Mamba and
    mLSTM conv channels and the Mamba SSM state split over "model", the
    mLSTM and sLSTM state replicated) and 4 decode steps against it: every
    output and the final cache, whole, within RTOL of the reference's and
    of the 1-rank port's."""
    got = _world(runs, layer)
    keys = ["prefill_y"] + [f"decode_y{t}" for t in range(STEPS)] + [
        k for k in got if k.startswith("cache_")]
    assert len(keys) > STEPS + 2
    for against in ("ref", "one"):
        want = runs[against][layer]
        assert set(keys) <= set(want)
        for k in keys:
            close(got[k], want[k], what=f"{layer} {k} against {against}")


def test_moe_fission_across_ranks_matches_reference(runs):
    """3 experts on a 2-way expert axis: r = 2, 6 virtual experts, 3 a
    rank. The output and aux within RTOL of the reference's r = 1 layer;
    the router's gradient and the virtual experts' within GRAD_RTOL of the
    reference's, split as ``experts_to_virtual`` splits the weights."""
    got = _world(runs, "fission")
    want = runs["ref"]["fission"]
    assert int(got["r"]) == 2
    close(got["train_y"], want["y"], what="fission y")
    close(got["train_aux"], want["aux"], what="fission aux")
    virtual = experts_to_virtual(want["g"], 2)
    for k, g in virtual.items():
        assert got[f"train_g_{k}"].shape == g.shape, k
        close(got[f"train_g_{k}"], g, GRAD_RTOL, f"fission gradient {k}")


def test_each_rank_holds_its_own_experts_and_channels(runs):
    """Each rank's Mamba body saw its 64 of the 128 d_inner channels (the
    in- and out-projections and the SSM cache), and its MoE body 3 of the
    6 virtual experts, the first at 3 x its rank: no rank computed another
    rank's channels or experts."""
    for r, rank in enumerate(runs["ranks"]):
        assert len(rank["mamba"]) == 1 + STEPS  # prefill and decodes
        for call in rank["mamba"]:
            assert tuple(call) == (64, 64, 64, 64, B, 64, 8)
        assert len(rank["moe"]) == 1
        assert tuple(rank["moe"][0]) == (3, 64, 64, 3, 64, 64, 3 * r)


@pytest.fixture
def phase16_on_cpu(monkeypatch):
    """``chip_smoke.py`` phase 16's layer checks made to run on the CPU:
    the reduced configs (in phase 16's bf16), 4 decode steps, routing
    groups of 16, no timing."""
    from _torch_lm import chip_smoke as cs
    from repro_torch import configs

    full = configs.get_arch
    monkeypatch.setattr(configs, "get_arch",
                        lambda name: full(name).reduced())
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "RANK_DECODE", 4)
    monkeypatch.setattr(tmoe, "MOE_GROUP", 16)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return cs


def test_phase16_rank_checks_on_cpu(phase16_on_cpu, monkeypatch):
    """Phase 16's per-rank checks (``moe_ranks``, ``mixer_ranks``) on the
    CPU: R bodies run in turn by ``run_serial`` on their parts of the
    weights and caches merge within RANK_RMS_SHARE of the unsharded
    layer, with equal routing, through the fission case (R above the
    expert count). With the last rank's term left out of every sum
    (``run_serial`` dropping it), each check fails."""
    cs = phase16_on_cpu
    from repro_torch import distributed

    rows = cs.moe_ranks("mixtral-8x7b", (2, 8), 1, 64, "cpu")
    rows += cs.mixer_ranks("jamba-v0.1-52b", "mamba", (2,), 1, 32, "cpu")
    rows += cs.mixer_ranks("xlstm-125m", "mlstm", (2,), 2, 32, "cpu")
    rows += cs.mixer_ranks("xlstm-125m", "slstm", (2,), 2, 16, "cpu")
    assert [r["ranks"] for r in rows] == [2, 8, 2, 2, 2]
    assert rows[1]["virtual_per_expert"] == 2
    for row in rows:
        share = row["rms_share"] if row["layer"] == "moe" else max(
            row["prefill"]["rms_share"], row["decode"]["rms_share"])
        assert share <= cs.RANK_RMS_SHARE / 4, row

    whole = distributed.run_serial

    def dropping(results):
        done = whole(results)
        return done[:-1] + [tuple(t * 0 if torch.is_tensor(t) else t
                                  for t in done[-1])]

    monkeypatch.setattr(distributed, "run_serial", dropping)
    with pytest.raises(AssertionError, match="mixer ranks"):
        cs.moe_ranks("mixtral-8x7b", (2,), 1, 64, "cpu")
    with pytest.raises(AssertionError, match="mixer ranks"):
        cs.mixer_ranks("jamba-v0.1-52b", "mamba", (2,), 1, 32, "cpu")
