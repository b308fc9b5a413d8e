"""The MoE, Mamba-hybrid and xLSTM LMs of ROADMAP item 10b (reduced
mixtral-8x7b, jamba-v0.1-52b, xlstm-125m) end to end on the port, beside
the JAX package run live: several decode steps against one pass over the
longer sequence (``tests/test_models.py::test_multi_token_decode_matches_
prefill`` for these configs); a prompt shorter than the conv's d_conv - 1
rows, whose prefilled conv cache is zero-padded in front, then decode,
against the reference's logits and caches; and the loss and gradients
with ``MOE_GROUP``, ``MAMBA_CHUNK`` and ``MLSTM_CHUNK`` patched to 8 in
both packages, so a 32-token row routes in 4 groups and scans in 4 chunks
inside the whole model (the group loop's ``checkpoint`` around the
chunks' own).

Tolerances (``tests/_torch_lm.py``): against the reference RTOL = 2e-5
and GRAD_RTOL = 1e-3 on layer-scaled weights (``pair``); against
the port's own full pass the reference test's rtol 2e-2, atol 2e-3, at a
capacity factor of 16 where experts route, so no token drops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm

from _torch_lm import (batch, close, grads_close,  # noqa: F401
                       one_torch_thread, pair, port_value_and_grad,
                       trees_close)


def _no_drop(name):
    return {"capacity_factor": 16.0} if name.startswith(("mixtral",
                                                         "jamba")) else {}


@pytest.mark.parametrize("name", ["mixtral-8x7b", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_multi_token_decode_matches_prefill(name):
    """A 12-token prefill and 4 decode steps == the prefill of all 16
    tokens, position for position; mixtral's window cut to 8 so its ring
    wraps."""
    over = _no_drop(name)
    if name.startswith("mixtral"):
        over["sliding_window"] = 8
    _, _, tm, tp = pair(name, **over)
    b, s, extra = 2, 12, 4
    toks = batch(tm.cfg, seed=4, b=b, s=s + extra)["inputs"]
    _, caches = tm.prefill(tp, toks[:, :s], cache_capacity=s + extra)
    outs = []
    for i in range(extra):
        logits, caches = tm.decode_step(tp, toks[:, s + i:s + i + 1], s + i,
                                        caches)
        outs.append(logits)
    with torch.no_grad():
        x, _, _ = tm.hidden(tp, toks, mode="prefill",
                            positions=torch.arange(s + extra),
                            caches=tm.init_caches(b, s + extra), remat=False)
        ref = tm.logits(tp, x)
    for i, got in enumerate(outs):
        np.testing.assert_allclose(got.numpy(), ref[:, s + i].numpy(),
                                   rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_short_prompt_then_decode_matches_reference(name):
    """A 2-token prompt (the conv keeps d_conv - 1 = 3 rows, so its cache
    is zero-padded in front), then 4 decode steps: the prefilled caches
    leaf for leaf, each step's logits, and the caches after the last step,
    against the reference's."""
    jm, jp, tm, tp = pair(name)
    s, extra, capacity = 2, 4, 8
    toks = batch(tm.cfg, seed=9, s=s + extra)["inputs"]
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :s]),
                          cache_capacity=capacity)
    tlog, tc = tm.prefill(tp, toks[:, :s], cache_capacity=capacity)
    close(tlog, jlog, what="prefill logits")
    trees_close(tc, jc)
    conv = [c["conv"] for c in tc if "conv" in c]
    assert conv and all(bool((c[:, :, 0] == 0).all()) for c in conv)
    for i in range(extra):
        step = toks[:, s + i:s + i + 1]
        jlog, jc = jm.decode_step(jp, jnp.asarray(step), jnp.asarray(s + i),
                                  jc)
        tlog, tc = tm.decode_step(tp, step, s + i, tc)
        close(tlog, jlog, what=f"decode logits t={s + i}")
    trees_close(tc, jc)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_grouped_and_chunked_loss_matches_reference(name, monkeypatch):
    """Loss, metrics (MoE's aux over 4 routing groups a row) and every
    gradient with the routing group and both scan chunks at 8 tokens in
    both packages, 32 tokens a row."""
    for mod in (jmoe, tmoe):
        monkeypatch.setattr(mod, "MOE_GROUP", 8)
    for mod in (jssm, tssm):
        monkeypatch.setattr(mod, "MAMBA_CHUNK", 8)
    for mod in (jxlstm, txlstm):
        monkeypatch.setattr(mod, "MLSTM_CHUNK", 8)
    jm, jp, tm, tp = pair(name)
    data = batch(jm.cfg, seed=10)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, data), has_aux=True)(jp)
    tl, tmet, tg = port_value_and_grad(lambda p: tm.loss(p, data), tp)
    close(tl, jl, what="loss")
    for key in ("nll", "accuracy", "aux"):
        close(tmet[key], jmet[key], what=key)
    if name.startswith("jamba"):
        assert float(tmet["aux"].detach()) > 0
    grads_close(tg, jg)


def test_phase14_routing_check_on_cpu():
    """``chip_smoke.py`` phase 14's routing comparison, on the CPU at
    reduced mixtral (no drops): a prefill and 4 decode steps route every
    generated token to the experts one full pass over the same tokens
    picks (``route_record``, ``route_flips``); a decode record moved to
    another expert is flagged at its token, with the full pass's gap
    p_k - p_(k+1) there; the decode logits equal the full pass's
    (``decode_readings``)."""
    from _torch_lm import chip_smoke as cs

    _, _, tm, tp = pair("mixtral-8x7b", capacity_factor=2.0)
    b, s, gen, k = 2, 12, 4, tm.cfg.top_k
    toks = torch.from_numpy(batch(tm.cfg, seed=11, b=b, s=s + gen)[
        "inputs"])
    decoded, full_routes, outs = [], [], []
    with cs.route_record(decoded):
        _, caches = tm.prefill(tp, toks[:, :s], cache_capacity=s + gen)
        for i in range(gen):
            logits, caches = tm.decode_step(tp, toks[:, s + i:s + i + 1],
                                            s + i, caches)
            outs.append(logits)
    with cs.route_record(full_routes):
        full, launches = cs.full_pass_logits(tm, tp, toks[:, :s],
                                             toks[:, s:])
    layers = len(full_routes)
    assert layers == 2 and launches == 0  # the CPU runs the plain version
    flips, count, gap = cs.route_flips(decoded, full_routes, s, gen, k)
    assert flips.shape == (b, gen) and not bool(flips.any()) and count == 0
    readings = cs.decode_readings(torch.stack(outs, 1), full)
    assert readings["rms_share"] < 1e-5 and readings["tokens"] == b * gen

    idx, top, keep = decoded[-(gen - 1) * layers]  # step 1, layer 0
    moved = idx.clone()
    moved[1, 0] = (idx[1, 0] + 1) % tm.cfg.num_experts
    decoded[-(gen - 1) * layers] = (moved, top, keep)
    flips, count, gap = cs.route_flips(decoded, full_routes, s, gen, k)
    assert flips.nonzero().tolist() == [[1, 1]] and count == 1
    want = full_routes[0][1][1, s + 1]
    assert gap == float(want[k - 1] - want[k])


def test_phase14_planted_faults_on_cpu():
    """``chip_smoke.py`` phase 14's planted xLSTM decode faults, on the CPU
    at reduced xlstm-125m: a prefill and 4 decode steps stay within 1e-5
    of one full pass over the same tokens (RMS share); with each of
    ``XLSTM_FAULTS`` planted they leave it by more than 8x
    ``XLSTM_FP32_SHARE`` (0.0072 to 0.66 here); after each the mixer
    table and the conv are restored."""
    from _torch_lm import chip_smoke as cs
    from repro_torch.models import transformer, xlstm

    _, _, tm, tp = pair("xlstm-125m")
    b, s, gen = 2, 12, 4
    toks = torch.from_numpy(batch(tm.cfg, seed=11, b=b, s=s + gen)[
        "inputs"])
    full, _ = cs.full_pass_logits(tm, tp, toks[:, :s], toks[:, s:])

    def share():
        outs = []
        with torch.no_grad():
            _, caches = tm.prefill(tp, toks[:, :s], cache_capacity=s + gen)
            for i in range(gen):
                logits, caches = tm.decode_step(
                    tp, toks[:, s + i:s + i + 1], s + i, caches)
                outs.append(logits)
        return cs.decode_readings(torch.stack(outs, 1), full)["rms_share"]

    table, conv = dict(transformer._MIXERS), xlstm.causal_conv
    assert share() < 1e-5
    for fault in cs.XLSTM_FAULTS:
        with cs.planted_fault(fault):
            assert share() > 8 * cs.XLSTM_FP32_SHARE, fault
        assert transformer._MIXERS == table and xlstm.causal_conv is conv
    assert share() < 1e-5
