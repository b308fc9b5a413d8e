"""The port's LMs (``repro_torch.models.transformer``) against the JAX
package's, run live on the reference's own weights carried across: for
all ten reduced configs (dense, MoE, Mamba hybrid, xLSTM) the loss, its
metrics (MoE's ``aux`` summed over the layers) and every gradient (against
``jax.grad``), prefill logits and caches and decode logits; the
reference's own prefill/decode consistency checks (``tests/test_models.py``)
ported; and a windowed ring that wraps during decode. The MoE, Mamba and
xLSTM configs' decode over several tokens is in
``tests/test_torch_lm_mixer_models.py``.

Tolerances (``tests/_torch_lm.py``): fp32 summation order, RTOL = 2e-5 of
the reference's scale; gradients GRAD_RTOL = 1e-3, 8x the reference's own
change under a one-rounding perturbation of its weights (``grads_close``:
an sLSTM's input-gate bias, on which the loss does not depend, against
its gate's weight gradient). Where the port is held to itself (decode
against a full pass), the reference test's own limits: rtol 2e-2, atol
2e-3, at a capacity factor of 16 where a config has experts, as the
reference test sets it, so no token drops."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from repro_torch.convert import params_to_numpy
from repro_torch.distributed import param_shapes
from repro_torch.models.transformer import make_model
from repro_torch.tree import tree_leaves

from _torch_lm import (ARCH_NAMES, batch, close, grads_close,  # noqa: F401
                       one_torch_thread, pair, port_value_and_grad,
                       trees_close)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_grads_match_reference(name):
    jm, jp, tm, tp = pair(name)
    data = batch(jm.cfg, seed=1)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, data), has_aux=True)(jp)
    tl, tmet, tg = port_value_and_grad(lambda p: tm.loss(p, data), tp)
    close(tl, jl, what="loss")
    for key in ("nll", "accuracy", "aux"):
        close(tmet[key], jmet[key], what=key)
    grads_close(tg, jg)


@pytest.mark.parametrize("name", ["gemma2-2b", "musicgen-medium"])
def test_chunked_loss_matches_reference_over_chunks(name, monkeypatch):
    """The cross-entropy at ``CE_CHUNK`` = 8 in both packages, so that the
    32 positions run as 4 chunks (the port's checkpointed loop against the
    reference's ``lax.scan``), with a mask that drops positions in every
    chunk: loss, metrics and every gradient. gemma2-2b has the tied head
    and the final softcap, musicgen-medium 4 output heads."""
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer as port_transformer

    monkeypatch.setattr(jax_transformer, "CE_CHUNK", 8)
    monkeypatch.setattr(port_transformer, "CE_CHUNK", 8)
    jm, jp, tm, tp = pair(name)
    data = batch(jm.cfg, seed=5)
    data["mask"] = (np.random.default_rng(6).random((2, 32)) < 0.7).astype(
        np.float32)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, data), has_aux=True)(jp)
    tl, tmet, tg = port_value_and_grad(lambda p: tm.loss(p, data), tp)
    close(tl, jl, what="loss")
    for key in ("nll", "accuracy", "aux"):
        close(tmet[key], jmet[key], what=key)
    grads_close(tg, jg)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_reference(name):
    """Prefill 12 tokens into a capacity of 16, then 3 decode steps: the
    last-token logits, every cache leaf (slot positions exact) and each
    step's logits against the reference's."""
    jm, jp, tm, tp = pair(name)
    cfg = jm.cfg
    s, extra, capacity = 12, 3, 16
    full = batch(cfg, seed=2, s=s + extra)["inputs"]
    jlog, jc = jm.prefill(jp, jnp.asarray(full[:, :s]),
                          cache_capacity=capacity)
    tlog, tc = tm.prefill(tp, full[:, :s], cache_capacity=capacity)
    close(tlog, jlog, what="prefill logits")
    trees_close(tc, jc)
    for i in range(extra):
        step_in = full[:, s + i:s + i + 1]
        jlog, jc = jm.decode_step(jp, jnp.asarray(step_in),
                                  jnp.asarray(s + i), jc)
        tlog, tc = tm.decode_step(tp, step_in, s + i, tc)
        close(tlog, jlog, what=f"decode logits t={s + i}")
    trees_close(tc, jc)


def _port_model(name, **over):
    cfg = dataclasses.replace(port_configs.ARCHS[name].reduced(), **over)
    model = make_model(cfg, "cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_decode_consistency(name):
    """``tests/test_models.py::test_prefill_decode_consistency`` on the
    port: decode of token s after a prefill of s tokens equals the full
    pass's last logits (windows cut to 8; no token drops)."""
    over = {}
    base = port_configs.ARCHS[name].reduced()
    if base.sliding_window:
        over["sliding_window"] = 8
    if base.local_window:
        over["local_window"] = 8
    if base.num_experts:
        over["capacity_factor"] = 16.0  # no token drops -> exact equality
    cfg, model, params = _port_model(name, **over)
    b, s = 2, 16
    full = batch(cfg, seed=3, b=b, s=s + 1)["inputs"]
    with torch.no_grad():
        x, _, _ = model.hidden(params, full, mode="prefill",
                               positions=torch.arange(s + 1),
                               caches=model.init_caches(b, s + 1),
                               remat=False)
        ref = model.logits(params, x[:, -1:])[:, 0]
    _, caches = model.prefill(params, full[:, :s], cache_capacity=s + 1)
    out, _ = model.decode_step(params, full[:, s:s + 1], s, caches)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-3)


def _decode_against_full_pass(cfg, model, params, s, extra, capacity):
    b = 2
    toks = batch(cfg, seed=4, b=b, s=s + extra)["inputs"]
    _, caches = model.prefill(params, toks[:, :s], cache_capacity=capacity)
    outs = []
    for i in range(extra):
        logits, caches = model.decode_step(
            params, toks[:, s + i:s + i + 1], s + i, caches)
        outs.append(logits)
    with torch.no_grad():
        x, _, _ = model.hidden(params, toks, mode="prefill",
                               positions=torch.arange(s + extra),
                               caches=model.init_caches(b, s + extra),
                               remat=False)
        ref = model.logits(params, x)
    for i, got in enumerate(outs):
        np.testing.assert_allclose(got.numpy(), ref[:, s + i].numpy(),
                                   rtol=2e-2, atol=2e-3)
    return toks, outs


def test_multi_token_decode_matches_prefill():
    """``tests/test_models.py::test_multi_token_decode_matches_prefill`` on
    the port: 4 tokens decoded one by one == the prefill of the longer
    sequence."""
    cfg, model, params = _port_model("yi-6b")
    _decode_against_full_pass(cfg, model, params, s=12, extra=4,
                              capacity=16)


def test_windowed_ring_wrap_matches_reference():
    """gemma2 with a local window of 8: a 12-token prompt and 10 decode
    steps, so the local layer's 8-slot ring wraps at prefill and again
    while decoding; the decode logits equal the port's own full pass
    (the reference test's limits) and the reference's decode (RTOL)."""
    jm, jp, tm, tp = pair("gemma2-2b", local_window=8)
    s, extra, capacity = 12, 10, 24
    toks, outs = _decode_against_full_pass(tm.cfg, tm, tp, s, extra,
                                           capacity)
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :s]), cache_capacity=capacity)
    assert jc[0]["k"].shape[3] == 8  # the local ring: [G, B, Kv, L, D]
    for i in range(extra):
        jlog, jc = jm.decode_step(jp, jnp.asarray(toks[:, s + i:s + i + 1]),
                                  jnp.asarray(s + i), jc)
        close(outs[i], jlog, what=f"decode logits t={s + i}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_shapes_and_param_counts(name):
    """The reference's smoke checks: logits [B,S,(nH,)V], and the port's
    element count equal to the reference tree's and within 6 % of the
    analytic ``param_count()``; ``param_shapes`` gives storage-free
    stand-ins of the init's leaves."""
    jm, jp, tm, tp = pair(name)
    n = sum(p.numel() for p in tree_leaves(tp))
    assert n == sum(p.size for p in jax.tree_util.tree_leaves(jp))
    assert abs(n - tm.cfg.param_count()) / n < 0.06
    fresh = tm.init(torch.Generator().manual_seed(5))
    same = jax.tree_util.tree_map(lambda a, b: a.shape == b.shape,
                                  params_to_numpy(fresh), jp)
    assert all(jax.tree_util.tree_leaves(same))
    metas = tree_leaves(param_shapes(tm.param_defs()))
    assert [(m.shape, m.dtype, m.device.type) for m in metas] == \
        [(p.shape, p.dtype, "meta") for p in tree_leaves(fresh)]
    data = batch(tm.cfg, seed=6, s=32)
    with torch.no_grad():
        x, _, _ = tm.hidden(fresh, data["inputs"], mode="prefill",
                            positions=torch.arange(32),
                            caches=tm.init_caches(2, 32), remat=False)
        logits = tm.logits(fresh, x)
    want = (2, 32, tm.cfg.vocab_size) if tm.cfg.num_output_heads == 1 else \
        (2, 32, tm.cfg.num_output_heads, tm.cfg.vocab_size)
    assert logits.shape == want and bool(torch.isfinite(logits).all())


def test_init_repeats_from_the_generator():
    cfg, model, a = _port_model("gemma2-2b")
    b = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_bf16_tree_crosses_bit_for_bit():
    """A JAX bf16 LM tree (gemma2-2b reduced in its own bf16) crosses into
    the port as ``torch.bfloat16`` leaves of the same bits and back, and
    the port serves it: a bf16 prefill with finite logits."""
    jm, jp, tm, tp = pair("gemma2-2b", dtype="bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert any(leaf.dtype == jnp.bfloat16 for _, leaf in flat)
    back = dict(jax.tree_util.tree_flatten_with_path(params_to_numpy(tp))[0])
    for path, leaf in flat:
        want = np.asarray(leaf)
        assert back[path].dtype == want.dtype, jax.tree_util.keystr(path)
        assert back[path].tobytes() == want.tobytes()
    assert tp["embed"].dtype == torch.bfloat16
    toks = batch(tm.cfg, seed=8, s=12)["inputs"]
    logits, caches = tm.prefill(tp, toks, cache_capacity=16)
    assert caches[0]["k"].dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())
