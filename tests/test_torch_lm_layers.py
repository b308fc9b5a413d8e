"""The port's LM building blocks (``repro_torch.models.layers`` and
``attention``) against the JAX package's, run live on the same numpy
inputs: norms, rope, sincos positions, softcap, the three MLPs, and GQA
attention in train, prefill and decode mode — a window of 8, softcaps, a
ring cache that wraps — plus ``prefill_cache``'s layout, whose slot
positions must be exact.

Tolerances (``tests/_torch_lm.py``): fp32 differs by summation order only,
RTOL = 2e-5 of the reference's scale; a bf16 norm by at most one bf16
rounding of the same fp32 value, 2^-8 relative. Copies (cache layouts)
are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as tattn
from repro_torch.distributed import is_param_def
from repro_torch.models import layers as tlayers
from repro_torch.tree import tree_map

from _torch_lm import close, one_torch_thread, reduced  # noqa: F401

BF16_RTOL = 2.0 ** -8  # one bf16 rounding of the same fp32 value


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3.0
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    close(tlayers.rms_norm(_t(x), _t(scale)),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
          what="rms_norm")
    close(tlayers.layer_norm(_t(x), _t(scale), _t(bias)),
          jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(bias)), what="layer_norm")
    xb = jnp.asarray(x, jnp.bfloat16)
    got = tlayers.rms_norm(_t(np.asarray(xb, np.float32)).bfloat16(),
                           _t(scale))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jlayers.rms_norm(xb, jnp.asarray(scale)), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=0)


def test_positions_and_softcap_match_reference():
    pos = np.arange(0, 40, 3)
    for theta in (10_000.0, 5_000_000.0):
        ts, tc = tlayers.rope_freqs(_t(pos), 16, theta)
        js, jc = jlayers.rope_freqs(jnp.asarray(pos), 16, theta)
        close(ts, js, what="rope sin")
        close(tc, jc, what="rope cos")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, len(pos), 4, 16)).astype(np.float32)
    js, jc = jlayers.rope_freqs(jnp.asarray(pos), 16, 10_000.0)
    ts, tc = tlayers.rope_freqs(_t(pos), 16, 10_000.0)
    close(tlayers.apply_rope(_t(x), ts[None, :, None], tc[None, :, None]),
          jlayers.apply_rope(jnp.asarray(x), js[None, :, None],
                             jc[None, :, None]), what="apply_rope")
    close(tlayers.sincos_positions(_t(pos), 64),
          jlayers.sincos_positions(jnp.asarray(pos), 64), what="sincos")
    s = rng.normal(size=(50,)).astype(np.float32) * 100
    close(tlayers.softcap(_t(s), 30.0), jlayers.softcap(jnp.asarray(s), 30.0),
          what="softcap")
    assert tlayers.softcap(_t(s), None) is not None


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_mlps_match_reference(mlp):
    jcfg, tcfg = reduced("yi-6b", mlp=mlp)
    rng = np.random.default_rng(2)
    params = {}
    shapes = {"w_gate": (64, 128), "w_up": (64, 128), "w_down": (128, 64),
              "b_up": (128,), "b_down": (64,)}
    for key in jlayers.mlp_defs(jcfg):
        params[key] = rng.normal(size=shapes[key]).astype(np.float32) * 0.2
    assert set(params) == set(tlayers.mlp_defs(tcfg))
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    close(tlayers.mlp_forward({k: _t(v) for k, v in params.items()}, _t(x),
                              tcfg),
          jlayers.mlp_forward({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), jcfg), what=mlp)


def _attention_params(rng, cfg):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    return {"wq": rng.normal(size=(d, h * dh)).astype(np.float32) * 0.15,
            "wk": rng.normal(size=(d, kv * dh)).astype(np.float32) * 0.15,
            "wv": rng.normal(size=(d, kv * dh)).astype(np.float32) * 0.15,
            "wo": rng.normal(size=(h * dh, d)).astype(np.float32) * 0.15}


@pytest.mark.parametrize("layer", [0, 1], ids=["local", "global"])
def test_attention_train_prefill_decode_match_reference(layer):
    """gemma2-style GQA (4 query heads over 2 kv heads), an attention
    softcap of 2 (small enough to bend these logits), layer 0 local with a window of 8 and layer 1 global: the train
    output, the prefilled ring (12 prompt tokens, capacity 14: the local
    ring of 8 wraps at prefill) and 6 decode steps (the global ring wraps
    at t = 14) against the reference's, cache slot for slot."""
    jcfg, tcfg = reduced("gemma2-2b", local_window=8, attn_softcap=2.0)
    rng = np.random.default_rng(3 + layer)
    params = _attention_params(rng, jcfg)
    tp = {k: _t(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    s, extra, capacity = 12, 6, 14
    xs = rng.normal(size=(2, s + extra, 64)).astype(np.float32)
    pos = np.arange(s)

    jy, _ = jattn.attention_forward(jp, jnp.asarray(xs[:, :s]), jcfg, layer,
                                    positions=jnp.asarray(pos), mode="train")
    ty, _ = tattn.attention_forward(tp, _t(xs[:, :s]), tcfg, layer,
                                    positions=_t(pos), mode="train")
    close(ty, jy, what="train")

    jy, jc = jattn.attention_forward(
        jp, jnp.asarray(xs[:, :s]), jcfg, layer, positions=jnp.asarray(pos),
        mode="prefill", cache_capacity=capacity)
    cache = tree_map(lambda d: d.initialize(None, torch.device("cpu")),
                     tattn.attn_cache_defs(tcfg, layer, 2, capacity),
                     is_leaf=is_param_def)
    ty, tc = tattn.attention_forward(
        tp, _t(xs[:, :s]), tcfg, layer, positions=_t(pos), mode="prefill",
        cache=cache)
    assert tc is cache
    close(ty, jy, what="prefill")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    close(tc["k"], jc["k"], what="prefill cache k")
    close(tc["v"], jc["v"], what="prefill cache v")

    for i in range(extra):
        t = s + i
        x1 = xs[:, t:t + 1]
        jy, jc = jattn.attention_forward(
            jp, jnp.asarray(x1), jcfg, layer, positions=jnp.asarray(t),
            mode="decode", cache=jc)
        ty, tc = tattn.attention_forward(
            tp, _t(x1), tcfg, layer, positions=torch.tensor([t]),
            mode="decode", cache=tc, t=t)
        close(ty, jy, what=f"decode t={t}")
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        close(tc["k"], jc["k"], what=f"decode cache k t={t}")


@pytest.mark.parametrize("s,capacity,window", [
    (5, 12, None), (12, 12, None), (17, 12, None), (5, 12, 8), (17, 12, 8),
    (23, 40, 8)])
def test_prefill_cache_layout_matches_reference(s, capacity, window):
    """Ring layout for s < cap and s >= cap (with and without a window that
    caps the ring): K/V copies and slot positions exactly the
    reference's."""
    jcfg, tcfg = reduced("gemma2-2b")
    rng = np.random.default_rng(s)
    k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    jc = jattn.prefill_cache(jcfg, jnp.asarray(k), jnp.asarray(v), window,
                             capacity)
    # Into a cache of the layer's ring size, in place, over stale contents.
    cap = tattn.ring_capacity(window, capacity)
    out = {"k": torch.full((2, 2, cap, 16), 7.0),
           "v": torch.full((2, 2, cap, 16), 7.0),
           "pos": torch.full((cap,), 7, dtype=torch.int32)}
    got = tattn.prefill_cache(tcfg, _t(k), _t(v), window, out)
    assert got is out
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jc[key]))
    if window is not None and capacity > window:  # a ring above the window
        big = {key: torch.zeros((2, 2, capacity, 16)) for key in ("k", "v")}
        big["pos"] = torch.zeros((capacity,), dtype=torch.int32)
        with pytest.raises(ValueError, match="window"):
            tattn.prefill_cache(tcfg, _t(k), _t(v), window, big)


def test_decode_is_one_kernel_call_over_the_filled_prefix(monkeypatch):
    """Decode reaches ``ops.flash_attention`` once, non-causal and
    unwindowed, over a [B, n, Kv, D] view of the ring (no copy) with n =
    min(t + 1, L)."""
    _, tcfg = reduced("gemma2-2b", local_window=8)
    calls = []
    real = tattn.ops.flash_attention

    def spy(q, k, v, **opts):
        calls.append((q.shape, k.shape, opts))
        return real(q, k, v, **opts)

    monkeypatch.setattr(tattn.ops, "flash_attention", spy)
    rng = np.random.default_rng(9)
    tp = {k: _t(v) for k, v in _attention_params(rng, tcfg).items()}
    cache = {"k": torch.zeros(2, 2, 8, 16), "v": torch.zeros(2, 2, 8, 16),
             "pos": torch.full((8,), -1, dtype=torch.int32)}
    for t in range(10):
        tattn.attention_forward(tp, _t(rng.normal(size=(2, 1, 64)).astype(
            np.float32)), tcfg, 0, positions=torch.tensor([t]),
            mode="decode", cache=cache, t=t)
        qs, ks, opts = calls[-1]
        assert ks == (2, min(t + 1, 8), 2, 16)
        assert opts["causal"] is False and opts["window"] is None
        assert opts["softcap"] == tcfg.attn_softcap
    assert len(calls) == 10
    assert cache["pos"].tolist() == [8, 9, 2, 3, 4, 5, 6, 7]
