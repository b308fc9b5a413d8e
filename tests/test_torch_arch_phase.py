"""``chip_smoke.py`` phase 19 (the six LM archs no earlier phase runs) and
phase 7's cases at their head groupings, rehearsed on the CPU at reduced
sizes.

- Phase 7's cases at phase 19's models (``arch_attention_cases``): each
  one's kv split plan; at those the plan splits, the check failing two
  faulty kv combines; and the plain attention at the same head groupings
  (G = 48 multi-query, G = 8, G = 7, G = 6 windowed, MHA at D = 64)
  against the JAX package's Pallas kernel in interpret mode, within its
  limits.
- Phase 19's helpers: ``lm_serve`` / ``full_pass_logits`` taking
  embedding rows (musicgen-medium) against the JAX package's prefill and
  decode on the same weights and rows (RTOL of ``tests/_torch_lm.py``),
  its four output heads held together;
  the ring check and the planted decode faults (``DECODE_FAULTS``, each
  at least ``FAULT_MARGIN`` x the limit; the bracket raising where a limit
  is too loose to catch them by that margin), on a ring that wraps too,
  and on phases 13's and 14's gemma2-2b and jamba-v0.1-52b;
  ``redraw_differences``; ``reroutes`` marking each token's first
  reroute; and the whole phase (``archs_phase``) on the six reduced
  configs with the attention kernel replaced by its plain version.
No full-width model runs here.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_fa_kernel
from repro_torch import configs as port_configs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mx_quantize as mxq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattention
from repro_torch.models import transformer
from repro_torch.models.transformer import make_model
from repro_torch.tree import tree_leaves

from _torch_lm import (RTOL, batch, chip_smoke as cs, close,  # noqa: F401
                       one_torch_thread, pair)

# The kv split count the plan gives each of phase 7's cases at phase 19's
# models: the decodes against 4128 and 2080 slots split in 3 (96 to 128
# CTAs of one query row), the serve drivers' against 543 in 2;
# mixtral-8x22b's 4 x 48 heads fill 192 CTAs against its 4096-slot ring
# and run whole, as every prefill does.
EXPECTED_SPLITS = {
    "yi-6b prefill": 1, "yi-6b ring decode": 3,
    "yi-34b prefill": 1, "yi-34b ring decode": 3,
    "granite-20b prefill": 1, "granite-20b ring decode": 3,
    "llava-next-mistral-7b prefill": 1,
    "llava-next-mistral-7b ring decode": 3,
    "musicgen-medium prefill": 1, "musicgen-medium ring decode": 3,
    "mixtral-8x22b prefill": 1, "mixtral-8x22b ring decode": 1,
    "llava-next-mistral-7b serve driver fp32": 1,
    "llava-next-mistral-7b serve driver decode fp32": 2,
    "musicgen-medium serve driver fp32": 1,
    "musicgen-medium serve driver decode fp32": 2,
}
ARCH_CASES = cs.arch_attention_cases()


def test_arch_attention_cases_follow_the_models():
    """One prefill and one last decode step a model of ``ARCH_MODELS`` at
    its batch, prompt, heads and window, and a pair a serve driver in
    fp32; each decode against the slots its last step reads."""
    cases = {label: rest for label, *rest in ARCH_CASES}
    assert set(cases) == set(EXPECTED_SPLITS)
    for arch, _, b, prompt in cs.ARCH_MODELS:
        cfg = port_configs.get_arch(arch)
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        keys = min(prompt + cs.MIXER_GEN, cfg.sliding_window or 1 << 30)
        assert cases[f"{arch} prefill"][:2] == [
            (b, prompt, prompt) + heads, cfg.dtype]
        assert cases[f"{arch} prefill"][2].get("window") == \
            cfg.sliding_window
        assert cases[f"{arch} ring decode"][:2] == [(b, 1, keys) + heads,
                                                    cfg.dtype]
    for arch in cs.ARCH_DRIVERS:
        _, sq, skv, *_ = cases[f"{arch} serve driver decode fp32"][0]
        assert (sq, skv) == (1, cs.DRIVER_PROMPT + cs.DRIVER_GEN - 1)
        assert cs.RING_SLOTS[f"{arch} serve driver decode fp32"] == skv + 1


@pytest.mark.parametrize("case", ARCH_CASES, ids=lambda c: c[0])
def test_arch_attention_case_plans(case):
    """The split count, and kv pieces on 64-key boundaries that cover the
    keys every row sees, in order and without overlap; the decodes read
    the head-major ring and hold the lse."""
    label, (b, sq, skv, h, _, _), dtype, opts = case
    assert dtype == ("float32" if "fp32" in label else "bfloat16")
    kw = dict(causal=opts["causal"], window=opts.get("window"),
              q_offset=opts.get("q_offset", 0))
    plan = tfa.attention_plan(b, h, sq, skv, **kw)
    assert plan.splits == EXPECTED_SPLITS[label]
    ranges = tfa.split_ranges(plan, skv)
    for (lo, hi), (lo_next, _) in zip(ranges, ranges[1:]):
        assert hi == lo_next and lo % tfa.SPLIT_KEYS == 0
    mask = tref.attention_mask(sq, skv, **kw)
    covered = torch.zeros(skv, dtype=torch.bool)
    for lo, hi in ranges:
        covered[lo:hi] = True
    assert bool(covered[mask.any(0)].all())
    decode = "decode" in label
    assert (label in cs.HEAD_MAJOR_KV) == decode
    assert (label in cs.LSE_CASES) == decode


@pytest.mark.parametrize("case", [c for c in ARCH_CASES
                                  if EXPECTED_SPLITS[c[0]] > 1],
                         ids=lambda c: c[0])
def test_phase7_check_fails_a_faulty_combine_at_arch_cases(case):
    """``chip_smoke.attention_within`` passes the plain split of the new
    decodes (through the head-major view) and fails two faulty combines of
    the same partials: piece 0 dropped, and the partials summed without
    their e^(m_s - m) rescale."""
    label, shape, dtype, opts = case
    b, sq, skv, h, _, d = shape
    q, k, v = cs.attention_inputs(torch.Generator().manual_seed(7), shape,
                                  dtype, "cpu", head_major=True,
                                  slots=cs.RING_SLOTS.get(label))
    plan = tfa.attention_plan(b, h, sq, skv, causal=opts["causal"])
    parts = tref.flash_attention_partials(
        q, k, v, tfa.split_ranges(plan, skv), **opts)
    plain = tref.flash_attention_ref(q, k, v, **opts)
    limit = cs.ATTENTION_RMS_SHARE[dtype]
    _, _, share = cs.attention_within(label, tref.combine_partials(parts, q),
                                      plain, dtype, "plain")
    assert share < limit / 8
    o = sum(o_s for _, _, o_s in parts)
    l = sum(l_s for _, l_s, _ in parts)
    faults = {
        "piece dropped": tref.combine_partials(parts[1:], q),
        "no rescale": (o / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
        .reshape(b, sq, h, d).to(q.dtype),
    }
    for fault, out in faults.items():
        with pytest.raises(AssertionError, match="RMS share"):
            cs.attention_within(label, out, plain, dtype, fault)


# Phase 7's new head groupings at sizes the interpret mode runs quickly:
# (B, Sq, Skv, H, Kv, D) and options.
GROUPINGS = {
    "mqa G=48": ((1, 16, 192, 48, 1, 32), dict(causal=False)),
    "gqa G=8": ((1, 64, 128, 16, 2, 32), dict(causal=True)),
    "gqa G=7": ((1, 64, 128, 14, 2, 32), dict(causal=True)),
    "gqa G=6 window": ((1, 64, 192, 12, 2, 32),
                       dict(causal=True, window=40, q_offset=128)),
    "mha D=64": ((2, 64, 128, 3, 3, 64), dict(causal=True)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_plain_attention_matches_pallas_at_arch_groupings(grouping, dtype):
    """The port's plain attention (what the kernel is held to on the card)
    against the reference's Pallas kernel in interpret mode at each new
    head grouping, within the limits ``tests/test_kernels.py`` holds the
    Pallas kernel to."""
    (b, sq, skv, h, kv, d), opts = GROUPINGS[grouping]
    rng = np.random.default_rng(19)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = np.asarray(j_fa_kernel(*[jnp.asarray(a, jdt) for a in arrays],
                                  interpret=True, qb=16, kvb=64, **opts),
                      np.float32)
    out = tref.flash_attention_ref(
        *[torch.from_numpy(a).to(tdt) for a in arrays], **opts)
    tol = cs.ATTENTION_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.fixture
def no_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_serving_embeddings_matches_reference(no_sync):
    """``lm_serve`` with embedding rows (musicgen-medium: prompt 12, 3
    decode rows) on the reference's weights: every step's logits against
    the JAX package's prefill and decode of the same rows (RTOL), the rows
    fed as given and no greedy token fed back; ``full_pass_logits`` over
    prompt and rows equal to the decode within fp32 summation order; the
    logits [B, gen, 4, V] held over all four heads by
    ``decode_readings``."""
    jm, jp, tm, tp = pair("musicgen-medium")
    cfg = tm.cfg
    b, s, gen = 2, 12, 3
    rows = batch(cfg, seed=5, b=b, s=s + gen)["inputs"]
    prompts, fed = torch.from_numpy(rows[:, :s]), torch.from_numpy(rows[:, s:])
    run = cs.lm_serve(tm, prompts, gen, params=tp, rows=fed)
    heads = cfg.num_output_heads
    assert heads == 4 and run["logits"].shape == (b, gen, heads,
                                                  cfg.vocab_size)
    assert torch.equal(run["fed"], fed)
    assert run["greedy"].shape == run["logits"].shape[:-1]
    _, jc = jm.prefill(jp, jnp.asarray(rows[:, :s]), cache_capacity=s + gen)
    for i in range(gen):
        jlog, jc = jm.decode_step(jp, jnp.asarray(rows[:, s + i:s + i + 1]),
                                  jnp.asarray(s + i), jc)
        close(run["logits"][:, i], jlog, what=f"decode logits t={s + i}")
    full, launches = cs.full_pass_logits(tm, tp, prompts, run["fed"])
    assert launches == 0  # the CPU runs the plain version
    readings = cs.decode_readings(run["logits"], full)
    assert readings["rms_share"] < 1e-5 and readings["finite"]
    assert readings["tokens"] == b * gen
    assert readings["argmax_differ"] == 0
    bad = full.clone()  # a wrong head fails the four-head reading
    bad[:, :, heads - 1] = full[:, :, 0]
    assert cs.decode_readings(run["logits"], bad)["rms_share"] > 0.5


def _scaled_model(name, **over):
    """The reduced config (an MoE at capacity factor e / k: no token drops)
    with ``over``, its weights layer-scaled."""
    cfg = port_configs.ARCHS[name].reduced()
    if cfg.num_experts:
        over = {"capacity_factor": cfg.num_experts / cfg.top_k, **over}
    cfg = dataclasses.replace(cfg, **over)
    model = make_model(cfg, "cpu")
    return model, cs.layer_scale_(model, model.init(
        torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("name,over", [
    ("yi-6b", {}), ("granite-20b", {}), ("llava-next-mistral-7b", {}),
    ("musicgen-medium", {}), ("mixtral-8x22b", {"sliding_window": 8}),
    ("gemma2-2b", {"sliding_window": 8}), ("jamba-v0.1-52b", {})],
    ids=["yi-6b", "granite-20b", "llava-next-mistral-7b", "musicgen-medium",
         "mixtral-8x22b wrap", "gemma2-2b wrap", "jamba-v0.1-52b"])
def test_ring_check_and_planted_faults(name, over, no_sync):
    """The ring check on a sound decode (rope, learned and sinusoidal
    positions, none in jamba's attention, token and embedding inputs;
    mixtral-8x22b's ring and gemma2-2b's local rings cut to 8 slots, so
    they wrap; jamba's Mamba caches skipped): RMS share within fp32
    summation order and the slots' positions equal; the t - 1 decode
    moves the positions, the stale slot leaves them and reaches
    ``FAULT_MARGIN`` x ``LM_RMS_SHARE`` in values; ``write_slot`` is
    restored after each; a limit too loose to catch the stale slot by that
    margin raises."""
    model, params = _scaled_model(name, **over)
    cfg = model.cfg
    b, s, gen = 2, 12, 6
    data = batch(cfg, seed=6, b=b, s=s + gen)["inputs"]
    prompts = torch.from_numpy(data[:, :s])
    rows = torch.from_numpy(data[:, s:]) \
        if cfg.input_mode == "embeddings" else None
    run = cs.lm_serve(model, prompts, gen, params=params, rows=rows)
    caches = model.init_caches(b, s + gen)
    full, _ = cs.full_pass_logits(model, params, prompts, run["fed"],
                                  caches)
    ring = cs.ring_readings(run["caches"], caches, s, gen)
    assert ring["rms_share"] < 1e-5 and ring["positions_equal"]
    assert ring["attention_layers"] == cs.attention_layers(cfg) > 0
    assert cs.decode_readings(run["logits"], full)["rms_share"] < 1e-5
    write = tattention.write_slot
    out = cs.decode_fault_bracket(model, params, prompts, run["fed"], full,
                                  caches, cs.LM_RMS_SHARE, "archs")
    assert tattention.write_slot is write
    assert cs.DECODE_FAULTS == ("position t - 1", "stale ring slot")
    assert "positions" in out["position t - 1"]["caught_by"]
    stale = out["stale ring slot"]
    assert stale["ring_positions_equal"] and stale["caught_by"] == ["values"]
    assert stale["ring_rms_share"] >= cs.FAULT_MARGIN * cs.LM_RMS_SHARE
    with pytest.raises(AssertionError, match=r"\['stale ring slot'\]"):
        cs.decode_fault_bracket(model, params, prompts, run["fed"], full,
                                caches, 1.0, "archs")
    assert tattention.write_slot is write


class _HostGenerator(torch.Generator):
    """A generator that ignores ``device`` (the phase asks for CUDA)."""

    def __new__(cls, device=None):
        return super().__new__(cls)

    def __init__(self, device=None):
        super().__init__()


def test_redraw_differences(monkeypatch):
    """The weights ``mixer_serving`` serves (a seeded draw, layer-scaled)
    equal the same draw made again slice by slice; one changed element of
    one block leaf is found, and only there."""
    monkeypatch.setattr(torch, "Generator", _HostGenerator)
    model = make_model(port_configs.ARCHS["granite-20b"].reduced(), "cpu")
    params = cs.layer_scale_(model, model.init(
        torch.Generator(device="cuda").manual_seed(0)))
    assert cs.redraw_differences(model, params) == []
    leaves = tree_leaves(params)
    target = next(i for i, p in enumerate(leaves)
                  if p is tree_leaves(params["blocks"])[-1])
    leaves[target].view(-1)[3] += 1.0
    assert cs.redraw_differences(model, params) == [target]


def test_lm_batch_matches_the_parity_tests_batch():
    """Phase 19's gradient batch for the embeddings archs is
    ``tests/_torch_lm.py``'s (seed 0): rows [2, 32, D] and a label per
    head."""
    for name in ("llava-next-mistral-7b", "musicgen-medium"):
        cfg = port_configs.ARCHS[name].reduced()
        got, want = cs.lm_batch(cfg), batch(cfg, seed=0)
        for key in ("inputs", "labels"):
            np.testing.assert_array_equal(got[key], want[key])


def test_archs_phase_on_cpu(monkeypatch):
    """``archs_phase`` end to end on the CPU: the six reduced configs in
    bf16 (mixtral-8x22b's window cut to 48, so its ring wraps in decode),
    2 x 64 prompts, 6 decode steps, the attention kernel replaced by its
    plain version counting launches; the two serve drivers reduced; the six
    reduced configs' gradient check. Every check of the phase passes; one
    launch a layer a prefill and a decode step."""
    original = port_configs.get_arch

    def get_arch(name):
        cfg = original(name).reduced()
        over = {"dtype": "bfloat16"}
        if cfg.sliding_window:
            over["sliding_window"] = 48
        return dataclasses.replace(cfg, **over)

    def plain_attention(q, k, v, *, return_lse=False, **opts):
        mxq.count_launch("flash_attention")
        return tref.flash_attention_ref(q, k, v, return_lse=return_lse,
                                        **opts)

    def busy(fn):
        fn()
        return 0.0, None

    monkeypatch.setattr(port_configs, "get_arch", get_arch)
    monkeypatch.setattr(ops, "_path", lambda t: "cuda")
    monkeypatch.setattr(tfa, "flash_attention_cuda", plain_attention)
    monkeypatch.setattr(transformer, "resolve_device",
                        lambda d=None: torch.device("cpu"))
    monkeypatch.setattr(torch, "Generator", _HostGenerator)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(cs, "device_busy_ms", busy)
    monkeypatch.setattr(cs, "MIXER_GEN", 6)
    monkeypatch.setattr(cs, "ARCH_MODELS",
                        tuple((a, 2, 2, 64) for a, *_ in cs.ARCH_MODELS))
    monkeypatch.setattr(cs, "ARCH_DRIVER_ARGS", [
        "--reduced", "--device", "cpu", "--batch", "4", "--prompt-len", "16",
        "--gen", "32"])
    from repro_torch.launch import serve as serve_lib

    serve = serve_lib.serve

    def serve_on_cpu(argv, on_mesh=True):
        res = serve(argv, on_mesh=on_mesh)
        res["peak_bytes"] = 0
        return res
    monkeypatch.setattr(serve_lib, "serve", serve_on_cpu)

    out = cs.archs_phase()
    for arch, *_ in cs.ARCH_MODELS:
        got = out[arch]
        assert got["launches"] == {"prefill": 2, "decode_steps": [2] * 6}
        check = got["decode_vs_full"]
        assert check["rms_share"] <= cs.MIXER_RMS_SHARE
        assert check["ring"]["positions_equal"]
        for fault in cs.DECODE_FAULTS:
            assert check["faults"][fault]["caught_by"]
    assert "dropped_shares" in out["mixtral-8x22b"]
    for arch in cs.ARCH_DRIVERS:
        assert out["drivers"][arch]["launches"] == 2 * 32
    assert set(out["gradients"]) == {a for a, *_ in cs.ARCH_MODELS}
    assert all(v <= 1.0 for worst in out["gradients"].values()
               for v in worst.values())


def test_reroutes_mark_a_tokens_first_reroute():
    """``reroutes`` lists each (token, layer) flip in layer order with the
    full pass's gap p_k - p_(k+1) there and whether it is the token's
    first; ``route_flips`` keeps phase 14's summary over every flip."""
    s, gen, k, layers = 2, 2, 2, 2

    def top(gaps):  # [1, s + gen, k + 1] probabilities with these gaps
        t = torch.zeros(1, s + gen, k + 1)
        t[0, :, k - 1] = 0.3
        t[0, s:, k] = 0.3 - torch.tensor(gaps)
        return t

    idx = torch.tensor([0, 1]).expand(1, s + gen, k)
    full = [(idx, top([0.01, 0.4]), None), (idx, top([0.3, 0.2]), None)]
    moved = torch.tensor([[[0, 2]]])
    same = torch.tensor([[[0, 1]]])
    decoded = []
    for step in range(gen):
        for layer in range(layers):
            flip = step == 0  # token 0 reroutes in both layers
            decoded.append((moved if flip else same, None, None))
    flips, each = cs.reroutes(decoded, full, s, gen, k)
    assert flips.tolist() == [[True, False]]
    assert [(b, step, layer, first) for b, step, layer, _, first in each] \
        == [(0, 0, 0, True), (0, 0, 1, False)]
    assert [gap for *_, gap, _ in each] == pytest.approx([0.01, 0.3])
    flips, count, gap = cs.route_flips(decoded, full, s, gen, k)
    assert flips.tolist() == [[True, False]] and count == 2
    assert gap == pytest.approx(0.3)
