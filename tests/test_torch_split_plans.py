"""The split plans of the port's two redesigned kernels, and the plain
versions of the splits, against the JAX package.

* GEMMs (``csrc/mx_gemm.cu``): ``mx_matmul.gemm_split_plan`` cuts a long
  contraction into chunks on MX-block boundaries; the partials are summed in
  the fixed order s = 0..S-1 (``ref.mx_matmul_split_ref``). Checked on
  ResNet18's 21 GEMMs at batch 32 and each one's pair dX / dW, and held to
  the JAX package's ``mx_matmul_fused_ref`` within ``gemm_error_limits``
  (a chunked sum is one more summation order).
* Attention (``csrc/flash_attention.cu``): ``flash_attention.attention_plan``
  cuts the kv range into pieces where the CTAs cannot fill the card; the
  partials merge in the fixed order s = 0..S-1
  (``ref.flash_attention_split_ref``). Checked at ``chip_smoke.py``'s phase-7
  cases, and held to the Pallas kernel in interpret mode within 2e-5 (fp32)
  / 2e-2 (bf16), fully masked rows included. Phase 7's check is shown to
  fail a combine that drops a piece or skips the rescale.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_gemm_bound import assert_gemm_close, pad16, qd

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_fa_kernel
from repro_torch.configs.dacapo_pairs import RESNET18
from repro_torch.core.estimator import vision_gemms
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mx_fused as tmf
from repro_torch.kernels import mx_matmul as tmm
from repro_torch.kernels import ref as tref

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread per test worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad16(k: int) -> int:
    return -(-k // 16) * 16


# ResNet18's 21 GEMMs at batch 32, as the estimator lists them.
RESNET18_GEMMS = vision_gemms(RESNET18, batch=32)


def _assert_plan_covers(m: int, n: int, kp: int, plan) -> None:
    splits, chunk = plan
    chunks = tmm.split_chunks(kp, splits, chunk)
    assert chunk % 16 == 0 and splits >= 1
    assert chunks[0][0] == 0 and chunks[-1][1] == kp
    for (lo, hi), (lo_next, _) in zip(chunks, chunks[1:] + [(kp, kp)]):
        assert lo % 16 == 0 and lo < hi == lo_next
    tiles = -(-m // tmm.TILE_M) * -(-n // tmm.tile_n(n))
    assert tiles == tmm.gemm_tiles(m, n)
    if 2 * tiles > tmm.SMS:
        assert splits == 1
    # One wave: every (tile, chunk) unit has a persistent CTA of its own.
    assert splits == 1 or tiles * splits <= tmm.WAVE_CTAS


@pytest.mark.parametrize("shape", RESNET18_GEMMS, ids=str)
def test_gemm_plans_cover_the_contraction(shape):
    """Forward, pair dX and pair dW of each GEMM: chunks on 16-multiples
    cover [0, Kp) exactly, S = 1 where the tiles fill half of 132 SMs or
    more, at most one unit a CTA where S > 1, and the pair's plans are
    those of fused(g, w^T) and fused(x^T, g)."""
    m, n, k = shape
    _assert_plan_covers(m, n, _pad16(k), tmf.fused_plan(m, n, k))
    plan_dx, plan_dw = tmf.pair_plans(m, n, k)
    assert plan_dx == tmf.fused_plan(m, k, n)
    assert plan_dw == tmf.fused_plan(k, n, m)
    _assert_plan_covers(m, k, _pad16(n), plan_dx)
    _assert_plan_covers(k, n, _pad16(m), plan_dw)


def test_gemm_plans_split_the_few_tile_contractions():
    """The pair's dW at the stem (2 tiles over M = 401,408: one 64-wide
    tile column) and every layer1 dW split; every forward of the stem and
    layer1 (thousands of tiles) does not."""
    stem = RESNET18_GEMMS[0]
    assert stem == (401408, 64, 147)
    assert tmm.gemm_tiles(147, 64) == 2
    assert tmf.pair_plans(*stem)[1][0] == tmm.WAVE_CTAS // 2 == 66
    for m, n, k in RESNET18_GEMMS[:5]:
        assert tmf.fused_plan(m, n, k)[0] == 1
        assert tmf.pair_plans(m, n, k)[1][0] > 1
    # A short contraction never splits, however few its tiles.
    assert tmm.gemm_split_plan(32, 1000, 512) == (1, 512)


@pytest.mark.parametrize("n, width", [(1, 64), (8, 64), (64, 64),
                                      (65, 128), (100, 128), (128, 128),
                                      (256, 128), (1000, 128)])
def test_tile_width_is_a_function_of_n(n, width):
    """The kernel's tile is TILE_M x tile_n(N): 64 columns up to N = 64
    (the stem and layer1 fill their tiles), else 128."""
    assert tmm.TILE_M == 128
    assert tmm.tile_n(n) == width
    assert tmm.gemm_tiles(130, n) == 2 * -(-n // width)


# The card tests' shapes (tests/test_torch_cuda_kernels.py): every tile
# width, ragged M, and K from one MX block to layer4's 4608.
CARD_MS, CARD_NS, CARD_KS = (1, 63, 64, 130), (8, 64, 100, 128, 256,
                                                1000), (16, 147, 4608)


@pytest.mark.parametrize("k", CARD_KS)
@pytest.mark.parametrize("m", CARD_MS)
def test_gemm_plans_cover_card_shapes(m, k):
    """At every shape of the card tests the plans of the forward and of the
    pair cover [0, Kp) on 16-multiples, keep one wave of units, and the
    pair's plans are the two fused plans."""
    for n in CARD_NS:
        _assert_plan_covers(m, n, _pad16(k), tmf.fused_plan(m, n, k))
        plan_dx, plan_dw = tmf.pair_plans(m, n, k)
        assert plan_dx == tmf.fused_plan(m, k, n)
        assert plan_dw == tmf.fused_plan(k, n, m)
        _assert_plan_covers(m, k, _pad16(n), plan_dx)
        _assert_plan_covers(k, n, _pad16(m), plan_dw)
    # One tile over the longest contraction splits; one MX block never.
    assert tmf.fused_plan(m, 8, 4608)[0] > 1
    assert tmf.fused_plan(m, 1000, 16) == (1, 16)


def _jax_fused(a: np.ndarray, b: np.ndarray, precision: str) -> np.ndarray:
    """The JAX package's fused oracle on K padded to 16."""
    pad = (-a.shape[1]) % 16
    return np.asarray(jref.mx_matmul_fused_ref(
        jnp.asarray(pad16(a)), jnp.asarray(np.pad(b, [(0, pad), (0, 0)])),
        precision, precision))


# (m, n, k): few tiles over a long contraction, so the plan splits; the
# second is ragged in all three dimensions.
SPLIT_GEMMS = [(16, 64, 2048), (40, 24, 3000)]


@pytest.mark.parametrize("precision", ["mx6", "mx9"])
@pytest.mark.parametrize("shape", SPLIT_GEMMS, ids=str)
def test_split_gemm_ref_matches_jax(shape, precision):
    """The plain split (chunk partials, then the fixed-order sum) of the
    plan for fused(a, b) and for the pair's dW = fused(x^T, g) is within
    both summation-order limits of the JAX package's fused oracle."""
    m, n, k = shape
    rng = np.random.default_rng(11)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    splits, chunk = tmf.fused_plan(m, n, k)
    assert splits > 1
    aq, bq = qd(a, precision), qd(b.T, precision)
    out = tref.mx_matmul_split_ref(
        torch.from_numpy(aq), torch.from_numpy(bq),
        tmm.split_chunks(_pad16(k), splits, chunk)).numpy()
    assert_gemm_close(out, _jax_fused(a, b, precision), aq, bq)
    # The pair's dW for x [k, m] and g [k, n]: contracted over k.
    x, g = a.T.copy(), b
    plan_dw = tmf.pair_plans(k, n, m)[1]
    assert plan_dw == (splits, chunk)
    xq, gq = qd(x.T, precision), qd(g.T, precision)
    dw = tref.mx_matmul_split_ref(
        torch.from_numpy(xq), torch.from_numpy(gq),
        tmm.split_chunks(_pad16(k), *plan_dw)).numpy()
    assert_gemm_close(dw, _jax_fused(x.T, g, precision), xq, gq)


def test_split_gemm_ref_sums_in_fixed_order():
    """The partials are added in the order s = 0..S-1, starting from the
    first partial; one chunk is the unsplit matmul."""
    rng = np.random.default_rng(12)
    aq = torch.from_numpy(qd(rng.normal(size=(8, 96)).astype(np.float32),
                             "mx9"))
    bq = torch.from_numpy(qd(rng.normal(size=(4, 96)).astype(np.float32),
                             "mx9"))
    chunks = [(0, 32), (32, 64), (64, 96)]
    parts = [tref._matmul_nt(aq[:, lo:hi], bq[:, lo:hi]) for lo, hi in chunks]
    assert torch.equal(tref.mx_matmul_split_ref(aq, bq, chunks),
                       (parts[0] + parts[1]) + parts[2])
    assert torch.equal(tref.mx_matmul_split_ref(aq, bq, [(0, 96)]),
                       tref._matmul_nt(aq, bq))


# Phase 7's cases and the kv split count the plan gives each: only the
# decode-append (16 CTAs of 64 rows against 8192 keys), in bf16 and fp32,
# splits.
EXPECTED_SPLITS = {
    "vit-b16 224px batch 32": 1,
    "vit-b32 224px batch 32": 1,
    "gqa causal": 1,
    "gemma2-2b local layer": 1,
    "decode-append": 16,
    "decode-append fp32": 16,
    "fully masked rows": 1,
}


@pytest.mark.parametrize("case", chip_smoke.ATTENTION_CASES,
                         ids=lambda c: c[0])
def test_attention_plan_at_phase7_cases(case):
    """The split count, and kv pieces on 64-key boundaries that cover the
    causal / window range of every row, in order and without overlap."""
    label, (b, sq, skv, h, _, _), _, opts = case
    kw = dict(causal=opts["causal"], window=opts.get("window"),
              q_offset=opts.get("q_offset", 0))
    plan = tfa.attention_plan(b, h, sq, skv, **kw)
    assert plan.splits == EXPECTED_SPLITS[label]
    ranges = tfa.split_ranges(plan, skv)
    assert len(ranges) == plan.splits
    for (lo, hi), (lo_next, _) in zip(ranges, ranges[1:]):
        assert hi == lo_next and lo % tfa.SPLIT_KEYS == 0
    mask = tref.attention_mask(sq, skv, **kw)
    covered = torch.zeros(skv, dtype=torch.bool)
    for lo, hi in ranges:
        covered[lo:hi] = True
    assert bool(covered[mask.any(0)].all())
    lo, hi = tfa.kv_range(sq, skv, **kw)
    assert bool(mask[:, lo:hi].any(0).all()) and not bool(
        mask[:, :lo].any() or mask[:, hi:].any())


def _attn_inputs(shape, dtype, seed):
    b, sq, skv, h, kv, d = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# (shape (B, Sq, Skv, H, Kv, D), options, kv pieces or None for the plan's):
# a decode-append the plan splits; fixed pieces with fully masked rows
# (every piece of the first rows has l = 0), a window that leaves pieces
# empty, and a softcap.
SPLIT_ATTENTION = {
    "decode-append plan": ((1, 16, 512, 2, 1, 32),
                           dict(causal=True, q_offset=496), None),
    "masked rows": ((1, 64, 256, 2, 1, 32), dict(causal=True, q_offset=-32),
                    [(0, 64), (64, 128), (128, 192), (192, 256)]),
    "window softcap": ((1, 64, 256, 4, 2, 32),
                       dict(causal=True, window=40, softcap=20.0,
                            q_offset=150),
                       [(0, 64), (64, 128), (128, 192), (192, 256)]),
    "non-causal": ((2, 32, 192, 2, 2, 16), dict(causal=False),
                   [(0, 64), (64, 128), (128, 192)]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SPLIT_ATTENTION))
def test_split_attention_ref_matches_pallas_kernel(case, dtype):
    shape, opts, ranges = SPLIT_ATTENTION[case]
    b, sq, skv, h, _, _ = shape
    if ranges is None:
        plan = tfa.attention_plan(b, h, sq, skv, causal=opts["causal"],
                                  window=opts.get("window"),
                                  q_offset=opts["q_offset"])
        assert plan.splits > 1
        ranges = tfa.split_ranges(plan, skv)
    js, ts = _attn_inputs(shape, dtype, seed=13)
    out = tref.flash_attention_split_ref(*ts, ranges, **opts)
    assert out.dtype == ts[0].dtype
    out = out.float().numpy()
    want = np.asarray(j_fa_kernel(*js, interpret=True, qb=64, kvb=64,
                                  **opts), np.float32)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out, want, rtol=tol, atol=tol)
    dead = ~tref.attention_mask(sq, skv, causal=opts["causal"],
                                window=opts.get("window"),
                                q_offset=opts.get("q_offset", 0)).any(-1)
    assert np.all(out[:, dead.numpy()] == 0.0)
    if case == "masked rows":
        assert dead.sum() == 32


# Phase 7's cases that the plan splits: where each row averages 8192 keys.
PHASE7_SPLIT_CASES = [c for c in chip_smoke.ATTENTION_CASES
                      if EXPECTED_SPLITS[c[0]] > 1]


def _rms_share(out: torch.Tensor, want: torch.Tensor) -> float:
    err = out.float() - want.float()
    return float(err.square().mean().sqrt()
                 / want.float().square().mean().sqrt())


@pytest.mark.parametrize("case", PHASE7_SPLIT_CASES, ids=lambda c: c[0])
def test_phase7_check_fails_a_faulty_combine(case):
    """``chip_smoke.attention_within`` passes the plain split at phase 7's
    split cases and fails two faulty combines of the same partials — piece
    0 dropped, and the partials summed without their e^(m_s - m) rescale —
    whose RMS share lies far above its limit."""
    label, (b, sq, skv, h, kv, d), dtype, opts = case
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen).to(getattr(torch, dtype))
               for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
    plan = tfa.attention_plan(b, h, sq, skv, causal=opts["causal"],
                              q_offset=opts["q_offset"])
    parts = tref.flash_attention_partials(
        q, k, v, tfa.split_ranges(plan, skv), **opts)
    plain = tref.flash_attention_ref(q, k, v, **opts)
    limit = chip_smoke.ATTENTION_RMS_SHARE[dtype]
    _, _, share = chip_smoke.attention_within(
        label, tref.combine_partials(parts, q), plain, dtype, "plain")
    assert share < limit / 8
    o = sum(o_s for _, _, o_s in parts)
    l = sum(l_s for _, l_s, _ in parts)
    faults = {
        "piece dropped": tref.combine_partials(parts[1:], q),
        "no rescale": (o / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
        .reshape(b, sq, h, d).to(q.dtype),
    }
    for fault, out in faults.items():
        assert _rms_share(out, plain) > 8 * limit, fault
        with pytest.raises(AssertionError, match="RMS share"):
            chip_smoke.attention_within(label, out, plain, dtype, fault)
