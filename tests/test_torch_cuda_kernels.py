"""The hand-written kernels on the card, beyond ``chip_smoke.py``'s shapes:
every head dim and dtype of the attention kernel over its options (ragged
edges, windows with and without causality, query offsets, kv splits with
fully masked rows, strided and misaligned inputs), and the MX GEMMs where
their contractions split, at every tile width (N from 8 to 1000, ragged M,
K from one MX block to 4608), at the stem's misaligned K = 147 read
contiguous and through transposed views, and with products in the fp32
subnormal range, each held to its plain version (``kernels/ref.py``) with
the tolerances of ``chip_smoke.py`` phases 6–7, the four kernels to the
bitwise contracts, and each repeated to show that the fixed-order splits
give the same bits. The backward pair (conversion stage, then staged
GEMMs) at every phase-6 GEMM and a ragged stem, bitwise the two fused
launches it replaces, with a wrong-axis dW that still fails the typical
limit; and a reduced ResNet18 SGD step, run twice, bit for bit the same
(deterministic cuDNN, set by ``device.resolve_device``).

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip without a card.
On the card (``--noconftest``: ``tests/conftest.py`` imports JAX, which the
port's card machine does not have):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.dacapo_pairs import RESNET18
from repro_torch.core.estimator import vision_gemms
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mx_fused as mxf
from repro_torch.kernels import mx_matmul as mxm
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


def _qkv(shape, d, dtype, dev, seed=0):
    b, sq, skv, h, kvh = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d))]


def _assert_attention(out, q, k, v, opts):
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    tol = ATTENTION_TOL[q.dtype]
    plan = fa.attention_plan(b, h, sq, skv, causal=opts["causal"],
                             window=opts.get("window"),
                             q_offset=opts.get("q_offset", 0))
    wants = [ref.flash_attention_ref(q, k, v, **opts)]
    if plan.splits > 1:
        wants.append(ref.flash_attention_split_ref(
            q, k, v, fa.split_ranges(plan, skv), **opts))
    for want in wants:
        assert out.shape == want.shape and out.dtype == want.dtype
        err = (out.float() - want.float()).abs()
        assert bool((err <= tol + tol * want.float().abs()).all()), float(
            err.max())
    dead = ~ref.attention_mask(sq, skv, causal=opts["causal"],
                               window=opts.get("window"),
                               q_offset=opts.get("q_offset", 0),
                               device=q.device).any(-1)
    assert bool((out[:, dead] == 0).all())
    return plan


# (B, Sq, Skv, H, Kv), options, and the kv pieces the plan gives.
ATTENTION_CASES = {
    "ragged non-causal": ((2, 70, 70, 4, 2), dict(causal=False), 1),
    "ragged causal": ((2, 70, 70, 4, 2), dict(causal=True), 1),
    "window softcap": ((1, 150, 150, 4, 4),
                       dict(causal=True, window=40, softcap=20.0), 1),
    "window only": ((1, 130, 130, 2, 1), dict(causal=False, window=33), 1),
    "offset, Sq < Skv": ((1, 40, 200, 4, 2),
                         dict(causal=True, q_offset=160), 1),
    "decode split": ((1, 16, 1024, 2, 1), dict(causal=True, q_offset=1008),
                     4),
    "decode split window": ((1, 16, 1024, 2, 1),
                            dict(causal=True, window=600, q_offset=1008), 2),
    "split, masked rows": ((1, 1032, 1024, 2, 2),
                           dict(causal=True, q_offset=-8), 4),
}


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_matches_plain(card, case, dtype, d):
    shape, opts, pieces = ATTENTION_CASES[case]
    q, k, v = _qkv(shape, d, dtype, card)
    out = fa.flash_attention_cuda(q, k, v, **opts)
    again = fa.flash_attention_cuda(q, k, v, **opts)
    torch.cuda.synchronize()
    assert _assert_attention(out, q, k, v, opts).splits == pieces
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_attention_reads_strided_and_copies_misaligned(card, dtype):
    """The ViT's q, k, v slices of one qkv tensor are read in place; a view
    whose rows are not 16-byte aligned is copied first. Either way the
    result is the contiguous call's, bit for bit."""
    b, s, h, d = 2, 37, 4, 64
    gen = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=card).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    want = fa.flash_attention_cuda(*(t.contiguous() for t in (q, k, v)),
                                   causal=False)
    assert torch.equal(fa.flash_attention_cuda(q, k, v, causal=False), want)
    wide = torch.randn((b, s, h, d + 1), generator=gen,
                       device=card).to(dtype)
    odd = wide[..., :d]  # rows of d + 1 elements: not 16-byte aligned
    odd_out = fa.flash_attention_cuda(odd, odd, odd, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(odd_out, fa.flash_attention_cuda(
        *(odd.contiguous(),) * 3, causal=True))
    _assert_attention(odd_out, odd, odd, odd, dict(causal=True))


def _within_limits(out, plain, aq, bq_nk):
    worst, typical = ref.gemm_error_limits(aq, bq_nk)
    err = (out - plain).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((err <= worst).all()) and bool((err <= typical).all())


def _qd(x, precision):
    return ref.mx_quant_dequant_ref(ops._pad_last(x, ref.BLOCK)[0]
                                    .contiguous(), precision)


# (M, N, K): few output tiles over a long contraction, so every kernel
# splits; the second is ragged in M, N and K.
SPLIT_GEMMS = [(16, 64, 2048), (40, 24, 3000), (300, 200, 1100)]


@pytest.mark.parametrize("precision", ["mx6", "mx9"])
@pytest.mark.parametrize("shape", SPLIT_GEMMS, ids=str)
def test_split_gemms_match_plain_and_each_other(card, shape, precision):
    """fused = unfused = prequant bitwise, within both limits of the plain
    version and of the plain split, and the same bits on a second call."""
    m, n, k = shape
    assert mxf.fused_plan(m, n, k)[0] > 1
    gen = torch.Generator(device=card).manual_seed(2)
    a = torch.randn((m, k), generator=gen, device=card)
    b = torch.randn((k, n), generator=gen, device=card)
    qb = ops.mx_quantize_rhs(b, precision)
    fused = mxf.mx_matmul_fused_cuda(a, b, precision, precision)
    prequant = mxf.mx_matmul_prequant_cuda(a, qb, precision)
    unfused = mxm.mx_matmul_cuda(ops.mx_quantize(a, precision), qb)
    again = mxf.mx_matmul_fused_cuda(a, b, precision, precision)
    torch.cuda.synchronize()
    assert torch.equal(fused, prequant) and torch.equal(fused, unfused)
    assert torch.equal(fused, again)
    aq, bq = _qd(a, precision), _qd(b.T, precision)
    kp = aq.shape[1]
    _within_limits(fused, ref._matmul_nt(aq, bq), aq, bq)
    _within_limits(fused, ref.mx_matmul_split_ref(
        aq, bq, mxm.split_chunks(kp, *mxf.fused_plan(m, n, k))), aq, bq)


# g [M, N], x [M, K], w [K, N]: the pair's dW contracts over M and splits.
# The stage reads x's rows of K = 147 as one span a tile and those of
# K = 301 (wider than a tile, not 16-byte aligned) 4 bytes a load.
PAIR_SHAPES = [(3000, 40, 24), (5000, 64, 147), (3000, 40, 301)]


@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=str)
def test_split_pair_equals_two_fused(card, shape):
    m, n, k = shape
    assert mxf.pair_plans(m, n, k)[1][0] > 1
    gen = torch.Generator(device=card).manual_seed(3)
    g = torch.randn((m, n), generator=gen, device=card)
    x = torch.randn((m, k), generator=gen, device=card)
    w = torch.randn((k, n), generator=gen, device=card)
    dx, dw = mxf.mx_matmul_bwd_pair_cuda(g, x, w, "mx9")
    dx2, dw2 = mxf.mx_matmul_bwd_pair_cuda(g, x, w, "mx9")
    torch.cuda.synchronize()
    assert torch.equal(dx, mxf.mx_matmul_fused_cuda(g, w.T, "mx9", "mx9"))
    assert torch.equal(dw, mxf.mx_matmul_fused_cuda(x.T, g, "mx9", "mx9"))
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    xq, gq = _qd(x.T, "mx9"), _qd(g.T, "mx9")
    _within_limits(dw, ref._matmul_nt(xq, gq), xq, gq)
    gq1, wq = _qd(g, "mx9"), _qd(w, "mx9")
    _within_limits(dx, ref._matmul_nt(gq1, wq), gq1, wq)


def _gemm_operands(m, n, k, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev)
            for s in ((m, k), (k, n), (m, n))]


def _assert_gemm_family(a, b, g, precision):
    """One GEMM a [M, K] @ b [K, N] through all four kernels: fused =
    unfused = prequant and the pair (cotangent g [M, N]) = two fused,
    bitwise; each within both limits of its plain version; a second call
    of each gives the same bits."""
    qb = ops.mx_quantize_rhs(b, precision)
    fused = mxf.mx_matmul_fused_cuda(a, b, precision, precision)
    prequant = mxf.mx_matmul_prequant_cuda(a, qb, precision)
    unfused = mxm.mx_matmul_cuda(ops.mx_quantize(a, precision), qb)
    dx, dw = mxf.mx_matmul_bwd_pair_cuda(g, a, b, precision)
    again = (mxf.mx_matmul_fused_cuda(a, b, precision, precision),
             mxf.mx_matmul_prequant_cuda(a, qb, precision),
             *mxf.mx_matmul_bwd_pair_cuda(g, a, b, precision))
    torch.cuda.synchronize()
    assert torch.equal(fused, prequant) and torch.equal(fused, unfused)
    assert torch.equal(dx, mxf.mx_matmul_fused_cuda(g, b.T, precision,
                                                    precision))
    assert torch.equal(dw, mxf.mx_matmul_fused_cuda(a.T, g, precision,
                                                    precision))
    for first, second in zip((fused, prequant, dx, dw), again):
        assert torch.equal(first, second)
    aq, bq = _qd(a, precision), _qd(b.T, precision)
    _within_limits(fused, ref._matmul_nt(aq, bq), aq, bq)
    gq, wq = _qd(g, precision), _qd(b, precision)
    _within_limits(dx, ref._matmul_nt(gq, wq), gq, wq)
    xq, gq2 = _qd(a.T, precision), _qd(g.T, precision)
    _within_limits(dw, ref._matmul_nt(xq, gq2), xq, gq2)


# Every tile width (N = 8 and 64 take 64-wide tiles, the rest 128), ragged
# and one-row M, and K from one MX block to layer4's 4608.
@pytest.mark.parametrize("k", [16, 147, 4608])
@pytest.mark.parametrize("n", [8, 64, 100, 128, 256, 1000])
@pytest.mark.parametrize("m", [1, 63, 64, 130])
def test_gemm_tiles_match_plain_and_contracts(card, m, n, k):
    a, b, g = _gemm_operands(m, n, k, card, seed=m * 7 + n * 3 + k)
    _assert_gemm_family(a, b, g, "mx9" if (m + n + k) % 2 else "mx6")


@pytest.mark.parametrize("rhs_strided", [False, True],
                         ids=["lhs-strided", "both-strided"])
def test_gemm_stem_k147_contiguous_and_strided(card, rhs_strided):
    """The stem's misaligned K = 147 (588-byte rows): read contiguous, and
    as transposed views (strides (1, M) and (1, K)) — the same bits as the
    contiguous call, within both limits of the plain version."""
    m, n, k = 1000, 64, 147
    gen = torch.Generator(device=card).manual_seed(4)
    a_t = torch.randn((k, m), generator=gen, device=card)
    b_t = torch.randn((n, k), generator=gen, device=card)
    a, b = a_t.T, (b_t.T if rhs_strided else b_t.T.contiguous())
    want = mxf.mx_matmul_fused_cuda(a.contiguous(), b.contiguous(), "mx9",
                                    "mx9")
    got = mxf.mx_matmul_fused_cuda(a, b, "mx9", "mx9")
    qb = ops.mx_quantize_rhs(b.contiguous(), "mx6")
    pre = mxf.mx_matmul_prequant_cuda(a, qb, "mx6")
    pre_c = mxf.mx_matmul_prequant_cuda(a.contiguous(), qb, "mx6")
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(pre, pre_c)
    aq, bq = _qd(a, "mx9"), _qd(b.T, "mx9")
    _within_limits(got, ref._matmul_nt(aq, bq), aq, bq)
    _assert_gemm_family(a.contiguous(), b.contiguous(),
                        torch.randn((m, n), generator=gen, device=card),
                        "mx9")


@pytest.mark.parametrize("k", [147, 4608])
def test_gemm_subnormal_scales(card, k):
    """Blocks whose shared exponent is at most -120 (values near 2^-125)
    against O(1) operands — whole rhs columns, one K-block of the other
    columns, one lhs row — held to both limits of the plain version. A
    dequantized value is never subnormal (a nonzero input is at least
    2^-126 and rounds to a multiple of a power of two), but the lhs row's
    products with the O(1) columns are fp32 subnormals, exact in the plain
    fp32 matmul: the tensor cores must not flush them."""
    m, n = 130, 100
    a, b, g = _gemm_operands(m, n, k, card, seed=5)
    tiny = 2.0 ** -125
    b[:, :8] *= tiny
    b[16:32, 8:] *= tiny
    a[0] *= tiny
    g[:, :4] *= tiny
    aq, bq = _qd(a, "mx9"), _qd(b.T, "mx9")
    exps = torch.frexp(torch.cat([bq[:8], aq[:1]]).abs().amax(1))[1] - 1
    assert bool((exps <= -120).all())
    prods = aq[0] * bq[8:]
    assert bool(((prods != 0) & (prods.abs() < 2.0 ** -126)).any())
    _assert_gemm_family(a, b, g, "mx9")


def _bits(t):
    return t.contiguous().view(torch.int32)


# The pair's shapes: phase 6's GEMMs (full-width ResNet18 at batch 32, each
# (M, N, K) once), the stem's K = 147 at a ragged M (dX's 152-wide tile) and
# a K in (128, 152] at N > 64 (dX's 128-wide tiles).
PAIR_PHASE6 = sorted(set(vision_gemms(RESNET18, batch=32))) + [
    (4999, 64, 147), (3000, 128, 144)]


@pytest.mark.parametrize("shape", PAIR_PHASE6, ids=str)
def test_pair_at_phase6_shapes_equals_two_fused(card, shape):
    """dX and dW bitwise fused(g, w^T) and fused(x^T, g); the conversion
    stage equal to its plain version; both outputs within both limits of
    the plain pair."""
    m, n, k = shape
    x, w, g = _gemm_operands(m, n, k, card, seed=m + n + k)
    dx, dw = mxf.mx_matmul_bwd_pair_cuda(g, x, w, "mx9")
    stage = mxf.pair_stage_cuda(g, x, w, "mx9")
    plain = ref.mx_pair_stage_ref(g, x, w, "mx9")
    torch.cuda.synchronize()
    assert torch.equal(_bits(dx), _bits(mxf.mx_matmul_fused_cuda(
        g, w.T, "mx9", "mx9")))
    assert torch.equal(_bits(dw), _bits(mxf.mx_matmul_fused_cuda(
        x.T, g, "mx9", "mx9")))
    for key, t in plain.items():
        assert torch.equal(stage[key][:, :t.shape[1]], t), key
    del stage, plain
    gq, wq = _qd(g, "mx9"), _qd(w, "mx9")
    _within_limits(dx, ref._matmul_nt(gq, wq), gq, wq)
    del gq, wq
    xq, gq2 = _qd(x.T, "mx9"), _qd(g.T, "mx9")
    _within_limits(dw, ref._matmul_nt(xq, gq2), xq, gq2)


@pytest.mark.parametrize("shape", [(25088, 128, 1152), (4999, 64, 147)],
                         ids=str)
def test_pair_wrong_axis_dw_fails_the_typical_limit(card, shape):
    """The control of phase 6: the pair's dW passes the typical limit of
    the plain dW, while a dW of g quantized along N (the wrong axis) does
    not."""
    m, n, k = shape
    x, w, g = _gemm_operands(m, n, k, card, seed=11)
    _, dw = mxf.mx_matmul_bwd_pair_cuda(g, x, w, "mx9")
    xq, gq = _qd(x.T, "mx9"), _qd(g.T, "mx9")
    plain = ref._matmul_nt(xq, gq)
    pad_m = (-m) % 16
    wrong = ref._matmul_nt(xq, torch.nn.functional.pad(
        _qd(g, "mx9")[:, :n], (0, 0, 0, pad_m)).T.contiguous())
    _, typical = ref.gemm_error_limits(xq, gq)
    assert bool(((dw - plain).abs() <= typical).all())
    assert not bool(((wrong - plain).abs() <= typical).all())


def test_reduced_resnet18_sgd_step_repeats_bitwise(card):
    """Two SGD steps of the reduced ResNet18 from the same weights and
    batch give the same parameters bit for bit: the convolutions' weight
    gradients (cuDNN) are deterministic on the card."""
    from repro_torch.core.kernel import sgd_momentum_step
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_leaves, tree_map

    cfg = RESNET18.reduced()
    model = make_vision_model(cfg, card)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (32, cfg.img_size, cfg.img_size, 3)).astype(np.float32)).to(card)
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, 32)).to(card)
    runs = []
    for _ in range(2):
        p, opt = params, tree_map(torch.zeros_like, params)
        for _ in range(3):
            p, opt, _ = sgd_momentum_step(model, p, opt, x, y, 0.05)
        runs.append(p)
    torch.cuda.synchronize()
    assert torch.backends.cudnn.deterministic is True
    for a, b in zip(tree_leaves(runs[0]), tree_leaves(runs[1])):
        assert torch.equal(_bits(a), _bits(b))
