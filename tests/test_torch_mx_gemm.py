"""Parity of the port's MX GEMMs (plain versions, CPU) with the JAX package:
``ops.mx_matmul``, ``mx_matmul_fused``, ``mx_matmul_bwd_pair`` and
``mx_matmul_prequant`` against the JAX package's entries run in its ``ref``
mode (jnp oracles) and ``interpret`` mode (the Pallas kernels, interpreted).

Tolerance: the quantized operands agree bitwise. The products agree within
``2·Kp·2⁻²⁴·(|A_q| @ |B_q|)`` elementwise (Kp = K padded to 16; A_q, B_q
the dequantized operands): a product of two dequantized MX values has at
most 8 + 8 significant bits, so it is exact in fp32, and the two sides can
differ only in the order of summation — this is the standard bound on the
difference of two fp32 summation orders of the same exact terms. They also
agree within the typical limit
``TYPICAL_C·sqrt(Kp)·2⁻²⁴·sqrt(A_q² @ B_q²)`` for zero-mean operands,
which a wrong output cannot pass over a long contraction (``tests/_torch_gemm_bound.py``).

Inputs are N(0,1), where every MX scale exponent stays inside the range
in which the reference's ``jnp.exp2`` is exact (|n| ≤ 12). One case at
gradient magnitude (cotangent ~1e-4) leaves that range: the port is held
to an exact float64 oracle there, and its differences from JAX lie only
where JAX's ``exp2`` is inexact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_gemm_bound import assert_gemm_close as _assert_close
from _torch_gemm_bound import gemm_excess as _gemm_excess
from _torch_gemm_bound import pad16 as _pad16
from _torch_gemm_bound import qd as _qd

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mx_fused as tmf
from repro_torch.kernels import mx_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (m, k, n): the shapes of bench_dispatch and tests/test_mx.py, a ragged
# one (K, N and M off every alignment), and one with blocks of zeros.
SHAPES = [(16, 432, 64), (32, 128, 64), (8, 128, 128), (5, 33, 48),
          "zeros"]
PAIRS = [("mx4", "mx4"), ("mx6", "mx6"), ("mx9", "mx9")]
MODES = ["ref", "interpret"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread per test worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed: int = 0):
    """a [m, k], b [k, n], g [m, n], N(0,1) float32 from a seeded numpy
    generator. ``"zeros"``: (8, 128, 128) with all-zero 16-blocks along K
    and N and an all-zero row (zero blocks along M for the pair's dW)."""
    m, k, n = (8, 128, 128) if shape == "zeros" else shape
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    if shape == "zeros":
        a[:, 32:64] = 0.0
        a[2] = 0.0
        g[:, 32:64] = 0.0
        g[3] = 0.0
    return a, b, g


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same_q(port_q, jax_q) -> None:
    for p, j in ((port_q.mantissa, jax_q.mantissa),
                 (port_q.exponent, jax_q.exponent),
                 (port_q.mx_bits, jax_q.mx_bits)):
        j = np.asarray(j)
        assert p.shape == j.shape and p.numpy().dtype == j.dtype
        np.testing.assert_array_equal(p.numpy().view(np.uint8),
                                      j.view(np.uint8))


def _gemm_jax(op: str, a, b, pa: str, pb: str):
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if op == "mx_matmul_prequant":
        return jops.mx_matmul_prequant(ja, jops.mx_quantize_rhs(jb, pb), pa)
    return getattr(jops, op)(ja, jb, pa, pb)


def _gemm_port(op: str, a, b, pa: str, pb: str) -> torch.Tensor:
    if op == "mx_matmul_prequant":
        return tops.mx_matmul_prequant(_t(a), tops.mx_quantize_rhs(_t(b), pb),
                                       pa)
    return getattr(tops, op)(_t(a), _t(b), pa, pb)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("pa,pb", PAIRS)
@pytest.mark.parametrize("op", ["mx_matmul", "mx_matmul_fused",
                                "mx_matmul_prequant"])
def test_gemm_matches_jax(monkeypatch, mode, shape, pa, pb, op):
    monkeypatch.setenv("REPRO_KERNEL_MODE", mode)
    a, b, _ = _inputs(shape)
    tops.reset_kernel_stats()
    out = _gemm_port(op, a, b, pa, pb)
    assert tops.kernel_stats()[op] == {"plain": 1}
    _assert_close(out.numpy(), _gemm_jax(op, a, b, pa, pb), _qd(a, pa),
                  _qd(b.T, pb))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("precision", ["mx4", "mx6", "mx9"])
def test_bwd_pair_matches_jax(monkeypatch, mode, shape, precision):
    monkeypatch.setenv("REPRO_KERNEL_MODE", mode)
    x, w, g = _inputs(shape, seed=1)
    dx, dw = tops.mx_matmul_bwd_pair(_t(g), _t(x), _t(w), precision)
    jdx, jdw = jops.mx_matmul_bwd_pair(jnp.asarray(g), jnp.asarray(x),
                                       jnp.asarray(w), precision)
    # dX contracts g and w^T over N; dW contracts x^T and g over M.
    _assert_close(dx.numpy(), jdx, _qd(g, precision), _qd(w, precision))
    _assert_close(dw.numpy(), jdw, _qd(x.T, precision), _qd(g.T, precision))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("precision", ["mx4", "mx6", "mx9"])
def test_quantized_operands_match_jax_bitwise(shape, precision):
    """Every operand view the GEMMs quantize — a and b^T along K, g along
    N (dX) and along M (dW), x^T along M — is bitwise the reference's."""
    a, b, g = _inputs(shape)
    for x in (a, b.T, g, g.T, a.T):
        _assert_same_q(tops.mx_quantize(_t(x), precision),
                       jref.mx_quantize_ref(jnp.asarray(_pad16(x)),
                                            precision))
    qb = tops.mx_quantize_rhs(_t(b), precision)
    jqb = jops.mx_quantize_rhs(jnp.asarray(b), precision)
    _assert_same_q(qb, jqb)
    assert qb.mantissa.shape == (-(-b.shape[0] // 16) * 16, b.shape[1])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("pa,pb", PAIRS + [("mx9", "mx6")])
def test_plain_contracts_are_bitwise(shape, pa, pb):
    """The reference's own bitwise contracts (tests/test_mx.py), on the
    port's plain versions: fused == unfused == prequant, and the backward
    pair == the two fused GEMMs it replaces."""
    a, b, g = _inputs(shape, seed=2)
    ta, tb, tg = _t(a), _t(b), _t(g)
    fused = tops.mx_matmul_fused(ta, tb, pa, pb)
    assert torch.equal(fused, tops.mx_matmul(ta, tb, pa, pb))
    assert torch.equal(fused, tops.mx_matmul_prequant(
        ta, tops.mx_quantize_rhs(tb, pb), pa))
    dx, dw = tops.mx_matmul_bwd_pair(tg, ta, tb, pa)
    assert torch.equal(dx, tops.mx_matmul_fused(tg, tb.T, pa, pa))
    assert torch.equal(dw, tops.mx_matmul_fused(ta.T, tg, pa, pa))
    assert dx.shape == ta.shape and dw.shape == tb.shape


def _jax_inexact_exponents():
    """Integers n for which the reference's ``jnp.exp2(n)`` is not 2**n."""
    n = np.arange(-200, 200)
    got = np.asarray(jnp.exp2(jnp.asarray(n, jnp.float32)), np.float64)
    with np.errstate(over="ignore"):
        exact = np.ldexp(1.0, n).astype(np.float32).astype(np.float64)
    return np.asarray(sorted(set(n[got != exact].tolist())))


def _exact_qd(x: np.ndarray, mb: int):
    """Float64 oracle of quantize-dequantize along the last axis (padded to
    16) with exact power-of-two scales; also each element's effective
    exponent."""
    x = _pad16(x)
    field = ((x.view(np.uint32) >> 23) & 0xFF).astype(np.int64)
    e = np.maximum(field, 1) - 127
    rows = x.shape[0]
    eb = e.reshape(rows, -1, 16)
    e_shared = eb.max(axis=-1, keepdims=True)
    e_sub = eb.reshape(rows, -1, 8, 2).max(axis=-1)
    e_eff = np.repeat(e_shared - (e_sub < e_shared), 2, axis=-1)
    e_eff = e_eff.reshape(x.shape)
    xd = x.astype(np.float64)
    m = np.clip(np.rint(np.abs(xd) * np.ldexp(1.0, (mb - 1) - e_eff)), 0,
                2 ** mb - 1) * np.sign(xd)
    m[field == 0] = 0
    return m * np.ldexp(1.0, e_eff - (mb - 1)), e_eff


@pytest.mark.parametrize("precision", ["mx6", "mx9"])
def test_gradient_magnitude_pair_is_exact_where_jax_exp2_is_not(precision):
    """A cotangent of ~1e-4 puts the scale exponents of g at 15 and beyond,
    where the reference's ``exp2`` is inexact (ROADMAP Queue 3). The port
    equals an exact float64 oracle — its quantized views of g bitwise, its
    gradients within the summation-order bound — and the reference's
    quantized views differ from that oracle only in elements whose scale
    ``exp2`` cannot represent."""
    mb = tref.MANTISSA_BITS[precision]
    rng = np.random.default_rng(3)
    m, k, n = 16, 432, 64
    g = (rng.normal(size=(m, n)) * 1e-4).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    dx, dw = tops.mx_matmul_bwd_pair(_t(g), _t(x), _t(w), precision)
    inexact = _jax_inexact_exponents()
    n_diff = 0
    views = {}
    for name, v in (("g", g), ("gT", g.T), ("w", w), ("xT", x.T)):
        exact, e_eff = _exact_qd(v, mb)
        views[name] = exact
        np.testing.assert_array_equal(_qd(v, precision), exact)
        jq = np.asarray(jref.mx_quant_dequant_ref(jnp.asarray(_pad16(v)),
                                                  precision), np.float64)
        diff = jq != exact
        suspect = (np.isin((mb - 1) - e_eff, inexact)
                   | np.isin(e_eff - (mb - 1), inexact))
        assert not (diff & ~suspect).any(), name
        n_diff += int(diff.sum())
    assert n_diff > 0  # the reference's exp2 really is inexact here
    for port, aq, bq in ((dx, views["g"], views["w"]),
                         (dw, views["xT"], views["gT"])):
        _assert_close(port.numpy(), aq @ bq.T, aq, bq)


def test_typical_limit_fails_wrong_dw_that_the_worst_limit_passes():
    """Over a long contraction (the pair's dW contracts over M) the worst
    summation-order limit is far above a zero-mean result: an all-zero dW
    and a dW from g quantized along the wrong axis (N instead of M) pass
    it. The typical limit fails both, and still holds for a right dW
    summed in the kernels' order (one sequential fp32 chain per output)."""
    m, k, n = 131072, 16, 16
    rng = np.random.default_rng(4)
    x = rng.normal(size=(m, k)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    _, dw = tops.mx_matmul_bwd_pair(_t(g), _t(x), _t(w), "mx9")
    aq, bq = _qd(x.T, "mx9"), _qd(g.T, "mx9")
    chain = np.stack([np.add.accumulate(aq[i] * bq, axis=1,
                                        dtype=np.float32)[:, -1]
                      for i in range(k)])
    _assert_close(chain, dw.numpy(), aq, bq)
    wrong_axis = aq @ _qd(g, "mx9")
    assert not np.array_equal(wrong_axis, dw.numpy())
    for wrong in (np.zeros_like(chain), wrong_axis):
        worst, typical = _gemm_excess(wrong, dw.numpy(), aq, bq)
        assert worst <= 0 < typical


def test_gemm_entries_route_by_device():
    a, b = torch.ones(4, 32), torch.ones(32, 8)
    with pytest.raises(ValueError, match="different devices"):
        tops.mx_matmul_fused(a, b.to("meta"))
    with pytest.raises(ValueError, match="no MX kernel"):
        tops.mx_matmul_fused(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="does not cover"):
        tops.mx_matmul_prequant(torch.ones(4, 48),
                                tops.mx_quantize_rhs(b, "mx6"))


def test_gemm_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers take CUDA tensors only, and say so before any
    build is attempted."""
    a, b = torch.ones(4, 32), torch.ones(32, 8)
    qa = tref.mx_quantize_ref(a, "mx6")
    qb = tops.mx_quantize_rhs(b, "mx6")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmm.mx_matmul_cuda(qa, qb)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmf.mx_matmul_fused_cuda(a, b, "mx6", "mx6")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmf.mx_matmul_bwd_pair_cuda(torch.ones(4, 8), a, b, "mx9")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmf.mx_matmul_prequant_cuda(a, qb, "mx6")
