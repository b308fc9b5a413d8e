"""Parity of the port's MX quantize/dequantize (plain versions, CPU) with
the JAX package: the jnp oracle ``repro.kernels.ref`` and the Pallas kernel
``repro.kernels.mx_quantize.mx_quantize`` in interpret mode.

Tolerance: none — MX quantization is integer bit manipulation plus
power-of-two scaling, so the port must reproduce the reference bit for
bit wherever the reference's own ``jnp.exp2`` is exact. That ``exp2`` is
``exp(x·ln2)`` in fp32 and inexact for |x| ≥ 13; the port builds exact
powers of two instead, so at MX9 and at extreme magnitudes the two part
ways, and the tests below pin both sides of that line: bitwise parity on
ordinary magnitudes, an exact float64 oracle everywhere, and mismatches
with JAX confined to blocks whose scale JAX's ``exp2`` cannot represent.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dacapo_pairs import RESNET18 as J_RESNET18
from repro.core import mx as jmx
from repro.kernels import mx_quantize as jmq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import mx as tmx
from repro_torch.kernels import mx_quantize as tmq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.tree import tree_leaves

PRECISIONS = ("mx4", "mx6", "mx9")
F32_DENORMAL = np.float32(1e-40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; one torch
    intra-op thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int = 0) -> np.ndarray:
    """[24, 128] N(0,1) rows plus hand-made blocks: all zero, all denormal,
    denormals beside normals, exact halves (round half to even), negative
    zeros and values that clip."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(24, 128)).astype(np.float32)
    x[0, :16] = 0.0
    x[1, 16:32] = F32_DENORMAL * np.arange(1, 17, dtype=np.float32)
    x[2, 32:48] = np.tile(np.float32([1e-40, 0.0, 1.0, -1.0]), 4)
    x[3, :16] = np.tile(np.float32([1.5, 2.5, -0.5, 3.5, 0.75, -1.25, 6.5,
                                    7.5]), 2)
    x[4, :16] = -0.0
    x[5, :16] = np.float32([7.99, -7.99, 0.001, 3.0] * 4)
    return x


def _fields(q):
    return [np.asarray(q.mantissa), np.asarray(q.exponent),
            np.asarray(q.mx_bits)]


def _tfields(q):
    return [q.mantissa.numpy(), q.exponent.numpy(), q.mx_bits.numpy()]


def _assert_same_bits(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_quantize_matches_jax_oracle_and_pallas_interpret(precision):
    x = _inputs()
    qt = tref.mx_quantize_ref(torch.from_numpy(x), precision)
    qj = jref.mx_quantize_ref(jnp.asarray(x), precision)
    qp = jmq.mx_quantize(jnp.asarray(x), precision, interpret=True)
    for port, oracle, pallas in zip(_tfields(qt), _fields(qj), _fields(qp)):
        _assert_same_bits(port, oracle)
        _assert_same_bits(port, pallas)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_dequantize_matches_jax_oracle(precision):
    x = _inputs(seed=1)
    qj = jref.mx_quantize_ref(jnp.asarray(x), precision)
    qt = tref.MXTensor(*(torch.from_numpy(np.array(f)) for f in _fields(qj)),
                       precision=precision)
    _assert_same_bits(tref.mx_dequantize_ref(qt).numpy(),
                      np.asarray(jref.mx_dequantize_ref(qj)))
    _assert_same_bits(
        tref.mx_quant_dequant_ref(torch.from_numpy(x), precision).numpy(),
        np.asarray(jref.mx_quant_dequant_ref(jnp.asarray(x), precision)))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_zero_and_denormal_blocks_quantize_as_zero(precision):
    """Zero and fp32-denormal blocks: exponent -126, bits 0, mantissa 0,
    dequantized 0 — what XLA gives (it treats denormal inputs as zero)."""
    x = np.zeros((2, 16), np.float32)
    x[1] = F32_DENORMAL * np.arange(1, 17, dtype=np.float32)
    qt = tref.mx_quantize_ref(torch.from_numpy(x), precision)
    assert not qt.mantissa.any()
    assert (qt.exponent == tref.EXP_MIN).all() and not qt.mx_bits.any()
    assert not tref.mx_dequantize_ref(qt).any()
    for port, oracle in zip(_tfields(qt),
                            _fields(jref.mx_quantize_ref(jnp.asarray(x),
                                                         precision))):
        _assert_same_bits(port, oracle)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_ops_odd_k_matches_jax_ops(precision):
    """Odd K goes through ``ops``' zero padding to 16, as in the reference."""
    x = np.random.default_rng(2).normal(size=(3, 5, 40)).astype(np.float32)
    tops.reset_kernel_stats()
    qt = tops.mx_quantize(torch.from_numpy(x), precision)
    qj = jops.mx_quantize(jnp.asarray(x), precision)
    assert qt.mantissa.shape == (15, 48)
    for port, ref in zip(_tfields(qt), _fields(qj)):
        _assert_same_bits(port, ref)
    yt = tops.mx_quant_dequant(torch.from_numpy(x), precision)
    assert yt.shape == x.shape
    _assert_same_bits(yt.numpy(), np.asarray(
        jops.mx_quant_dequant(jnp.asarray(x), precision)))
    assert tops.kernel_stats() == {"mx_quantize": {"plain": 2},
                                   "mx_dequantize": {"plain": 1}}


def _np_quantize_exact(x: np.ndarray, mb: int):
    """Independent float64 oracle of MX quantization with exact scales."""
    bits = x.view(np.uint32)
    field = ((bits >> 23) & 0xFF).astype(np.int64)
    zero = field == 0
    e = np.maximum(field, 1) - 127
    xb = x.reshape(-1, 16).astype(np.float64)
    eb = e.reshape(-1, 16)
    e_shared = eb.max(axis=1)
    e_sub = eb.reshape(-1, 8, 2).max(axis=2)
    mx = (e_sub < e_shared[:, None]).astype(np.int64)
    e_eff = np.repeat(e_shared[:, None] - mx, 2, axis=1)
    m = np.clip(np.rint(np.abs(xb) * np.ldexp(1.0, (mb - 1) - e_eff)), 0,
                2 ** mb - 1) * np.sign(xb)
    m[zero.reshape(-1, 16)] = 0
    m = m.astype(np.int8)  # the stored mantissa: -0 becomes 0
    packed = (mx << np.arange(8)).sum(axis=1)
    deq = m.astype(np.float64) * np.ldexp(1.0, e_eff - (mb - 1))
    return (m.reshape(x.shape), e_shared.astype(np.int8),
            packed.astype(np.uint8), deq.astype(np.float32).reshape(x.shape))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_exact_power_of_two_scales_over_the_whole_range(precision):
    """Magnitudes from 1e-36 to 1e36: the port equals an exact float64
    oracle, bitwise (quantized fields and dequantized values)."""
    rng = np.random.default_rng(3)
    mag = 10.0 ** rng.uniform(-36, 36, size=(64, 1))
    x = (rng.normal(size=(64, 64)) * mag).astype(np.float32)
    qt = tref.mx_quantize_ref(torch.from_numpy(x), precision)
    mant, expo, bits, deq = _np_quantize_exact(
        x, tref.MANTISSA_BITS[precision])
    _assert_same_bits(qt.mantissa.numpy(), mant)
    _assert_same_bits(qt.exponent.numpy().ravel(), expo)
    _assert_same_bits(qt.mx_bits.numpy().ravel(), bits)
    _assert_same_bits(tref.mx_dequantize_ref(qt).numpy(), deq)


@pytest.fixture(scope="module")
def reduced_resnet18():
    """A reduced ResNet18 tree initialized by the JAX package and carried
    across to the port as numpy."""
    jp = j_make_vision_model(J_RESNET18.reduced()).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("precision", ("mx4", "mx6"))
def test_quantize_tree_mx_matches_jax_quantize_tree(reduced_resnet18,
                                                    precision):
    """The serving path (mx6 on the main path): bitwise on every leaf, and
    the same leaves skipped by the ``ndim >= 2, size >= 1024`` predicate."""
    jp, tp = reduced_resnet18
    qtree = tmx.quantize_tree_mx(tp, precision)
    served = tmx.dequantize_tree_mx(qtree)
    jserved = jmx.quantize_tree(jp, precision)
    want = _paths(jserved)
    got = _paths(params_to_numpy(served))
    assert want.keys() == got.keys()
    for key in want:
        _assert_same_bits(got[key], want[key])
    # Skipped leaves come back as the very source object in both packages.
    jflat, _ = jax.tree_util.tree_flatten_with_path(jserved)
    jsrc = jax.tree_util.tree_leaves(jp)
    jax_skipped = {jax.tree_util.keystr(p) for (p, v), s in zip(jflat, jsrc)
                   if v is s}
    qflat, _ = jax.tree_util.tree_flatten_with_path(
        qtree, is_leaf=lambda p: isinstance(p, tmx.MXLeaf))
    port_skipped = {jax.tree_util.keystr(p) for p, v in qflat
                    if not isinstance(v, tmx.MXLeaf)}
    assert port_skipped == jax_skipped
    assert 0 < len(port_skipped) < len(want)
    # The fake-quant entry agrees with the resident round trip.
    for a, b in zip(tree_leaves(tmx.quantize_tree(tp, precision)),
                    tree_leaves(served)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _jax_inexact_exponents():
    """Integers n for which the reference's ``jnp.exp2(n)`` is not 2**n."""
    n = np.arange(-200, 200)
    got = np.asarray(jnp.exp2(jnp.asarray(n, jnp.float32)), np.float64)
    with np.errstate(over="ignore"):
        exact = np.ldexp(1.0, n).astype(np.float32).astype(np.float64)
    return set(n[got != exact].tolist())


def test_mx9_tree_differs_from_jax_only_where_jax_exp2_is_inexact(
        reduced_resnet18):
    """At mx9, weight blocks need scales 2**13 and beyond, where the
    reference's exp2 is inexact (ROADMAP Queue 3). Every element where the
    port and JAX disagree must lie in a sub-block whose quantize scale
    ``(mb-1) - e_eff`` or dequantize scale ``e_eff - (mb-1)`` JAX cannot
    represent exactly; everywhere else they agree bitwise."""
    jp, tp = reduced_resnet18
    mb = tref.MANTISSA_BITS["mx9"]
    inexact = _jax_inexact_exponents()
    want = _paths(jmx.quantize_tree(jp, "mx9"))
    src = _paths(params_to_numpy(tp))
    n_diff = 0
    for key, w in src.items():
        if w.ndim < 2 or w.size < 1024:
            continue
        flat = torch.from_numpy(w.reshape(-1, w.shape[-1]))
        q = tops.mx_quantize(flat, "mx9")
        got = tops.mx_dequantize(q)[:, : w.shape[-1]].numpy()
        bits = q.mx_bits.numpy().astype(np.int64)[..., None] >> np.arange(8)
        e_eff = q.exponent.numpy().astype(np.int64)[..., None] - (bits & 1)
        e_elem = np.repeat(e_eff, 2, axis=-1).reshape(got.shape[0], -1)
        e_elem = e_elem[:, : w.shape[-1]]
        diff = got.reshape(w.shape) != want[key]
        n_diff += int(diff.sum())
        suspect = np.isin((mb - 1) - e_elem, list(inexact)) | np.isin(
            e_elem - (mb - 1), list(inexact))
        assert not (diff.reshape(got.shape) & ~suspect).any(), key
    assert n_diff > 0  # the divergence is real on this tree


def test_ops_route_by_device():
    tops.reset_kernel_stats()
    tops.mx_dequantize(tops.mx_quantize(torch.ones(4, 32), "mx6"))
    assert tops.kernel_stats() == {"mx_quantize": {"plain": 1},
                                   "mx_dequantize": {"plain": 1}}
    with pytest.raises(ValueError, match="no MX kernel"):
        tops.mx_quantize(torch.ones(4, 32, device="meta"), "mx6")


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers take CUDA tensors only, and say so before any
    build is attempted."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmq.mx_quantize_cuda(torch.ones(4, 32), "mx6")
    q = tref.mx_quantize_ref(torch.ones(4, 32), "mx6")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmq.mx_dequantize_cuda(q)
    with pytest.raises(ValueError, match="K % 16"):
        tmq.mx_quantize_cuda(torch.ones(4, 30), "mx6")
