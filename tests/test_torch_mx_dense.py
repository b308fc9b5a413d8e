"""Parity of the port's MX layer with the JAX package's ``core/mx.py`` and
``core/kernel.py``: ``mx_dense`` (forward and gradients),
``mx_dense_prequant`` against a resident weight carried across from JAX,
``activation_quant``, ``ServingParamsCache.get_quantized`` and the kernels'
``serving_quantized``, and the MX carry-across of ``convert.py``.

Tolerance for GEMM outputs: ``2·Kp·2⁻²⁴·(|A_q| @ |B_q|)`` elementwise,
the bound on two fp32 summation orders of the same exact products, and the
typical limit ``TYPICAL_C·sqrt(Kp)·2⁻²⁴·sqrt(A_q² @ B_q²)`` for zero-mean
operands (see ``tests/_torch_gemm_bound.py``); everything else is bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_gemm_bound import assert_gemm_close as _assert_close
from _torch_gemm_bound import qd as _qd

from repro.configs.dacapo_pairs import RESNET18 as J_RESNET18
from repro.core import kernel as jkernel
from repro.core import mx as jmx
from repro.core.estimator import DaCapoEstimator as JEstimator
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch import core as tcore
from repro_torch.configs.dacapo_pairs import RESNET18
from repro_torch.convert import (mx_from_numpy, mx_to_numpy,
                                 params_from_numpy)
from repro_torch.core import kernel as tkernel
from repro_torch.core import mx as tmx
from repro_torch.core.estimator import DaCapoEstimator
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.registry import make_vision_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread per test worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(rng, *shape) -> np.ndarray:
    return rng.normal(size=shape).astype(np.float32)


def _numpy_mx(q):
    """A JAX MXTensor with its arrays as numpy (what crosses over)."""
    return jax.tree_util.tree_map(np.asarray, q)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_mx_dense_forward_and_gradients_match_jax(monkeypatch, mode):
    """Forward at mx6 and ``torch.autograd`` gradients at mx9 against
    ``jax.grad`` of the same linear loss ``sum(mx_dense(x, w) * c)`` (its
    cotangent is exactly ``c`` in both frameworks); the backward is ONE
    ``mx_matmul_bwd_pair`` call."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", mode)
    rng = np.random.default_rng(10)
    x, w, c = _normal(rng, 2, 8, 432), _normal(rng, 432, 64), _normal(
        rng, 2, 8, 64)

    def loss(x, w):
        return jnp.sum(jmx.mx_dense(x, w, "mx6", "mx9") * c)

    jy = jmx.mx_dense(jnp.asarray(x), jnp.asarray(w), "mx6", "mx9")
    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tops.reset_kernel_stats()
    y = tmx.mx_dense(tx, tw, "mx6", "mx9")
    (y * torch.from_numpy(c)).sum().backward()
    assert tops.kernel_stats() == {"mx_matmul_fused": {"plain": 1},
                                   "mx_matmul_bwd_pair": {"plain": 1}}
    assert y.shape == (2, 8, 64) and y.dtype == torch.float32
    x2, c2 = x.reshape(16, 432), c.reshape(16, 64)
    _assert_close(y.detach().reshape(16, 64).numpy(),
                  np.asarray(jy).reshape(16, 64), _qd(x2, "mx6"),
                  _qd(w.T, "mx6"))
    _assert_close(tx.grad.reshape(16, 432).numpy(),
                  np.asarray(jgx).reshape(16, 432), _qd(c2, "mx9"),
                  _qd(w, "mx9"))
    _assert_close(tw.grad.numpy(), np.asarray(jgw), _qd(x2.T, "mx9"),
                  _qd(c2.T, "mx9"))


def test_mx_dense_backward_is_the_pair_bitwise():
    """``mx_dense``'s gradients are bitwise one ``mx_matmul_bwd_pair`` call
    on the cotangent, which is bitwise the two fused GEMMs it replaces."""
    rng = np.random.default_rng(11)
    x, w, c = (torch.from_numpy(_normal(rng, 5, 33)),
               torch.from_numpy(_normal(rng, 33, 48)),
               torch.from_numpy(_normal(rng, 5, 48)))
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    tmx.mx_dense(tx, tw, "mx9", "mx6").backward(c)
    dx, dw = tops.mx_matmul_bwd_pair(c, x, w, "mx6")
    assert torch.equal(tx.grad, dx) and torch.equal(tw.grad, dw)
    assert torch.equal(dx, tops.mx_matmul_fused(c, w.T, "mx6", "mx6"))
    assert torch.equal(dw, tops.mx_matmul_fused(x.T, c, "mx6", "mx6"))


@pytest.mark.parametrize("precision", ["mx4", "mx6", "mx9"])
def test_mx_dense_prequant_serves_the_jax_resident_weight(monkeypatch,
                                                          precision):
    """JAX quantizes the weight once (``ops.mx_quantize_rhs``, through the
    Pallas quantize kernel interpreted); it crosses by ``mx_from_numpy``
    bit for bit, equals the port's own resident copy, and the port's
    ``mx_dense_prequant`` on it equals ``mx_dense``'s forward bitwise and
    the reference's ``mx_dense_prequant`` within the bound."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")
    rng = np.random.default_rng(12)
    x, w = _normal(rng, 2, 5, 33), _normal(rng, 33, 48)
    jqw = jops.mx_quantize_rhs(jnp.asarray(w), precision)
    qw = mx_from_numpy(_numpy_mx(jqw), "cpu")
    own = tops.mx_quantize_rhs(torch.from_numpy(w), precision)
    for a, b in ((qw.mantissa, own.mantissa), (qw.exponent, own.exponent),
                 (qw.mx_bits, own.mx_bits)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tx = torch.from_numpy(x)
    tops.reset_kernel_stats()
    y_p = tmx.mx_dense_prequant(tx, qw, precision)
    assert tops.kernel_stats() == {"mx_matmul_prequant": {"plain": 1}}
    assert y_p.shape == (2, 5, 48)
    assert torch.equal(y_p, tmx.mx_dense(tx, torch.from_numpy(w), precision,
                                         "mx9"))
    jy = jmx.mx_dense_prequant(jnp.asarray(x), jqw, precision)
    _assert_close(y_p.reshape(10, 48).numpy(), np.asarray(jy).reshape(10, 48),
                  _qd(x.reshape(10, 33), precision), _qd(w.T, precision))


def test_activation_quant_matches_jax_and_is_straight_through(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    rng = np.random.default_rng(13)
    x, c = _normal(rng, 3, 5, 40), _normal(rng, 3, 5, 40)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tmx.activation_quant(tx, "mx6")
    jy = np.asarray(jmx.activation_quant(jnp.asarray(x), "mx6"))
    np.testing.assert_array_equal(y.detach().numpy().view(np.uint32),
                                  jy.view(np.uint32))
    (y * torch.from_numpy(c)).sum().backward()
    assert torch.equal(tx.grad, torch.from_numpy(c))
    assert tmx.activation_quant(tx, None) is tx


@pytest.fixture(scope="module")
def reduced_resnet18():
    jp = j_make_vision_model(J_RESNET18.reduced()).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


CALLS = [("get_quantized", "mx6"), ("get_quantized", "mx6"), ("get", "mx6"),
         ("get", "mx6"), ("get_quantized", "mx9"), ("get", "mx4"),
         ("get_quantized", "mx4")]


def test_serving_cache_get_quantized_counts_match_jax(reduced_resnet18):
    """``get_quantized`` fills once per (tree, precision); a later ``get``
    of the same key dequantizes the resident copy without a refill — the
    reference's ``fills``/hits/misses on the same call sequence."""
    jp, tp = reduced_resnet18
    jc, tc = jkernel.ServingParamsCache(), tkernel.ServingParamsCache()
    for method, precision in CALLS:
        jout = getattr(jc, method)(jp, precision)
        tout = getattr(tc, method)(tp, precision)
        assert (jc.fills, jc.stats()) == (tc.fills, tc.stats()), (method,
                                                                  precision)
        if method == "get_quantized":
            assert tout is tc.get_quantized(tp, precision)
            jc.get_quantized(jp, precision)
        else:
            # JAX's tree_leaves orders both trees alike (sorted keys).
            got = [t.numpy() for t in jax.tree_util.tree_leaves(tout)]
            for a, b in zip(got, jax.tree_util.tree_leaves(jout)):
                np.testing.assert_array_equal(a.view(np.uint8),
                                              np.asarray(b).view(np.uint8))
    assert tc.fills == 3


def test_kernels_serving_quantized(reduced_resnet18):
    """``InferenceKernel`` / ``LabelingKernel.serving_quantized``: the
    resident MX tree (bitwise the reference's) with MX on, the fp32 tree
    itself with MX off."""
    jp, tp = reduced_resnet18
    cfg, jcfg = RESNET18.reduced(), J_RESNET18.reduced()
    est, jest = DaCapoEstimator(), JEstimator()
    model, jmodel = make_vision_model(cfg, "cpu"), j_make_vision_model(jcfg)
    for cls, jcls in ((tkernel.InferenceKernel, jkernel.InferenceKernel),
                      (tkernel.LabelingKernel, jkernel.LabelingKernel)):
        assert cls(model, cfg, est, False, "cpu").serving_quantized(
            tp, "mx6") is tp
        kern, jk = cls(model, cfg, est, True, "cpu"), jcls(jmodel, jcfg,
                                                           jest, True)
        tree = kern.serving_quantized(tp, "mx6")
        jtree = jk.serving_quantized(jp, "mx6")
        assert kern.serving_quantized(tp, "mx6") is tree
        assert kern.serving_cache.fills == jk.serving_cache.fills == 1
        mx_leaf = lambda p: isinstance(p, (tmx.MXLeaf, jmx.MXLeaf))  # noqa
        tl = jax.tree_util.tree_leaves(tree, is_leaf=mx_leaf)
        jl = jax.tree_util.tree_leaves(jtree, is_leaf=mx_leaf)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert isinstance(a, tmx.MXLeaf) == isinstance(b, jmx.MXLeaf)
            if isinstance(a, tmx.MXLeaf):
                back = mx_to_numpy(a)
                for f in ("mantissa", "exponent", "mx_bits"):
                    np.testing.assert_array_equal(getattr(back.q, f),
                                                  np.asarray(getattr(b.q, f)))
                assert (back.shape, back.dtype, back.k) == (b.shape, b.dtype,
                                                            b.k)


def test_mx_representation_crosses_bit_for_bit():
    """A JAX MXTensor and MXLeaf cross into the port bit for bit and come
    back unchanged through ``mx_to_numpy``."""
    rng = np.random.default_rng(14)
    x = _normal(rng, 24, 48)
    x[0, :16] = 0.0
    for precision in ("mx4", "mx6", "mx9"):
        jq = _numpy_mx(jref.mx_quantize_ref(jnp.asarray(x), precision))
        tq = mx_from_numpy(jq, "cpu")
        assert tq.precision == precision
        assert (tq.mantissa.dtype, tq.exponent.dtype, tq.mx_bits.dtype) == (
            torch.int8, torch.int8, torch.uint8)
        back = mx_to_numpy(tq)
        for f in ("mantissa", "exponent", "mx_bits"):
            a, b = getattr(back, f), getattr(jq, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    jleaf = jmx.quantize_tree_mx({"w": jnp.asarray(x)}, "mx6", 16)["w"]
    leaf = mx_from_numpy(jmx.MXLeaf(_numpy_mx(jleaf.q), jleaf.shape,
                                    jleaf.dtype, jleaf.k), "cpu")
    assert isinstance(leaf, tmx.MXLeaf) and leaf.dtype == torch.float32
    got = tmx.dequantize_tree_mx({"w": leaf})["w"].numpy()
    want = np.asarray(jmx.dequantize_tree_mx({"w": jleaf})["w"])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(TypeError, match="mantissa"):
        mx_from_numpy(tref.MXTensor(x, x, x, "mx6"), "cpu")


def test_core_exports_mx_dense():
    assert tcore.mx_dense is tmx.mx_dense
