"""Parity of the port's attention (``ops.flash_attention`` on CPU tensors,
i.e. the plain version ``ref.flash_attention_ref`` and the plain backward
of its ``autograd.Function``) with the JAX package's Pallas kernel, run in
interpret mode, and with ``jax.grad`` of the JAX oracle.

Tolerances: the forward within 2e-5 (fp32) and 2e-2 (bf16), absolute and
relative, the limits ``tests/test_kernels.py`` holds the Pallas kernel to
against its oracle; both compute in fp32 and differ in summation order
(and, for bf16, by one rounding of the output). Gradients within 1e-5
relative L2 of ``jax.grad`` (fp32). The JAX oracle and the Pallas kernel
differ where ``q_offset != Skv - Sq`` and on rows with no unmasked key;
the port follows the kernel, and two tests pin that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_fa_kernel
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread per test worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, dtype="float32", seed=0):
    """(JAX arrays, torch tensors) of q [B,Sq,H,D], k, v [B,Skv,Kv,D] from
    one numpy seed; bf16 rounds the same fp32 values on both sides."""
    b, sq, skv, h, kv, d = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _pallas(js, **kw):
    """The Pallas kernel in interpret mode, with 64-row blocks where the
    sequence allows (as tests/test_kernels.py runs it)."""
    return np.asarray(j_fa_kernel(*js, interpret=True, qb=64, kvb=64, **kw),
                      np.float32)


def _port(ts, **kw):
    out = tops.flash_attention(*ts, **kw)
    assert out.dtype == ts[0].dtype and out.device.type == "cpu"
    return out.float().numpy()


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


# (B, Sq, Skv, H, Kv, D): the shapes of tests/test_kernels.py (MHA, GQA,
# MQA, D = 128), and the reduced ViTs' attention (D = 16; 10 and 37 tokens).
SHAPES = [
    (1, 128, 128, 4, 4, 64),
    (2, 128, 128, 8, 2, 64),
    (1, 256, 256, 4, 1, 32),
    (2, 64, 64, 4, 2, 128),
]
VIT_SHAPES = [(4, 10, 10, 4, 4, 16), (4, 37, 37, 4, 4, 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_pallas_kernel(shape, dtype, causal):
    js, ts = _inputs(shape, dtype)
    tol = _tol(dtype)
    np.testing.assert_allclose(_port(ts, causal=causal),
                               _pallas(js, causal=causal), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_vit_attention_matches_pallas_kernel(shape):
    """Non-causal, D = 16: the reduced ViTs' attention. The Pallas blocks
    shrink to the whole sequence (``min(qb, Sq)``), so 37 tokens run."""
    js, ts = _inputs(shape, seed=3)
    np.testing.assert_allclose(_port(ts, causal=False),
                               _pallas(js, causal=False), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("window", [32, 64])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_window_softcap_match_pallas_kernel(window, softcap):
    js, ts = _inputs((1, 256, 256, 4, 2, 32), seed=1)
    kw = dict(causal=True, window=window, softcap=softcap)
    np.testing.assert_allclose(_port(ts, **kw), _pallas(js, **kw),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_offset", [0, 64])
@pytest.mark.parametrize("window", [None, 32])
def test_q_offset_matches_pallas_kernel(q_offset, window):
    """Sq = 64 queries against Skv = 128 keys, the rows at q_offset + i."""
    js, ts = _inputs((2, 64, 128, 4, 2, 32), seed=2)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    np.testing.assert_allclose(_port(ts, **kw), _pallas(js, **kw),
                               rtol=2e-5, atol=2e-5)


def test_oracle_ignores_q_offset_and_the_port_follows_the_kernel():
    """With Sq < Skv and q_offset = 0 the JAX oracle still places the rows
    at i + Skv - Sq; the Pallas kernel and the port place them at i."""
    js, ts = _inputs((1, 64, 128, 2, 2, 32), seed=4)
    kernel = _pallas(js, causal=True, q_offset=0)
    oracle = np.asarray(jref.flash_attention_ref(*js, causal=True))
    port = _port(ts, causal=True, q_offset=0)
    np.testing.assert_allclose(port, kernel, rtol=2e-5, atol=2e-5)
    assert np.abs(port - oracle).max() > 0.1
    # Where the two agree (q_offset = Skv - Sq), the port agrees with both.
    np.testing.assert_allclose(_port(ts, causal=True, q_offset=64), oracle,
                               rtol=2e-5, atol=2e-5)


def test_fully_masked_rows_are_zero_as_in_the_kernel():
    """A row that sees no key outputs 0 in the Pallas kernel and the port;
    the oracle's softmax over an all-masked row averages v instead."""
    js, ts = _inputs((1, 128, 128, 2, 1, 32), seed=5)
    # Positions q_offset + i before every key: the first 64 rows.
    kernel = _pallas(js, causal=True, q_offset=-64)
    port = _port(ts, causal=True, q_offset=-64)
    assert np.all(port[:, :64] == 0.0) and np.all(kernel[:, :64] == 0.0)
    assert np.abs(port[:, 64:]).max() > 0
    np.testing.assert_allclose(port, kernel, rtol=2e-5, atol=2e-5)
    # An empty window masks every row, whatever the row positions.
    assert np.all(_pallas(js, causal=True, window=0) == 0.0)
    assert np.all(_port(ts, causal=True, window=0) == 0.0)
    oracle = np.asarray(jref.flash_attention_ref(*js, causal=True, window=0),
                        np.float32)
    mean_v = np.asarray(js[2], np.float32).mean(axis=1, keepdims=True)
    np.testing.assert_allclose(oracle, np.broadcast_to(mean_v, oracle.shape),
                               rtol=1e-5, atol=1e-5)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# Cases where the JAX oracle and the kernel agree: q_offset = Skv - Sq (the
# port is called with it) and no fully masked row.
GRAD_CASES = {
    "vit-noncausal-d16": ((2, 37, 37, 4, 4, 16), dict(causal=False)),
    "gqa-causal": ((2, 64, 64, 8, 2, 32), dict(causal=True)),
    "window-softcap": ((1, 64, 64, 4, 2, 32),
                       dict(causal=True, window=16, softcap=20.0)),
    "decode-append": ((1, 16, 48, 4, 1, 32), dict(causal=True)),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradients_match_jax_grad(case):
    """The autograd.Function's plain backward against ``jax.grad`` of the
    oracle's sum-of-squares loss."""
    shape, kw = GRAD_CASES[case]
    js, ts = _inputs(shape, seed=6)
    q_offset = shape[2] - shape[1]

    def jloss(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, **kw) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*js)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    out = tops.flash_attention(*leaves, q_offset=q_offset, **kw)
    (out ** 2).sum().backward()
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.shape == leaf.shape
        assert _rel_l2(leaf.grad.numpy(), w) <= 1e-5, name


def test_gradcheck_float64():
    """Finite differences in float64 on a tiny GQA case with a window, a
    softcap, an offset and a fully masked first row."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).requires_grad_(True)
               for s in ((1, 5, 4, 8), (1, 6, 2, 8), (1, 6, 2, 8)))

    def fn(q, k, v):
        return tops.flash_attention(q, k, v, causal=True, window=3,
                                    softcap=2.0, q_offset=-1)

    assert fn(q, k, v)[:, 0].abs().max() == 0  # row 0 sees no key
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_entry_counts_the_plain_path_and_checks_devices():
    _, ts = _inputs((1, 8, 8, 2, 1, 16))
    tops.reset_kernel_stats()
    tops.flash_attention(*ts, causal=False)
    assert tops.kernel_stats() == {"flash_attention": {"plain": 1}}
    with pytest.raises(ValueError, match="different devices"):
        tops.flash_attention(ts[0], ts[1].to("meta"), ts[2])
    with pytest.raises(ValueError, match="group"):
        tref.flash_attention_ref(ts[0], ts[1].repeat(1, 1, 3, 1),
                                 ts[2].repeat(1, 1, 3, 1))
