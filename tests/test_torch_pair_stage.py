"""The backward pair's conversion stage (``csrc/mx_gemm.cu::
pair_stage_kernel``), on the CPU: its layout (``mx_fused.
pair_stage_shapes``) against the splits the pair's GEMMs walk
(``mx_fused.pair_plans``), and its plain version (``ref.mx_pair_stage_ref``)
against the JAX package's quantize / dequantize and against the plain pair.

Tolerance: none. A dequantized MX value is exact in bf16, so the staged
operands equal the reference's dequantized operands value for value, and
the plain GEMM over them is bitwise the plain pair. Inputs are N(0,1) from
a seeded numpy generator, inside the range where the reference's
``jnp.exp2`` is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_gemm_bound import pad16

from repro.kernels import ref as jref
from repro_torch.configs.dacapo_pairs import RESNET18
from repro_torch.core.estimator import vision_gemms
from repro_torch.kernels import mx_fused as tmf
from repro_torch.kernels import mx_matmul as tmm
from repro_torch.kernels import ref as tref

# (M, N, K) of y [M, N] = x [M, K] @ w [K, N]: phase 6's GEMMs (full-width
# ResNet18 at batch 32) and ragged ones (M, N and K off every alignment).
PHASE6 = sorted(set(vision_gemms(RESNET18, batch=32)))
RAGGED = [(5, 48, 33), (3000, 40, 24), (1, 8, 16)]


@pytest.mark.parametrize("shape", PHASE6 + RAGGED, ids=str)
def test_stage_layout_covers_the_pair_plans(shape):
    """dX's operands gn, wn carry the contraction N along their rows, dW's
    xt, gt the contraction M down their columns, padded to 16: the Kp
    that each GEMM's plan cuts into chunks on 16-multiples, the last
    ending there; xt's and gt's row pitches hold K and N columns in
    16-byte multiples."""
    m, n, k = shape
    shapes = tmf.pair_stage_shapes(m, n, k)
    (s_dx, c_dx), (s_dw, c_dw) = tmf.pair_plans(m, n, k)
    np_, mp = -(-n // 16) * 16, -(-m // 16) * 16
    assert shapes == {"gn": (m, np_), "wn": (k, np_),
                      "xt": (mp, -(-k // 8) * 8), "gt": (mp, -(-n // 8) * 8)}
    assert shapes["xt"][1] >= k and shapes["gt"][1] >= n
    for cp, cp_b, splits, chunk in (
            (shapes["gn"][1], shapes["wn"][1], s_dx, c_dx),
            (shapes["xt"][0], shapes["gt"][0], s_dw, c_dw)):
        assert cp == cp_b
        chunks = tmm.split_chunks(cp, splits, chunk)
        assert chunks[0][0] == 0 and chunks[-1][1] == cp
        assert all(lo % 16 == 0 and lo < hi for lo, hi in chunks)
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))


def _inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    g, x, w = (rng.standard_normal(s).astype(np.float32)
               for s in ((m, n), (m, k), (k, n)))
    if m >= 8 and n >= 64:
        x[:, 16:32] = 0.0  # all-zero blocks along M in xt (dW's lhs)
        # an all-zero block along N in each row of gn (dX's lhs), and
        # all-zero blocks along M in gt (dW's rhs)
        g[:, 32:48] = 0.0
        g[3] = 0.0  # a row of all-zero blocks along N in gn
    return g, x, w


def _jax_qd(a: np.ndarray, precision: str) -> np.ndarray:
    q = jref.mx_quantize_ref(jnp.asarray(pad16(a)), precision)
    return np.asarray(jref.mx_dequantize_ref(q))


@pytest.mark.parametrize("precision", ["mx4", "mx6", "mx9"])
@pytest.mark.parametrize("shape", [(40, 64, 147), (5, 48, 33)], ids=str)
def test_plain_stage_matches_jax_quantization(shape, precision):
    """gn and wn hold the reference's dequantized g and w along their
    rows, xt and gt its dequantized x^T and g^T (along M) transposed back,
    value for value, in bf16."""
    g, x, w = _inputs(*shape, seed=1)
    stage = tref.mx_pair_stage_ref(torch.from_numpy(g), torch.from_numpy(x),
                                   torch.from_numpy(w), precision)
    for name, src, flip in (("gn", g, False), ("wn", w, False),
                            ("xt", x.T, True), ("gt", g.T, True)):
        want = _jax_qd(np.ascontiguousarray(src), precision)
        assert stage[name].dtype == torch.bfloat16
        assert np.array_equal(stage[name].float().numpy(),
                              want.T if flip else want)


@pytest.mark.parametrize("precision", ["mx6", "mx9"])
@pytest.mark.parametrize("shape", [(40, 64, 147), (3000, 40, 24)], ids=str)
def test_plain_stage_gives_the_plain_pair_bitwise(shape, precision):
    """The staged operands, widened to fp32, multiply to the plain pair's
    dX and dW bit for bit: staging loses nothing."""
    g, x, w = (torch.from_numpy(a) for a in _inputs(*shape, seed=2))
    stage = {key: t.float() for key, t in tref.mx_pair_stage_ref(
        g, x, w, precision).items()}
    m, n = g.shape
    pad_n, pad_m = (-n) % 16, (-m) % 16
    pad = torch.nn.functional.pad
    dx, dw = tref.mx_matmul_bwd_pair_ref(
        pad(g, (0, pad_n)), pad(w.T, (0, 0, 0, pad_n)), pad(x.T, (0, pad_m)),
        pad(g, (0, 0, 0, pad_m)), precision)
    assert torch.equal(tref._matmul_nt(stage["gn"], stage["wn"]), dx)
    assert torch.equal(tref._matmul_nt(stage["xt"].T.contiguous(),
                                       stage["gt"].T.contiguous()), dw)


def test_pair_stage_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tmf.pair_stage_cuda(torch.ones(4, 8), torch.ones(4, 3),
                            torch.ones(3, 8), "mx9")


def test_pair_gemm_cuda_rejects_cpu_stages():
    stage = {name: torch.zeros(shape, dtype=torch.bfloat16) for name, shape
             in tmf.pair_stage_shapes(4, 8, 3).items()}
    with pytest.raises(ValueError, match="CUDA"):
        tmf.pair_gemm_cuda(stage, 4, 8, 3)
