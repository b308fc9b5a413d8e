"""The unfused MX GEMM's path, and ``ops.mx_matmul`` on the CPU against the
JAX package at a shape of each path.

The card kernel (``csrc/mx_gemm.cu::mx_gemm_mx``) takes one of two paths,
a pure function of the GEMM's shape (``csrc/mx_gemm.cu::mx_panel_path``),
which ``kernels/mx_matmul.py::mx_path`` mirrors so that the wrapper
allocates the staged rhs's scratch where the kernel needs it: "panel"
(whole MX lhs panels by bulk copy: the stem) and "staged" (the rhs
converted once per GEMM into bf16). Both give
the same bits; the card tests hold each to the fused kernel bitwise. Here:
the mirror's path for each of full-width ResNet18's 21 GEMMs at batch 32,
the odd shapes of ``chip_smoke.py`` phase 6, a split shape and the head;
its constants against the CUDA source; and the plain path of
``ops.mx_matmul`` against the JAX package's (its ``ref`` and ``interpret``
modes) within the summation-order limits of ``tests/_torch_gemm_bound.py``
(the quantized operands agree bitwise, so the products differ only in the
order of their sums).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_gemm_bound import assert_gemm_close
from _torch_gemm_bound import qd

from repro.kernels import ops as jops
from repro_torch.configs.dacapo_pairs import RESNET18
from repro_torch.core.estimator import vision_gemms
from repro_torch.kernels import mx_matmul as tmm
from repro_torch.kernels import ops as tops

SOURCE = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/kernels/csrc/mx_gemm.cu")

# The path of each of ResNet18's 21 GEMMs at batch 32, in vision_gemms
# order: the stem (Kp = 160, N = 64) takes the panel; layer1's 576-deep
# contractions do not fit one, and every wider GEMM stages its rhs.
RESNET18_PATHS = ["panel"] + ["staged"] * 20
GEMMS = vision_gemms(RESNET18, batch=32)


def _kp(k: int) -> int:
    return -(-k // 16) * 16


@pytest.mark.parametrize("index", range(len(RESNET18_PATHS)))
def test_resnet18_gemm_paths(index):
    assert len(GEMMS) == len(RESNET18_PATHS) == 21
    m, n, k = GEMMS[index]
    assert tmm.mx_path(m, n, _kp(k)) == RESNET18_PATHS[index]


# (M, N, K) beyond ResNet18: phase 6's odd shapes (a ragged panel and a
# short 128-wide contraction), a few-tile 64-wide GEMM whose contraction
# splits (no panel), the head's N = 1000, a 64-wide rhs too short for a
# panel and one too deep.
@pytest.mark.parametrize("shape,path", [
    ((5, 48, 33), "panel"), ((8, 128, 128), "staged"),
    ((16, 64, 147), "panel"), ((16, 64, 2048), "staged"),
    ((32, 1000, 512), "staged"), ((100, 64, 30), "staged"),
    ((100, 64, 340), "staged")], ids=str)
def test_other_gemm_paths(shape, path):
    m, n, k = shape
    assert tmm.mx_path(m, n, _kp(k)) == path
    if shape == (16, 64, 2048):
        assert tmm.gemm_split_plan(m, n, _kp(k))[0] > 1


@pytest.mark.parametrize("kp,fits", [(32, False), (48, True), (160, True),
                                     (336, True), (352, False)])
def test_mx_panel_bounds(kp, fits):
    """A panel needs room for the resident rhs's slab (Kp >= 48) and, with
    its double buffer and the bf16 tiles, fits up to Kp = 336."""
    assert tmm.mx_panel_fits(kp) is fits


def test_path_constants_match_the_source():
    text = SOURCE.read_text()

    def number(pattern: str) -> tuple:
        found = re.findall(pattern, text)
        assert len(found) == 1, pattern
        return tuple(int(x) for x in np.atleast_1d(found[0]))

    assert number(r"constexpr int kSmemMax = (\d+);") == (tmm.SMEM_MAX,)
    # RhsMX<X> = MXOp<X, false>: rows of X + 16 bytes, a slab of kBK
    # mantissa rows and two planes of kBK / 16 rows
    assert number(r"static constexpr int kMP = [^;]*: X \+ (\d+);") == (16,)
    assert tmm.RHS_MX64_STAGE == 64 * (64 + 16) + 2 * (64 // 16) * (64 + 16)


# (m, k, n): the panel (K = 147 ragged, ragged M); the staged rhs 64 and
# 256 wide, with no split (K ragged) and split.
PARITY = [((130, 147, 64), "panel"), ((20, 30, 64), "staged"),
          ((12, 128, 256), "staged"), ((12, 1000, 128), "staged"),
          ((16, 2048, 64), "staged")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread per test worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("case", PARITY, ids=str)
def test_plain_mx_matmul_matches_jax(monkeypatch, mode, case):
    (m, k, n), path = case
    assert tmm.mx_path(m, n, _kp(k)) == path
    monkeypatch.setenv("REPRO_KERNEL_MODE", mode)
    rng = np.random.default_rng(m + k + n)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    tops.reset_kernel_stats()
    out = tops.mx_matmul(torch.from_numpy(a), torch.from_numpy(b), "mx6",
                         "mx6")
    assert tops.kernel_stats()["mx_matmul"] == {"plain": 1}
    want = jops.mx_matmul(jnp.asarray(a), jnp.asarray(b), "mx6", "mx6")
    assert_gemm_close(out.numpy(), want, qd(a, "mx6"), qd(b.T, "mx6"))
