"""Wrappers of the hand-written CUDA MX kernels (``csrc/mx_quantize.cu``).

``mx_quantize_cuda`` replaces the JAX package's Pallas TPU kernel
``kernels/mx_quantize.py::_quantize_kernel``; ``mx_dequantize_cuda`` is its
inverse (the reference's ``kernels/ref.py::mx_dequantize_ref``). Both are
memory-bound (5.125 bytes moved per element); the source's header gives
the bound and the design. Their plain versions are
``kernels/ref.py::mx_quantize_ref`` / ``mx_dequantize_ref``.

Build: at first use, ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface, under ``_build/`` beside this
file (ignored by git), keyed by the source's hash; ``ctypes`` loads it.
Only a CUDA tensor reaches these wrappers (``kernels/ops.py`` routes a CPU
tensor to the plain version); they raise on anything they do not take,
and raise when the launch reports an error — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels.ref import BLOCK, MANTISSA_BITS, MXTensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "mx_quantize.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

# Launch counters: one per kernel, bumped exactly where the kernel is
# launched. Shared by every caller in the process, hence the lock.
_launches: Dict[str, int] = {"mx_quantize": 0, "mx_dequantize": 0}
_launch_lock = threading.Lock()


def launch_counts() -> Dict[str, int]:
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME to the CUDA toolkit)")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"mx_quantize_{digest}.so"


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library.
    The compiler's resource report (``-Xptxas -v``) is kept beside it."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.mx_quantize_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
            lib.mx_quantize_f32.restype = i32
            lib.mx_dequantize_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i32,
                                              ptr]
            lib.mx_dequantize_f32.restype = i32
            lib.mx_error_string.argtypes = [i32]
            lib.mx_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib: ctypes.CDLL, code: int, name: str) -> None:
    if code != 0:
        msg = lib.mx_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def _require(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: expected a contiguous, 16-byte aligned "
                         "tensor")


def mx_quantize_cuda(x: torch.Tensor, precision: str) -> MXTensor:
    """x [M, K] (K % 16 == 0) on the card -> MXTensor quantized along K.
    fp16/bf16 inputs are widened to fp32 first (exact), as the reference
    does with ``astype(float32)``."""
    if x.dim() != 2 or x.shape[1] % BLOCK:
        raise ValueError(f"expected [M, K] with K % {BLOCK} == 0, "
                         f"got {tuple(x.shape)}")
    mb = MANTISSA_BITS[precision]
    if x.dtype in (torch.float16, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    _require(x, torch.float32, "mx_quantize_cuda input")
    m, k = x.shape
    mant = torch.empty((m, k), dtype=torch.int8, device=x.device)
    expo = torch.empty((m, k // BLOCK), dtype=torch.int8, device=x.device)
    bits = torch.empty((m, k // BLOCK), dtype=torch.uint8, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.mx_quantize_f32(x.data_ptr(), mant.data_ptr(),
                                   expo.data_ptr(), bits.data_ptr(),
                                   m * (k // BLOCK), mb, stream)
    _check(lib, code, "mx_quantize")
    if m * k:
        _count_launch("mx_quantize")
    return MXTensor(mant, expo, bits, precision)


def mx_dequantize_cuda(q: MXTensor) -> torch.Tensor:
    """MXTensor [M, K] on the card -> fp32 [M, K]."""
    mant, expo, bits = q.mantissa, q.exponent, q.mx_bits
    if mant.dim() != 2 or mant.shape[1] % BLOCK:
        raise ValueError(f"expected a [M, K] mantissa with K % {BLOCK} == 0, "
                         f"got {tuple(mant.shape)}")
    m, k = mant.shape
    if expo.shape != (m, k // BLOCK) or bits.shape != (m, k // BLOCK):
        raise ValueError("exponent / bits must be [M, K/16]")
    mb = MANTISSA_BITS[q.precision]
    _require(mant, torch.int8, "mx_dequantize_cuda mantissa")
    expo, bits = expo.contiguous(), bits.contiguous()
    if expo.device != mant.device or bits.device != mant.device:
        raise ValueError("mantissa, exponent and bits must share a device")
    if expo.dtype != torch.int8 or bits.dtype != torch.uint8:
        raise ValueError("exponent must be int8 and bits uint8")
    out = torch.empty((m, k), dtype=torch.float32, device=mant.device)
    lib = _load()
    with torch.cuda.device(mant.device):
        stream = torch.cuda.current_stream(mant.device).cuda_stream
        code = lib.mx_dequantize_f32(mant.data_ptr(), expo.data_ptr(),
                                     bits.data_ptr(), out.data_ptr(),
                                     m * (k // BLOCK), mb, stream)
    _check(lib, code, "mx_dequantize")
    if m * k:
        _count_launch("mx_dequantize")
    return out
