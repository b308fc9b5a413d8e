"""Wrappers of the hand-written CUDA MX kernels (``csrc/mx_quantize.cu``).

``mx_quantize_cuda`` replaces the JAX package's Pallas TPU kernel
``kernels/mx_quantize.py::_quantize_kernel``; ``mx_dequantize_cuda`` is its
inverse (the reference's ``kernels/ref.py::mx_dequantize_ref``). Both are
memory-bound (5.125 bytes moved per element); the source's header gives
the bound and the design. Their plain versions are
``kernels/ref.py::mx_quantize_ref`` / ``mx_dequantize_ref``.

Build: this module also builds the library every kernel of the port lives
in. At first use, one ``nvcc`` per ``csrc/*.cu``, all started together,
compiles the sources for ``sm_90a``, and one more links them into one
shared library with a plain C interface, under ``_build/`` beside this file
(ignored by git), keyed by the hash of all sources and headers; ``ctypes``
loads it and ``load()`` binds every C function. The GEMM wrappers
(``mx_matmul.py``, ``mx_fused.py``) and the attention wrapper
(``flash_attention.py``) launch through the same library and count their
launches in the same counters.

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
from typing import Dict, List, Optional

import torch

from repro_torch.kernels.ref import BLOCK, MANTISSA_BITS, MXTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

# Launch counters: one per kernel, bumped exactly where the kernel is
# launched. Shared by every caller in the process, hence the lock.
_launches: Dict[str, int] = {
    "mx_quantize": 0, "mx_dequantize": 0, "mx_matmul": 0,
    "mx_matmul_fused": 0, "mx_matmul_bwd_pair": 0, "mx_matmul_prequant": 0,
    "flash_attention": 0}
_launch_lock = threading.Lock()


def launch_counts() -> Dict[str, int]:
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def count_launch(name: str) -> None:
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


def sources() -> List[Path]:
    """The CUDA translation units, one library: every ``csrc/*.cu``."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every kernel (once per hash of the sources and headers) and
    return the library: one ``nvcc -c`` per source, all started together,
    then one ``nvcc -shared`` link. The compiler's resource report
    (``-Xptxas -v``) of every source is kept beside the library."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    failed = [(src.name, proc.returncode, log) for src, proc, log in
              zip(srcs, procs, logs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode, logs[-1]))
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({code}):\n{log}" for name, code, log in failed))
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


# ctypes argument types of every C function of the library, by name.
_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_F32 = ctypes.c_float
_SIGNATURES = {
    "mx_quantize_f32": [_PTR, _PTR, _PTR, _PTR, _I64, _I32, _PTR],
    "mx_dequantize_f32": [_PTR, _PTR, _PTR, _PTR, _I64, _I32, _PTR],
    "mx_gemm_mx": [_PTR, _PTR, _PTR, _I32, _PTR, _PTR, _PTR, _I32, _PTR,
                   _I32, _I32, _I32, _PTR],
    "mx_gemm_fused": [_PTR, _I64, _I64, _I32, _PTR, _I64, _I64, _I32, _PTR,
                      _I32, _I32, _I32, _PTR],
    "mx_gemm_prequant": [_PTR, _I64, _I64, _I32, _PTR, _PTR, _PTR, _I32,
                         _PTR, _I32, _I32, _I32, _PTR],
    "mx_gemm_bwd_pair": [_PTR, _PTR, _PTR, _I32, _PTR, _PTR, _I32, _I32,
                         _I32, _PTR],
    "flash_attention_fwd": [_PTR] * 4 + [_I32] * 7 + [_I64] * 12
    + [_F32, _I32, _F32, _I32, _I32, _I32, _I32, _PTR],
}


def load() -> ctypes.CDLL:
    """The kernel library, built at first use, its functions bound."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I32
            lib.mx_error_string.argtypes = [_I32]
            lib.mx_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(fn, device: torch.device, *args) -> int:
    """Call a library function with ``args`` and the current stream of
    ``device``; returns its CUDA error code."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.mx_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def require(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
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
    require(x, torch.float32, "mx_quantize_cuda input")
    m, k = x.shape
    mant = torch.empty((m, k), dtype=torch.int8, device=x.device)
    expo = torch.empty((m, k // BLOCK), dtype=torch.int8, device=x.device)
    bits = torch.empty((m, k // BLOCK), dtype=torch.uint8, device=x.device)
    lib = load()
    code = launch(lib.mx_quantize_f32, x.device, x.data_ptr(),
                  mant.data_ptr(), expo.data_ptr(), bits.data_ptr(),
                  m * (k // BLOCK), mb)
    check(lib, code, "mx_quantize")
    if m * k:
        count_launch("mx_quantize")
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
    require(mant, torch.int8, "mx_dequantize_cuda mantissa")
    expo, bits = expo.contiguous(), bits.contiguous()
    if expo.device != mant.device or bits.device != mant.device:
        raise ValueError("mantissa, exponent and bits must share a device")
    if expo.dtype != torch.int8 or bits.dtype != torch.uint8:
        raise ValueError("exponent must be int8 and bits uint8")
    out = torch.empty((m, k), dtype=torch.float32, device=mant.device)
    lib = load()
    code = launch(lib.mx_dequantize_f32, mant.device, mant.data_ptr(),
                  expo.data_ptr(), bits.data_ptr(), out.data_ptr(),
                  m * (k // BLOCK), mb)
    check(lib, code, "mx_dequantize")
    if m * k:
        count_launch("mx_dequantize")
    return out
