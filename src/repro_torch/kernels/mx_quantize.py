"""Wrappers of the hand-written CUDA MX kernels (``csrc/mx_quantize.cu``).

``mx_quantize_many_cuda`` replaces the JAX package's Pallas TPU kernel
``kernels/mx_quantize.py::_quantize_kernel``; ``mx_dequantize_many_cuda``
is its inverse (the reference's ``kernels/ref.py::mx_dequantize_ref``).
Each takes a whole list of leaves — a serving tree's weights — in one
launch (``MAX_LEAVES`` leaves a launch), placed by ``plan_many`` in arenas
of one ``torch.empty`` each; ``mx_quantize_cuda`` / ``mx_dequantize_cuda``
are their one-leaf calls. Both kernels are memory-bound (5.125 bytes moved
per element); the source's header gives the bound and the design. Their
plain versions are ``kernels/ref.py::mx_quantize_ref`` /
``mx_dequantize_ref``, leaf by leaf.

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
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
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
    "mx_quantize_many": [_PTR, _I32, _I32, _I64, _PTR],
    "mx_dequantize_many": [_PTR, _I32, _I32, _I64, _PTR],
    "mx_gemm_mx": [_PTR, _PTR, _PTR, _I32, _PTR, _PTR, _PTR, _I32, _PTR,
                   _PTR, _I32, _I32, _I32, _I32, _I32, _PTR, _PTR],
    "mx_gemm_fused": [_PTR, _I64, _I64, _I32, _PTR, _I64, _I64, _I32, _PTR,
                      _I32, _I32, _I32, _I32, _I32, _PTR, _PTR],
    "mx_gemm_prequant": [_PTR, _I64, _I64, _I32, _PTR, _PTR, _PTR, _I32,
                         _PTR, _I32, _I32, _I32, _I32, _I32, _PTR, _PTR],
    "mx_pair_stage": [_PTR, _PTR, _PTR, _I32, _PTR, _PTR, _PTR, _PTR, _I32,
                      _I32, _I32, _PTR],
    "mx_gemm_bwd_pair": [_PTR] * 6 + [_I32] * 5 + [_PTR, _I32, _I32, _PTR,
                                                   _PTR],
    "flash_attention_fwd": [_PTR] * 4 + [_I32] * 7 + [_I64] * 12
    + [_F32, _I32, _F32, _I32, _I32, _I32, _I32] + [_I32] * 3
    + [_PTR] * 4,
}

# The grouped quantize kernels' launch table, as csrc/mx_quantize.cu lays it
# out (Leaf, kChunk, kMaxLeaves); load() checks that the library agrees.
CHUNK_BLOCKS = 256  # 16-blocks a CTA takes at once, all of one leaf
MAX_LEAVES = 128  # leaves in one launch's table
OUT_ALIGN = 32  # elements: each leaf's fp32 output starts 128-byte aligned
LEAF_DTYPE = np.dtype([("src", np.int64), ("dst", np.int64),
                       ("expo", np.int64), ("bits", np.int64),
                       ("begin", np.int64), ("blocks", np.int32),
                       ("k", np.int32), ("kb", np.int32), ("vec", np.int32)])


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
            for name, want in (("mx_many_leaf_bytes", LEAF_DTYPE.itemsize),
                               ("mx_many_max_leaves", MAX_LEAVES),
                               ("mx_many_chunk_blocks", CHUNK_BLOCKS)):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = [], _I64
                if fn() != want:
                    raise RuntimeError(f"{name}() is {fn()}, the wrapper "
                                       f"expects {want}")
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


@dataclasses.dataclass(frozen=True, eq=False)
class ManyPlan:
    """Where the leaves of one grouped quantize or dequantize live. Leaf i
    has shape shapes[i]: rows[i] rows of real width ks[i] once flattened to
    [-1, K] (kps[i] rounds it up to 16), and blocks[i] 16-blocks, at blocks
    begin[i] .. begin[i] + blocks[i] of the mantissa (16 bytes a block),
    exponent and bits arenas. Every begin is a multiple of
    ``CHUNK_BLOCKS``, so each mantissa starts 16-byte aligned and each chunk
    of ``CHUNK_BLOCKS`` blocks lies in one leaf (blocks past a leaf's last,
    up to its next chunk boundary, are its own scratch). Its fp32 values
    start at element out_begin[i] of the output arena, a multiple of
    ``OUT_ALIGN``. ``groups`` are the launches: (first leaf, end leaf),
    ``MAX_LEAVES`` leaves at most; ``tables`` their launch tables with the
    pointers left to fill (read-only: plans are shared)."""

    shapes: Tuple[Tuple[int, ...], ...]
    rows: Tuple[int, ...]
    ks: Tuple[int, ...]
    kps: Tuple[int, ...]
    blocks: Tuple[int, ...]
    begin: Tuple[int, ...]
    out_begin: Tuple[int, ...]
    groups: Tuple[Tuple[int, int], ...]
    arena_blocks: int
    arena_out: int
    tables: Tuple[np.ndarray, ...]
    strides: Tuple[Tuple[int, ...], ...]  # each shape's contiguous strides

    def chunks(self, group: Tuple[int, int]) -> int:
        """Chunks of ``CHUNK_BLOCKS`` blocks that ``group``'s launch takes."""
        lo, hi = group
        end = self.begin[hi] if hi < len(self.begin) else self.arena_blocks
        return (end - self.begin[lo]) // CHUNK_BLOCKS

    @property
    def launches(self) -> int:
        """Launches of each kernel: one per group that holds a block."""
        return sum(1 for group in self.groups if self.chunks(group))


def plan_many(shapes: Sequence[Sequence[int]]) -> ManyPlan:
    """The plan of leaves of these shapes, each flattened to [-1, K] as
    ``ops.mx_quantize`` flattens it. Pure Python, no device touched; the
    last 64 plans are kept, since a tree's shapes repeat fill after fill."""
    return _plan(tuple(s if type(s) is tuple or isinstance(s, torch.Size)
                       else tuple(s) for s in shapes))


def _strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    strides, step = [], 1
    for size in reversed(shape):
        strides.append(step)
        step *= max(size, 1)
    return tuple(reversed(strides))


@functools.lru_cache(maxsize=64)
def _plan(shapes: Tuple[Tuple[int, ...], ...]) -> ManyPlan:
    rows, ks, kps, blocks, begin, out_begin = [], [], [], [], [], []
    n_blocks = n_out = 0
    for shape in shapes:
        if not shape:
            raise ValueError("a leaf without a last axis cannot be quantized "
                             "along it")
        m, k = math.prod(shape[:-1]), int(shape[-1])
        kp = -(-k // BLOCK) * BLOCK
        b = m * kp // BLOCK
        if b >= 2 ** 31:
            raise ValueError(f"a leaf of {b} MX blocks exceeds the kernels' "
                             "32-bit block index")
        rows.append(m)
        ks.append(k)
        kps.append(kp)
        blocks.append(b)
        begin.append(n_blocks)
        out_begin.append(n_out)
        n_blocks += -(-b // CHUNK_BLOCKS) * CHUNK_BLOCKS
        n_out += -(-(m * k) // OUT_ALIGN) * OUT_ALIGN
    n = len(rows)
    groups = tuple((lo, min(lo + MAX_LEAVES, n))
                   for lo in range(0, n, MAX_LEAVES))
    tables = []
    for lo, hi in groups:
        table = np.zeros(hi - lo, LEAF_DTYPE)
        table["begin"] = np.asarray(begin[lo:hi]) - begin[lo]
        table["blocks"], table["k"] = blocks[lo:hi], ks[lo:hi]
        table["kb"] = np.asarray(kps[lo:hi]) // BLOCK
        table.flags.writeable = False
        tables.append(table)
    return ManyPlan(tuple(tuple(s) for s in shapes), tuple(rows), tuple(ks),
                    tuple(kps), tuple(blocks), tuple(begin),
                    tuple(out_begin), groups, n_blocks, n_out, tuple(tables),
                    tuple(_strides(tuple(s)) for s in shapes))


def _launch_many(name: str, plan: ManyPlan, mb: int, device: torch.device,
                 src: np.ndarray, dst: np.ndarray, expo: np.ndarray,
                 bits: np.ndarray, fp32: np.ndarray) -> None:
    """One launch of ``name``'s grouped kernel per group of ``plan`` that
    holds a block, each counted. ``src``, ``dst``, ``expo``, ``bits`` are
    the leaves' data pointers and ``fp32`` their fp32 side's (``src`` for
    quantize, ``dst`` for dequantize): a leaf moves float4s where its K is a
    multiple of 4 and that pointer 16-byte aligned."""
    lib = load()
    fn = getattr(lib, name + "_many")
    vec = (np.asarray(plan.ks) % 4 == 0) & (fp32 % 16 == 0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for group, table in zip(plan.groups, plan.tables):
            chunks = plan.chunks(group)
            if not chunks:
                continue
            lo, hi = group
            table = table.copy()  # the kernel gets a copy as its parameter
            table["src"], table["dst"] = src[lo:hi], dst[lo:hi]
            table["expo"], table["bits"] = expo[lo:hi], bits[lo:hi]
            table["vec"] = vec[lo:hi]
            check(lib, fn(table.ctypes.data, hi - lo, mb, chunks, stream),
                  name)
            count_launch(name)


def _pointers(ts: Sequence[torch.Tensor]) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in ts), np.int64, len(ts))


@dataclasses.dataclass(frozen=True, eq=False)
class _Arenas:
    """The mantissa, exponent and bits arenas of one grouped quantize, laid
    out by ``plan``, and their data pointers."""

    plan: ManyPlan
    mant: torch.Tensor
    expo: torch.Tensor
    bits: torch.Tensor
    precision: str
    pointers: Tuple[int, int, int]

    def views(self, i: int) -> Tuple[torch.Tensor, ...]:
        """Leaf i's mantissa [M, Kp], exponent and bits [M, Kp/16]."""
        m, kp, b = self.plan.rows[i], self.plan.kps[i], self.plan.begin[i]
        nb = kp // BLOCK
        return (self.mant.as_strided((m, kp), (kp, 1), BLOCK * b),
                self.expo.as_strided((m, nb), (nb, 1), b),
                self.bits.as_strided((m, nb), (nb, 1), b))


class ArenaMX(MXTensor):
    """An ``MXTensor`` that :func:`mx_quantize_many_cuda` placed in a tree's
    arenas. Its planes are views made when first read: a serving fill whose
    copy is only dequantized makes none, since the grouped dequantize reads
    the arenas directly."""

    def __init__(self, arenas: _Arenas, index: int):
        self.precision = arenas.precision
        self._arenas = arenas
        self._index = index

    @property
    def device(self) -> torch.device:
        return self._arenas.mant.device

    def __getattr__(self, name: str):
        if name not in ("mantissa", "exponent", "mx_bits"):
            raise AttributeError(name)
        self.mantissa, self.exponent, self.mx_bits = self._arenas.views(
            self._index)
        return getattr(self, name)


def _unread_arenas(qs: Sequence[MXTensor], plan: ManyPlan):
    """The arenas that hold ``qs`` as ``plan`` lays them out, leaf i at
    index i, none of their planes read yet (so none replaced); else None."""
    arenas = qs[0].__dict__.get("_arenas")
    if arenas is None or arenas.plan is not plan:
        return None
    for i, q in enumerate(qs):
        d = q.__dict__
        if (d.get("_arenas") is not arenas or d["_index"] != i
                or "mantissa" in d):
            return None
    return arenas


def _check_card(device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {device}")


def mx_quantize_many_cuda(xs: Sequence[torch.Tensor], precision: str,
                          plan: Optional[ManyPlan] = None
                          ) -> List[MXTensor]:
    """Leaves ``xs`` on one card, each flattened to [M, K] (any K) -> their
    MXTensors [M, Kp] quantized along K, in one launch per ``MAX_LEAVES``
    leaves, as views of three arenas of one ``torch.empty`` each (laid out
    by ``plan``, ``plan_many`` of the leaves' shapes when not given).
    Columns K..Kp-1 quantize as the reference's zero padding, with no
    padded copy. A leaf that is not fp32 is converted to fp32 first, as
    the reference's ``astype(float32)``."""
    mb = MANTISSA_BITS[precision]
    if not xs:
        return []
    dev = xs[0].device
    _check_card(dev, "mx_quantize_many_cuda")
    src = []
    for x in xs:
        if x.device != dev:
            raise ValueError(f"mx_quantize_many_cuda: leaves on {dev} and "
                             f"{x.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            x = x.float().contiguous()
        src.append(x)
    if plan is None:
        plan = plan_many([x.shape for x in src])
    mant = torch.empty(plan.arena_blocks * BLOCK, dtype=torch.int8,
                       device=dev)
    expo = torch.empty(plan.arena_blocks, dtype=torch.int8, device=dev)
    bits = torch.empty(plan.arena_blocks, dtype=torch.uint8, device=dev)
    arenas = _Arenas(plan, mant, expo, bits, precision,
                     (mant.data_ptr(), expo.data_ptr(), bits.data_ptr()))
    begin = np.asarray(plan.begin, np.int64)
    sp = _pointers(src)
    mp, ep, bp = arenas.pointers
    _launch_many("mx_quantize", plan, mb, dev, sp, mp + BLOCK * begin,
                 ep + begin, bp + begin, sp)
    return [ArenaMX(arenas, i) for i in range(len(src))]


def mx_dequantize_many_cuda(qs: Sequence[MXTensor],
                            shapes: Sequence[Sequence[int]],
                            plan: Optional[ManyPlan] = None
                            ) -> List[torch.Tensor]:
    """MXTensors of one precision on one card, ``qs[i]`` the [M, Kp]
    quantization of a leaf of shape ``shapes[i]`` (M rows of width K once
    flattened, Kp = K rounded up to 16) -> fp32 tensors of those shapes
    holding the K real columns, in one launch per ``MAX_LEAVES`` leaves,
    as contiguous views of one output arena of one ``torch.empty``."""
    if len(qs) != len(shapes):
        raise ValueError(f"{len(qs)} MXTensors for {len(shapes)} shapes")
    if not qs:
        return []
    if plan is None:
        plan = plan_many(shapes)
    arenas = _unread_arenas(qs, plan)
    if arenas is not None:  # a tree's own arenas, read where they lie
        precision, dev = arenas.precision, arenas.mant.device
        begin = np.asarray(plan.begin, np.int64)
        mant = arenas.pointers[0] + BLOCK * begin
        expo, bits = (p + begin for p in arenas.pointers[1:])
        planes = ()
    else:
        precision, dev = qs[0].precision, qs[0].mantissa.device
        _check_card(dev, "mx_dequantize_many_cuda")
        planes = _dequantize_sources(qs, plan, precision, dev)
        mant, expo, bits = (_pointers(ts) for ts in planes)
    # ``planes`` may hold contiguous copies: they must outlive the launch's
    # queueing (a block freed before it could come back as ``out``).
    out = torch.empty(plan.arena_out, dtype=torch.float32, device=dev)
    dst = out.data_ptr() + 4 * np.asarray(plan.out_begin, np.int64)
    _launch_many("mx_dequantize", plan, MANTISSA_BITS[precision], dev, mant,
                 dst, expo, bits, dst)
    return [out.as_strided(shape, strides, o) for shape, strides, o in
            zip(plan.shapes, plan.strides, plan.out_begin)]


def _dequantize_sources(qs, plan: ManyPlan, precision: str,
                        device: torch.device):
    """The mantissas, exponents and bits of MXTensors that are not a tree's
    unread arenas, each checked against ``plan``; planes that are not
    contiguous are copied."""
    mant, expo, bits = [], [], []
    for q, m, kp in zip(qs, plan.rows, plan.kps):
        mt, e, b = q.mantissa, q.exponent, q.mx_bits
        nb = kp // BLOCK
        if (mt.shape != (m, kp) or e.shape != (m, nb) or b.shape != (m, nb)
                or mt.dtype != torch.int8 or e.dtype != torch.int8
                or b.dtype != torch.uint8):
            raise ValueError(
                f"expected an int8 mantissa [{m}, {kp}], int8 exponent and "
                f"uint8 bits [{m}, {nb}], got {mt.dtype} "
                f"{tuple(mt.shape)}, {e.dtype} {tuple(e.shape)}, {b.dtype} "
                f"{tuple(b.shape)}")
        if not mt.device == e.device == b.device == device:
            raise ValueError("mx_dequantize_many_cuda: planes on "
                             f"{mt.device}, {e.device}, {b.device}, not all "
                             f"on {device}")
        if q.precision != precision:
            raise ValueError(f"one launch takes one precision: {precision} "
                             f"and {q.precision}")
        if not mt.is_contiguous() or mt.data_ptr() % 4:
            raise ValueError("mx_dequantize_many_cuda: a mantissa must be "
                             "contiguous and 4-byte aligned (the kernel "
                             "reads it a 32-bit word a lane)")
        mant.append(mt)
        expo.append(e if e.is_contiguous() else e.contiguous())
        bits.append(b if b.is_contiguous() else b.contiguous())
    return mant, expo, bits


def mx_quantize_cuda(x: torch.Tensor, precision: str) -> MXTensor:
    """x [M, K] (K % 16 == 0) on the card -> MXTensor quantized along K:
    a one-leaf :func:`mx_quantize_many_cuda`."""
    if x.dim() != 2 or x.shape[1] % BLOCK:
        raise ValueError(f"expected [M, K] with K % {BLOCK} == 0, "
                         f"got {tuple(x.shape)}")
    return mx_quantize_many_cuda([x], precision)[0]


def mx_dequantize_cuda(q: MXTensor) -> torch.Tensor:
    """MXTensor [M, K] on the card -> fp32 [M, K]: a one-leaf
    :func:`mx_dequantize_many_cuda`."""
    mant = q.mantissa
    if mant.dim() != 2 or mant.shape[1] % BLOCK:
        raise ValueError(f"expected a [M, K] mantissa with K % {BLOCK} == 0, "
                         f"got {tuple(mant.shape)}")
    return mx_dequantize_many_cuda([q], [tuple(mant.shape)])[0]
