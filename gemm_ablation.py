#!/usr/bin/env python3
"""Where the MX GEMMs' slab loop spends its time, on one GPU.

    python3 gemm_ablation.py

Builds three variants of ``src/repro_torch/kernels/csrc/mx_gemm.cu`` in a
temporary directory — as it is; with the converters cut (the wgmmas read
whatever the bf16 buffers hold); with the slab copies cut (no TMA or
cp.async, the stages keep stale bytes) — each with ``nvcc`` into a library
of its own, and times ``mx_matmul_fused`` (mx9) and ``mx_matmul_prequant``
(mx6) under each at full-width ResNet18 shapes at batch 32 that take the
slab ring (layer1 to layer4; the stem takes the panel path, which these
cuts do not touch). The cut variants compute wrong outputs: they are
timed, never checked. Prints one JSON line per variant and shape and
exits 0. Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src/repro_torch/kernels/csrc"
SHAPES = [(100352, 64, 576), (25088, 128, 1152), (6272, 256, 2304),
          (1568, 512, 4608)]
CUTS = {
    "as built": [],
    "no conversion": [
        ("        g.a.convert(st, cons.m0, cons.k0, u, a16);", ""),
        ("        g.b.convert(st + A::kStageBytes, cons.n0, cons.k0, "
         "u - kBM * kKB,\n                    b16);", "")],
    "no copies": [
        ("      mbar_expect_tx(&bars[stage],\n                     "
         "g.a.tma_bytes() + (kResB ? 0u : g.b.tma_bytes()));",
         "      mbar_expect_tx(&bars[stage], 0u);"),
        ("    g.a.load(st, cur.m0, cur.k0, &bars[stage]);\n    if (!kResB) "
         "g.b.load(st + A::kStageBytes, cur.n0, cur.k0, &bars[stage]);",
         "")],
}


def build(tmp: Path) -> dict:
    """One library per variant, all compiled together."""
    from repro_torch.kernels import mx_quantize as mxq

    source = (CSRC / "mx_gemm.cu").read_text()
    procs = {}
    for name, cuts in CUTS.items():
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"gemm_ablation: the {name!r} site is not "
                                 "once in mx_gemm.cu")
            text = text.replace(old, new)
        out = tmp / name.replace(" ", "_")
        out.mkdir()
        (out / "mx_gemm.cu").write_text(text)
        for header in CSRC.glob("*.cuh"):
            (out / header.name).write_text(header.read_text())
        procs[name] = (out / "lib.so", subprocess.Popen(
            [mxq._nvcc(), *mxq.NVCC_FLAGS, "-shared", "-o",
             str(out / "lib.so"), str(out / "mx_gemm.cu"),
             str(CSRC / "mx_quantize.cu"), f"-I{out}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"gemm_ablation: {name!r} did not build:\n"
                             f"{log[-4000:]}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in mxq._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.mx_error_string.argtypes = [ctypes.c_int]
        lib.mx_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gemm_ablation: torch.cuda.is_available() is False "
                         "— this measurement needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels import mx_fused as mxf
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops

    print(chip_smoke.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    data = []
    for m, n, k in SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        data.append((a, w, ops.mx_quantize_rhs(w, "mx6")))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for name, lib in libs.items():
            mxq._lib = lib  # every wrapper launches through this library
            for (m, n, k), (a, w, qw) in zip(SHAPES, data):
                print(json.dumps({
                    "variant": name, "shape_mnk": [m, n, k],
                    "fused_ms": chip_smoke.time_ms(
                        lambda: mxf.mx_matmul_fused_cuda(a, w, "mx9",
                                                         "mx9")),
                    "prequant_ms": chip_smoke.time_ms(
                        lambda: mxf.mx_matmul_prequant_cuda(a, qw, "mx6")),
                    "fused_bound_ms": chip_smoke.gemm_bound_ms(
                        "mx_matmul_fused", m, n, k)[0]}), flush=True)
        mxq._lib = None


if __name__ == "__main__":
    main()
