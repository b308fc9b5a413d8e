#!/usr/bin/env python3
"""The grouped MX quantize and dequantize kernels against variants of
their design, on one GPU.

    python3 quantize_ablation.py

Builds, each into a library of its own in a temporary directory with the
flags of the port's build (one ``nvcc`` each, all started together):

- ``lanes`` — ``csrc/mx_quantize.cu`` as built: four lanes a block;
- ``grid-stride`` — the same with the grid capped at 1056 CTAs (eight an SM
  on the H100's 132) striding over the chunks, not one CTA a chunk;
- ``registers uncapped`` — the same with quantize's
  ``__launch_bounds__(256, 8)`` (32 registers, eight CTAs an SM) dropped;
- ``staged`` — the other design, ``quantize_ablation.cu``: shared-memory
  staging (coalesced 16-byte loads into shared memory, then one block a
  thread through ``mx::quantize_block``; dequantize mirrored).

Each is driven through the port's own wrappers (``mx_quantize_many_cuda``
/ ``mx_dequantize_many_cuda``: same planner, tables and arenas). On the
quantizable leaves of full-width ResNet18, WideResNet50, ViT-B/32 and
ViT-B/16 (random weights from a seed) and on WideResNet50's largest leaf
[9216, 1024] alone: every variant's outputs equal the built kernels' bit
for bit at mx4, mx6 and mx9; then each variant's quantize and dequantize
launch timed at mx6 (median of 15, L2 flushed, ``chip_smoke.time_ms``)
beside the bound (bytes over 3.35 TB/s), the variants in turns, forward
then backward. Prints one JSON line per tree and exits 0 (1 if a variant
differs). Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
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
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "src/repro_torch/kernels/csrc"


VARIANTS = {  # name -> (source, the text replaced in csrc/mx_quantize.cu)
    "grid-stride": ("mx_quantize.cu", [
        ("  quantize_chunk(t, blockIdx.x);",
         "  for (long long c = blockIdx.x; c < t.chunks; c += gridDim.x)\n"
         "    quantize_chunk(t, c);"),
        ("  dequantize_chunk(t, blockIdx.x);",
         "  for (long long c = blockIdx.x; c < t.chunks; c += gridDim.x)\n"
         "    dequantize_chunk(t, c);"),
        ("mx_quantize_many_kernel<<<(unsigned)chunks,",
         "mx_quantize_many_kernel<<<(unsigned)(chunks < 1056 ? chunks : 1056),"),
        ("mx_dequantize_many_kernel<<<(unsigned)chunks,",
         "mx_dequantize_many_kernel<<<(unsigned)(chunks < 1056 ? chunks : "
         "1056),")]),
    "registers uncapped": ("mx_quantize.cu", [
        ("__global__ void __launch_bounds__(kThreads, 8)\n"
         "mx_quantize_many_kernel",
         "__global__ void __launch_bounds__(kThreads)\n"
         "mx_quantize_many_kernel")]),
    "staged": ("quantize_ablation.cu", []),
}


def build(tmp: Path) -> dict:
    """One library per variant, all compiled together, their table entry
    points bound as the port's ``load()`` binds them."""
    from repro_torch.kernels import mx_quantize as mxq

    procs = {}
    for name, (source, cuts) in VARIANTS.items():
        out = tmp / name.replace(" ", "_")
        out.mkdir()
        text = (CSRC / "mx_quantize.cu").read_text()
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"quantize_ablation: the {name!r} site is "
                                 "not once in mx_quantize.cu")
            text = text.replace(old, new)
        (out / "mx_quantize.cu").write_text(text)
        (out / "mx_common.cuh").write_text(
            (CSRC / "mx_common.cuh").read_text())
        (out / "quantize_ablation.cu").write_text(
            (ROOT / "quantize_ablation.cu").read_text())
        cmd = [mxq._nvcc(), *mxq.NVCC_FLAGS, "-shared", "-o",
               str(out / "lib.so"), str(out / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
        if proc.returncode:
            raise SystemExit(f"quantize_ablation: nvcc failed for {name}\n"
                             f"{log}")
        lib = ctypes.CDLL(str(tmp / name.replace(" ", "_") / "lib.so"))
        for fn in ("mx_quantize_many", "mx_dequantize_many"):
            getattr(lib, fn).argtypes = mxq._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        lib.mx_error_string.argtypes = [ctypes.c_int]
        lib.mx_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.configs.dacapo_pairs import (RESNET18, VIT_B16, VIT_B32,
                                                  WIDERESNET50)
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.models.registry import make_vision_model

    if not torch.cuda.is_available():
        raise SystemExit("quantize_ablation: needs a CUDA card")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    built = mxq.load()
    gen = torch.Generator().manual_seed(0)
    trees = {"[9216, 1024]": [torch.randn(9216, 1024, generator=gen).cuda()]}
    for cfg in (RESNET18, WIDERESNET50, VIT_B32, VIT_B16):
        trees[cfg.name] = chip_smoke.quantizable_leaves(
            make_vision_model(cfg, "cuda").init(gen))
    with tempfile.TemporaryDirectory() as tmp:
        designs = {"lanes": built, **build(Path(tmp))}
        order = list(designs) + list(designs)[::-1]
        status = 0
        try:
            for label, leaves in trees.items():
                shapes = [tuple(x.shape) for x in leaves]
                plan = mxq.plan_many(shapes)
                row = {"tree": label, "leaves": len(leaves),
                       "bound_ms": chip_smoke.quantize_bytes(shapes)
                       / chip_smoke.HBM_BYTES_PER_S * 1e3, "differs": []}
                for prec in ("mx4", "mx6", "mx9"):
                    outs = {}
                    for design, lib in designs.items():
                        mxq._lib = lib
                        qs = mxq.mx_quantize_many_cuda(leaves, prec, plan)
                        outs[design] = (qs, mxq.mx_dequantize_many_cuda(
                            qs, shapes, plan))
                    torch.cuda.synchronize()
                    q_want, y_want = outs["lanes"]
                    for design, (qs, ys) in outs.items():
                        if not all(chip_smoke.same_q(a, b)
                                   and chip_smoke.same_bits(c, d)
                                   for a, b, c, d in zip(qs, q_want, ys,
                                                         y_want)):
                            row["differs"].append(f"{design} {prec}")
                    if prec == "mx6":
                        q6 = q_want
                    del outs
                status |= bool(row["differs"])
                for design in order:
                    mxq._lib = designs[design]
                    for kind, fn in (
                            ("q", lambda: mxq.mx_quantize_many_cuda(
                                leaves, "mx6", plan)),
                            ("dq", lambda: mxq.mx_dequantize_many_cuda(
                                q6, shapes, plan))):
                        row.setdefault(f"{design} {kind}_ms", []).append(
                            chip_smoke.time_ms(fn))
                print(json.dumps(row), flush=True)
        finally:
            mxq._lib = built
    return status


if __name__ == "__main__":
    sys.exit(main())
