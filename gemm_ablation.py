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
timed, never checked. Then, with the library as built, the backward pair
(``mx_matmul_bwd_pair``, mx9) at the stem and layer1 to layer4: the whole
pair, its conversion stage alone (``mx_fused.pair_stage_cuda``) and its
two GEMMs alone on the staged operands (``mx_fused.pair_gemm_cuda``),
beside its bound and the staged floor; at the stem and layer1 also the
pair's alternative design, a fourth library built from ``mx_gemm.cu`` with
``gemm_ablation_cluster.cu`` appended: no staged copies, each GEMM the
fused ring in thread-block clusters that convert a shared slab once and
store it into every CTA's shared memory (checked bitwise against the pair
as built, then timed whole and each GEMM alone). Prints one JSON line per
variant and shape and exits 0 (1 if the cluster pair differs from the
pair as built). Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
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
PAIR_SHAPES = [(401408, 64, 147)] + SHAPES  # the stem, then layer1-4
CLUSTER_SHAPES = PAIR_SHAPES[:2]  # at most 8 tiles along the shared axis
CLUSTER = "cluster pair"
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
    texts = {CLUSTER: source + (ROOT / "gemm_ablation_cluster.cu").read_text()}
    for name, cuts in CUTS.items():
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"gemm_ablation: the {name!r} site is not "
                                 "once in mx_gemm.cu")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
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
            log = "\n".join(line for line in log.splitlines()
                            if not line.startswith("ptxas info"))
            raise SystemExit(f"gemm_ablation: {name!r} did not build:\n"
                             f"{log[-4000:]}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in mxq._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        if hasattr(lib, "mx_gemm_pair_cluster"):
            lib.mx_gemm_pair_cluster.argtypes = (
                [mxq._PTR] * 3 + [mxq._I32] * 2 + [mxq._PTR] * 2
                + [mxq._I32] * 5 + [mxq._PTR, mxq._I32, mxq._I32, mxq._PTR,
                                    mxq._PTR])
            lib.mx_gemm_pair_cluster.restype = ctypes.c_int
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
    differs = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    data = []
    for m, n, k in SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        data.append((a, w, ops.mx_quantize_rhs(w, "mx6")))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for name in CUTS:
            mxq._lib = libs[name]  # every wrapper launches through it
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
        mxq._lib = libs["as built"]
        del data
        for m, n, k in PAIR_SHAPES:
            g = torch.randn((m, n), generator=gen, device="cuda")
            x = torch.randn((m, k), generator=gen, device="cuda")
            w = torch.randn((k, n), generator=gen, device="cuda")
            stage = mxf.pair_stage_cuda(g, x, w, "mx9")
            row = {}
            if (m, n, k) in CLUSTER_SHAPES:
                dx, dw = mxf.mx_matmul_bwd_pair_cuda(g, x, w, "mx9")
                cx, cw = cluster_pair(libs[CLUSTER], g, x, w)
                same = (chip_smoke.bitwise(cx, dx)
                        and chip_smoke.bitwise(cw, dw))
                differs |= not same
                row = {"cluster_bitwise": same}
                for key, parts in (("cluster_ms", 3), ("cluster_dx_ms", 1),
                                   ("cluster_dw_ms", 2)):
                    row[key] = chip_smoke.time_ms(lambda: cluster_pair(
                        libs[CLUSTER], g, x, w, parts))
                del dx, dw, cx, cw
            print(json.dumps({
                "variant": "pair", "shape_mnk": [m, n, k],
                "as_built_ms": chip_smoke.time_ms(
                    lambda: mxf.mx_matmul_bwd_pair_cuda(g, x, w, "mx9")),
                "stage_alone_ms": chip_smoke.time_ms(
                    lambda: mxf.pair_stage_cuda(g, x, w, "mx9")),
                "gemms_alone_ms": chip_smoke.time_ms(
                    lambda: mxf.pair_gemm_cuda(stage, m, n, k)),
                "bound_ms": chip_smoke.gemm_bound_ms(
                    "mx_matmul_bwd_pair", m, n, k)[0],
                "staged_floor_ms": chip_smoke.pair_staged_floor_ms(
                    m, n, k), **row}), flush=True)
            del g, x, w, stage
        mxq._lib = None
    if differs:
        raise SystemExit("gemm_ablation: the cluster pair differs from the "
                         "pair as built")


def cluster_pair(lib, g, x, w, parts=3):
    """The backward pair (mx9) through ``gemm_ablation_cluster.cu``'s
    ``mx_gemm_pair_cluster``, with the pair's splits: dX where ``parts``
    has bit 0, dW where it has bit 1 (the other left unwritten)."""
    import torch

    from repro_torch.kernels import mx_fused as mxf
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels.mx_matmul import plan_args
    from repro_torch.kernels.ref import MANTISSA_BITS

    (m, n), k = g.shape, w.shape[0]
    dx = torch.empty((m, k), dtype=torch.float32, device=g.device)
    dw = torch.empty((k, n), dtype=torch.float32, device=g.device)
    plan_dx, plan_dw = mxf.pair_plans(m, n, k)
    split_dx, _ws_dx = plan_args(m, k, plan_dx, g.device)
    split_dw, _ws_dw = plan_args(k, n, plan_dw, g.device)
    code = mxq.launch(lib.mx_gemm_pair_cluster, g.device, g.data_ptr(),
                      x.data_ptr(), w.data_ptr(), MANTISSA_BITS["mx9"],
                      parts, dx.data_ptr(), dw.data_ptr(), m, n, k, *split_dx,
                      *split_dw)
    mxq.check(lib, code, "mx_gemm_pair_cluster")
    return dx, dw


if __name__ == "__main__":
    main()
