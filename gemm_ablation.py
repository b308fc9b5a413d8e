#!/usr/bin/env python3
"""Where the MX GEMMs' time goes, and each GEMM kernel beside an older
checkout's, on one GPU.

    python3 gemm_ablation.py [--parent DIR]

Builds variants of ``src/repro_torch/kernels/csrc/mx_gemm.cu`` in a
temporary directory, each with ``nvcc`` into a library of its own, all
compiled together:
- "as built"; "no conversion" (the ring's converters cut: the wgmmas read
  whatever the bf16 buffers hold); "no copies" (the ring's slab copies
  cut, the stages keep stale bytes) — ``mx_matmul_fused`` (mx9) and
  ``mx_matmul_prequant`` (mx6) are timed under each at full-width
  ResNet18 shapes at batch 32 that take the slab ring (layer1 to layer4;
  the stem takes the panel path, which these cuts do not touch). The cut
  variants compute wrong outputs: they are timed, never checked.
- "unfused no conversion" / "unfused no copies": the unfused ring
  (``run_mx``) with its lhs conversion or its slab copies cut (timed,
  never checked); "unfused one CTA an SM": its 64-wide tiles on one CTA an
  SM with six stages (as its 128-wide ones); "unfused 64-wide tiles":
  every staged GEMM on 64-wide tiles (the same split plans, so the same
  bits: checked) — the unfused GEMM (mx6) is timed under each and as built
  at layer1 to layer4.
- "cluster pair": ``mx_gemm.cu`` with ``gemm_ablation_cluster.cu``
  appended, the backward pair's alternative design (no staged copies, each
  GEMM the fused ring in thread-block clusters that convert a shared slab
  once and store it into every CTA's shared memory).
- "parent", with ``--parent DIR`` (the root of an unpacked older checkout
  of the port, e.g. ``.archive_check/parent``): that checkout's
  ``mx_gemm.cu``, headers and ``mx_quantize.cu`` (before this port's
  unfused redesign, its unfused GEMM converts the rhs with each slab,
  once per CTA at layer1).
Then, with the library as built, the backward pair (``mx_matmul_bwd_pair``,
mx9) at the stem and layer1 to layer4: the whole pair, its conversion
stage alone (``mx_fused.pair_stage_cuda``) and its two GEMMs alone
(``mx_fused.pair_gemm_cuda``), beside its bound and the staged floor; at
the stem and layer1 also the cluster pair, checked bitwise against the
pair as built, then timed whole and each GEMM alone. Then the unfused GEMM
(``mx_matmul``, mx6) at each distinct GEMM of ResNet18 (the stem to
layer4 and the head): as built, and with ``--parent`` every GEMM kernel
(unfused, fused, prequant, pair) under the parent's library too, in turns
(parent, as built, as built, parent), each checked bitwise against the
kernel as built; the 21-launch passes of the four kernels as built and
under the parent's library (parent, as built, as built, parent). Last,
the L2 flush of ``chip_smoke``'s timers: the stem's unfused GEMM and a
[9216, 1024] quantize timed with the flush's dirty lines left in the L2
(``clean=False``) and written back before the start event (the default),
in turns. Times are ``chip_smoke.time_ms`` / ``pass_ms``. Prints one JSON
line per variant and shape and exits 0 (1 if a variant that must equal
the kernel as built differs). Needs one CUDA card and nvcc, as
``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src/repro_torch/kernels/csrc"
SHAPES = [(100352, 64, 576), (25088, 128, 1152), (6272, 256, 2304),
          (1568, 512, 4608)]
PAIR_SHAPES = [(401408, 64, 147)] + SHAPES  # the stem, then layer1-4
CLUSTER_SHAPES = PAIR_SHAPES[:2]  # at most 8 tiles along the shared axis
CLUSTER = "cluster pair"
PARENT = "parent"
# The cut variants that keep the kernel's arithmetic, checked bitwise.
UNFUSED_CHECKED = ("unfused one CTA an SM", "unfused 64-wide tiles")
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


# The unfused ring's (run_mx) variants: its lhs conversion or its slab
# copies cut (timed, never checked, as the cuts above), and two that keep
# its arithmetic (UNFUSED_CHECKED): its 64-wide tiles on one CTA an SM, and
# every staged GEMM on 64-wide tiles.
UNFUSED_CUTS = {
    "unfused no conversion": [
        ("    g.a.convert(st, threadIdx.x, pl, a16);\n", "")],
    "unfused no copies": [
        ("      mbar_expect_tx(&bars[stage], L::kStage);\n      g.a.load(st, "
         "cur.m0, cur.k0, &bars[stage]);\n      g.b.load(st + LhsMX::"
         "kStageBytes, cur.n0, cur.k0, &bars[stage]);\n",
         "      mbar_expect_tx(&bars[stage], 0u);\n")],
    "unfused one CTA an SM": [
        ("  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;",
         "  static constexpr int kMinBlocks = 1;"),
        ("  static constexpr int kMax = BN == 64 ? 4 : 6;",
         "  static constexpr int kMax = 6;")],
    "unfused 64-wide tiles": [
        ("  return narrow(N) ? go(std::integral_constant<int, 64>{})\n"
         "                   : go(std::integral_constant<int, 128>{});\n}\n"
         "\n// Fused:",
         "  return go(std::integral_constant<int, 64>{});\n}\n\n// Fused:")],
}


def cut(text: str, name: str, cuts) -> str:
    for old, new in cuts:
        if text.count(old) != 1:
            raise SystemExit(f"gemm_ablation: the {name!r} site is not once "
                             "in mx_gemm.cu")
        text = text.replace(old, new)
    return text


def build(tmp: Path, parent) -> dict:
    """One library per variant, all compiled together; ``parent`` is an
    older checkout's ``csrc`` directory, or None."""
    from repro_torch.kernels import mx_quantize as mxq

    source = (CSRC / "mx_gemm.cu").read_text()
    variants = {CLUSTER: (source + (ROOT / "gemm_ablation_cluster.cu")
                          .read_text(), CSRC)}
    for name, cuts in {**CUTS, **UNFUSED_CUTS}.items():
        variants[name] = (cut(source, name, cuts), CSRC)
    if parent is not None:
        variants[PARENT] = ((parent / "mx_gemm.cu").read_text(), parent)
    procs = {}
    for name, (text, csrc) in variants.items():
        out = tmp / name.replace(" ", "_")
        out.mkdir()
        (out / "mx_gemm.cu").write_text(text)
        for header in csrc.glob("*.cuh"):
            (out / header.name).write_text(header.read_text())
        procs[name] = (out / "lib.so", subprocess.Popen(
            [mxq._nvcc(), *mxq.NVCC_FLAGS, "-shared", "-o",
             str(out / "lib.so"), str(out / "mx_gemm.cu"),
             str(csrc / "mx_quantize.cu"), f"-I{out}"],
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
        if name == PARENT:  # its unfused entry takes no staged-rhs scratch
            sig = mxq._SIGNATURES["mx_gemm_mx"]
            lib.mx_gemm_mx.argtypes = sig[:8] + sig[9:]
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


def unfused(lib, qa, qb, parent=False):
    """mx_matmul through ``lib``'s ``mx_gemm_mx`` on stored MX operands,
    with a bf16 scratch for a staged rhs whatever the path the variant
    takes (the parent's entry takes none)."""
    import torch

    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels.mx_matmul import gemm_split_plan, plan_args
    from repro_torch.kernels.ref import MANTISSA_BITS

    lm = qa.mantissa
    (m, kp), n = lm.shape, qb.mantissa.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=lm.device)
    split, _ws = plan_args(m, n, gemm_split_plan(m, n, kp), lm.device)
    scratch = torch.empty((n, kp), dtype=torch.bfloat16, device=lm.device)
    args = [lm.data_ptr(), qa.exponent.data_ptr(), qa.mx_bits.data_ptr(),
            MANTISSA_BITS[qa.precision], qb.mantissa.data_ptr(),
            qb.exponent.data_ptr(), qb.mx_bits.data_ptr(),
            MANTISSA_BITS[qb.precision]] + ([] if parent
                                            else [scratch.data_ptr()])
    code = mxq.launch(lib.mx_gemm_mx, lm.device, *args, out.data_ptr(), m,
                      n, kp, *split)
    mxq.check(lib, code, "mx_gemm_mx")
    return out


def under(lib, fn):
    """``fn()`` with every wrapper launching through ``lib``."""
    from repro_torch.kernels import mx_quantize as mxq

    kept, mxq._lib = mxq._lib, lib
    try:
        return fn()
    finally:
        mxq._lib = kept


def main() -> None:
    import torch

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--parent", type=Path, default=None,
                      help="root of an unpacked older checkout of the port")
    opts = args.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_ablation: torch.cuda.is_available() is False "
                         "— this measurement needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels import mx_fused as mxf
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops

    print(chip_smoke.nvidia_smi_line(), flush=True)
    parent = (None if opts.parent is None
              else opts.parent / "src/repro_torch/kernels/csrc")
    differs = []
    gen = torch.Generator(device="cuda").manual_seed(6)
    data = []
    for m, n, k in SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        data.append((a, w, ops.mx_quantize_rhs(w, "mx6")))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), parent)
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
        for (m, n, k), (a, _, qw) in zip(SHAPES, data):
            qa = ops.mx_quantize(a, "mx6")
            want = unfused(libs["as built"], qa, qw)
            for name in ["as built", *UNFUSED_CUTS]:
                row = {"variant": name, "shape_mnk": [m, n, k],
                       "unfused_ms": chip_smoke.time_ms(
                           lambda: unfused(libs[name], qa, qw)),
                       "unfused_bound_ms": chip_smoke.gemm_bound_ms(
                           "mx_matmul", m, n, k)[0]}
                if name in UNFUSED_CHECKED:
                    row["bitwise"] = chip_smoke.bitwise(
                        unfused(libs[name], qa, qw), want)
                    if not row["bitwise"]:
                        differs.append(f"{name} at {(m, n, k)}")
                print(json.dumps(row), flush=True)
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
                if not same:
                    differs.append(f"cluster pair at {(m, n, k)}")
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
        mxq._lib = libs["as built"]
        differs += unfused_rows(libs, gen)
        timer_rows(gen)
        mxq._lib = None
    if differs:
        raise SystemExit("gemm_ablation: differs from the kernel as built: "
                         + "; ".join(differs))


def unfused_rows(libs, gen) -> list:
    """Every GEMM kernel per distinct GEMM of ResNet18, as built and, with
    a parent library, under it; then the four kernels' 21-launch passes;
    returns what differs from the kernel as built."""
    import torch

    import chip_smoke
    from repro_torch.configs.dacapo_pairs import RESNET18
    from repro_torch.core.estimator import vision_gemms
    from repro_torch.kernels import mx_fused as mxf
    from repro_torch.kernels import mx_matmul as mxm
    from repro_torch.kernels import ops

    parent = libs.get(PARENT)
    gemms = vision_gemms(RESNET18, batch=32)
    counts = Counter(gemms)
    ops_ = []
    for m, n, k in gemms:
        a = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        g = torch.randn((m, n), generator=gen, device="cuda")
        ops_.append((a, w, g, ops.mx_quantize(a, "mx6"),
                     ops.mx_quantize_rhs(w, "mx6")))
    differs = []
    seen = set()
    for (m, n, k), (a, w, g, qa, qw) in zip(gemms, ops_):
        if (m, n, k) in seen:
            continue
        seen.add((m, n, k))
        path = mxm.mx_path(m, n, qa.mantissa.shape[1])
        kernels = {
            "unfused": (lambda: mxm.mx_matmul_cuda(qa, qw),
                        lambda: unfused(parent, qa, qw, parent=True)),
            "fused": (lambda: mxf.mx_matmul_fused_cuda(a, w, "mx9", "mx9"),
                      None),
            "prequant": (lambda: mxf.mx_matmul_prequant_cuda(a, qw, "mx6"),
                         None),
            "pair": (lambda: mxf.mx_matmul_bwd_pair_cuda(g, a, w, "mx9"),
                     None)}
        row = {"variant": "per gemm", "shape_mnk": [m, n, k],
               "count": counts[(m, n, k)], "unfused_path": path}
        for name, (fn, parent_fn) in kernels.items():
            want = fn()
            runs = {"": fn}
            if parent is not None:
                runs["parent"] = (parent_fn if parent_fn is not None
                                  else lambda fn=fn: under(parent, fn))
            for label, run in runs.items():
                if label and not same_outputs(run(), want):
                    differs.append(f"{label} {name} at {(m, n, k)}")
            times = {label: [] for label in runs}
            order = list(runs)[1:] + [""]
            for label in order + order[::-1]:
                times[label].append(chip_smoke.time_ms(runs[label]))
            for label, ts in times.items():
                row[f"{name}_{label}_ms" if label else f"{name}_ms"] = ts
            bound = {"unfused": "mx_matmul", "fused": "mx_matmul_fused",
                     "prequant": "mx_matmul_prequant",
                     "pair": "mx_matmul_bwd_pair"}[name]
            row[f"{name}_bound_ms"] = chip_smoke.gemm_bound_ms(bound, m, n,
                                                               k)[0]
        print(json.dumps(row), flush=True)
    passes = {
        "unfused": ([lambda qa=qa, qw=qw: mxm.mx_matmul_cuda(qa, qw)
                     for _, _, _, qa, qw in ops_],
                    [lambda qa=qa, qw=qw: unfused(parent, qa, qw, True)
                     for _, _, _, qa, qw in ops_]),
        "fused": ([lambda a=a, w=w: mxf.mx_matmul_fused_cuda(a, w, "mx9",
                                                             "mx9")
                   for a, w, _, _, _ in ops_], None),
        "prequant": ([lambda a=a, qw=qw: mxf.mx_matmul_prequant_cuda(
            a, qw, "mx6") for a, _, _, _, qw in ops_], None),
        "pair": ([lambda a=a, w=w, g=g: mxf.mx_matmul_bwd_pair_cuda(
            g, a, w, "mx9") for a, w, g, _, _ in ops_], None)}
    row = {"variant": "passes", "launches": len(gemms)}
    for name, (fns, parent_fns) in passes.items():
        row[f"{name}_ms"] = []
        if parent is not None:
            row[f"{name}_parent_ms"] = []
            if parent_fns is None:
                parent_fns = [lambda fn=fn: under(parent, fn) for fn in fns]
        for label in ("parent", "", "", "parent"):
            if label and parent is None:
                continue
            key = f"{name}_{label}_ms" if label else f"{name}_ms"
            row[key].append(chip_smoke.pass_ms(parent_fns if label
                                               else fns))
    print(json.dumps(row), flush=True)
    return differs


def same_outputs(got, want) -> bool:
    import chip_smoke

    if isinstance(want, tuple):
        return all(chip_smoke.bitwise(x, y) for x, y in zip(got, want))
    return chip_smoke.bitwise(got, want)


def timer_rows(gen) -> None:
    """The stem's unfused GEMM and a [9216, 1024] quantize under both L2
    flushes of ``chip_smoke.time_ms``, in turns."""
    import torch

    import chip_smoke
    from repro_torch.kernels import mx_matmul as mxm
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops

    m, n, k = 401408, 64, 147
    qa = ops.mx_quantize(torch.randn((m, k), generator=gen, device="cuda"),
                         "mx6")
    qw = ops.mx_quantize_rhs(
        torch.randn((k, n), generator=gen, device="cuda"), "mx6")
    x = torch.randn((9216, 1024), generator=gen, device="cuda")
    for what, fn in (("stem mx_matmul mx6", lambda: mxm.mx_matmul_cuda(
            qa, qw)), ("mx_quantize [9216, 1024] mx6",
                       lambda: mxq.mx_quantize_cuda(x, "mx6"))):
        row = {"variant": "timer", "what": what, "dirty_ms": [],
               "clean_ms": []}
        for _ in range(3):
            row["dirty_ms"].append(chip_smoke.time_ms(fn, clean=False))
            row["clean_ms"].append(chip_smoke.time_ms(fn))
        print(json.dumps(row), flush=True)


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
