#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

1. device  — a CUDA card must be present; prints its name and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build   — compiles the hand-written MX kernels (``nvcc``, sm_90a) from
   the checkout's sources.
3. kernels — holds ``mx_quantize`` / ``mx_dequantize`` against their plain
   PyTorch versions on the card, bitwise, for mx4/mx6/mx9 over every
   quantized leaf shape of full-width ResNet18 and WideResNet50, an odd K
   and blocks of zeros, denormals, halves and extremes; times kernel,
   plain version and bound (bytes over 3.35 TB/s) at each leaf shape.
4. session — the port's main path: ``CLSystemSpec(RESNET18, WIDERESNET50,
   "dacapo-spatiotemporal", apply_mx=True, device="cuda")``, pretrained on
   the card, run for 45 s of virtual time over S1; the MX serving copies
   must have gone through the kernels (launch counters and
   ``kernel_stats``), and the student's MX6 serving tree and forward must
   agree with the port's plain CPU path.
5. full width — InferenceKernel / LabelingKernel at the full Table III
   configs (224 px, 1000 classes, random weights), MX6 serving copies
   filled through the kernels and checked bitwise against the plain
   version on the card, then a 32-frame batch served by each.

Before the last line it prints the card's ``nvidia-smi`` line and one JSON
object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
REPLACES = "src/repro/kernels/mx_quantize.py:39"  # Pallas _quantize_kernel
REPLACES_DEQ = "src/repro/kernels/ref.py:67"  # mx_dequantize_ref (jnp)
SOURCE = "src/repro_torch/kernels/csrc/mx_quantize.cu"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> None:
    import torch

    # ------------------------------------------------------------ 1 device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke run needs a CUDA card")
    import numpy as np

    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core.estimator import DaCapoEstimator
    from repro_torch.core.kernel import InferenceKernel, LabelingKernel
    from repro_torch.core.mx import _quantizable
    from repro_torch.core.session import CLSystemSpec, pretrain_model
    from repro_torch.data.stream import DriftStream, scenario
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ------------------------------------------------------------- 2 build
    t0 = time.perf_counter()
    lib = mxq.build()
    log("build", f"nvcc sm_90a -> {lib.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())

    # ----------------------------------------------------------- 3 kernels
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters: int = 15) -> float:
        """Median per-call device time, L2 flushed before each call (a
        serving-copy fill finds the weights cold). A spin kernel ahead of
        the start event lets the host enqueue the call before the device
        reaches it, so host-side launch overhead stays out of the time."""
        fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def same_q(qa, qb) -> bool:
        return (torch.equal(qa.mantissa, qb.mantissa)
                and torch.equal(qa.exponent, qb.exponent)
                and torch.equal(qa.mx_bits, qb.mx_bits))

    def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))

    gen = torch.Generator().manual_seed(0)
    full = {cfg.name: make_vision_model(cfg, dev).init(gen)
            for cfg in (RESNET18, WIDERESNET50)}
    leaves = {}  # flattened [rows, K] view -> one real leaf of that shape
    for params in full.values():
        for p in tree_leaves(params):
            if _quantizable(p, 1024):
                flat = p.reshape(-1, p.shape[-1])
                leaves.setdefault(tuple(flat.shape), flat)
    special = torch.tensor(
        [0.0] * 16                                   # all-zero block
        + [1e-40 * (i + 1) for i in range(16)]       # fp32 denormals
        + [1e-40, 0.0, 1.0, -1.0] * 4                # denormals beside 1.0
        + [1.5, 2.5, -0.5, 3.5, 0.75, -1.25, 6.5, 7.5] * 2   # halves
        + [3e38, -3e38, 1e-38, 2e-38, 1e30, -1e-30, 5.0, 0.1] * 2,
        dtype=torch.float32, device=dev).reshape(-1, 16)
    cases = dict(leaves)
    cases[(1000, 1000)] = torch.randn(1000, 1000, generator=gen).to(dev)
    cases[("special",) + tuple(special.shape)] = special.repeat(4, 4)
    max_err = {"mx_quantize": 0.0, "mx_dequantize": 0.0}
    timings = []
    for shape, x in cases.items():
        xp = ops._pad_last(x, ref.BLOCK)[0].contiguous()
        for prec in ("mx4", "mx6", "mx9"):
            qk = ops.mx_quantize(x, prec)
            qp = ref.mx_quantize_ref(xp, prec)
            dk = ops.mx_dequantize(qk)
            dp = ref.mx_dequantize_ref(qp)
            torch.cuda.synchronize()
            if not same_q(qk, qp):
                raise AssertionError(f"mx_quantize {prec} {shape}: kernel != "
                                     "plain")
            if not bitwise(dk, dp):
                raise AssertionError(f"mx_dequantize {prec} {shape}: kernel "
                                     "!= plain")
            max_err["mx_quantize"] = max(
                max_err["mx_quantize"],
                float((qk.mantissa.float() - qp.mantissa.float()).abs()
                      .max()))
            max_err["mx_dequantize"] = max(
                max_err["mx_dequantize"],
                float(torch.nan_to_num(dk - dp).abs().max()))
        if shape in leaves:
            n = xp.numel()
            q6 = mxq.mx_quantize_cuda(xp, "mx6")
            bytes_moved = n * 4 + n + 2 * (n // 16)
            row = {
                "shape": list(shape),
                "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
                "q_ms": time_ms(lambda: mxq.mx_quantize_cuda(xp, "mx6")),
                "q_plain_ms": time_ms(lambda: ref.mx_quantize_ref(xp, "mx6")),
                "dq_ms": time_ms(lambda: mxq.mx_dequantize_cuda(q6)),
                "dq_plain_ms": time_ms(lambda: ref.mx_dequantize_ref(q6)),
            }
            timings.append(row)
            log("kernels", "mx6 {shape}: quantize {q_ms:.4f} ms (plain "
                "{q_plain_ms:.4f}), dequantize {dq_ms:.4f} ms (plain "
                "{dq_plain_ms:.4f}), bound {bound_ms:.4f} ms".format(**row))
    log("kernels", f"bitwise equal to the plain version for mx4/mx6/mx9 over "
        f"{len(cases)} shapes (tolerance 0); max_abs_err {max_err}")
    del flush
    biggest = max(timings, key=lambda r: r["shape"][0] * r["shape"][1])

    # ----------------------------------------------------------- 4 session
    stream = DriftStream(scenario("S1", 3), seed=5, img=24)
    spec = CLSystemSpec(student=RESNET18, teacher=WIDERESNET50,
                        allocator="dacapo-spatiotemporal", apply_mx=True,
                        device="cuda")
    session = spec.build()
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tp = pretrain_model(session.teacher, stream, 25, 32, rng)
    sp = pretrain_model(session.student, stream, 15, 32, rng,
                        segments=stream.segments[:1], seed=8)
    session.set_pretrained(tp, sp)
    torch.cuda.synchronize()
    log("session", f"pretrained teacher 25x32 + student 15x32 on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    t0 = time.perf_counter()
    res = session.run(stream, duration=45.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mxq.launch_counts()
    stats = ops.kernel_stats()
    log("session", f"phases {len(res.phase_log)}, drift events "
        f"{res.drift_events}, avg accuracy {res.avg_accuracy:.4f}, wall "
        f"{wall:.2f} s, launches {launches}, kernel_stats {stats}")
    for op in ("mx_quantize", "mx_dequantize"):
        served = stats.get(op, {})
        if served.get("cuda", 0) < 1 or served.get("plain", 0) != 0:
            raise AssertionError(f"{op} not served by the kernel: {served}")
        if launches[op] < 1:
            raise AssertionError(f"{op} launched no time on the main path")
    if not res.phase_log or not np.isfinite(res.avg_accuracy):
        raise AssertionError(f"bad session result: {len(res.phase_log)} "
                             f"phases, avg accuracy {res.avg_accuracy}")
    # The card against the port's plain CPU path on the same weights.
    cpu_student = make_vision_model(session.student_cfg, "cpu")
    cpu_params = tree_map(lambda p: p.cpu(), session.student_params)
    from repro_torch.core import mx as mx_lib
    serve_cuda = session.inference.serving_params(session.student_params,
                                                  "mx6")
    serve_cpu = mx_lib.quantize_tree(cpu_params, "mx6")
    for a, b in zip(tree_leaves(serve_cuda), tree_leaves(serve_cpu)):
        if not bitwise(a.cpu(), b):
            raise AssertionError("MX6 serving tree: card != CPU plain path")
    frames, _ = stream.frames(0.0, 2.0, max_frames=16)
    with torch.no_grad():
        lg_cuda = session.student.apply(serve_cuda, frames).cpu()
        lg_cpu = cpu_student.apply(serve_cpu, frames)
    diff = float((lg_cuda - lg_cpu).abs().max())
    if not diff < 1e-3:
        raise AssertionError(f"student logits card vs CPU differ by {diff}")
    log("session", "MX6 serving tree bitwise equal to the CPU plain path; "
        f"student logits max |card - CPU| = {diff:.3g} (tolerance 1e-3, "
        "fp32 summation order)")

    # -------------------------------------------------------- 5 full width
    est = DaCapoEstimator()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(32, 224, 224, 3)).astype(np.float32)).to(dev)
    mxq.reset_launch_counts()
    full_launches = {}
    for cfg in (RESNET18, WIDERESNET50):
        model = make_vision_model(cfg, dev)
        params = full[cfg.name]
        cls = InferenceKernel if cfg is RESNET18 else LabelingKernel
        kern = cls(model, cfg, est, apply_mx=True, device="cuda")
        kern.serving_cache.get(params, "mx6")  # warm the allocator
        kern.serving_cache.invalidate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serving = kern.serving_cache.get(params, "mx6")
        torch.cuda.synchronize()
        fill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain_tree = tree_map(
            lambda p: ref.mx_quant_dequant_ref(
                ops._pad_last(p.reshape(-1, p.shape[-1]), 16)[0],
                "mx6")[:, : p.shape[-1]].reshape(p.shape)
            if _quantizable(p, 1024) else p, params)
        torch.cuda.synchronize()
        plain_fill_ms = (time.perf_counter() - t0) * 1e3
        for p, s, plain in zip(tree_leaves(params), tree_leaves(serving),
                               tree_leaves(plain_tree)):
            if _quantizable(p, 1024):
                if not bitwise(s, plain):
                    raise AssertionError(f"{cfg.name}: kernel-filled serving "
                                         "leaf != plain")
            elif s is not p:
                raise AssertionError(f"{cfg.name}: unquantized leaf copied")
        if cfg is RESNET18:
            serve = lambda: kern.predict_async(params, x)  # noqa: E731
        else:
            serve = lambda: kern.label_async(params, x, "mx6")  # noqa: E731
        with torch.no_grad():
            logits = kern._run_apply(serving, x)
        if logits.shape != (32, cfg.num_classes) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: bad logits {logits.shape}")
        serve()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = serve()
        out.cpu()
        fps = 3 * 32 / (time.perf_counter() - t0)
        n_params = sum(p.numel() for p in tree_leaves(params))
        log("full", f"{cfg.name} ({n_params / 1e6:.1f} M params, 224 px): "
            f"MX6 serving fill {fill_ms:.2f} ms through the kernels "
            f"({plain_fill_ms:.2f} ms plain), bitwise equal; "
            f"{fps:.1f} frames/s at batch 32")
    full_launches = mxq.launch_counts()
    if min(full_launches.values()) < 1:
        raise AssertionError(f"full-width launches {full_launches}")
    log("full", f"launches {full_launches}")

    kernels = []
    for name, ms, plain_ms, replaces in (
            ("mx_quantize", biggest["q_ms"], biggest["q_plain_ms"],
             REPLACES),
            ("mx_dequantize", biggest["dq_ms"], biggest["dq_plain_ms"],
             REPLACES_DEQ)):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": biggest["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": biggest["shape"],
            "precision": "mx6", "launches_full_width": full_launches[name]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
