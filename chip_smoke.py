#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

1. device  — a CUDA card must be present; prints its name and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build   — compiles every hand-written kernel from the checkout's
   sources (one ``nvcc`` per source, all started together, sm_90a, then
   one link).
3. kernels — holds ``mx_quantize`` / ``mx_dequantize`` against their plain
   PyTorch versions on the card, bitwise, for mx4/mx6/mx9 over every
   quantized leaf shape of full-width ResNet18 and WideResNet50, an odd K
   and blocks of zeros, denormals, halves and extremes; times kernel,
   plain version and bound (bytes over 3.35 TB/s) at each leaf shape.
   Then the grouped calls (``ops.mx_quantize_many`` /
   ``mx_dequantize_many``, one launch per tree): the full-width trees of
   ResNet18, WideResNet50, ViT-B/32 and ViT-B/16, a tree of odd and special
   leaves (ragged K, K not a multiple of 4, a misaligned view, bf16, an
   empty leaf, the blocks above) and a tree above the launch table's cap,
   each bitwise equal to the plain versions leaf by leaf at mx4/mx6/mx9
   with the planned launch count; each model tree's two grouped launches
   timed beside the tree's bound.
4. session — the port's main path: ``CLSystemSpec(RESNET18, WIDERESNET50,
   "dacapo-spatiotemporal", apply_mx=True, device="cuda")``, pretrained on
   the card, run for 45 s of virtual time over S1 — twice, each from a
   fresh build and a fresh ``np.random.default_rng(0)``, and the two runs
   must agree bit for bit (phase logs, drift events, average accuracy,
   the student's parameters, launch counts); the MX serving copies must
   have gone through the kernels, one quantize and one dequantize launch
   per serving-copy fill (launch counters and ``kernel_stats``),
   and the student's MX6 serving tree and forward must agree with the
   port's plain CPU path.
5. full width — InferenceKernel / LabelingKernel at the full Table III
   configs (224 px, 1000 classes, random weights), MX6 serving copies
   filled through the kernels (one launch of each per fill) and checked
   bitwise against the plain version on the card, then a 32-frame batch
   served by each; each fill's host wall, its host part alone and its
   device time (CUDA events) beside its bound.
6. gemm    — the MX GEMM kernels on full-width ResNet18's 21 GEMMs at
   batch 32 (``vision_gemms``; the real weights of phase 3's tree as
   [K, N], N(0,1) activations and cotangents): MX9 training through
   ``mx_dense`` (forward and backward), MX6 serving through
   ``mx_quantize_rhs`` + ``mx_dense_prequant``, and the unfused
   ``ops.mx_matmul``; 21 launches of each GEMM kernel per pass, all
   served by "cuda"; prints each GEMM's tile (BM x BN) and split of its
   contraction (pieces S for the forward and the pair's dX and dW); the
   bitwise contracts fused = unfused = prequant and pair = two fused;
   every kernel within
   the worst summation-order limit 2·Kp·2⁻²⁴·(|A_q| @ |B_q|) and the
   typical limit 4·sqrt(Kp)·2⁻²⁴·sqrt(A_q² @ B_q²) of its plain version,
   on every GEMM and on ragged and zero-block shapes, with an all-zero dW
   and a dW of g quantized along the wrong axis shown to fail the typical
   limit at every GEMM; times at the largest GEMM (the stem; the pair's
   dX and dW also alone), of whole passes beside their summed bounds (the
   unfused chain's 21 ``mx_matmul`` launches on pre-quantized operands
   too), and of each GEMM's unfused (with the path it takes), fused and
   prequant launch beside its bound; as a
   yardstick only, not the same function, ``torch.matmul`` in bf16 on the
   stem's pre-dequantized operands (``library_ms`` stays null: no PyTorch
   call computes an MX GEMM). The backward pair is also timed per GEMM,
   with its conversion stage alone, and as a pass of its 21 launches
   alone, beside its bound and its staged floor (the bytes of the staged
   operands counted too).
7. attention — the flash-attention kernel against its plain version on
   the card, within 2e-5 (fp32) / 2e-2 (bf16) absolute and relative and
   with the error's RMS within 2^-12 (fp32) / 2^-6 (bf16) of the plain
   output's (and against the plain version of the kv split where the plan
   splits): the main path's ViT-B/16 and ViT-B/32 attention at 224 px and
   batch 32 (fp32, non-causal, 197 and 50 tokens), GQA causal bf16,
   gemma2-2b's local layer (8192 tokens, D 256, window 4096, softcap 50),
   a decode-append (128 queries at offset 8064 against 8192 keys) in bf16
   and in fp32, and rows with no key (exactly 0); prints each case's
   design (3xTF32 or bf16 MMAs) and kv split count; times kernel, plain
   version and ``F.scaled_dot_product_attention`` where one call computes
   the same function, beside the bound (bytes over 3.35 TB/s, 4·B·H·D
   FLOPs per unmasked pair over 989 TFLOP/s). ``attention_mutants.py``
   shows that this check fails a faulty kv combine on the card.
8. vit     — the paper's second pair on the card: the phase-4 session,
   twice and bit for bit the same, with the ViT-B/32 student and ViT-B/16
   teacher (attention served by the
   kernel only, MX6 copies by the quantize kernels, the same card-vs-CPU
   checks); full width at 224 px with random weights, batch 32 — the
   ViT-B/32 InferenceKernel and the ViT-B/16 LabelingKernel, MX6 fills
   bitwise against the plain version, 12 attention launches per forward,
   frames/s; one MX-free SGD step of full-width ViT-B/32 with finite
   gradients (the attention's plain backward on the card).
9. modes   — the engine's other modes through ``CLSystemSpec(...).build()``
   → ``run``, each session twice and bit for bit the same: the phase-4
   session under concurrent dispatch (every phase charged max(t_TSA,
   t_BSA); one quantize and one dequantize launch per fill, no plain
   call); the same on ``forced_row_mesh(2)`` with DC-ST-Online, each
   partition change logged; the ViT pair under concurrent dispatch with
   labeling microbatched at 64 (attention launches, no plain call); then
   at full width the synchronous API: ``LabelingKernel.label`` of
   WideResNet50 on 128 frames, whole and microbatched at 32 (ids equal
   but for near ties), ``InferenceKernel.predict`` of ResNet18 at batch
   32, frames/s beside the card's ``nvidia-smi`` line.
10. trace  — the trace spine (``core/trace.py``, ``core/replay.py``):
   phase 4's session in each dispatch mode and phase 8's ViT session,
   each untraced and traced (``trace=True``) and bit for bit the same;
   every recorded phase replayed bit for bit (``TraceReplayer.phase_time``
   == the recorded end) and through ``save`` / ``load`` unchanged; the
   from-units MAPE of the concurrent trace printed; each traced session's
   host time by label (Σwall, Σcost, ``calibrate()``'s scale, the share of
   the run's wall) beside the traced and untraced walls; ``dacapo-replay``
   under concurrent dispatch at ``eval_fps=2.0`` (its own recorder, a
   measured ``profile_cost_s`` after every phase that retrained, every
   phase replayed bit for bit, fills through the kernels only; not held to
   repeat: it charges host wall to its virtual clock); then one traced
   concurrent phase at full width (224 px, random weights, MX6): the
   ViT-B/32 and ResNet18 students' ``predict_async`` on 32 frames and the
   ViT-B/16 and WideResNet50 teachers' ``label_async`` on 128, each
   program's serving copy filled inside it — path "cuda" for each, 12
   attention launches per ViT forward, ``finish()`` equal to the replayed
   end, outputs equal to an untraced repeat, and each program's
   ``wall_s`` beside its device time.

Device times are medians over launches between CUDA events, the L2
flushed before each and its dirty lines written back before the start
event (``flush_l2``).

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
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
REPLACES = "src/repro/kernels/mx_quantize.py:39"  # Pallas _quantize_kernel
REPLACES_DEQ = "src/repro/kernels/ref.py:67"  # mx_dequantize_ref (jnp)
SOURCE = "src/repro_torch/kernels/csrc/mx_quantize.cu"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def flush_l2(clean: bool):
    """The L2 flush ahead of a timed window: ``flush()`` zeroes a buffer
    five times the L2 (a serving-copy fill finds the weights cold) and,
    where ``clean``, then reads a second one, so that the zeroed lines are
    written back before the window opens rather than inside it, where it
    would weigh on a short call (gemm_ablation.py's timer rows time a
    short quantize and the stem's GEMM under both flushes)."""
    import torch

    dirty = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    other = (torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if clean else None)

    def flush():
        dirty.zero_()
        if other is not None:
            other.max()

    return flush


def time_ms(fn, iters: int = 15, spin: int = 1_000_000,
            clean: bool = True) -> float:
    """Median per-call device time, L2 flushed before each call
    (``flush_l2``). A spin kernel of ``spin`` cycles ahead of the start
    event lets the host enqueue the call before the device reaches it, so
    host-side launch overhead stays out of the time."""
    import numpy as np
    import torch

    flush = flush_l2(clean)
    fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def pass_ms(fns, reps: int = 3, clean: bool = True) -> float:
    """Median over ``reps`` of the summed device time of the calls in
    ``fns``, run back to back once the L2 is flushed (``flush_l2``; each
    call between its own pair of events, behind one spin kernel long
    enough for the host to enqueue them all)."""
    import numpy as np
    import torch

    flush = flush_l2(clean)
    sums = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(50_000_000)
        events = []
        for fn in fns:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        sums.append(sum(a.elapsed_time(b) for a, b in events))
    return float(np.median(sums))


# Spin ahead of a timed serving-copy fill: ~20 ms at the H100's clocks,
# more than the host takes to issue a whole fill.
FILL_SPIN = 40_000_000
FILLS = 9  # fills whose median host wall a fill reports: the host is noisy


def same_q(qa, qb) -> bool:
    import torch

    return (torch.equal(qa.mantissa, qb.mantissa)
            and torch.equal(qa.exponent, qb.exponent)
            and torch.equal(qa.mx_bits, qb.mx_bits))


def bitwise(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def same_bits(a, b) -> bool:
    """Same dtype, shape and bytes (any dtype)."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def quantizable_leaves(params) -> list:
    """The leaves a serving-copy fill quantizes, in tree order."""
    from repro_torch.core.mx import _quantizable
    from repro_torch.tree import tree_leaves

    return [p for p in tree_leaves(params) if _quantizable(p, 1024)]


def quantize_bytes(shapes) -> int:
    """Bytes that one grouped quantize of leaves of these shapes (or one
    dequantize, the other way) must move, each once: M·K fp32 values, M·Kp
    mantissas and 2·M·Kp/16 exponent and bits bytes (K the last axis, M
    the rest, Kp = K rounded up to 16)."""
    import math

    total = 0
    for shape in shapes:
        m, k = math.prod(shape[:-1]), int(shape[-1])
        kp = -(-k // 16) * 16
        total += 4 * m * k + m * kp + 2 * (m * kp // 16)
    return total


def session_fills(session) -> int:
    """Serving-copy fills so far of the session's inference and labeling
    kernels."""
    return (session.inference.serving_cache.fills
            + session.labeling.serving_cache.fills)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def session_run(student, teacher, observer=None, **spec):
    """One repeatable run of the main path: a fresh ``CLSystemSpec(student,
    teacher, "dacapo-spatiotemporal", apply_mx=True, **spec).build()`` (the
    keywords of ``spec`` override these) and a fresh
    ``np.random.default_rng(0)``, teacher and student pretrained on the
    device, then 45 s of virtual time over S1 (launch counts and
    kernel_stats set to 0 just before the run). Returns the session, the
    stream, the result, the run's host wall seconds and the pretraining's,
    the run's serving-copy fills, and its launch counts and kernel_stats.
    ``observer(session, record)``, if given, sees every phase record."""
    import numpy as np
    import torch

    from repro_torch.core.session import CLSystemSpec, pretrain_model
    from repro_torch.data.stream import DriftStream, scenario
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops

    stream = DriftStream(scenario("S1", 3), seed=5, img=24)
    spec = {"allocator": "dacapo-spatiotemporal", "apply_mx": True,
            "device": "cuda", **spec}
    session = CLSystemSpec(student=student, teacher=teacher, **spec).build()
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tp = pretrain_model(session.teacher, stream, 25, 32, rng)
    sp = pretrain_model(session.student, stream, 15, 32, rng,
                        segments=stream.segments[:1], seed=8)
    session.set_pretrained(tp, sp)
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    fills = session_fills(session)
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    t0 = time.perf_counter()
    observers = () if observer is None else (
        lambda rec: observer(session, rec),)
    res = session.run(stream, duration=45.0, observers=observers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (session, stream, res, wall, pretrain_s,
            session_fills(session) - fills, mxq.launch_counts(),
            ops.kernel_stats())


def run_differences(first, second) -> list:
    """What differs between two :func:`session_run` results (empty when
    they agree bit for bit): phase count, drift events, phase logs
    (per-phase accuracies, virtual-clock times), average accuracy, the
    student's parameters and the launch counts."""
    from repro_torch.tree import tree_leaves

    (s1, _, r1, *_, l1, _), (s2, _, r2, *_, l2, _) = first, second
    diffs = []
    if len(r1.phase_log) != len(r2.phase_log):
        diffs.append(f"phases {len(r1.phase_log)} != {len(r2.phase_log)}")
    if r1.drift_events != r2.drift_events:
        diffs.append(f"drift events {r1.drift_events} != {r2.drift_events}")
    for i, (a, b) in enumerate(zip(r1.phase_log, r2.phase_log)):
        if a != b:
            diffs.append(f"phase {i}: {a} != {b}")
            break
    if r1.avg_accuracy != r2.avg_accuracy:
        diffs.append(f"avg accuracy {r1.avg_accuracy!r} != "
                     f"{r2.avg_accuracy!r}")
    p1, p2 = tree_leaves(s1.student_params), tree_leaves(s2.student_params)
    if len(p1) != len(p2) or not all(bitwise(a, b)
                                     for a, b in zip(p1, p2)):
        diffs.append("student parameters differ")
    if l1 != l2:
        diffs.append(f"launches {l1} != {l2}")
    return diffs


def fill_checks(tag: str, fills: int, launches: dict, stats: dict) -> None:
    """One "cuda" quantize and one "cuda" dequantize launch per serving-copy
    fill, and no call on the plain path."""
    for op in ("mx_quantize", "mx_dequantize"):
        if launches[op] != fills or stats.get(op) != {"cuda": fills}:
            raise AssertionError(f"{tag}: {op} {launches[op]} launches, "
                                 f"kernel_stats {stats.get(op)}, for {fills} "
                                 "fills: expected one cuda launch a fill")
    plain = {op: paths for op, paths in stats.items() if paths.get("plain")}
    if plain:
        raise AssertionError(f"{tag}: calls on the plain path: {plain}")


def session_phase(tag: str, student, teacher, path_kernels, observer=None,
                  **spec):
    """Phases 4, 8 and 9: the main path (:func:`session_run`, with
    ``spec``) run twice on the card, each time from a fresh build and a
    fresh generator; the two runs must agree bit for bit
    (:func:`run_differences`). Every kernel of ``path_kernels`` must have
    launched in the first run and served all its calls, the quantize and
    dequantize kernels once per serving-copy fill; the student's MX6
    serving tree must equal the port's plain CPU path bitwise, its logits
    within 1e-3. Returns the first run's launch counts, kernel_stats,
    session and result, and both runs' walls."""
    import numpy as np
    import torch

    from repro_torch.core import mx as mx_lib
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_leaves, tree_map

    runs = [session_run(student, teacher, observer, **spec)
            for _ in range(2)]
    for i, (_, _, r, wall, pre_s, fills, counts, st) in enumerate(runs):
        log(tag, f"run {i + 1}: {student.name} / {teacher.name}: pretrained "
            f"teacher 25x32 + student 15x32 on the card in {pre_s:.2f} s; "
            f"phases {len(r.phase_log)}, drift events {r.drift_events}, avg "
            f"accuracy {r.avg_accuracy!r}, wall {wall:.2f} s, serving-copy "
            f"fills {fills}, launches {counts}, kernel_stats {st}")
    diffs = run_differences(*runs)
    if diffs:
        raise AssertionError(f"{tag}: two runs of the session differ: "
                             + "; ".join(diffs))
    log(tag, "the two runs agree bit for bit: phase logs, drift events, "
        "average accuracy, student parameters, launch counts")
    walls = [run[3] for run in runs]
    session, stream, res, _, _, fills, launches, stats = runs[0]
    del runs
    for op in path_kernels:
        served = stats.get(op, {})
        if served.get("cuda", 0) < 1 or served.get("plain", 0) != 0:
            raise AssertionError(f"{op} not served by the kernel: {served}")
        if launches[op] < 1:
            raise AssertionError(f"{op} launched no time on the main path")
    fill_checks(tag, fills, launches, stats)
    log(tag, f"one quantize and one dequantize launch per serving-copy fill "
        f"({fills} fills)")
    if not res.phase_log or not np.isfinite(res.avg_accuracy):
        raise AssertionError(f"bad session result: {len(res.phase_log)} "
                             f"phases, avg accuracy {res.avg_accuracy}")
    # The card against the port's plain CPU path on the same weights.
    cpu_student = make_vision_model(session.student_cfg, "cpu")
    cpu_params = tree_map(lambda p: p.cpu(), session.student_params)
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
    log(tag, "MX6 serving tree bitwise equal to the CPU plain path; "
        f"student logits max |card - CPU| = {diff:.3g} (tolerance 1e-3, "
        "fp32 summation order)")
    return launches, stats, session, res, walls


def full_width_serve(tag: str, cfg, params, x, est, inference: bool):
    """Phases 5 and 8: the InferenceKernel (``inference``) or the
    LabelingKernel of ``cfg`` on full-width ``params``: the MX6 serving
    copy filled through the kernels, one quantize and one dequantize launch
    a fill, and checked bitwise against the plain version on the card; a
    fill's host wall and its host part alone (issuing it), medians of
    ``FILLS`` fills, and its device time (CUDA events, behind a spin that
    covers the host part) beside its bound;
    finite logits for the batch ``x``, and frames/s of three served
    batches. Returns the kernel and its serving tree."""
    import numpy as np
    import torch

    from repro_torch.core.kernel import InferenceKernel, LabelingKernel
    from repro_torch.core.mx import _quantizable
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops, ref
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_leaves, tree_map

    model = make_vision_model(cfg, x.device)
    cls = InferenceKernel if inference else LabelingKernel
    kern = cls(model, cfg, est, apply_mx=True, device="cuda")
    kern.serving_cache.get(params, "mx6")  # warm the allocator
    walls, hosts = [], []
    before = mxq.launch_counts()
    for _ in range(FILLS):
        kern.serving_cache.invalidate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serving = kern.serving_cache.get(params, "mx6")
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    after = mxq.launch_counts()
    per_fill = {op: (after[op] - before[op]) / FILLS for op in after
                if after[op] != before[op]}
    if per_fill != {"mx_quantize": 1, "mx_dequantize": 1}:
        raise AssertionError(f"{cfg.name}: a fill launched {per_fill}")
    fill_ms, host_ms = float(np.median(walls)), float(np.median(hosts))

    def fill():
        kern.serving_cache.invalidate()
        kern.serving_cache.get(params, "mx6")

    device_ms = time_ms(fill, spin=FILL_SPIN)
    shapes = [tuple(p.shape) for p in quantizable_leaves(params)]
    bound_ms = 2 * quantize_bytes(shapes) / HBM_BYTES_PER_S * 1e3
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
    if inference:
        serve = lambda: kern.predict_async(params, x)  # noqa: E731
    else:
        serve = lambda: kern.label_async(params, x, "mx6")  # noqa: E731
    with torch.no_grad():
        logits = kern._run_apply(serving, x)
    if logits.shape != (len(x), cfg.num_classes) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: bad logits {logits.shape}")
    serve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        out = serve()
    out.cpu()
    fps = 3 * len(x) / (time.perf_counter() - t0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(tag, f"{cfg.name} ({n_params / 1e6:.1f} M params, {cfg.img_size} "
        f"px, {len(shapes)} quantized leaves): MX6 serving fill "
        f"{fill_ms:.4f} ms host wall (its host part {host_ms:.4f} ms; "
        f"median of {FILLS}: walls {[round(t, 4) for t in walls]}), "
        f"device time {device_ms:.4f} ms, bound {bound_ms:.4f} ms, launches "
        f"{per_fill} ({plain_fill_ms:.2f} ms plain), bitwise equal; "
        f"{fps:.1f} frames/s at batch {len(x)}")
    return kern, serving


def grouped_phase(trees, timed):
    """Phase 3, grouped: the leaves of each tree of ``trees`` (label ->
    leaves) through one ``ops.mx_quantize_many`` and one
    ``ops.mx_dequantize_many`` call at mx4, mx6 and mx9, bitwise equal to
    the plain versions leaf by leaf (the dequantized leaf in its shape and
    dtype), with the planned launches of each kernel (one per
    ``MAX_LEAVES`` leaves), all served by "cuda". Times the two mx6 launches
    of each tree of ``timed`` beside the tree's bound. Returns one row per
    tree."""
    import torch

    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops, ref

    rows = []
    for label, leaves in trees.items():
        shapes = [tuple(x.shape) for x in leaves]
        plan = mxq.plan_many(shapes)
        want = {"mx_quantize": plan.launches, "mx_dequantize": plan.launches}
        for prec in ("mx4", "mx6", "mx9"):
            mxq.reset_launch_counts()
            ops.reset_kernel_stats()
            qs = ops.mx_quantize_many(leaves, prec)
            ys = ops.mx_dequantize_many(qs, shapes, [x.dtype for x in leaves])
            torch.cuda.synchronize()
            got = {op: n for op, n in mxq.launch_counts().items() if n}
            stats = ops.kernel_stats()
            if got != want or stats != {op: {"cuda": n}
                                        for op, n in want.items()}:
                raise AssertionError(f"grouped {label} {prec}: launches "
                                     f"{got}, kernel_stats {stats}; "
                                     f"expected {want}")
            for i, (x, q, y) in enumerate(zip(leaves, qs, ys)):
                k = x.shape[-1]
                qp = ref.mx_quantize_ref(
                    ops._pad_last(x.reshape(-1, k), ref.BLOCK)[0], prec)
                if not same_q(q, qp):
                    raise AssertionError(f"mx_quantize_many {label} {prec} "
                                         f"leaf {i} {tuple(x.shape)}: "
                                         "kernel != plain")
                yp = ref.mx_dequantize_ref(qp)[:, :k].reshape(x.shape)
                if not same_bits(y, yp.to(x.dtype)):
                    raise AssertionError(f"mx_dequantize_many {label} {prec} "
                                         f"leaf {i} {tuple(x.shape)}: "
                                         "kernel != plain")
            del qs, ys
        row = {"tree": label, "leaves": len(leaves),
               "elements": sum(x.numel() for x in leaves),
               "launches": plan.launches}
        if label in timed:
            q6 = mxq.mx_quantize_many_cuda(leaves, "mx6", plan)
            row.update(
                q_ms=time_ms(lambda: mxq.mx_quantize_many_cuda(
                    leaves, "mx6", plan)),
                dq_ms=time_ms(lambda: mxq.mx_dequantize_many_cuda(
                    q6, shapes, plan)),
                bound_ms=quantize_bytes(shapes) / HBM_BYTES_PER_S * 1e3)
            del q6
            log("kernels", "grouped mx6 {tree} ({leaves} leaves, {elements} "
                "elements, {launches} launch each): quantize {q_ms:.4f} ms, "
                "dequantize {dq_ms:.4f} ms, bound {bound_ms:.4f} ms "
                "each".format(**row))
        rows.append(row)
    seen = "; ".join("{tree}: {leaves} leaves, {launches} launch(es)".format(
        **row) for row in rows)
    log("kernels", f"grouped quantize and dequantize bitwise equal to the "
        f"plain version leaf by leaf for mx4/mx6/mx9 over {len(trees)} trees "
        f"({seen}; tolerance 0)")
    return rows


def odd_trees(gen, special, dev) -> dict:
    """Phase 3's grouped trees beyond the models': the odd and special
    leaves (``special``, phase 3's own odd cases, with ragged K, K not a
    multiple of 4, a view whose fp32 rows are not 16-byte aligned, a bf16
    leaf, an empty leaf), and a tree of ``MAX_LEAVES + 9`` small leaves:
    two launches."""
    import torch

    from repro_torch.kernels import mx_quantize as mxq

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    odd = list(special) + [
        randn(5, 1000), randn(7, 30), randn(3, 3, 8, 33),
        randn(24, 96).bfloat16(), randn(64 * 48 + 1)[1:].view(64, 48),
        torch.empty((0, 16), device=dev)]
    shapes = ((17, 48), (3, 1000), (64, 64), (2, 30), (1, 16), (9, 8, 16))
    capped = [randn(*shapes[i % len(shapes)])
              for i in range(mxq.MAX_LEAVES + 9)]
    return {"odd and special": odd, "above the cap": capped}


FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:87"  # Pallas wrapper
# Phase 7's cases: (label, (B, Sq, Skv, H, Kv, D), dtype, options). The
# first is the main path's largest attention, and the table row's shape.
ATTENTION_CASES = (
    ("vit-b16 224px batch 32", (32, 197, 197, 12, 12, 64), "float32",
     dict(causal=False)),
    ("vit-b32 224px batch 32", (32, 50, 50, 12, 12, 64), "float32",
     dict(causal=False)),
    ("gqa causal", (2, 1024, 1024, 8, 2, 64), "bfloat16",
     dict(causal=True)),
    ("gemma2-2b local layer", (1, 8192, 8192, 8, 4, 256), "bfloat16",
     dict(causal=True, window=4096, softcap=50.0)),
    ("decode-append", (1, 128, 8192, 8, 4, 256), "bfloat16",
     dict(causal=True, q_offset=8064)),
    ("decode-append fp32", (1, 128, 8192, 8, 4, 256), "float32",
     dict(causal=True, q_offset=8064)),
    ("fully masked rows", (1, 64, 64, 2, 2, 32), "float32",
     dict(causal=True, q_offset=-4)),
)
ATTENTION_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
# A second limit: the error's RMS as a share of the plain output's RMS.
# Where rows average thousands of keys, a typical output (sqrt(e / Skv),
# 0.018 at 8192) is the size of the bf16 limit, so a kv combine that drops
# a piece or skips the e^(m_s - m) rescale (RMS share 0.25-0.35 at the
# decode-append, attention_mutants.py on an H100) could pass it
# elementwise. Rounding P and the output to bf16 leaves the sound kernel
# near 2^-9 (0.0021-0.0024 in this phase on an H100); fp32 below 1e-5.
ATTENTION_RMS_SHARE = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -6}


def attention_inputs(gen, shape, dtype: str, dev):
    """q [B, Sq, H, D], k and v [B, Skv, Kv, D]: N(0, 1) from ``gen`` in
    ``dtype``."""
    import torch

    b, sq, skv, h, kvh, d = shape
    return [torch.randn(size, generator=gen, device=dev).to(
        getattr(torch, dtype)) for size in ((b, sq, h, d), (b, skv, kvh, d),
                                            (b, skv, kvh, d))]


def attention_pairs(sq: int, skv: int, causal: bool, window,
                    q_offset: int) -> int:
    """Unmasked (query, key) pairs of one head: each row at position
    q_offset + i sees keys max(0, pos - window + 1) .. min(Skv - 1, pos)."""
    import numpy as np

    pos = np.arange(sq, dtype=np.int64) + q_offset
    lo = np.maximum(pos - window + 1, 0) if window is not None else 0
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_bound_ms(shape, itemsize: int, pairs: int):
    """(bound ms, "bytes" or "operations"): q, k, v and the output once
    each over 3.35 TB/s; 4·B·H·D FLOPs per unmasked pair over 989
    TFLOP/s."""
    b, sq, skv, h, kvh, d = shape
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * skv * kvh * d)
    t_ops = 4 * b * h * d * pairs / BF16_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def sdpa_call(q, k, v, opts):
    """One ``F.scaled_dot_product_attention`` call computing the same
    function, or None where none does: a softcap, or a row with no key
    (SDPA gives NaN there, the kernel 0). A window or an offset becomes a
    boolean mask, GQA ``enable_gqa``. Timed only, as a yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    if opts.get("softcap") is not None:
        return None
    sq, skv = q.shape[1], k.shape[1]
    mask = ref.attention_mask(sq, skv, causal=opts["causal"],
                              window=opts.get("window"),
                              q_offset=opts.get("q_offset", 0),
                              device=q.device)
    if not bool(mask.any(-1).all()):
        return None
    kw = {"enable_gqa": q.shape[2] != k.shape[2]}
    if not bool(mask.all()):
        kw["attn_mask"] = mask
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  **kw).transpose(1, 2)


def attention_readings(out, want, dtype: str):
    """(max abs error, largest share of the elementwise limit tol +
    tol·|want| of ``ATTENTION_TOL``, RMS(out - want) / RMS(want))."""
    tol = ATTENTION_TOL[dtype]
    wf = want.float()
    err = (out.float() - wf).abs()
    return (float(err.max()), float((err / (tol + tol * wf.abs())).max()),
            float(err.square().mean().sqrt()
                  / wf.square().mean().sqrt().clamp_min(1e-30)))


def attention_within(label: str, out, want, dtype: str, what: str):
    """Raise unless ``out`` has ``want``'s shape and ``dtype``, every
    element within its limit and the RMS share within
    ``ATTENTION_RMS_SHARE``. Returns :func:`attention_readings`."""
    import torch

    limit = ATTENTION_RMS_SHARE[dtype]
    err, reading, share = attention_readings(out, want, dtype)
    if (out.shape != want.shape or out.dtype != getattr(torch, dtype)
            or not reading <= 1.0 or not share <= limit):
        raise AssertionError(
            f"flash_attention {label}: kernel vs {what}: max err {err} "
            f"({reading:.3g} of the limit {ATTENTION_TOL[dtype]}·(1 + "
            f"|plain|)), RMS share {share:.3g} (limit {limit})")
    return err, reading, share


ATTENTION_DESIGN = {"float32": "3xTF32 mma.sync m16n8k8",
                    "bfloat16": "bf16 mma.sync m16n8k16"}


def attention_phase(dev="cuda"):
    """Phase 7: the attention kernel against its plain version on the card
    at every case of ``ATTENTION_CASES``, within both limits of
    ``attention_within`` (and, where the plan splits the kv range, against
    the plain version of the split too); rows with no key exactly 0. Prints
    each case's design and kv split count; times kernel, plain version and
    SDPA (where one call fits) and the bound. Returns the per-case rows and
    the largest error."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(7)
    rows, max_err = [], 0.0
    for label, shape, dtype, opts in ATTENTION_CASES:
        b, sq, skv, h, kvh, d = shape
        q, k, v = attention_inputs(gen, shape, dtype, dev)
        plan = fa.attention_plan(b, h, sq, skv, causal=opts["causal"],
                                 window=opts.get("window"),
                                 q_offset=opts.get("q_offset", 0))
        out = fa.flash_attention_cuda(q, k, v, **opts)
        plain = ref.flash_attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err, reading, share = attention_within(label, out, plain, dtype,
                                               "plain")
        if plan.splits > 1:
            attention_within(label, out, ref.flash_attention_split_ref(
                q, k, v, fa.split_ranges(plan, skv), **opts), dtype,
                f"plain {plan.splits}-piece split")
        mask = ref.attention_mask(sq, skv, causal=opts["causal"],
                                  window=opts.get("window"),
                                  q_offset=opts.get("q_offset", 0),
                                  device=dev)
        dead = ~mask.any(-1)
        if bool(dead.any()) and not bool((out[:, dead] == 0).all()):
            raise AssertionError(f"flash_attention {label}: a row with no "
                                 "key is not 0")
        max_err = max(max_err, err)
        pairs = attention_pairs(sq, skv, opts["causal"], opts.get("window"),
                                opts.get("q_offset", 0))
        bound_ms, bound_by = attention_bound_ms(shape, q.element_size(),
                                                pairs)
        lib = sdpa_call(q, k, v, opts)
        lib_err = (None if lib is None else
                   float((lib().float() - plain.float()).abs().max()))
        del out, plain
        row = {"case": label, "shape_b_sq_skv_h_kv_d": list(shape),
               "dtype": dtype, "options": opts, "max_abs_err": err,
               "dead_rows": int(dead.sum()), "tol_reading": reading,
               "rms_share": share, "design": ATTENTION_DESIGN[dtype],
               "kv_splits": plan.splits,
               "pairs_per_head": pairs,
               "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                             **opts)),
               "plain_ms": time_ms(lambda: ref.flash_attention_ref(
                   q, k, v, **opts)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None if lib is None else time_ms(lib),
               "library_max_abs_err": lib_err}
        rows.append(row)
        log("attention", "{case} {shape_b_sq_skv_h_kv_d} {dtype} {options}: "
            "{design}, {kv_splits} kv piece(s); max err {max_abs_err:.3g} "
            "({tol_reading:.3g} of the limit), RMS share {rms_share:.3g}, "
            "{ms:.4f} ms (plain {plain_ms:.4f} ms, SDPA {library_ms}), bound "
            "{bound_ms:.4f} ms ({bound_by})".format(**row))
        del q, k, v
        torch.cuda.empty_cache()
    log("attention", f"kernel within tolerance of its plain version in all "
        f"{len(rows)} cases (2e-5 fp32, 2e-2 bf16; RMS shares "
        f"{ATTENTION_RMS_SHARE}); max_abs_err {max_err}")
    return rows, max_err


def vit_phase(est, x):
    """Phase 8: the ViT pair on the card. The DC-ST session with the
    ViT-B/32 student and ViT-B/16 teacher (attention through the kernel,
    MX6 serving copies through the quantize kernels); full width at 224 px
    (random weights, batch ``x``): the ViT-B/32 InferenceKernel and the
    ViT-B/16 LabelingKernel, 12 attention launches per forward; one
    MX-free SGD step of full-width ViT-B/32 with finite gradients.
    Returns the session's and the full-width launch counts."""
    import torch

    from repro_torch.configs.dacapo_pairs import VIT_B16, VIT_B32
    from repro_torch.core.allocation import CLHyperParams
    from repro_torch.core.kernel import sgd_momentum_step
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_leaves, tree_map

    launches, stats, *_ = session_phase(
        "vit", VIT_B32, VIT_B16,
        ("mx_quantize", "mx_dequantize", "flash_attention"))
    if stats["flash_attention"] != {"cuda": launches["flash_attention"]}:
        raise AssertionError(f"attention calls {stats['flash_attention']} "
                             f"!= launches {launches['flash_attention']}")

    def expect_attention(n: int, what: str) -> None:
        got = mxq.launch_counts()["flash_attention"]
        served = ops.kernel_stats().get("flash_attention")
        if got != n or served != {"cuda": n}:
            raise AssertionError(f"{what}: {got} attention launches, "
                                 f"kernel_stats {served}; expected {n}")

    gen = torch.Generator().manual_seed(3)
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    full = {}
    for cfg in (VIT_B32, VIT_B16):
        full[cfg.name] = make_vision_model(cfg, x.device).init(gen)
        kern, serving = full_width_serve("vit", cfg, full[cfg.name], x, est,
                                         inference=cfg is VIT_B32)
        before = mxq.launch_counts()["flash_attention"]
        with torch.no_grad():
            kern._run_apply(serving, x)
        torch.cuda.synchronize()
        per_forward = mxq.launch_counts()["flash_attention"] - before
        if per_forward != cfg.num_layers:
            raise AssertionError(f"{cfg.name}: {per_forward} attention "
                                 "launches per forward, expected "
                                 f"{cfg.num_layers}")
    full_launches = mxq.launch_counts()
    expect_attention(full_launches["flash_attention"], "full width")
    if min(full_launches[op] for op in ("mx_quantize", "mx_dequantize")) < 1:
        raise AssertionError(f"full-width launches {full_launches}")
    log("vit", f"full width: {VIT_B32.num_layers} attention launches per "
        f"forward; launches {full_launches}, all served by cuda")

    # One MX-free training step of full-width ViT-B/32: the attention's
    # backward (plain PyTorch) on the card.
    model = make_vision_model(VIT_B32, x.device)
    params = full[VIT_B32.name]
    y = torch.randint(0, VIT_B32.num_classes, (len(x),),
                      generator=torch.Generator().manual_seed(4)).to(x.device)
    opt = tree_map(torch.zeros_like, params)
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    t0 = time.perf_counter()
    new_params, grads, loss = sgd_momentum_step(model, params, opt, x, y,
                                                CLHyperParams().lr)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    expect_attention(VIT_B32.num_layers, "training step")
    # From zero momentum the new momentum is the gradient.
    if not bool(torch.isfinite(loss)) or not all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(grads)):
        raise AssertionError("ViT-B/32 training step: non-finite loss or "
                             "gradient")
    if all(bool((a == b).all()) for a, b in zip(tree_leaves(new_params),
                                                tree_leaves(params))):
        raise AssertionError("ViT-B/32 training step changed no weight")
    log("vit", f"vit-b32 full-width SGD step at batch {len(x)}: loss "
        f"{float(loss):.4f}, every gradient finite, {step_s:.3f} s host wall "
        f"(first step), {VIT_B32.num_layers} attention launches")
    return launches, full_launches


def concurrent_clock(tag: str, res) -> None:
    """Every phase of a concurrent session ends at max(t_TSA, t_BSA) past
    its start, within the float rounding of the clock's additions
    (1e-12 of the phase-end time)."""
    worst, tsa_bound = 0.0, 0
    for rec in res.records:
        err = abs((rec.t - rec.phase_start) - max(rec.t_tsa, rec.t_bsa))
        if not err <= 1e-12 * rec.t:
            raise AssertionError(f"{tag}: phase {rec.index} took "
                                 f"{rec.t - rec.phase_start!r} s, not "
                                 f"max({rec.t_tsa!r}, {rec.t_bsa!r})")
        worst = max(worst, err)
        tsa_bound += rec.t_tsa >= rec.t_bsa
    log(tag, f"each of {len(res.records)} phases took max(t_TSA, t_BSA) "
        f"(largest difference {worst:.3g} s, limit 1e-12 of t); T-SA bound "
        f"in {tsa_bound}, B-SA in {len(res.records) - tsa_bound}; "
        f"speculation hits {sum(r.spec_hits for r in res.records)}, misses "
        f"{sum(r.spec_misses for r in res.records)}")


def sync_api_full_width(est):
    """Phase 9, part 4: the synchronous API at full width (224 px, 1000
    classes, random weights, MX6 serving copies through the kernels).
    ``LabelingKernel.label`` of WideResNet50 on 128 host frames, whole and
    with ``microbatch=32``: the ids must agree except on frames whose top
    two logits lie within twice that frame's logit difference between the
    two calls, and the largest logit difference must stay within 1e-3 of
    the largest logit (fp32 summation order: the convolutions' algorithms
    may differ by batch size). ``InferenceKernel.predict`` of ResNet18 at
    batch 32, on its MX6 serving copy. Frames/s of each, host frames in
    and host ids out, medians of 3 calls. Returns the launch counts and
    kernel_stats of the calls."""
    import numpy as np
    import torch

    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core.kernel import InferenceKernel, LabelingKernel
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.models.registry import make_vision_model

    px = WIDERESNET50.img_size
    frames = np.random.default_rng(2).normal(
        size=(128, px, px, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(9)
    teacher = make_vision_model(WIDERESNET50, "cuda")
    student = make_vision_model(RESNET18, "cuda")
    t_params, s_params = teacher.init(gen), student.init(gen)
    lab = LabelingKernel(teacher, WIDERESNET50, est, apply_mx=True,
                         device="cuda")
    inf = InferenceKernel(student, RESNET18, est, apply_mx=True,
                          device="cuda")
    torch.cuda.synchronize()
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    whole = lab.label(t_params, frames, "mx6")
    micro = lab.label(t_params, frames, "mx6", microbatch=32)
    # predict serves the tree it is given: the session's UpdateWeight.
    s_serving = inf.serving_params(s_params, "mx6")
    pred = inf.predict(s_serving, frames[:32])
    torch.cuda.synchronize()
    launches, stats = mxq.launch_counts(), ops.kernel_stats()
    for op in ("mx_quantize", "mx_dequantize"):
        if launches[op] != 2 or stats[op] != {"cuda": 2}:
            raise AssertionError(f"full-width sync API: {op} launched "
                                 f"{launches[op]} times, kernel_stats "
                                 f"{stats[op]}: expected one fill of each "
                                 "kernel's serving copy")
    if lab.n_apply_calls != 1 + 4 or inf.n_apply_calls != 1:
        raise AssertionError(f"forwards: label {lab.n_apply_calls}, "
                             f"predict {inf.n_apply_calls}")
    if (whole.shape != (128,) or pred.shape != (32,)
            or not isinstance(whole, np.ndarray)
            or not ((0 <= pred) & (pred < RESNET18.num_classes)).all()):
        raise AssertionError(f"bad ids: {whole.shape}, {pred.shape}")
    serving = lab.serving_cache.get(t_params, "mx6")
    with torch.no_grad():
        lg_whole = lab._run_apply(serving, frames)
        lg_micro = torch.cat([lab._run_apply(serving, frames[i: i + 32])
                              for i in range(0, 128, 32)])
    if not bool(torch.isfinite(lg_whole).all()):
        raise AssertionError("WideResNet50 logits not finite")
    if not np.array_equal(whole, lg_whole.argmax(-1).cpu().numpy()):
        raise AssertionError("label ids != argmax of the same forward")
    delta = (lg_whole - lg_micro).abs()
    scale = float(lg_whole.abs().max())
    max_diff = float(delta.max())
    if not max_diff <= 1e-3 * max(1.0, scale):
        raise AssertionError(f"whole vs microbatched logits differ by "
                             f"{max_diff} (largest logit {scale})")
    top2 = lg_whole.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    limit = 2 * delta.max(-1).values.cpu().numpy()
    differ = whole != micro
    if (differ & (gap > limit)).any():
        raise AssertionError(f"{int(differ.sum())} label ids differ "
                             "between whole and microbatched labeling "
                             "where the top two logits are apart")
    log("modes", f"full width, sync API: wideresnet50 label() ids equal "
        f"whole and microbatched (32) on {128 - int(differ.sum())} of 128 "
        f"frames, {int(differ.sum())} excused as near ties; logits max "
        f"|whole - microbatched| {max_diff:.3g} (largest logit "
        f"{scale:.3g}; limit 1e-3 of it); resnet18 predict() at batch 32; "
        f"launches {launches}, kernel_stats {stats}")

    def fps(fn, n: int) -> float:
        fn()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()  # returns host ids: synchronised
            walls.append(time.perf_counter() - t0)
        return n / float(np.median(walls))

    rates = {
        "wideresnet50 label, 128 frames": fps(
            lambda: lab.label(t_params, frames, "mx6"), 128),
        "wideresnet50 label, 128 frames, microbatch 32": fps(
            lambda: lab.label(t_params, frames, "mx6", microbatch=32), 128),
        "resnet18 predict, 32 frames": fps(
            lambda: inf.predict(s_serving, frames[:32]), 32),
    }
    log("modes", "frames/s (host frames in, host ids out, median of 3): "
        + "; ".join(f"{k} {v:.1f}" for k, v in rates.items())
        + f" | {nvidia_smi_line()}")
    return launches, stats


def modes_phase(est):
    """Phase 9: the engine's other modes on the card, through
    ``CLSystemSpec(...).build()`` → ``run`` (each session twice from a
    fresh build and generator, bit for bit, as phases 4 and 8): the phase-4
    ResNet session under concurrent dispatch; the same on
    ``forced_row_mesh(2)`` with DC-ST-Online (each partition change
    logged); the ViT pair under concurrent dispatch (labeling microbatched
    at 64); then the synchronous API at full width
    (:func:`sync_api_full_width`). Returns each part's launch counts."""
    from repro_torch.configs.dacapo_pairs import (RESNET18, VIT_B16, VIT_B32,
                                                  WIDERESNET50)
    from repro_torch.core.partition import forced_row_mesh

    mx_ops = ("mx_quantize", "mx_dequantize")
    counts = {}
    launches, _, session, res, walls = session_phase(
        "modes", RESNET18, WIDERESNET50, mx_ops, dispatch="concurrent")
    concurrent_clock("modes", res)
    counts["concurrent"] = launches
    log("modes", f"resnet pair, concurrent: walls {walls[0]:.2f} / "
        f"{walls[1]:.2f} s, launches {launches}")

    seen = []
    mesh = forced_row_mesh(2)
    launches, _, session, res, walls = session_phase(
        "modes", RESNET18, WIDERESNET50, mx_ops, dispatch="concurrent",
        allocator="dacapo-spatiotemporal-online", mesh=mesh,
        observer=lambda s, rec: seen.append(
            (s, rec.index, rec.decision.rows_bsa, s._mesh_rows_bsa,
             s.partition)))
    concurrent_clock("modes", res)
    counts["mesh"] = launches
    trace = [entry[1:] for entry in seen if entry[0] is session]
    seen.clear()
    part = session.partition
    log("modes", f"mesh {mesh.devices.shape} of {list(mesh.devices.flat)}: "
        f"at construction rows_bsa {session.r_bsa} of "
        f"{session.estimator.total_rows} -> mesh split "
        f"{session._mesh_split(session.r_bsa)} (T-SA "
        f"{part.t_devices.shape}, B-SA {part.b_devices.shape}); inference "
        f"on {session.inference._device}, labeling on "
        f"{session.labeling._device}, retraining on "
        f"{session.retrain._device}")
    refissions, last = 0, trace[0][3] if trace else None
    for index, rows_bsa, split, partition in trace:
        if partition is not last:
            refissions += 1
            log("modes", f"phase {index}: rows_bsa {rows_bsa} -> mesh split "
                f"{split} (re-fission)")
        last = partition
    moved = sorted({rows_bsa for _, rows_bsa, _, _ in trace})
    if refissions == 0:
        log("modes", f"no re-fission in {len(trace)} phases: the decisions' "
            f"rows_bsa took {moved}, and on a 2-row mesh _mesh_split maps "
            "every B-SA share of 1..15 of 16 rows to 1 mesh row "
            f"({[session._mesh_split(r) for r in moved]})")
    log("modes", f"mesh, dc-st-online, concurrent: walls {walls[0]:.2f} / "
        f"{walls[1]:.2f} s, launches {launches}")

    launches, stats, session, res, walls = session_phase(
        "modes", VIT_B32, VIT_B16, mx_ops + ("flash_attention",),
        dispatch="concurrent")
    concurrent_clock("modes", res)
    if session._label_microbatch != 64:
        raise AssertionError(f"labeling microbatch "
                             f"{session._label_microbatch}, expected 64")
    if stats["flash_attention"] != {"cuda": launches["flash_attention"]}:
        raise AssertionError(f"attention calls {stats['flash_attention']} "
                             f"!= launches {launches['flash_attention']}")
    counts["vit_concurrent"] = launches
    log("modes", f"vit pair, concurrent, labeling microbatched at 64: "
        f"flash_attention launches {launches['flash_attention']}, "
        f"kernel_stats {stats['flash_attention']} (no plain call); walls "
        f"{walls[0]:.2f} / {walls[1]:.2f} s")

    counts["full_width_sync"], _ = sync_api_full_width(est)
    return counts


def replay_checks(tag: str, trace) -> float:
    """Phase 10: every phase of ``trace`` replays bit for bit
    (``TraceReplayer.phase_time`` == the recorded end) and a ``save`` /
    ``load`` round trip gives an equal trace. Returns the MAPE (per cent)
    of the ``from_units=True`` prediction against the recorded concurrent
    phase times (a report, not a check; None for a sequential trace)."""
    import tempfile

    from repro_torch.core.replay import TraceReplayer
    from repro_torch.core.trace import SessionTrace

    if not trace.phases:
        raise AssertionError(f"{tag}: the trace holds no phase")
    rep = TraceReplayer(trace)
    for i, ph in enumerate(trace.phases):
        got = rep.phase_time(i)
        if got != ph.end:
            raise AssertionError(f"{tag}: phase {i} replays to {got!r}, "
                                 f"recorded end {ph.end!r}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        trace.save(path)
        if SessionTrace.load(path).as_dict() != trace.as_dict():
            raise AssertionError(f"{tag}: save / load changed the trace")
    if trace.phases[0].mode != "concurrent":
        return None
    errs = [abs(rep.predict(i, from_units=True) - ph.end) / ph.end
            for i, ph in enumerate(trace.phases) if ph.end > 0]
    return 100.0 * sum(errs) / len(errs)


def host_breakdown(tag: str, trace, wall_s: float) -> dict:
    """Phase 10: the run's host time by label — Σwall_s, Σcost_s and
    Σunits of each label's events (programs' issue walls, the retrain
    charge's measured fit; units are frames, samples or SGD batches), the
    ``calibrate()`` scale Σwall/Σcost, and the share of the run's host
    wall that each label's Σwall is; what no event covers (frame windows,
    the score sink's forwards, fills outside programs, the phase-end
    collect, the policy) is ``unrecorded``."""
    from repro_torch.core.replay import TraceReplayer

    cal = TraceReplayer(trace).calibrate()
    rows = {}
    for e in trace.events():
        row = rows.setdefault(e.label, {"events": 0, "wall_s": 0.0,
                                        "cost_s": 0.0, "units": 0.0})
        row["events"] += 1
        row["wall_s"] += e.wall_s
        row["cost_s"] += e.cost_s
        row["units"] += e.units
    for label, row in rows.items():
        row["scale"] = cal.scales.get(label)
        row["wall_share"] = row["wall_s"] / wall_s
    recorded = sum(row["wall_s"] for row in rows.values())
    out = {"run_wall_s": wall_s, "labels": rows,
           "recorded_wall_s": recorded,
           "unrecorded_wall_s": wall_s - recorded,
           "global_scale": cal.global_scale}
    log("trace", f"{tag}: host time by label over a run of {wall_s:.4f} s "
        "(label: events, Σwall s (share of the run), Σcost virtual s, "
        "calibrate() scale, Σunits): " + "; ".join(
            f"{label}: {row['events']}, {row['wall_s']:.4f} "
            f"({100 * row['wall_share']:.1f} %), {row['cost_s']:.4f}, "
            + ("-" if row["scale"] is None else f"{row['scale']:.4g}")
            + f", {row['units']:g}"
            for label, row in sorted(rows.items()))
        + f"; unrecorded {out['unrecorded_wall_s']:.4f} s "
        f"({100 * out['unrecorded_wall_s'] / wall_s:.1f} %); global scale "
        f"{cal.global_scale:.4g}")
    return out


def traced_pair(tag: str, student, teacher, **spec):
    """Phase 10, part 1: one untraced and one traced :func:`session_run` of
    one description; they must agree bit for bit
    (:func:`run_differences`), fills through the kernels only, and every
    phase of the trace must replay bit for bit. Returns both runs and the
    trace."""
    untraced = session_run(student, teacher, **spec)
    traced = session_run(student, teacher, trace=True, **spec)
    diffs = run_differences(untraced, traced)
    if diffs:
        raise AssertionError(f"{tag}: traced != untraced: "
                             + "; ".join(diffs))
    session, _, res, wall, _, fills, launches, stats = traced
    fill_checks(tag, fills, launches, stats)
    recorder = session.dispatcher.recorder
    if recorder is None or untraced[0].dispatcher.recorder is not None:
        raise AssertionError(f"{tag}: recorder not as configured")
    trace = recorder.trace
    mape = replay_checks(tag, trace)
    paths = {}
    for e in trace.events():
        if e.kind == "program":
            paths[e.label, e.path] = paths.get((e.label, e.path), 0) + 1
    if any(path == "plain" for _, path in paths):
        raise AssertionError(f"{tag}: a program took the plain path: "
                             f"{paths}")
    log("trace", f"{tag}: traced == untraced bit for bit ({len(res.phase_log)}"
        f" phases); every one of {len(trace.phases)} recorded phases "
        f"replays bit for bit and survives save / load; walls untraced "
        f"{untraced[3]:.4f} s, traced {wall:.4f} s; programs by (label, "
        f"path) {dict(sorted(paths.items()))}; from-units MAPE "
        + ("n/a (sequential)" if mape is None else f"{mape:.6f} %"))
    return untraced, traced, trace, mape


def replay_policy_run(tag: str) -> dict:
    """Phase 10, part 3: ``dacapo-replay`` under concurrent dispatch,
    ``eval_fps=2.0``. It charges measured host wall to its virtual clock,
    so it is not held to repeat: it must create its own recorder, charge a
    positive ``profile_cost_s`` after every phase that retrained (the
    phases it re-prices), replay every phase bit for bit, and fill through
    the kernels only."""
    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core.trace import TraceRecorder

    session, _, res, wall, _, fills, launches, stats = session_run(
        RESNET18, WIDERESNET50, allocator="dacapo-replay",
        dispatch="concurrent", eval_fps=2.0)
    recorder = session.dispatcher.recorder
    if not isinstance(recorder, TraceRecorder) or (
            session.allocator._trace_recorder is not recorder):
        raise AssertionError(f"{tag}: dacapo-replay made no recorder")
    fill_checks(tag, fills, launches, stats)
    trace = recorder.trace
    replay_checks(tag, trace)
    phases = trace.phases
    for i in range(1, len(phases)):
        cost = phases[i].decisions[0]["profile_cost_s"]
        rescored = any(e.label == "retrain" for e in phases[i - 1].events)
        if (cost > 0) != rescored:
            raise AssertionError(f"{tag}: phase {i} profile_cost_s {cost!r}"
                                 f" after a phase that retrained: {rescored}")
    n_t = session.hp.n_t
    picks = [r.decision.retrain_samples for r in res.records]
    boosts = sum(n > n_t for n in picks)
    profile = [ph.decisions[0]["profile_cost_s"] for ph in phases]
    log("trace", f"{tag}: {len(phases)} phases, recorder made by the "
        f"policy; retrain samples chosen {picks} (DC-ST's base {n_t}: "
        f"{boosts} boosted); profile_cost_s charged "
        f"{[round(c, 6) for c in profile]} (sum {sum(profile):.6f} s); avg "
        f"accuracy {res.avg_accuracy!r}; wall {wall:.4f} s; every phase "
        f"replays bit for bit; {fills} fills, launches {launches}")
    return {"phases": len(phases), "boosts": boosts,
            "profile_cost_s": sum(profile), "avg_accuracy": res.avg_accuracy,
            "wall_s": wall, "launches": launches}


def full_width_trace(est, dev="cuda") -> dict:
    """Phase 10, part 4: at full width (224 px, 1000 classes, random
    weights, MX6 serving) one traced concurrent ``KernelDispatcher`` phase
    issuing, per vision pair (ViT-B/32 / ViT-B/16, ResNet18 /
    WideResNet50), the student's ``predict_async`` on 32 frames (``b_sa``,
    "score"; its serving copy filled inside the program) and the teacher's
    ``label_async`` on 128 frames microbatched at 64 (``t_sa``, "label"),
    each costed by ``plan_time_per_sample`` at the offline row split, as
    the session does. Fresh kernels each run, so every program fills its
    serving copy. Checks: the ViT programs' path is "cuda", with 12
    attention launches per forward; every program that filled has path
    "cuda"; ``finish()`` equals the replayed phase end bit for bit; the
    outputs equal an untraced repeat bit for bit. Prints each program's
    ``wall_s`` beside its device time (CUDA events around the issue)."""
    import numpy as np
    import torch

    from repro_torch.configs.dacapo_pairs import (RESNET18, VIT_B16, VIT_B32,
                                                  WIDERESNET50)
    from repro_torch.core.decision import SpatialPlan
    from repro_torch.core.dispatch import KernelDispatcher
    from repro_torch.core.estimator import spatial_allocation
    from repro_torch.core.kernel import InferenceKernel, LabelingKernel
    from repro_torch.core.replay import TraceReplayer
    from repro_torch.core.trace import TraceRecorder
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.models.registry import make_vision_model

    pairs = ((VIT_B32, VIT_B16), (RESNET18, WIDERESNET50))
    gen = torch.Generator().manual_seed(10)
    weights = {cfg.name: make_vision_model(cfg, dev).init(gen)
               for pair in pairs for cfg in pair}
    rng = np.random.default_rng(10)
    px = VIT_B16.img_size
    x32, x128 = (torch.from_numpy(rng.normal(size=(n, px, px, 3)).astype(
        np.float32)).to(dev) for n in (32, 128))

    def programs():
        out = []
        for s_cfg, t_cfg in pairs:
            inf = InferenceKernel(make_vision_model(s_cfg, dev), s_cfg, est,
                                  apply_mx=True, device=dev)
            lab = LabelingKernel(make_vision_model(t_cfg, dev), t_cfg, est,
                                 apply_mx=True, device=dev)
            r_tsa, r_bsa = spatial_allocation(est, s_cfg, 30.0, "mx6")
            spatial = SpatialPlan(r_tsa, r_bsa).resolve(r_tsa, r_bsa,
                                                        est.total_rows)
            sp, tp = weights[s_cfg.name], weights[t_cfg.name]
            out.append((s_cfg, inf, "b_sa", "score",
                        lambda k=inf, p=sp: k.predict_async(
                            k.serving_params(p, "mx6"), x32),
                        len(x32) * inf.plan_time_per_sample(spatial),
                        len(x32)))
            out.append((t_cfg, lab, "t_sa", "label",
                        lambda k=lab, p=tp: k.label_async(
                            p, x128, "mx6", microbatch=64),
                        len(x128) * lab.plan_time_per_sample(spatial),
                        len(x128)))
        return out

    def run(recorder):
        plan = KernelDispatcher("concurrent", recorder=recorder).begin_phase(
            0.0)
        rows = []
        torch.cuda.synchronize()
        for cfg, kern, role, label, thunk, cost, units in programs():
            fills, forwards = kern.serving_cache.fills, kern.n_apply_calls
            before = mxq.launch_counts()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            handle = plan.dispatch(role, label, thunk, cost_s=cost,
                                   units=units)
            b.record()
            after = mxq.launch_counts()
            rows.append({
                "program": f"{cfg.name} {label}", "cfg": cfg, "role": role,
                "cost_s": cost, "units": units, "handle": handle,
                "events": (a, b),
                "fills": kern.serving_cache.fills - fills,
                "forwards": kern.n_apply_calls - forwards,
                "launches": {op: after[op] - before[op] for op in after
                             if after[op] != before[op]}})
        end = plan.finish()
        outs = [row.pop("handle").collect() for row in rows]
        torch.cuda.synchronize()
        for row in rows:
            a, b = row.pop("events")
            row["device_ms"] = a.elapsed_time(b)
        return end, outs, rows

    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    recorder = TraceRecorder()
    end, outs, rows = run(recorder)
    launches, stats = mxq.launch_counts(), ops.kernel_stats()
    phase = recorder.phases[0]
    replayed = TraceReplayer(recorder.trace).phase_time(0)
    if replayed != end or phase.end != end:
        raise AssertionError(f"full-width trace: finish() {end!r} != "
                             f"replayed {replayed!r}")
    events = [e for e in phase.events if e.kind == "program"]
    if len(events) != len(rows):
        raise AssertionError(f"full-width trace: {len(events)} program "
                             f"events for {len(rows)} programs")
    for row, e in zip(rows, events):
        cfg = row["cfg"]
        row["wall_s"], row["path"] = e.wall_s, e.path
        if (e.role, e.cost_s, e.units) != (row["role"], row["cost_s"],
                                           row["units"]):
            raise AssertionError(f"{row['program']}: event {e}")
        if row["fills"] and e.path != "cuda":
            raise AssertionError(f"{row['program']} filled a serving copy "
                                 f"on path {e.path!r}")
        if cfg.kind == "vit":
            want = cfg.num_layers * row["forwards"]
            if e.path != "cuda" or row["launches"].get(
                    "flash_attention") != want:
                raise AssertionError(f"{row['program']}: path {e.path!r}, "
                                     f"launches {row['launches']}, expected "
                                     f"{want} attention launches")
        if row["fills"] and any(row["launches"].get(op) != 1 for op in (
                "mx_quantize", "mx_dequantize")):
            raise AssertionError(f"{row['program']}: launches "
                                 f"{row['launches']} for one fill")
    if any(paths.get("plain") for paths in stats.values()):
        raise AssertionError(f"full-width trace: plain calls {stats}")
    end2, outs2, rows2 = run(None)
    if end2 != end or not all(np.array_equal(a, b)
                              for a, b in zip(outs, outs2)):
        raise AssertionError("full-width trace: traced != untraced repeat")
    for row, row2 in zip(rows, rows2):
        row["device_ms_untraced"] = row2["device_ms"]
        log("trace", f"full width, {row['program']} [{row['role']}] "
            f"{row['units']} frames: path {row['path']!r}, wall_s "
            f"{row['wall_s']:.6f} s, device {row['device_ms']:.4f} ms "
            f"(untraced repeat {row2['device_ms']:.4f} ms), cost_s "
            f"{row['cost_s']:.6f}, fills {row['fills']}, forwards "
            f"{row['forwards']}, launches {row['launches']}")
    log("trace", f"full width: one traced concurrent phase of {len(rows)} "
        f"programs, finish() {end!r} == replayed end; outputs equal the "
        f"untraced repeat bit for bit; launches {launches}, kernel_stats "
        f"{stats}")
    return {"launches": launches, "rows": [
        {key: row[key] for key in ("program", "role", "units", "cost_s",
                                   "path", "wall_s", "device_ms",
                                   "device_ms_untraced", "fills",
                                   "forwards", "launches")}
        for row in rows]}


def trace_phase(est) -> dict:
    """Phase 10: the trace spine on the card. (1) Phase 4's session in each
    dispatch mode, traced and untraced, bit for bit the same; every phase
    replays bit for bit, saves and loads; the from-units MAPE printed.
    (2) The host time by label of those traced sessions and of phase 8's
    ViT session (traced and untraced, also bit for bit the same), beside
    the traced and untraced walls. (3) ``dacapo-replay``, concurrent
    (:func:`replay_policy_run`). (4) The full-width traced phase
    (:func:`full_width_trace`). Returns each part's launch counts, the
    breakdowns and the MAPEs."""
    from repro_torch.configs.dacapo_pairs import (RESNET18, VIT_B16, VIT_B32,
                                                  WIDERESNET50)

    out = {"launches": {}, "breakdown": {}, "mape_pct": {}, "walls": {}}
    for tag, pair, spec in (
            ("resnet_sequential", (RESNET18, WIDERESNET50), {}),
            ("resnet_concurrent", (RESNET18, WIDERESNET50),
             {"dispatch": "concurrent"}),
            ("vit_sequential", (VIT_B32, VIT_B16), {})):
        untraced, traced, trace, mape = traced_pair(tag, *pair, **spec)
        out["launches"][tag] = traced[6]
        out["mape_pct"][tag] = mape
        out["walls"][tag] = {"untraced_s": untraced[3],
                             "traced_s": traced[3]}
        out["breakdown"][tag] = host_breakdown(tag, trace, traced[3])
        if pair[0] is VIT_B32:
            attention = traced[7].get("flash_attention", {})
            if attention != {"cuda": traced[6]["flash_attention"]} or (
                    not attention):
                raise AssertionError(f"{tag}: attention {attention}")
        del untraced, traced, trace
    replay = replay_policy_run("replay_concurrent")
    out["launches"]["replay_concurrent"] = replay.pop("launches")
    out["replay"] = replay
    full = full_width_trace(est)
    out["launches"]["full_width"] = full["launches"]
    out["full_width"] = full["rows"]
    print("[trace] summary " + json.dumps(out, default=float), flush=True)
    return out


GEMM_SOURCE = "src/repro_torch/kernels/csrc/mx_gemm.cu"
GEMM_REPLACES = {  # the Pallas kernel each GEMM kernel replaces
    "mx_matmul": "src/repro/kernels/mx_matmul.py:76",
    "mx_matmul_fused": "src/repro/kernels/mx_fused.py:102",
    "mx_matmul_bwd_pair": "src/repro/kernels/mx_fused.py:189",
    "mx_matmul_prequant": "src/repro/kernels/mx_fused.py:301",
}


def gemm_weights(params):
    """The weights of a ResNet tree in ``vision_gemms`` order (stem; per
    block conv1, conv2 and the projection; head), each reshaped HWIO ->
    [kh*kw*cin, cout] = [K, N]."""
    ws = [params["stem"]]
    for bp in params["blocks"]:
        ws += [bp[key] for key in ("conv1", "conv2", "conv3", "proj")
               if key in bp]
    ws.append(params["head_w"])
    return [w.reshape(-1, w.shape[-1]) for w in ws]


def gemm_bound_ms(name: str, m: int, n: int, k: int):
    """(bound ms, "bytes" or "operations") of one GEMM kernel call: fp32
    operands at 4 bytes an element, stored MX operands at 1 + 2/16, each
    output once; operations over the bf16 tensor-core rate."""
    kp = -(-k // 16) * 16
    mx = 1 + 2 / 16
    flops = (4 if name == "mx_matmul_bwd_pair" else 2) * m * n * k
    nbytes = {
        "mx_matmul": mx * (m * kp + kp * n) + 4 * m * n,
        "mx_matmul_fused": 4 * (m * k + k * n + m * n),
        "mx_matmul_bwd_pair": 4 * (m * n + 2 * m * k + 2 * k * n),
        "mx_matmul_prequant": 4 * m * k + mx * kp * n + 4 * m * n,
    }[name]
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def pair_staged_floor_ms(m: int, n: int, k: int) -> float:
    """The least time of the staged pair's bytes: g, x and w read once as
    fp32; the four bf16 operands (``mx_fused.pair_stage_shapes``) written
    once and read once; dX and dW written once as fp32 — over 3.35 TB/s
    (its 4·M·N·K operations take less at the bf16 tensor-core rate at
    every phase-6 shape)."""
    from repro_torch.kernels import mx_fused as mxf

    staged = sum(r * c for r, c in mxf.pair_stage_shapes(m, n, k).values())
    nbytes = 4 * (m * n + m * k + k * n) + 2 * 2 * staged + 4 * (
        m * k + k * n)
    return max(nbytes / HBM_BYTES_PER_S,
               4 * m * n * k / BF16_FLOP_PER_S) * 1e3


def gemm_phase(cfg, params, batch: int, dev="cuda"):
    """Phase 6: the MX GEMM kernels on ``cfg``'s GEMMs at ``batch``, with
    the model's real weights. Drives MX9 training (``mx_dense`` forward and
    backward), MX6 serving (``mx_quantize_rhs`` then
    ``mx_dense_prequant``) and the unfused chain (``ops.mx_matmul``),
    checks launches, dispatch, the bitwise contracts and every kernel
    against its plain version, and times them. Returns the kernel rows."""
    import torch

    from repro_torch.core.estimator import vision_gemms
    from repro_torch.core.mx import mx_dense, mx_dense_prequant
    from repro_torch.kernels import mx_fused as mxf
    from repro_torch.kernels import mx_matmul as mxm
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops, ref

    dev = torch.device(dev)
    gemms = vision_gemms(cfg, batch=batch)
    ws = gemm_weights(params)
    if [tuple(w.shape) for w in ws] != [(k, n) for _, n, k in gemms]:
        raise AssertionError("weights do not match vision_gemms")
    plans = [(mxf.fused_plan(m, n, k)[0],
              *(p[0] for p in mxf.pair_plans(m, n, k))) for m, n, k in gemms]
    log("gemm", "tile (BM x BN) and contraction pieces S per GEMM (M, N, K): "
        "forward tile, pieces forward / pair dX / pair dW: " + "; ".join(
            f"{shape} {mxm.TILE_M}x{mxm.tile_n(shape[1])} {f}/{dx}/{dw}"
            for shape, (f, dx, dw) in zip(gemms, plans)))
    gen = torch.Generator(device=dev).manual_seed(6)
    acts = [torch.randn((m, k), generator=gen, device=dev)
            for m, _, k in gemms]
    cots = [torch.randn((m, n), generator=gen, device=dev)
            for m, n, _ in gemms]
    count = len(gemms)

    def expect(launches: dict, what: str) -> None:
        """Exactly ``launches`` on every counter, all served by "cuda"."""
        got = mxq.launch_counts()
        want = {name: launches.get(name, 0) for name in got}
        stats = ops.kernel_stats()
        want_stats = {op: {"cuda": n} for op, n in launches.items()}
        if got != want or stats != want_stats:
            raise AssertionError(f"{what}: launches {got}, kernel_stats "
                                 f"{stats}; expected {want_stats}")
        log("gemm", f"{what}: launches {launches}, all served by cuda")

    def reset() -> None:
        mxq.reset_launch_counts()
        ops.reset_kernel_stats()

    def mx9_training_pass():
        """y = mx_dense(a, w) and y.backward(g) for every GEMM; returns
        (y, dx, dw) per GEMM and the host wall seconds."""
        t0 = time.perf_counter()
        out = []
        for a, w, g in zip(acts, ws, cots):
            a_t = a.detach().requires_grad_(True)
            w_t = w.detach().requires_grad_(True)
            y = mx_dense(a_t, w_t, "mx9", "mx9")
            y.backward(g)
            out.append((y.detach(), a_t.grad, w_t.grad))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 1. Training at MX9: one fused launch and one pair launch per GEMM.
    reset()
    train, train_wall = mx9_training_pass()
    expect({"mx_matmul_fused": count, "mx_matmul_bwd_pair": count},
           f"MX9 training pass ({train_wall:.3f} s host wall, first pass)")
    launches = {"mx_matmul_fused": count, "mx_matmul_bwd_pair": count}

    # 2. Serving at MX6 against resident weights.
    reset()
    qws = [ops.mx_quantize_rhs(w, "mx6") for w in ws]
    serve = [mx_dense_prequant(a, qw, "mx6") for a, qw in zip(acts, qws)]
    torch.cuda.synchronize()
    expect({"mx_quantize": count, "mx_matmul_prequant": count},
           "MX6 serving pass")
    launches["mx_matmul_prequant"] = count

    # 3. The unfused chain.
    reset()
    unfused = [ops.mx_matmul(a, w, "mx6", "mx6") for a, w in zip(acts, ws)]
    torch.cuda.synchronize()
    expect({"mx_quantize": 2 * count, "mx_matmul": count}, "unfused chain")
    launches["mx_matmul"] = count

    # 4. Checks: the bitwise contracts, and each kernel within two limits
    # of its plain version (dequantized operands, then a fp32 matmul with
    # TF32 off): the worst summation-order limit 2·Kp·2^-24·(|A_q| @ |B_q|),
    # and the typical limit 4·sqrt(Kp)·2^-24·sqrt(A_q² @ B_q²) for these
    # zero-mean operands (ref.gemm_error_limits). Over the pair's long
    # dW contractions only the typical limit fails a wrong output, which
    # the controls below show at every GEMM.
    max_err = {name: 0.0 for name in GEMM_REPLACES}
    max_reading = {name: 0.0 for name in GEMM_REPLACES}  # err / typical
    least_control = {}  # smallest control reading per wrong output
    dw_readings = []  # per GEMM: the pair's dW and the two controls

    def qd(x, precision):
        return ref.mx_quant_dequant_ref(
            ops._pad_last(x, ref.BLOCK)[0].contiguous(), precision)

    def readings(out, plain, aq, bq_nk):
        """|out - plain| and its largest ratio to the worst and to the
        typical limit."""
        worst, typical = ref.gemm_error_limits(aq, bq_nk)
        err = (out - plain).abs()
        tiny = torch.finfo(torch.float32).tiny
        return (err, float((err / worst.clamp_min(tiny)).max()),
                float((err / typical.clamp_min(tiny)).max()))

    def within(name, what, out, plain, aq, bq_nk) -> float:
        err, r_worst, r_typical = readings(out, plain, aq, bq_nk)
        if (out.shape != plain.shape or not bool(torch.isfinite(out).all())
                or not r_worst <= 1 or not r_typical <= 1):
            raise AssertionError(
                f"{name} {what}: kernel vs plain outside the limits (max "
                f"err {float(err.max())}, {r_worst:.3g} x the worst and "
                f"{r_typical:.3g} x the typical limit)")
        max_err[name] = max(max_err[name], float(err.max()))
        max_reading[name] = max(max_reading[name], r_typical)
        return r_typical

    def check_all(a, w, g, outs, what, tp="mx9", sp="mx6", qw=None,
                  controls=False):
        """One GEMM: the kernels' outputs ``outs`` = (fused at ``tp``, the
        pair's dx and dw at ``tp``, prequant and unfused at ``sp``) vs
        their plain versions, and the contracts fused = unfused =
        prequant, pair = two fused. With ``controls``, an all-zero dW and
        a dW of g quantized along N (the wrong axis) must fail the typical
        limit."""
        y_t, dx, dw, y_p, y_u = outs
        (m, k), n = a.shape, w.shape[1]
        ap, wp = ops._pad_last(a, 16)[0], ops._pad_rows(w, (-k) % 16)
        within("mx_matmul_fused", what, y_t,
               ref.mx_matmul_fused_ref(ap, wp, tp, tp), qd(a, tp),
               qd(w.T, tp))
        g1, pad_n = ops._pad_last(g, 16)
        xt, pad_m = ops._pad_last(a.T, 16)
        pdx, pdw = ref.mx_matmul_bwd_pair_ref(
            g1, ops._pad_rows(w.T, pad_n), xt, ops._pad_rows(g, pad_m), tp)
        within("mx_matmul_bwd_pair", what + " dx", dx, pdx, qd(g, tp),
               qd(w, tp))
        xq, gq = qd(a.T, tp), qd(g.T, tp)
        r_dw = within("mx_matmul_bwd_pair", what + " dw", dw, pdw, xq, gq)
        stage, plain_stage = (mxf.pair_stage_cuda(g, a, w, tp),
                              ref.mx_pair_stage_ref(g, a, w, tp))
        if not all(torch.equal(stage[key][:, :t.shape[1]], t)
                   for key, t in plain_stage.items()):
            raise AssertionError(f"{what}: the pair's conversion stage != "
                                 "its plain version")
        del stage, plain_stage
        if controls:
            wrong_axis = ref._matmul_nt(
                xq, ops._pad_rows(qd(g, tp)[:, :n], pad_m).T)
            seen = [f"M={m}: {r_dw:.3g}"]
            for label, bad in (("zero", torch.zeros_like(dw)),
                               ("axis", wrong_axis)):
                _, r_worst, r_typical = readings(bad, pdw, xq, gq)
                if not r_typical > 1:
                    raise AssertionError(f"{what}: the typical limit passes "
                                         f"a {label} dW ({r_typical:.3g})")
                least_control[label] = min(
                    least_control.get(label, float("inf")), r_typical)
                seen.append(f"{label} {r_worst:.3g}w {r_typical:.3g}t")
            dw_readings.append(" ".join(seen))
        aq, bq = qd(a, sp), qd(w.T, sp)
        qw = ops.mx_quantize_rhs(w, sp) if qw is None else qw
        within("mx_matmul_prequant", what, y_p,
               ref.mx_matmul_prequant_ref(ap, qw, sp), aq, bq)
        within("mx_matmul", what, y_u, ref.mx_matmul_ref(
            ref.mx_quantize_ref(ap, sp), ref.mx_quantize_ref(wp.T, sp)),
            aq, bq)
        f_s = (y_t if sp == tp
               else mxf.mx_matmul_fused_cuda(a, w, sp, sp))
        if not (bitwise(f_s, y_p) and bitwise(f_s, y_u)):
            raise AssertionError(f"{what}: fused != prequant / unfused")
        if not (bitwise(dx, mxf.mx_matmul_fused_cuda(g, w.T, tp, tp))
                and bitwise(dw, mxf.mx_matmul_fused_cuda(a.T, g, tp, tp))):
            raise AssertionError(f"{what}: pair != two fused")

    for (m, n, k), a, w, g, (y9, dx, dw), y6_p, y6_u, qw in zip(
            gemms, acts, ws, cots, train, serve, unfused, qws):
        check_all(a, w, g, (y9, dx, dw, y6_p, y6_u), f"({m}, {n}, {k})",
                  qw=qw, controls=True)
    # Odd shapes: ragged M, N and K, and blocks of zeros (along K and N,
    # and a zero row: zero blocks along M for dW); mx4 and mx6 too.
    for m, n, k in ((5, 48, 33), (8, 128, 128)):
        a = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev)
        g = torch.randn((m, n), generator=gen, device=dev)
        if m == 8:
            a[:, 32:64], a[2], g[:, 32:64], g[3] = 0.0, 0.0, 0.0, 0.0
        for prec in ("mx4", "mx6", "mx9"):
            qb = ops.mx_quantize_rhs(w, prec)
            outs = (mxf.mx_matmul_fused_cuda(a, w, prec, prec),
                    *mxf.mx_matmul_bwd_pair_cuda(g, a, w, prec),
                    mxf.mx_matmul_prequant_cuda(a, qb, prec),
                    mxm.mx_matmul_cuda(ops.mx_quantize(a, prec), qb))
            check_all(a, w, g, outs, f"({m}, {n}, {k}) {prec}", prec, prec,
                      qb)
    torch.cuda.synchronize()
    log("gemm", f"contracts bitwise (fused = unfused = prequant, pair = two "
        f"fused), the pair's conversion stage equal to its plain version, "
        f"and every kernel within the worst and the typical limit of "
        f"its plain version on all {count} GEMMs and the odd shapes; "
        f"max_abs_err {max_err}; largest err / typical limit {max_reading}; "
        f"smallest control reading (must be > 1) {least_control}")
    log("gemm", "the pair's dW per GEMM, as err / typical limit, with the "
        "all-zero and the wrong-axis control as err / worst limit (w) and "
        "err / typical limit (t): " + "; ".join(dw_readings))
    del train, serve, unfused

    # 5. Times at the largest GEMM by operations, and of whole passes.
    big = max(range(count), key=lambda i: gemms[i][0] * gemms[i][1]
              * gemms[i][2])
    (m, n, k), a, w, g = gemms[big], acts[big], ws[big], cots[big]
    ap, wp = ops._pad_last(a, 16)[0], ops._pad_rows(w, (-k) % 16)
    qa6, qw6 = ops.mx_quantize(a, "mx6"), qws[big]
    g1, pad_n = ops._pad_last(g, 16)
    xt, pad_m = ops._pad_last(a.T, 16)
    wtp, g2 = ops._pad_rows(w.T, pad_n), ops._pad_rows(g, pad_m)
    qa6_ref, qwt6_ref = ref.mx_quantize_ref(ap, "mx6"), ref.mx_quantize_ref(
        wp.T, "mx6")
    timed = {
        "mx_matmul": (lambda: mxm.mx_matmul_cuda(qa6, qw6),
                      lambda: ref.mx_matmul_ref(qa6_ref, qwt6_ref), "mx6"),
        "mx_matmul_fused": (
            lambda: mxf.mx_matmul_fused_cuda(a, w, "mx9", "mx9"),
            lambda: ref.mx_matmul_fused_ref(ap, wp, "mx9", "mx9"), "mx9"),
        "mx_matmul_bwd_pair": (
            lambda: mxf.mx_matmul_bwd_pair_cuda(g, a, w, "mx9"),
            lambda: ref.mx_matmul_bwd_pair_ref(g1, wtp, xt, g2, "mx9"),
            "mx9"),
        "mx_matmul_prequant": (
            lambda: mxf.mx_matmul_prequant_cuda(a, qw6, "mx6"),
            lambda: ref.mx_matmul_prequant_ref(ap, qw6, "mx6"), "mx6"),
    }
    rows = []
    for name, (kernel, plain, prec) in timed.items():
        bound_ms, bound_by = gemm_bound_ms(name, m, n, k)
        row = {"name": name, "route": "cuda", "source": GEMM_SOURCE,
               "replaces": GEMM_REPLACES[name], "launches": launches[name],
               "max_abs_err": max_err[name], "ms": time_ms(kernel),
               "plain_ms": time_ms(plain), "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None,
               "shape_mnk": [m, n, k], "precision": prec,
               "max_typical_reading": max_reading[name]}
        rows.append(row)
        log("gemm", "{name} {precision} at (M, N, K) = {shape_mnk}: "
            "{ms:.4f} ms (plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms "
            "({bound_by})".format(**row))
        if name == "mx_matmul_bwd_pair":
            # Its conversion stage and its two GEMMs alone, and the two
            # fused launches it equals bitwise, fused(g, w^T) and
            # fused(x^T, g).
            stage = mxf.pair_stage_cuda(g, a, w, "mx9")
            row["stage_ms"] = time_ms(
                lambda: mxf.pair_stage_cuda(g, a, w, "mx9"))
            row["gemm_ms"] = time_ms(
                lambda: mxf.pair_gemm_cuda(stage, m, n, k))
            del stage
            row["staged_floor_ms"] = pair_staged_floor_ms(m, n, k)
            row["dx_fused_ms"] = time_ms(
                lambda: mxf.mx_matmul_fused_cuda(g, w.T, "mx9", "mx9"))
            row["dw_fused_ms"] = time_ms(
                lambda: mxf.mx_matmul_fused_cuda(a.T, g, "mx9", "mx9"))
            row["pieces_dx_dw"] = list(plans[big][1:])
            log("gemm", "mx_matmul_bwd_pair's conversion stage alone "
                "{stage_ms:.4f} ms, its two GEMMs alone {gemm_ms:.4f} ms "
                "(staged floor {staged_floor_ms:.4f} ms); as two fused "
                "launches: dX {dx_fused_ms:.4f} ms, dW {dw_fused_ms:.4f} ms; "
                "pieces dX/dW {pieces_dx_dw}".format(**row))
    train_ms = pass_ms(
        [fn for a, w, g in zip(acts, ws, cots) for fn in (
            lambda a=a, w=w: mxf.mx_matmul_fused_cuda(a, w, "mx9", "mx9"),
            lambda a=a, w=w, g=g: mxf.mx_matmul_bwd_pair_cuda(g, a, w,
                                                              "mx9"))])
    fwd_ms = pass_ms([lambda a=a, w=w: mxf.mx_matmul_fused_cuda(
        a, w, "mx9", "mx9") for a, w in zip(acts, ws)])
    pair_pass = pass_ms([lambda a=a, w=w, g=g: mxf.mx_matmul_bwd_pair_cuda(
        g, a, w, "mx9") for a, w, g in zip(acts, ws, cots)])
    stage_pass = pass_ms([lambda a=a, w=w, g=g: mxf.pair_stage_cuda(
        g, a, w, "mx9") for a, w, g in zip(acts, ws, cots)])
    staged_floor = sum(pair_staged_floor_ms(*shape) for shape in gemms)
    serve_ms = pass_ms([lambda a=a, qw=qw: mxf.mx_matmul_prequant_cuda(
        a, qw, "mx6") for a, qw in zip(acts, qws)])
    qas = [ops.mx_quantize(a, "mx6") for a in acts]
    unfused_pass = pass_ms([lambda qa=qa, qw=qw: mxm.mx_matmul_cuda(qa, qw)
                            for qa, qw in zip(qas, qws)])
    flops = sum(2 * m * n * k for m, n, k in gemms)
    bound = {name: sum(gemm_bound_ms(name, *shape)[0] for shape in gemms)
             for name in GEMM_REPLACES}
    log("gemm", f"summed device time (summed bound): MX9 training pass "
        f"({count} fused + {count} pair launches) {train_ms:.4f} ms "
        f"({bound['mx_matmul_fused'] + bound['mx_matmul_bwd_pair']:.4f}), "
        f"of which the {count} forward launches {fwd_ms:.4f} ms "
        f"({bound['mx_matmul_fused']:.4f}); MX6 serving pass ({count} "
        f"prequant launches) {serve_ms:.4f} ms "
        f"({bound['mx_matmul_prequant']:.4f}); {flops / 1e9:.2f} GFLOP per "
        "forward")
    log("gemm", f"the {count} pair launches alone {pair_pass:.4f} ms (bound "
        f"{bound['mx_matmul_bwd_pair']:.4f}, staged floor "
        f"{staged_floor:.4f}), of which their conversion stages alone "
        f"{stage_pass:.4f} ms")
    log("gemm", f"the unfused chain's {count} mx_matmul launches on their "
        f"pre-quantized mx6 operands {unfused_pass:.4f} ms (bound "
        f"{bound['mx_matmul']:.4f}, "
        f"{100 * bound['mx_matmul'] / unfused_pass:.1f} % of it)")
    # Where each pass's time goes: every GEMM's kernels alone.
    per_gemm = []
    for (m, n, k), a, w, g, qa, qw, (pieces, p_dx, p_dw) in zip(
            gemms, acts, ws, cots, qas, qws, plans):
        row = {"shape_mnk": [m, n, k],
               "tile": [mxm.TILE_M, mxm.tile_n(n)], "pieces": pieces,
               "unfused_path": mxm.mx_path(m, n, qa.mantissa.shape[1]),
               "unfused_ms": time_ms(lambda: mxm.mx_matmul_cuda(qa, qw)),
               "unfused_bound_ms": gemm_bound_ms("mx_matmul", m, n, k)[0],
               "fused_ms": time_ms(lambda: mxf.mx_matmul_fused_cuda(
                   a, w, "mx9", "mx9")),
               "fused_bound_ms": gemm_bound_ms("mx_matmul_fused", m, n,
                                               k)[0],
               "prequant_ms": time_ms(lambda: mxf.mx_matmul_prequant_cuda(
                   a, qw, "mx6")),
               "prequant_bound_ms": gemm_bound_ms("mx_matmul_prequant", m,
                                                  n, k)[0],
               "pair_pieces_dx_dw": [p_dx, p_dw],
               "pair_ms": time_ms(lambda: mxf.mx_matmul_bwd_pair_cuda(
                   g, a, w, "mx9")),
               "pair_stage_ms": time_ms(lambda: mxf.pair_stage_cuda(
                   g, a, w, "mx9")),
               "pair_bound_ms": gemm_bound_ms("mx_matmul_bwd_pair", m, n,
                                              k)[0],
               "pair_staged_floor_ms": pair_staged_floor_ms(m, n, k)}
        per_gemm.append(row)
        log("gemm", "{shape_mnk} tile {tile} pieces {pieces}: unfused mx6 "
            "{unfused_ms:.4f} ms (bound {unfused_bound_ms:.4f}; path "
            "{unfused_path}), fused mx9 "
            "{fused_ms:.4f} ms (bound {fused_bound_ms:.4f}), prequant mx6 "
            "{prequant_ms:.4f} ms (bound {prequant_bound_ms:.4f}); pair mx9 "
            "{pair_ms:.4f} ms, its stage {pair_stage_ms:.4f} ms (bound "
            "{pair_bound_ms:.4f}, staged floor {pair_staged_floor_ms:.4f}; "
            "pieces dX/dW {pair_pieces_dx_dw})".format(**row))
    # A yardstick only, not the same function (no quantization, bf16
    # output): torch.matmul in bf16 on the stem's operands dequantized
    # beforehand. library_ms stays null: no PyTorch call computes an MX
    # GEMM.
    (m, n, k), a, w = gemms[0], acts[0], ws[0]
    a_bf = qd(a, "mx9").bfloat16()
    w_bf = qd(w.T, "mx9").bfloat16().T
    yard_ms = time_ms(lambda: torch.matmul(a_bf, w_bf))
    log("gemm", f"yardstick, NOT the same function: torch.matmul in bf16 on "
        f"the stem's pre-dequantized operands ({m}, {n}, {k}): "
        f"{yard_ms:.4f} ms, beside fused {per_gemm[0]['fused_ms']:.4f} ms")
    del a_bf, w_bf
    walls = [mx9_training_pass()[1] for _ in range(3)]
    log("gemm", "MX9 training pass through mx_dense and autograd, host wall "
        f"of three warm passes: {[round(t, 4) for t in walls]} s")
    for row in rows:
        row.update(train_pass_ms=train_ms, serve_pass_ms=serve_ms,
                   forward_pass_ms=fwd_ms, pass_bound_ms=bound)
        if row["name"] == "mx_matmul_bwd_pair":
            row.update(pass_ms=pair_pass, stage_pass_ms=stage_pass,
                       staged_floor_pass_ms=staged_floor)
        if row["name"] == "mx_matmul":
            row.update(pass_ms=unfused_pass,
                       pass_bound_ms=bound["mx_matmul"])
        if row["name"] == "mx_matmul_fused":
            row["per_gemm"] = per_gemm  # with every kernel's times
    return rows


def main() -> None:
    import torch

    # ------------------------------------------------------------ 1 device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke run needs a CUDA card")
    import numpy as np

    from repro_torch.configs.dacapo_pairs import (RESNET18, VIT_B16, VIT_B32,
                                                  WIDERESNET50)
    from repro_torch.core.estimator import DaCapoEstimator
    from repro_torch.core.mx import _quantizable
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ------------------------------------------------------------- 2 build
    t0 = time.perf_counter()
    lib = mxq.build()
    log("build", f"one nvcc per source, all started together, then one link;"
        f" sm_90a, {[p.name for p in mxq.sources()]} -> {lib.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        # Entry points and their registers and spills; not ptxas's notes on
        # where it placed wgmma fences ("(C7519) ... use of registers").
        if ("entry function" in line or "Used" in line
                or "spill" in line):
            log("build", "ptxas: " + line.strip())

    # ----------------------------------------------------------- 3 kernels
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
    biggest = max(timings, key=lambda r: r["shape"][0] * r["shape"][1])
    trees = {cfg.name: quantizable_leaves(full[cfg.name])
             for cfg in (RESNET18, WIDERESNET50)}
    for cfg in (VIT_B32, VIT_B16):
        trees[cfg.name] = quantizable_leaves(
            make_vision_model(cfg, dev).init(gen))
    timed = tuple(trees)
    trees.update(odd_trees(gen, [cases[(1000, 1000)], cases[
        ("special",) + tuple(special.shape)]], dev))
    tree_rows = grouped_phase(trees, timed)
    del trees

    # ----------------------------------------------------------- 4 session
    launches, *_ = session_phase("session", RESNET18, WIDERESNET50,
                                 ("mx_quantize", "mx_dequantize"))

    # -------------------------------------------------------- 5 full width
    est = DaCapoEstimator()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(32, 224, 224, 3)).astype(np.float32)).to(dev)
    mxq.reset_launch_counts()
    for cfg in (RESNET18, WIDERESNET50):
        full_width_serve("full", cfg, full[cfg.name], x, est,
                         inference=cfg is RESNET18)
    full_launches = mxq.launch_counts()
    if min(full_launches[op] for op in ("mx_quantize", "mx_dequantize")) < 1:
        raise AssertionError(f"full-width launches {full_launches}")
    log("full", f"launches {full_launches}")

    # -------------------------------------------------------------- 6 gemm
    t0 = time.perf_counter()
    gemm_rows = gemm_phase(RESNET18, full[RESNET18.name], 32)
    log("gemm", f"phase done in {time.perf_counter() - t0:.2f} s")
    del full

    # --------------------------------------------------------- 7 attention
    t0 = time.perf_counter()
    attention_rows, attention_err = attention_phase()
    log("attention", f"phase done in {time.perf_counter() - t0:.2f} s")

    # --------------------------------------------------------------- 8 vit
    t0 = time.perf_counter()
    vit_launches, vit_full_launches = vit_phase(est, x)
    log("vit", f"phase done in {time.perf_counter() - t0:.2f} s")

    # ------------------------------------------------------------- 9 modes
    t0 = time.perf_counter()
    del x
    mode_launches = modes_phase(est)
    log("modes", f"phase done in {time.perf_counter() - t0:.2f} s")

    # ------------------------------------------------------------ 10 trace
    t0 = time.perf_counter()
    trace_launches = trace_phase(est)["launches"]
    log("trace", f"phase done in {time.perf_counter() - t0:.2f} s")

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
            "precision": "mx6", "launches_full_width": full_launches[name],
            "launches_per_fill": 1,
            "launches_modes": {part: counts[name]
                               for part, counts in mode_launches.items()},
            "launches_trace": {part: counts[name]
                               for part, counts in trace_launches.items()},
            "trees": [{key: row[key] for key in (
                "tree", "leaves", "elements", "launches", "bound_ms",
                "q_ms" if name == "mx_quantize" else "dq_ms") if key in row}
                for row in tree_rows]})
    kernels += gemm_rows
    main_case = attention_rows[0]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES,
        "launches": vit_launches["flash_attention"],
        "max_abs_err": attention_err,
        **{key: main_case[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": main_case["shape_b_sq_skv_h_kv_d"],
        "precision": main_case["dtype"],
        "launches_full_width": vit_full_launches["flash_attention"],
        "launches_modes": {"vit_concurrent": mode_launches[
            "vit_concurrent"]["flash_attention"]},
        "launches_trace": {part: trace_launches[part]["flash_attention"]
                           for part in ("vit_sequential", "full_width")},
        "cases": attention_rows})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
