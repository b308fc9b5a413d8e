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
   gemma2-2b's local and global layers as phase 13 prefills them (8192
   tokens, D 256, softcap 50; window 4096 on the local one; the global
   one also at phase 13's batch of 4), its ring decodes (4 sequences, one
   query against a full 4096-slot local ring and a full 8224-slot global
   one, non-causal, softcap 50, K/V read through the head-major cache's
   transposed view as decode reads them), the fp32 setups of the drivers
   (the train driver's 1 x 1024 with window 4096 and softcap 50, the serve
   driver's 4 x 512 prefill and its decode against a 544-slot ring),
   phase 14's attention setups (mixtral-8x7b's prefill of 4 x 4096 with
   GQA 32/8 at D 128 and window 4096, its ring decode against 4096 slots
   through the head-major view, jamba-v0.1-52b's unwindowed 2 x 4096 and
   its first and last decodes against 4097 and 4128 of a 4128-slot ring,
   the serve example's fp32 decodes at D 16 against 33 and 48 of 48
   slots), a decode-append (128 queries at offset 8064 against 8192
   keys) in bf16 and in fp32, and rows with no key (exactly 0); at every
   decode, the gemma2-2b prefill and the rows with no key also the
   kernel's row log-sum-exp (``return_lse``) against the plain version's
   (``LSE_TOL``; -inf where a row has no key) and the output with lse
   bitwise the output without; prints each
   case's
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

11. fleet  — the fleet engine (``core/fleet.py``) on the card, through
   ``FleetSpec(...).build()``: the 3-stream fleet of the reference's fleet
   tests (S1 / S3 / ES1, seeds 5 / 6 / 7, 24 px, 40 s of virtual time;
   drift-weighted DC-ST lanes, resolve-max rows, MX6 serving) twice in
   each dispatch mode, each pair bit for bit (every lane through
   ``run_differences``, the fleet phase log), one "cuda" quantize and
   dequantize launch per fill, every phase's ledger conserved over the
   lanes; ``serve_batched`` against the per-lane run (ledgers exactly,
   lane accuracies within 1e-6, fewer forwards) and the ViT pair's
   2-stream fleet batched, its ``torch.func.vmap`` programs launching the
   attention kernel once per layer; at full width ``predict_fleet_async``
   over 3 lanes of ResNet18 and of ViT-B/32 against ``predict_async`` per
   lane and ``label_fleet_async`` of WideResNet50 over 3 bursts of 128
   against ``label_async`` per burst, with frames/s; a traced concurrent
   fleet equal to the untraced one, each labeling group fanned over the 3
   lanes with its wall split evenly, every phase replayed bit for bit
   (also under its ``FleetDecision``), and the host time by label.
12. manager — the sharded manager tier (``core/manager.py``) on the card,
   through ``ManagerSpec(fleet=FleetSpec(...), ...).build()`` over phase
   11's fleet (MX6, 40 s): a 1-shard manager, without and with per-lane
   checkpoints, equal to phase 11's bare sequential fleet bit for bit (the
   checkpoints' wall a save printed); 2 shards with
   shard 1 lost at round 3 and its lanes restored from their checkpoints,
   serially and with ``parallel_shards=2``, bit for bit (records,
   decisions, both ledgers, events, every lane's student tree); the
   ``estimator`` placement policy with a camera admitted at t=10 and live
   migrations, twice bit for bit; the failover traced, serial and pooled:
   traced == untraced and the merged traces equal; in every run one "cuda"
   quantize and dequantize launch per fill (restored and migrated lanes
   included) and the two-level ledger conserved; each run's wall per 40 s,
   serial beside pooled, with the card's ``nvidia-smi`` line.
13. lm      — the dense LM side (``models/transformer.py``, the drivers of
   ``launch/``) at gemma2-2b's full width (2.61 B parameters; GQA 8/4, D
   256, local window 4096 on even layers, softcaps 50 and 30): served in
   its own bf16 from a seeded CUDA generator (element count against
   ``param_count()``), 4 x 8192 prompt tokens of ``TokenPipeline``
   prefilled into an 8224-slot cache (the local layers' 4096-slot rings
   wrap) and 32 greedy decode steps, twice and bit for bit; every attention
   call through the kernel, 26 launches a prefill and 26 a decode step;
   the decode logits held to one ``hidden``/``logits`` pass over prompt and
   generated tokens (RMS share within ``LM_RMS_SHARE``, greedy tokens
   equal but for near ties, |logit| <= 30); then the serve driver as the
   reference runs it (fp32, batch 4, prompt 512, 32 tokens: prefill ms,
   decode tok/s, peak memory) and the train driver (fp32 AdamW, batch 1 x
   seq 1024, 3 steps with finite loss: each step's wall, peak memory),
   both with no mesh (``on_mesh=False``), their numbers kept for phase 15.
14. mixers  — the MoE, Mamba and xLSTM layers (``models/moe.py``,
   ``ssm.py``, ``xlstm.py``) at full width in bf16 from a seeded CUDA
   generator, the depth cut to fit one card (``MIXER_MODELS``):
   mixtral-8x7b at 4 of 32 layers, 4 x 4096 prompt tokens (routing groups
   of 512; the 4096-slot ring wraps while decoding), jamba-v0.1-52b at one
   pattern period (8 of 32 layers), 2 x 4096, xlstm-125m whole, 4 x 1024
   (4 mLSTM chunks, 1024 sLSTM steps); each prefilled and decoded 32 steps
   twice, bit for bit, every attention call "cuda" (one launch a layer a
   prefill and a decode step), the element count against
   ``param_defs()``, the eager recurrences' share of the prefill and the
   MoE drops at the config's capacity factor logged, decode held to one
   full pass (``MIXER_RMS_SHARE``; at a capacity factor of e / k for the
   MoE models), for xlstm-125m also in fp32 (``XLSTM_FP32_SHARE``) and
   with three decode faults planted, each of which both limits must fail
   (``xlstm_decode_bracket``); the reduced three trained once on the card
   and once on the CPU port, loss and gradients within
   ``tests/_torch_lm.py``'s tolerances; ``examples/train_lm_torch.py`` at
   full xlstm-125m for 3 steps and ``examples/serve_lm_torch.py`` at its
   defaults.
15. sharding — the mesh half (``distributed.py``, ``launch/mesh.py``,
   ``sharding.py``, ``steps.py``) on one card, last because its drivers
   start and end a process group: the serve and train drivers on
   ``make_host_mesh(1)`` (a one-rank NCCL group, the rules of their
   shapes, the bundles) at phase 13's setups, their tokens, decode logits,
   losses and final parameters bit for bit phase 13's runs with no mesh,
   every attention launch "cuda"; gemma2-2b's decode against its 8224-slot
   global ring in bf16 cut into ``SHARDS`` slot ranges, each through
   ``attention.decode_shard`` (the kernel with lse; none where a shard has
   no valid slot), merged by ``merge_decode_shards`` over the stacked
   results, and its global and a local layer (window 4096) at 1 x 8192
   over ``SHARDS`` query slices through ``seq_shard`` (``q_offset``
   against the whole K/V), each held to the unsharded kernel call within
   phase 7's bf16 limits, with each shard's kernel ms beside the
   unsharded call's. A multi-rank world needs several cards (NCCL refuses
   two ranks on one; gloo has no CUDA ``all_gather``): collectives across
   cards are not run here.
16. ranks  — the MoE, Mamba and xLSTM layers across ranks on one card
   (``rank_phase``): the serve drivers of reduced mixtral-8x7b,
   jamba-v0.1-52b and xlstm-125m (fp32, 4 x 32 prompt, 16 tokens) on
   ``make_host_mesh(1)``, tokens and decode logits bit for bit their runs
   with no mesh, every attention launch "cuda"; then each layer's per-rank
   body for R virtual model ranks, run in turn (``distributed.run_serial``:
   each round of the ranks' terms summed as the all-reduce would), at
   published widths in bf16 (``RANK_CASES``): mixtral-8x7b's MoE FFN at 1
   x 4096 over 2, 4 and 16 ranks (16: expert fission, 16 virtual experts
   of d_ff 7168), jamba-v0.1-52b's over 4, its Mamba layer at 1 x 4096
   over 2 and 4 (prefill, then ``RANK_DECODE`` decode steps against the
   rank-split caches), xlstm-125m's mLSTM and sLSTM at 4 x 1024 over 2;
   the merged output within ``RANK_RMS_SHARE`` of the unsharded layer's,
   every rank's routing equal to it, the replicated recurrent state equal
   on every rank bit for bit; times of the unsharded layer and of the R
   bodies in turn.
17. dryrun — the dry run against the card (``dryrun_phase``): gemma2-2b's
   bf16 prefill and the train driver's step traced on a one-rank mesh and
   run: FLOPs and argument bytes equal, the measured peak within
   ``DRY_PEAK`` of the predicted, the roofline share; then
   ``DRY_PRODUCTION``'s cells on a fake (16, 16) mesh.
18. experiments — the paper's figure experiments and the quickstart
   (``experiments_phase``): Table III's six models at published widths on
   the card, ResNet34 and WideResNet101 each with one MX6 fill (bitwise the
   plain version) and one forward of 8 frames at 224 px (the first 2
   within ``EXP_FORWARD_RMS_SHARE`` of the CPU's forward); Fig. 3; Fig. 9
   on S1 at the fast sizes twice from fresh pretraining, bit for bit; Figs.
   11 (both pairs, so the ViTs' attention kernel) and 12 at the fast
   sizes; ``examples/quickstart_torch.py``'s three demos (the MX matmul
   through the quantize kernel and the unfused MX GEMM, held elementwise
   to its plain version within phase 6's limits; reduced gemma2-2b
   through the attention kernel; a DC-ST session). Every kernel call is
   "cuda", and the quantize, dequantize, MX GEMM and attention kernels
   each launch.

Device times are medians over launches between CUDA events, the L2
flushed before each and its dirty lines written back before the start
event (``flush_l2``).

Before the last line it prints the card's ``nvidia-smi`` line and one JSON
object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
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
    ("gemma2-2b global layer", (1, 8192, 8192, 8, 4, 256), "bfloat16",
     dict(causal=True, softcap=50.0)),
    ("gemma2-2b prefill batch 4", (4, 8192, 8192, 8, 4, 256), "bfloat16",
     dict(causal=True, softcap=50.0)),
    ("gemma2-2b ring decode", (4, 1, 4096, 8, 4, 256), "bfloat16",
     dict(causal=False, softcap=50.0)),
    ("gemma2-2b global ring decode", (4, 1, 8224, 8, 4, 256), "bfloat16",
     dict(causal=False, softcap=50.0)),
    ("gemma2-2b train fp32", (1, 1024, 1024, 8, 4, 256), "float32",
     dict(causal=True, window=4096, softcap=50.0)),
    ("gemma2-2b serve driver fp32", (4, 512, 512, 8, 4, 256), "float32",
     dict(causal=True, softcap=50.0)),
    ("gemma2-2b serve driver decode fp32", (4, 1, 544, 8, 4, 256), "float32",
     dict(causal=False, softcap=50.0)),
    ("mixtral-8x7b prefill", (4, 4096, 4096, 32, 8, 128), "bfloat16",
     dict(causal=True, window=4096)),
    ("mixtral-8x7b ring decode", (4, 1, 4096, 32, 8, 128), "bfloat16",
     dict(causal=False)),
    ("jamba-v0.1-52b attention layer", (2, 4096, 4096, 32, 8, 128),
     "bfloat16", dict(causal=True)),
    ("jamba-v0.1-52b first decode", (2, 1, 4097, 32, 8, 128), "bfloat16",
     dict(causal=False)),
    ("jamba-v0.1-52b last decode", (2, 1, 4128, 32, 8, 128), "bfloat16",
     dict(causal=False)),
    ("serve example first decode fp32", (4, 1, 33, 4, 2, 16), "float32",
     dict(causal=False)),
    ("serve example last decode fp32", (4, 1, 48, 4, 2, 16), "float32",
     dict(causal=False)),
    ("decode-append", (1, 128, 8192, 8, 4, 256), "bfloat16",
     dict(causal=True, q_offset=8064)),
    ("decode-append fp32", (1, 128, 8192, 8, 4, 256), "float32",
     dict(causal=True, q_offset=8064)),
    ("fully masked rows", (1, 64, 64, 2, 2, 32), "float32",
     dict(causal=True, q_offset=-4)),
)
# The decode cases read K/V as phases 13 and 14 decode: a [B, Kv, L, D]
# ring viewed as [B, L, Kv, D] (``models/attention.py::flash_decode``), so
# the head stride exceeds the sequence stride.
HEAD_MAJOR_KV = ("gemma2-2b ring decode", "gemma2-2b global ring decode",
                 "gemma2-2b serve driver decode fp32",
                 "mixtral-8x7b ring decode", "jamba-v0.1-52b first decode",
                 "jamba-v0.1-52b last decode",
                 "serve example first decode fp32",
                 "serve example last decode fp32")
# Where a decode reads the filled prefix of a longer ring: the ring's L
# (phase 14's jamba decodes against 4097 to 4128 of 4128 slots, the serve
# example's reduced mixtral-8x7b against 33 to 48 of 48).
RING_SLOTS = {"jamba-v0.1-52b first decode": 4128,
              "serve example first decode fp32": 48}
ATTENTION_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
# A second limit: the error's RMS as a share of the plain output's RMS.
# Where rows average thousands of keys, a typical output (sqrt(e / Skv),
# 0.018 at 8192) is the size of the bf16 limit, so a kv combine that drops
# a piece or skips the e^(m_s - m) rescale (RMS share 0.25-0.35 at the
# decode-append, attention_mutants.py on an H100) could pass it
# elementwise. Rounding P and the output to bf16 leaves the sound kernel
# near 2^-9 (0.0021-0.0024 in this phase on an H100); fp32 below 1e-5.
ATTENTION_RMS_SHARE = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -6}
# The cases where phase 7 also holds the kernel's row log-sum-exp
# (``return_lse``) to the plain version's: every decode, the gemma2-2b
# prefill, and rows with no key (-inf on both sides). Limit: |lse -
# plain| <= LSE_TOL * (1 + |plain|) in both dtypes: lse is fp32 from fp32
# logits (bf16 products are exact in fp32; 3xTF32 keeps ~22 bits), so the
# two differ by summation order, ~1e-6 of |lse| <= ~60; a kv combine that
# drops a piece or skips its rescale moves lse by O(0.1).
LSE_CASES = tuple(label for label, *_ in ATTENTION_CASES
                  if "decode" in label) + ("gemma2-2b prefill batch 4",
                                          "fully masked rows")
LSE_TOL = 2e-5


def lse_within(label: str, got, want) -> float:
    """Raise unless the kernel's lse [B, Sq, H] fp32 has -inf exactly
    where the plain version's has it and is within LSE_TOL elsewhere.
    Returns the max abs error over the finite rows."""
    import torch

    dead = torch.isinf(want)
    if (got.shape != want.shape or got.dtype != torch.float32
            or not torch.equal(torch.isinf(got), dead)
            or not bool((got[dead] < 0).all())):
        raise AssertionError(f"flash_attention {label}: lse shape, dtype or "
                             "its -inf rows differ from the plain version")
    err = (got[~dead] - want[~dead]).abs()
    if err.numel() and not bool((err <= LSE_TOL * (1 + want[~dead].abs()))
                                .all()):
        raise AssertionError(f"flash_attention {label}: lse max err "
                             f"{float(err.max())} above {LSE_TOL}·(1 + "
                             "|plain|)")
    return float(err.max()) if err.numel() else 0.0


def attention_inputs(gen, shape, dtype: str, dev, head_major: bool = False,
                     slots=None):
    """q [B, Sq, H, D], k and v [B, Skv, Kv, D]: N(0, 1) from ``gen`` in
    ``dtype``; with ``head_major`` k and v are transposed views of the
    first Skv rows of contiguous [B, Kv, L, D] rings (L = ``slots``,
    default Skv), as the decode cache holds them."""
    import torch

    b, sq, skv, h, kvh, d = shape
    kv_size = ((b, kvh, slots or skv, d) if head_major
               else (b, skv, kvh, d))
    q, k, v = [torch.randn(size, generator=gen, device=dev).to(
        getattr(torch, dtype)) for size in ((b, sq, h, d), kv_size, kv_size)]
    if head_major:
        k, v = (t[:, :, :skv].transpose(1, 2) for t in (k, v))
    return q, k, v


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
        head_major = label in HEAD_MAJOR_KV
        q, k, v = attention_inputs(gen, shape, dtype, dev, head_major,
                                   RING_SLOTS.get(label))
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
        lse_err = None
        if label in LSE_CASES:
            out_l, lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                 **opts)
            _, plain_lse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                                   **opts)
            torch.cuda.synchronize()
            if not same_bits(out_l, out):
                raise AssertionError(f"flash_attention {label}: the output "
                                     "with return_lse differs from without")
            lse_err = lse_within(label, lse, plain_lse)
            del out_l, lse, plain_lse
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
               "dtype": dtype, "options": opts,
               "kv_layout": ("[B, Kv, {}, D] viewed".format(
                   RING_SLOTS.get(label, "L")) if head_major
                             else "[B, Skv, Kv, D]"),
               "max_abs_err": err,
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
               "library_max_abs_err": lib_err, "lse_max_abs_err": lse_err}
        rows.append(row)
        log("attention", "{case} {shape_b_sq_skv_h_kv_d} {dtype} {options}, "
            "k/v {kv_layout}: "
            "{design}, {kv_splits} kv piece(s); max err {max_abs_err:.3g} "
            "({tol_reading:.3g} of the limit), RMS share {rms_share:.3g}, "
            "{ms:.4f} ms (plain {plain_ms:.4f} ms, SDPA {library_ms}), bound "
            "{bound_ms:.4f} ms ({bound_by}); lse max err "
            "{lse_max_abs_err}".format(**row))
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


def host_breakdown(tag: str, trace, wall_s: float,
                   phase: str = "trace") -> dict:
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
    log(phase, f"{tag}: host time by label over a run of {wall_s:.4f} s "
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


# Phase 11: fleets on the card. The fleet of the reference's fleet tests
# (tests/test_fleet.py: small_setup's hyper-parameters and pretraining,
# _golden_streams), drift-weighted DC-ST lanes, MX6 serving.
FLEET_HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)
FLEET_S = 40.0  # virtual seconds a fleet runs
FLEET_LANES = 3


def fleet_streams(n: int = FLEET_LANES) -> list:
    """S1 / S3 / ES1, two segments each, seeds 5 / 6 / 7, 24 px."""
    from repro_torch.data.stream import DriftStream, scenario

    return [DriftStream(scenario(name, 2), seed=seed, img=24)
            for name, seed in (("S1", 5), ("S3", 6), ("ES1", 7))][:n]


def fleet_run(student, teacher, lanes: int = FLEET_LANES, hook=None,
              **spec) -> dict:
    """One repeatable fleet run: a fresh ``FleetSpec(student, teacher,
    fleet_mode="drift-weighted", row_policy="resolve-max", apply_mx=True,
    device="cuda", **spec).build()`` and a fresh
    ``np.random.default_rng(0)``, teacher and student pretrained on the card
    (10 and 8 steps of 32), then ``lanes`` streams for ``FLEET_S`` virtual
    seconds, stepped through ``open_run`` (launch counts and kernel_stats
    set to 0 just before). ``hook(fleet)`` runs after the build. Returns
    the fleet, its result, the run's host wall, its fills, launch counts
    and kernel_stats, each lane's final student tree and the
    ``FleetDecision`` each phase executed."""
    import numpy as np
    import torch

    from repro_torch.core.allocation import CLHyperParams
    from repro_torch.core.fleet import FleetSpec
    from repro_torch.core.session import pretrain_model
    from repro_torch.data.stream import DriftStream, scenario
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops

    spec = {"fleet_mode": "drift-weighted", "row_policy": "resolve-max",
            "apply_mx": True, "device": "cuda", "seed": 0, "eval_fps": 0.5,
            "hp": CLHyperParams(**FLEET_HP), **spec}
    fleet = FleetSpec(student=student, teacher=teacher, **spec).build()
    if hook is not None:
        hook(fleet)
    stream = DriftStream(scenario("S1", 2), seed=5, img=24)
    rng = np.random.default_rng(0)
    tp = pretrain_model(fleet.teacher, stream, 10, 32, rng)
    sp = pretrain_model(fleet.student, stream, 8, 32, rng,
                        segments=stream.segments[:1], seed=8)
    fleet.set_pretrained(tp, sp)
    torch.cuda.synchronize()
    fills = session_fills(fleet)
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    decisions = []
    t0 = time.perf_counter()
    run = fleet.open_run(fleet_streams(lanes), FLEET_S)
    try:
        while not run.done:
            if run.lanes and run.clock < run.duration:
                decisions.append(run.fleet_dec)  # the phase about to run
            run.step()
        res = run.finalize()
        params = [lane.params for lane in run.lanes]
    finally:
        run.close()
    torch.cuda.synchronize()
    return {"fleet": fleet, "res": res, "wall": time.perf_counter() - t0,
            "fills": session_fills(fleet) - fills,
            "launches": mxq.launch_counts(), "stats": ops.kernel_stats(),
            "params": params, "decisions": decisions}


def fleet_differences(first: dict, second: dict) -> list:
    """What differs between two :func:`fleet_run` results: each lane
    through :func:`run_differences` (its phase log, drift events, average
    accuracy, final student tree, and the run's launch counts), then the
    fleet phase log and the fleet's average accuracy."""
    from types import SimpleNamespace

    diffs = []
    a, b = first["res"], second["res"]
    if a.n_streams != b.n_streams:
        return [f"lanes {a.n_streams} != {b.n_streams}"]
    for i in range(a.n_streams):
        runs = [(SimpleNamespace(student_params=run["params"][i]), None,
                 run["res"].streams[i], run["launches"], None)
                for run in (first, second)]
        diffs += [f"lane {i}: {d}" for d in run_differences(*runs)]
    if a.fleet_phase_log != b.fleet_phase_log:
        diffs.append("fleet phase logs differ")
    if a.fleet_avg_accuracy != b.fleet_avg_accuracy:
        diffs.append(f"fleet accuracy {a.fleet_avg_accuracy!r} != "
                     f"{b.fleet_avg_accuracy!r}")
    return diffs


def fleet_conservation(tag: str, res) -> None:
    """Every fleet phase's T-SA and B-SA charge is the sum of its lanes'
    (relative 1e-9: the same addends, summed in another order)."""
    for i, e in enumerate(res.fleet_phase_log):
        for role in ("t_tsa", "t_bsa"):
            lanes = e[f"per_stream_{role}"]
            if len(lanes) != res.n_streams or not abs(
                    sum(lanes) - e[role]) <= 1e-9 * max(1.0, e[role]):
                raise AssertionError(f"{tag}: phase {i} {role} {e[role]!r}"
                                     f" != sum of lanes {lanes}")


def fleet_summary(run: dict) -> str:
    res = run["res"]
    return (f"phases {len(res.fleet_phase_log)}, drift events "
            f"{[s.drift_events for s in res.streams]}, lane accuracies "
            f"{[s.avg_accuracy for s in res.streams]}, wall "
            f"{run['wall']:.4f} s, fills {run['fills']}, launches "
            f"{run['launches']}, kernel_stats {run['stats']}")


def fleet_pairs(out: dict) -> dict:
    """Phase 11, part 1: the 3-stream fleet twice in each dispatch mode,
    each pair bit for bit; one quantize and one dequantize launch per
    fill, all "cuda"; every phase's ledger conserved over the lanes.
    Returns each mode's first run."""
    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50

    firsts = {}
    import numpy as np

    for mode in ("sequential", "concurrent"):
        tag = f"fleet_{mode}"
        runs = [fleet_run(RESNET18, WIDERESNET50, dispatch=mode)
                for _ in range(2)]
        for i, run in enumerate(runs):
            log("fleet", f"{tag} run {i + 1}: {fleet_summary(run)}")
        diffs = fleet_differences(*runs)
        if diffs:
            raise AssertionError(f"{tag}: two runs differ: "
                                 + "; ".join(diffs))
        run = runs[0]
        fill_checks(tag, run["fills"], run["launches"], run["stats"])
        fleet_conservation(tag, run["res"])
        res = run["res"]
        if not all(np.isfinite(s.avg_accuracy) and s.phase_log
                   for s in res.streams):
            raise AssertionError(f"{tag}: bad lane results")
        log("fleet", f"{tag}: the two runs agree bit for bit (every lane's "
            "phase log, drift events, accuracy and student tree, the fleet "
            f"phase log, launch counts); {run['fills']} fills, one cuda "
            "quantize and one cuda dequantize launch each; ledgers "
            f"conserved over {res.n_streams} lanes in every phase; walls "
            f"{runs[0]['wall']:.4f} / {runs[1]['wall']:.4f} s per "
            f"{FLEET_S:g} s of virtual time")
        out["launches"][tag] = run["launches"]
        out["walls"][tag] = [r["wall"] for r in runs]
        firsts[mode] = run
    return firsts


def count_vmapped(fleet, seen: dict) -> None:
    """Count the fleet programs ``predict_fleet_async`` issues for more
    than one lane, and the attention calls made inside them."""
    from repro_torch.kernels import ops

    inner = fleet.inference.predict_fleet_async

    def counted(params_list, windows):
        before = ops.kernel_stats().get("flash_attention", {})
        preds = inner(params_list, windows)
        after = ops.kernel_stats().get("flash_attention", {})
        if len(windows) > 1:
            seen["programs"] += 1
            for path in ("cuda", "plain"):
                seen[path] += after.get(path, 0) - before.get(path, 0)
        return preds

    fleet.inference.predict_fleet_async = counted


def fleet_batched(out: dict, per_lane: dict) -> None:
    """Phase 11, part 2: ``serve_batched=True`` against the per-lane run of
    part 1 (concurrent): ledgers and fleet phase log exactly, each lane's
    accuracy within 1e-6 (as tests/test_fleet.py holds the reference's),
    fewer forwards; then the ViT pair's 2-stream fleet, per lane and
    batched, its vmapped programs calling the attention kernel ("cuda")
    under ``torch.func.vmap``."""
    from repro_torch.configs.dacapo_pairs import (RESNET18, VIT_B16, VIT_B32,
                                                  WIDERESNET50)

    seen = {"programs": 0, "cuda": 0, "plain": 0}
    run = fleet_run(RESNET18, WIDERESNET50, dispatch="concurrent",
                    serve_batched=True,
                    hook=lambda f: count_vmapped(f, seen))
    log("fleet", f"fleet_batched: {fleet_summary(run)}")
    base, res = per_lane["res"], run["res"]
    fill_checks("fleet_batched", run["fills"], run["launches"], run["stats"])
    if res.fleet_phase_log != base.fleet_phase_log:
        raise AssertionError("fleet_batched: fleet phase log != per-lane")
    worst = 0.0
    for a, b in zip(base.streams, res.streams):
        if (a.retrain_time, a.label_time) != (b.retrain_time, b.label_time):
            raise AssertionError("fleet_batched: lane ledgers differ")
        worst = max(worst, abs(a.avg_accuracy - b.avg_accuracy))
    calls = (per_lane["fleet"].inference.n_apply_calls,
             run["fleet"].inference.n_apply_calls)
    if not worst <= 1e-6 or not calls[1] < calls[0] or not seen["programs"]:
        raise AssertionError(f"fleet_batched: accuracy off by {worst}, "
                             f"forwards {calls}, vmapped {seen}")
    log("fleet", f"fleet_batched: ledgers and fleet phase log equal to the "
        f"per-lane run; lane accuracies within {worst:.3g} (limit 1e-6); "
        f"student forwards {calls[0]} per lane -> {calls[1]} batched "
        f"({seen['programs']} vmapped fleet programs)")
    out["launches"]["fleet_batched"] = run["launches"]
    out["walls"]["fleet_batched"] = run["wall"]
    vit = {}
    for batched in (False, True):
        seen = {"programs": 0, "cuda": 0, "plain": 0}
        vit[batched] = fleet_run(VIT_B32, VIT_B16, lanes=2,
                                 dispatch="concurrent",
                                 serve_batched=batched,
                                 hook=lambda f, s=seen: count_vmapped(f, s))
        vit[batched]["seen"] = seen
        log("fleet", f"vit_fleet serve_batched={batched}: "
            f"{fleet_summary(vit[batched])}")
    run, seen = vit[True], vit[True]["seen"]
    stats = run["stats"]
    fill_checks("vit_fleet", run["fills"], run["launches"], stats)
    if (not seen["programs"] or seen["plain"]
            or seen["cuda"] != seen["programs"] * VIT_B32.reduced()
            .num_layers or stats.get("flash_attention", {}).get("plain")):
        raise AssertionError(f"vit_fleet: attention under vmap {seen}, "
                             f"kernel_stats {stats}")
    a, b = vit[False]["res"], run["res"]
    if a.fleet_phase_log != b.fleet_phase_log or any(
            (x.retrain_time, x.label_time) != (y.retrain_time, y.label_time)
            for x, y in zip(a.streams, b.streams)):
        raise AssertionError("vit_fleet: batched ledgers != per-lane")
    diff = max(abs(x.avg_accuracy - y.avg_accuracy)
               for x, y in zip(a.streams, b.streams))
    log("fleet", f"vit_fleet: {seen['programs']} vmapped fleet programs "
        f"issued {seen['cuda']} attention launches (one per layer each), "
        f"all cuda; ledgers equal to the per-lane run; lane accuracies "
        f"differ by {diff:.3g} (reported)")
    out["launches"]["vit_fleet_batched"] = run["launches"]
    out["vit_vmapped"] = dict(seen, accuracy_diff=diff)


def fleet_full_width(est, dev="cuda") -> dict:
    """Phase 11, part 3, at full width (224 px, 1000 classes, random
    weights, MX6 serving copies): ``predict_fleet_async`` over 3 lanes'
    trees of ResNet18 and of ViT-B/32 (32 frames a lane) against
    ``predict_async`` per lane — logits within 1e-3 of the largest (fp32
    summation order: a vmapped convolution with per-lane weights runs as a
    grouped convolution), ids equal but where the top two logits lie
    within twice the difference — and ``label_fleet_async`` of
    WideResNet50 over 3 bursts of 128 (microbatch 64) against
    ``label_async`` per burst: ids equal, else the frame's margin printed
    and its logits held to the same limit. Frames/s of the fleet program
    and of the per-lane programs (host frames in, ids synchronised, median
    of 5)."""
    import numpy as np
    import torch

    from repro_torch.configs.dacapo_pairs import (RESNET18, VIT_B32,
                                                  WIDERESNET50)
    from repro_torch.core.kernel import InferenceKernel, LabelingKernel
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_map

    rng = np.random.default_rng(11)
    px = RESNET18.img_size

    def median_wall(fn) -> float:
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls))

    def held(tag, lg_a, lg_b, ids_a, ids_b):
        """Logits within 1e-3 of the largest; differing ids near ties."""
        delta = (lg_a - lg_b).abs()
        scale = float(lg_a.abs().max())
        worst = float(delta.max())
        if not bool(torch.isfinite(lg_a).all()) or not (
                worst <= 1e-3 * max(1.0, scale)):
            raise AssertionError(f"{tag}: logits differ by {worst} "
                                 f"(largest {scale})")
        top2 = lg_b.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        differ = np.nonzero(ids_a != ids_b)[0]
        limit = 2 * delta.max(-1).values.cpu().numpy()
        for i in differ:
            log("fleet", f"{tag}: frame {i}: ids {ids_a[i]} / {ids_b[i]}, "
                f"top-two margin {gap[i]:.3g}, logit difference "
                f"{limit[i] / 2:.3g}")
            if gap[i] > limit[i]:
                raise AssertionError(f"{tag}: ids differ at frame {i} where"
                                     " the top two logits are apart")
        return worst, scale, len(differ)

    out = {}
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    for cfg in (RESNET18, VIT_B32):
        model = make_vision_model(cfg, dev)
        kern = InferenceKernel(model, cfg, est, apply_mx=True, device=dev)
        serving = [kern.serving_params(
            model.init(torch.Generator().manual_seed(20 + i)), "mx6")
            for i in range(FLEET_LANES)]
        windows = [rng.normal(size=(32, px, px, 3)).astype(np.float32)
                   for _ in range(FLEET_LANES)]
        before = ops.kernel_stats().get("flash_attention", {}).get("cuda", 0)
        fleet_ids = [p.cpu().numpy()
                     for p in kern.predict_fleet_async(serving, windows)]
        attn = ops.kernel_stats().get("flash_attention", {}).get(
            "cuda", 0) - before
        lane_ids = [kern.predict(s, w) for s, w in zip(serving, windows)]
        stacked = tree_map(lambda *leaves: torch.stack(leaves), *serving)
        x = torch.from_numpy(np.stack(windows)).to(dev)
        with torch.no_grad():
            lg_fleet = kern._apply_fleet[1](stacked, x).reshape(
                -1, cfg.num_classes)
            lg_lane = torch.cat([model.apply(s, x[i])
                                 for i, s in enumerate(serving)])
        worst, scale, near = held(f"{cfg.name} fleet predict", lg_fleet,
                                  lg_lane, np.concatenate(fleet_ids),
                                  np.concatenate(lane_ids))
        n = FLEET_LANES * 32
        fleet_s = median_wall(
            lambda: kern.predict_fleet_async(serving, windows))
        lane_s = median_wall(lambda: [kern.predict_async(s, w)
                                      for s, w in zip(serving, windows)])
        out[cfg.name] = {"frames": n, "fleet_fps": n / fleet_s,
                         "per_lane_fps": n / lane_s, "max_logit_diff": worst,
                         "largest_logit": scale, "near_ties": near,
                         "attention_launches_fleet": attn}
        if cfg is VIT_B32 and attn != cfg.num_layers:
            raise AssertionError(f"vit-b32 fleet program: {attn} attention "
                                 f"launches, expected {cfg.num_layers}")
        log("fleet", f"full width {cfg.name}: predict_fleet_async over "
            f"{FLEET_LANES} lanes x 32 frames = predict_async per lane "
            f"(logits max |diff| {worst:.3g}, largest {scale:.3g}, limit "
            f"1e-3 of it; {near} ids excused as near ties; attention "
            f"launches in the fleet program {attn}); frames/s fleet "
            f"{n / fleet_s:.1f}, per lane {n / lane_s:.1f}")
        del kern, serving, stacked, x, lg_fleet, lg_lane
    teacher = make_vision_model(WIDERESNET50, dev)
    lab = LabelingKernel(teacher, WIDERESNET50, est, apply_mx=True,
                         device=dev)
    tparams = teacher.init(torch.Generator().manual_seed(30))
    bursts = [rng.normal(size=(128, px, px, 3)).astype(np.float32)
              for _ in range(FLEET_LANES)]
    fleet_ids = np.concatenate([
        y.cpu().numpy() for y in lab.label_fleet_async(
            tparams, bursts, "mx6", microbatch=64)])
    burst_ids = np.concatenate([lab.label(tparams, b, "mx6", microbatch=64)
                                for b in bursts])
    if np.array_equal(fleet_ids, burst_ids):
        check = "ids equal"
    else:
        serving = lab.serving_cache.get(tparams, "mx6")
        frames = np.concatenate(bursts)
        with torch.no_grad():
            lg_fleet = torch.cat([lab._run_apply(serving, frames[i: i + 64])
                                  for i in range(0, len(frames), 64)])
            lg_burst = torch.cat([lab._run_apply(serving, b[i: i + 64])
                                  for b in bursts for i in range(0, 128, 64)])
        worst, scale, near = held("wideresnet50 fleet label", lg_fleet,
                                  lg_burst, fleet_ids, burst_ids)
        check = (f"ids differ on {near} near ties; logits within {worst:.3g}"
                 f" of largest {scale:.3g}")
    n = FLEET_LANES * 128
    fleet_s = median_wall(lambda: [y for y in lab.label_fleet_async(
        tparams, bursts, "mx6", microbatch=64)])
    burst_s = median_wall(lambda: [lab.label_async(tparams, b, "mx6",
                                                   microbatch=64)
                                   for b in bursts])
    out[WIDERESNET50.name] = {"frames": n, "fleet_fps": n / fleet_s,
                              "per_lane_fps": n / burst_s, "check": check}
    log("fleet", f"full width wideresnet50: label_fleet_async over "
        f"{FLEET_LANES} bursts of 128 (microbatch 64) against label_async "
        f"per burst: {check}; frames/s fleet {n / fleet_s:.1f}, per burst "
        f"{n / burst_s:.1f} | {nvidia_smi_line()}")
    launches, stats = mxq.launch_counts(), ops.kernel_stats()
    plain = {op: p for op, p in stats.items() if p.get("plain")}
    if plain:
        raise AssertionError(f"full-width fleet: plain calls {plain}")
    return {"rows": out, "launches": launches}


def fleet_traced(out: dict, untraced: dict) -> None:
    """Phase 11, part 4: the 3-stream concurrent fleet traced equals the
    untraced run of part 1 bit for bit; every ``dispatch_multi`` group
    (the fleet's labeling program) has fan 3, one wall for each lane, and
    the lanes' walls sum to the wall ``dispatch_multi`` measured, which
    holds the labeling call (timed again inside it); every phase replays
    bit for bit, also priced under the ``FleetDecision`` it executed;
    the host time by label."""
    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core.replay import TraceReplayer

    inner = []

    def time_labeling(fleet):
        call = fleet.labeling.label_fleet_async

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            labels = call(*args, **kwargs)
            inner.append(time.perf_counter() - t0)
            return labels

        fleet.labeling.label_fleet_async = timed

    run = fleet_run(RESNET18, WIDERESNET50, dispatch="concurrent",
                    trace=True, hook=time_labeling)
    log("fleet", f"fleet_traced: {fleet_summary(run)}")
    diffs = fleet_differences(untraced, run)
    if diffs:
        raise AssertionError("fleet_traced: traced != untraced: "
                             + "; ".join(diffs))
    fill_checks("fleet_traced", run["fills"], run["launches"], run["stats"])
    trace = run["fleet"].dispatcher.recorder.trace
    groups = []
    for phase in trace.phases:
        group = [e for e in phase.events if e.label == "label"]
        if group:
            groups.append(group)
    if len(groups) != len(inner):
        raise AssertionError(f"fleet_traced: {len(groups)} labeling groups,"
                             f" {len(inner)} labeling calls")
    slack = []
    for group, wall in zip(groups, inner):
        walls = {e.wall_s for e in group}
        total = sum(e.wall_s for e in group)
        if ([e.lane for e in group] != list(range(FLEET_LANES))
                or {e.fan for e in group} != {FLEET_LANES}
                or len(walls) != 1 or not total >= wall):
            raise AssertionError(f"fleet_traced: group {group} against the "
                                 f"labeling call's {wall} s")
        slack.append(total - wall)
    rep = TraceReplayer(trace)
    if len(run["decisions"]) != len(trace.phases):
        raise AssertionError(f"fleet_traced: {len(run['decisions'])} "
                             f"decisions for {len(trace.phases)} phases")
    for i, (phase, dec) in enumerate(zip(trace.phases, run["decisions"])):
        got = (rep.phase_time(i), rep.predict(i, dec))
        if got != (phase.end, phase.end):
            raise AssertionError(f"fleet_traced: phase {i} replays to {got}"
                                 f", recorded end {phase.end!r}")
    replay_checks("fleet_traced", trace)
    out["breakdown"] = host_breakdown("fleet_traced", trace, run["wall"],
                                      phase="fleet")
    out["walls"]["fleet_traced"] = run["wall"]
    out["launches"]["fleet_traced"] = run["launches"]
    log("fleet", f"fleet_traced: traced == untraced bit for bit; "
        f"{len(groups)} labeling groups, each fan {FLEET_LANES} with one "
        f"wall per lane summing to the measured wall (it exceeds the "
        f"labeling call's own by {min(slack) * 1e3:.3f}-"
        f"{max(slack) * 1e3:.3f} ms); all {len(trace.phases)} phases "
        "replay bit for bit, also under the FleetDecision each executed")


def fleet_phase(est):
    """Phase 11: fleets on the card (parts 1-4 above). Returns each part's
    launch counts, walls, rates and the traced host breakdown, and each
    dispatch mode's first 3-stream run (phase 12 holds its 1-shard manager
    to the sequential one)."""
    out = {"launches": {}, "walls": {}}
    firsts = fleet_pairs(out)
    fleet_batched(out, firsts["concurrent"])
    full = fleet_full_width(est)
    out["launches"]["full_width"] = full["launches"]
    out["full_width"] = full["rows"]
    fleet_traced(out, firsts["concurrent"])
    print("[fleet] summary " + json.dumps(out, default=float), flush=True)
    return out, firsts


# Phase 12: the manager tier on the card. Phase 11's fleet (the same
# FleetSpec, pretraining and streams) under FleetManager: scenario (a) of
# tests/test_torch_manager_parity.py (2 shards, 3 streams, shard 1 lost at
# round 3, per-lane checkpoints every 2 rounds, recovery 2.0 s a lane) and
# scenario (b) (2 shards, the estimator policy with migration_cost_s 0.5
# and oversub_limit 10, one camera due at t=10).
MANAGER_FAIL = dict(n_shards=2, checkpoint_every=2, recovery_cost_s=2.0,
                    migration=False)
MANAGER_PLACE = dict(n_shards=2, placement="estimator",
                     placement_kwargs={"migration_cost_s": 0.5,
                                       "oversub_limit": 10.0},
                     migration=True, migration_cooldown=2,
                     migration_cost_s=0.5)


def manager_run(lanes: int = FLEET_LANES, fail_at=None,
                checkpoints: bool = False, admit: bool = False,
                **manager) -> dict:
    """One repeatable manager run: ``ManagerSpec(fleet=FleetSpec(...),
    **manager).build()`` over phase 11's fleet spec (drift-weighted,
    resolve-max, MX6, sequential, on the card), a fresh
    ``np.random.default_rng(0)`` pretraining the teacher and student on the
    card as :func:`fleet_run` does (10 and 8 steps of 32), then ``lanes``
    streams for ``FLEET_S`` virtual seconds (launch counts and kernel_stats
    set to 0 just before). ``fail_at`` is the ``FailureInjector``'s list;
    ``checkpoints`` puts the per-lane checkpoints in a fresh temporary
    directory; ``admit`` adds ES1 (seed 9) due at t=10. Returns the
    manager, its result, the run's host wall, the fills of every shard
    (the dead one's too), launch counts, kernel_stats and each surviving
    lane's final student tree by camera."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core.allocation import CLHyperParams
    from repro_torch.core.fleet import FleetSpec
    from repro_torch.core.manager import ManagerSpec
    from repro_torch.core.session import pretrain_model
    from repro_torch.data.stream import DriftStream, scenario
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault import FailureInjector

    fleet = FleetSpec(student=RESNET18, teacher=WIDERESNET50,
                      fleet_mode="drift-weighted", row_policy="resolve-max",
                      apply_mx=True, device="cuda", seed=0, eval_fps=0.5,
                      hp=CLHyperParams(**FLEET_HP))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        mgr = ManagerSpec(
            fleet=fleet, checkpoint_dir=ckpt if checkpoints else None,
            failure_injector=(None if fail_at is None
                              else FailureInjector(fail_at)),
            **manager).build()
        first = mgr.shards[0].session
        stream = DriftStream(scenario("S1", 2), seed=5, img=24)
        rng = np.random.default_rng(0)
        tp = pretrain_model(first.teacher, stream, 10, 32, rng)
        sp = pretrain_model(first.student, stream, 8, 32, rng,
                            segments=stream.segments[:1], seed=8)
        mgr.set_pretrained(tp, sp)
        torch.cuda.synchronize()
        fills = sum(session_fills(s.session) for s in mgr.shards)
        mxq.reset_launch_counts()
        ops.reset_kernel_stats()
        admissions = ([(10.0, "late", DriftStream(scenario("ES1", 2),
                                                  seed=9, img=24))]
                      if admit else ())
        t0 = time.perf_counter()
        res = mgr.run(fleet_streams(lanes), duration=FLEET_S,
                      admissions=admissions)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    params = {lane.key: lane.params for shard in mgr.shards
              if shard.alive and shard.run is not None
              for lane in shard.run.lanes}
    return {"mgr": mgr, "res": res, "wall": wall,
            "fills": sum(session_fills(s.session) for s in mgr.shards)
            - fills, "launches": mxq.launch_counts(),
            "stats": ops.kernel_stats(), "params": params}


def manager_differences(first: dict, second: dict) -> list:
    """What differs between two :func:`manager_run` results: rounds,
    events, the ``ManagerDecision`` stream, both ledgers, every lane's
    records (their phase logs), accuracy timeline and final student tree,
    the fleet accuracy and the launch counts."""
    from repro_torch.tree import tree_leaves

    a, b = first["res"], second["res"]
    diffs = []
    for name in ("rounds", "events", "decisions", "ledger", "shard_ledgers",
                 "fleet_avg_accuracy"):
        if getattr(a, name) != getattr(b, name):
            diffs.append(f"{name} differ")
    if set(a.lane_results) != set(b.lane_results) or set(
            first["params"]) != set(second["params"]):
        return diffs + [f"lanes {sorted(a.lane_results)} != "
                        f"{sorted(b.lane_results)}"]
    for key, la in a.lane_results.items():
        lb = b.lane_results[key]
        if la.phase_log != lb.phase_log:
            diffs.append(f"lane {key}: phase logs differ")
        if la.accuracy_timeline != lb.accuracy_timeline:
            diffs.append(f"lane {key}: accuracy timelines differ")
        pa, pb = (tree_leaves(run["params"][key]) for run in (first, second))
        if len(pa) != len(pb) or not all(bitwise(x, y)
                                         for x, y in zip(pa, pb)):
            diffs.append(f"lane {key}: student trees differ")
    if first["launches"] != second["launches"]:
        diffs.append(f"launches {first['launches']} != "
                     f"{second['launches']}")
    return diffs


def manager_checks(tag: str, run: dict) -> None:
    """Fills through the kernels (restored and migrated lanes included),
    the two-level ledger conserved, every camera scored."""
    import numpy as np

    res = run["res"]
    fill_checks(tag, run["fills"], run["launches"], run["stats"])
    if not res.conservation_gap() <= 1e-9:
        raise AssertionError(f"{tag}: conservation gap "
                             f"{res.conservation_gap()!r}")
    extra = res.ledger["recovery_cost"] + res.ledger["migration_cost"]
    if abs(res.ledger["total"] - res.ledger["t_tsa"] - extra) > 1e-9 * max(
            1.0, res.ledger["total"]):
        raise AssertionError(f"{tag}: ledger {res.ledger}")
    if not res.lane_results or not all(
            lane.records and np.isfinite(lane.avg_accuracy)
            for lane in res.lane_results.values()):
        raise AssertionError(f"{tag}: bad lane results")


def manager_summary(run: dict) -> str:
    res = run["res"]
    kinds = {}
    for e in res.events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    return (f"rounds {res.rounds} ({res.parallel_rounds} pooled), events "
            f"{kinds}, lane accuracies "
            f"{ {k: v.avg_accuracy for k, v in res.lane_results.items()} }, "
            f"ledger {res.ledger}, wall {run['wall']:.4f} s, fills "
            f"{run['fills']}, launches {run['launches']}")


def trace_differences(a, b) -> list:
    """Merged manager traces, phase for phase and event for event, the
    events' measured ``wall_s`` aside."""
    import dataclasses

    if len(a.phases) != len(b.phases):
        return [f"{len(a.phases)} != {len(b.phases)} phases"]
    for i, (pa, pb) in enumerate(zip(a.phases, b.phases)):
        if (pa.shard, pa.start, pa.end, len(pa.events)) != (
                pb.shard, pb.start, pb.end, len(pb.events)) or any(
                dataclasses.replace(ea, wall_s=0.0)
                != dataclasses.replace(eb, wall_s=0.0)
                for ea, eb in zip(pa.events, pb.events)):
            return [f"merged trace phase {i} differs"]
    return []


def manager_phase(bare: dict) -> dict:
    """Phase 12 (``bare``: phase 11's first sequential fleet run): (i) a
    1-shard manager equals the bare fleet bit for bit, without and with
    per-lane checkpoints every round (their wall cost a save printed);
    (ii) scenario (a) serially and with ``parallel_shards=2`` bit for bit;
    (iii) scenario (b) twice, bit for bit, one admission and at least one
    migration; (iv) scenario (a) traced, serial and pooled: the traced
    pooled run equals the untraced one and its merged trace the serial
    one; (v) every run's fills one "cuda" quantize and dequantize launch
    each. Returns each run's launch counts and wall."""
    from repro_torch.tree import tree_leaves

    out = {"launches": {}, "walls": {}}

    def keep(tag, run):
        log("manager", f"{tag}: {manager_summary(run)}")
        manager_checks(tag, run)
        out["launches"][tag] = run["launches"]
        out["walls"][tag] = run["wall"]

    # (i) 1-shard degeneracy against phase 11's bare fleet, without and
    # with per-lane checkpoints (every round: their cost on the wall).
    ones = {}
    for checkpoints in (False, True):
        tag = "manager_one_shard" + ("_ckpt" if checkpoints else "")
        one = ones[checkpoints] = manager_run(n_shards=1,
                                              checkpoints=checkpoints)
        keep(tag, one)
        got = one["res"].shard_results[0]
        want = bare["res"]
        diffs = []
        if got.fleet_phase_log != want.fleet_phase_log:
            diffs.append("fleet phase logs differ")
        for i, (lg, lw) in enumerate(zip(got.streams, want.streams)):
            if (lg.phase_log, lg.accuracy_timeline) != (
                    lw.phase_log, lw.accuracy_timeline):
                diffs.append(f"lane {i}: phase log or timeline differs")
            pa = tree_leaves(one["params"][f"cam{i}"])
            pb = tree_leaves(bare["params"][i])
            if len(pa) != len(pb) or not all(bitwise(x, y)
                                             for x, y in zip(pa, pb)):
                diffs.append(f"lane {i}: student trees differ")
        if (len(got.streams) != len(want.streams)
                or one["launches"] != bare["launches"]
                or one["fills"] != bare["fills"]):
            diffs.append(f"lanes / launches / fills {one['launches']} "
                         f"{one['fills']} != {bare['launches']} "
                         f"{bare['fills']}")
        if diffs:
            raise AssertionError(f"{tag} != the bare fleet: "
                                 + "; ".join(diffs))
    saves = sum(e.kind == "checkpoint" for e in ones[True]["res"].events
                ) * len(bare["res"].streams)
    log("manager", f"manager_one_shard: equal to phase 11's bare sequential "
        f"fleet bit for bit (fleet phase log, every lane's phase log, "
        f"timeline and student tree, launches, fills), with and without "
        f"per-lane checkpoints; walls {bare['wall']:.4f} s bare, "
        f"{ones[False]['wall']:.4f} s, {ones[True]['wall']:.4f} s with "
        f"{saves} lane checkpoints "
        f"({(ones[True]['wall'] - ones[False]['wall']) / saves * 1e3:.2f} "
        f"ms of wall each)")

    # (ii) scenario (a), serial against pooled.
    runs = {w: manager_run(fail_at=[(3, 1)], checkpoints=True,
                           parallel_shards=w, **MANAGER_FAIL)
            for w in (0, 2)}
    for w, run in runs.items():
        keep(f"manager_failover_x{w}", run)
    serial, pooled = runs[0]["res"], runs[2]["res"]
    kinds = [e.kind for e in serial.events]
    recovered = [p for d in serial.decisions for p in d.placements
                 if p.kind == "recover"]
    if (kinds.count("fail") != 1 or not recovered
            or serial.shard_results[1] is not None
            or any(p.reason != "restored from checkpoint"
                   for p in recovered) or not pooled.parallel_rounds):
        raise AssertionError(f"manager_failover: events {kinds}, "
                             f"recoveries {recovered}")
    diffs = manager_differences(runs[0], runs[2])
    if diffs:
        raise AssertionError("manager_failover: serial != parallel_shards=2:"
                             " " + "; ".join(diffs))
    log("manager", f"manager_failover: serial == parallel_shards=2 bit for "
        f"bit (records, decisions, both ledgers, events, every lane's "
        f"student tree, launches); shard 1 lost at round 3, "
        f"{len(recovered)} lanes restored from their checkpoints; walls "
        f"{runs[0]['wall']:.4f} s serial, {runs[2]['wall']:.4f} s pooled "
        f"per {FLEET_S:g} s of virtual time | {nvidia_smi_line()}")

    # (iii) scenario (b), twice.
    placed = [manager_run(admit=True, **MANAGER_PLACE) for _ in range(2)]
    for i, run in enumerate(placed):
        keep(f"manager_placement_{i + 1}", run)
    diffs = manager_differences(*placed)
    acts = [p.kind for d in placed[0]["res"].decisions for p in d.placements]
    if diffs or acts.count("admit") != 1 or "migrate" not in acts:
        raise AssertionError(f"manager_placement: placements {acts}; "
                             + "; ".join(diffs))
    log("manager", f"manager_placement: two runs bit for bit; placements "
        f"{acts}; walls {placed[0]['wall']:.4f} / {placed[1]['wall']:.4f} s")

    # (iv) scenario (a) traced, serial and pooled.
    traced = {w: manager_run(fail_at=[(3, 1)], checkpoints=True,
                             parallel_shards=w, trace=True, **MANAGER_FAIL)
              for w in (0, 2)}
    for w, run in traced.items():
        keep(f"manager_traced_x{w}", run)
    diffs = manager_differences(runs[2], traced[2]) + trace_differences(
        traced[0]["mgr"].trace, traced[2]["mgr"].trace)
    merged = traced[2]["mgr"].trace
    if diffs or {ph.shard for ph in merged.phases} != {0, 1}:
        raise AssertionError("manager_traced: " + "; ".join(diffs))
    replay_checks("manager_traced", merged)
    out["breakdown"] = host_breakdown("manager_traced_x2", merged,
                                      traced[2]["wall"], phase="manager")
    log("manager", f"manager_traced: the traced pooled run equals the "
        f"untraced one bit for bit, and its merged trace ({len(merged)} "
        f"phases over shards 0 and 1) the serial run's; walls "
        f"{traced[0]['wall']:.4f} s serial, {traced[2]['wall']:.4f} s pooled")
    fills = {tag: counts["mx_quantize"]
             for tag, counts in out["launches"].items()}
    log("manager", f"one cuda quantize and one cuda dequantize launch per "
        f"fill in every run, restored and migrated lanes included: {fills}")
    print("[manager] summary " + json.dumps(out, default=float), flush=True)
    return out


LM_ARCH = "gemma2-2b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 8192, 32
# Phase 13's driver runs, which phase 15 repeats on the host mesh.
SERVE_DRIVER = ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "512",
                "--gen", "32"]
TRAIN_DRIVER = ["--arch", LM_ARCH, "--steps", "3", "--batch", "1", "--seq",
                "1024", "--log-every", "1"]
# Phase 13's limit on decode against one full pass over the same tokens,
# both in the config's bf16: RMS(decode - full) <= LM_RMS_SHARE x RMS(full)
# over all 4 x 32 x 256000 logits. Derivation: the two runs store every
# activation in bf16 (unit roundoff u = 2^-9) after different summation
# orders (M = 4 against M = 32896 GEMMs, ring-slot against position order
# in attention), so a stored value differs by up to one rounding either way,
# RMS 0.82u; ~10 stored values a sublayer give ~2.6u of its output. The
# residual stream (RMS ~48: random embeddings times sqrt(2304)) has a bf16
# step of 0.25, so each of the 52 residual adds flips its rounding with
# probability ~|dy| / 0.25 ~ 2 %, ~0.035 RMS an add, ~0.25 over 52 adds:
# 0.5 % of the residual, which the final norm carries into the head. The
# tied head's logits (RMS ~24, softcap 30; sech^2 ~0.45 on average) then
# move by ~0.005 of their RMS. The limit leaves 12x for compounding through
# the layers; a decode that reads a wrong slot, position or cache is off by
# O(1). Greedy tokens must agree wherever the full pass's top two logits
# are further apart than twice the largest error.
LM_RMS_SHARE = 2.0 ** -4


def lm_decode_bound_ms(cfg) -> float:
    """The least time of one decode step at phase 13's last position: its
    weights read once and every sequence's K/V (the global layers' slots
    up to the last position, the local layers' full rings) once, over
    3.35 TB/s (the matmuls' 2 FLOPs a weight a sequence are ~1 % of the
    bf16 peak's reach)."""
    itemsize = 2  # bf16
    n = LM_PROMPT + LM_GEN
    kv = 0
    for i in range(cfg.num_layers):
        window = cfg.local_window if cfg.is_local_layer(i) else None
        slots = min(n, window) if window else n
        kv += 2 * LM_BATCH * cfg.num_kv_heads * cfg.resolved_head_dim * slots
    params = cfg.param_count() + (2 * cfg.num_layers + 1) * cfg.d_model
    return (params + kv) * itemsize / HBM_BYTES_PER_S * 1e3


def device_busy_ms(fn):
    """(host wall ms, device busy ms) of ``fn()`` between two syncs: the
    busy time is ``fill_profile.py``'s, the union of the device events
    ``torch.profiler`` records; None where it records none. The wall
    includes the profiler's own host cost."""
    import torch
    from torch.profiler import ProfilerActivity

    from fill_profile import busy_us, device_events

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(start, stop) for _, start, stop in device_events(prof)]
    return wall * 1e3, (busy_us(spans) / 1e3 if spans else None)


def lm_serve(model, prompts, gen: int, profile_step=None,
             params=None) -> dict:
    """One serving run of phases 13 and 14: ``params`` (default: weights
    from a fresh CUDA generator, seed 0), the prefill of ``prompts`` into a
    cache of prompt + ``gen`` slots, then ``gen`` greedy decode steps.
    Returns the params, the decode logits [B, gen, V] and the tokens fed
    [B, gen], host walls, and the
    attention launches of the prefill and of each decode step. Nothing
    in the decode loop waits for the card, so ``issue_s`` (the host time
    spent inside ``decode_step``) near ``decode_s`` means the host, not
    the card, sets the pace. Decode step ``profile_step`` (if any) runs
    between two syncs under the profiler: ``step_profile`` is its host
    wall and device busy ms (``device_busy_ms``)."""
    import torch

    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops

    if params is None:
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
    s = prompts.shape[1]
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, prompts, cache_capacity=s + gen)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    per_prefill = mxq.launch_counts()["flash_attention"]
    tok = logits.argmax(-1)
    fed, outs, per_step = [], [], []
    issue_s, step_profile = 0.0, None
    t0 = time.perf_counter()
    for i in range(gen):
        before = mxq.launch_counts()["flash_attention"]
        fed.append(tok)
        t1 = time.perf_counter()
        if i == profile_step:
            box = []
            step_profile = device_busy_ms(lambda: box.append(
                model.decode_step(params, tok[:, None], s + i, caches)))
            logits, caches = box[0]
        else:
            logits, caches = model.decode_step(params, tok[:, None], s + i,
                                               caches)
        issue_s += time.perf_counter() - t1
        per_step.append(mxq.launch_counts()["flash_attention"] - before)
        outs.append(logits)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return {"params": params, "logits": torch.stack(outs, 1),
            "fed": torch.stack(fed, 1), "prefill_s": prefill_s,
            "decode_s": decode_s, "issue_s": issue_s,
            "step_profile": step_profile,
            "per_prefill": per_prefill,
            "per_step": per_step,
            "stats": ops.kernel_stats().get("flash_attention")}


def full_pass_logits(model, params, prompts, fed):
    """One ``hidden``/``logits`` pass over prompt + ``fed`` tokens: (the
    logits at the fed tokens' positions [B, gen, V], attention launches)."""
    import torch

    from repro_torch.kernels import mx_quantize as mxq

    s, gen = prompts.shape[1], fed.shape[1]
    tokens = torch.cat([prompts, fed.to(prompts.dtype)], 1)
    before = mxq.launch_counts()["flash_attention"]
    with torch.no_grad():
        x, _, _ = model.hidden(params, tokens, mode="prefill",
                               positions=torch.arange(s + gen), remat=False)
        full = model.logits(params, x[:, s:])
    return full, mxq.launch_counts()["flash_attention"] - before


def decode_readings(dec, full, held=None) -> dict:
    """Decode logits ``dec`` against the full pass's ``full`` [B, gen, V]
    over the (b, step) tokens ``held`` (default all): RMS share, max
    error, argmax changes and those not near a tie (the full pass's top two
    further apart than twice the max error), the largest |logit|."""
    import torch

    if held is None:
        held = torch.ones(dec.shape[:2], dtype=torch.bool, device=dec.device)
    d, f = dec[held], full[held]
    max_err = float((d - f).abs().max()) if d.numel() else 0.0
    top2 = f.topk(2, -1).values
    differ = d.argmax(-1) != f.argmax(-1)
    clear = differ & (top2[..., 0] - top2[..., 1] > 2 * max_err)
    return {"rms_share": float((d - f).square().mean().sqrt()
                               / f.square().mean().sqrt()),
            "max_abs_err": max_err, "argmax_differ": int(differ.sum()),
            "argmax_differ_clear": int(clear.sum()),
            "max_abs_logit": max(float(dec.abs().max()),
                                 float(full.abs().max())),
            "finite": bool(torch.isfinite(dec).all()),
            "tokens": int(held.sum())}


def lm_decode_against_full(model, params, prompts, run: dict,
                           limit: float = LM_RMS_SHARE) -> dict:
    """Phase 13's (and 14's) check of decode against one
    ``hidden``/``logits`` pass over prompt + generated tokens, at the
    generated positions: the RMS share within ``limit``, every logit
    within the final softcap (if the config has one), greedy tokens equal
    except near ties. Returns the readings."""
    cap = model.cfg.final_softcap
    s, gen = prompts.shape[1], run["fed"].shape[1]
    full, launches = full_pass_logits(model, params, prompts, run["fed"])
    readings = decode_readings(run["logits"], full)
    readings.update(full_pass_launches=launches, positions=[s, s + gen - 1])
    if (not readings["rms_share"] <= limit or readings["argmax_differ_clear"]
            or (cap is not None and not readings["max_abs_logit"] <= cap)
            or not readings["finite"]):
        raise AssertionError(f"{model.cfg.name}: decode against the full "
                             f"pass: {readings} (limits: RMS share {limit}, "
                             f"no clear argmax change, |logit| <= {cap})")
    return readings


def lm_phase() -> dict:
    """Phase 13: gemma2-2b at full width on the card. (i) Serving in the
    config's bf16: weights from a seeded CUDA generator (element count
    checked against ``param_count()``), prefill of 4 x 8192 prompt tokens
    of ``TokenPipeline`` into a cache of 8224 slots (the local layers'
    4096-slot rings wrap), 32 greedy decode steps — twice, bit for bit;
    every attention call "cuda", 26 launches a prefill and 26 a decode
    step; decode held to one full pass (``lm_decode_against_full``). (ii)
    The serve driver as the reference runs it (fp32, batch 4, prompt 512,
    32 tokens): prefill ms, decode tok/s, peak memory. (iii) The train
    driver: fp32 AdamW, batch 1 x seq 1024, 3 steps, finite loss, each
    step's wall and the peak memory. Returns the numbers and launches."""
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.registry import make_lm_model
    from repro_torch.tree import tree_leaves

    cfg = get_arch(LM_ARCH)
    layers = cfg.num_layers
    model = make_lm_model(cfg)
    prompts = torch.from_numpy(TokenPipeline(
        cfg.vocab_size, LM_PROMPT, LM_BATCH, seed=0).batch(0)["inputs"]).to(
            model.device)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    first = lm_serve(model, prompts, LM_GEN)
    out["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in tree_leaves(first["params"]))
    # param_count() leaves out the post-block norms and the final norm.
    want = cfg.param_count() + (2 * layers + 1) * cfg.d_model
    if n != want:
        raise AssertionError(f"lm: {n} parameters, expected {want}")
    if (first["per_prefill"] != layers
            or first["per_step"] != [layers] * LM_GEN
            or first["stats"] != {"cuda": layers * (1 + LM_GEN)}):
        raise AssertionError(
            f"lm: attention launches {first['per_prefill']} a prefill, "
            f"{first['per_step']} per decode step, kernel_stats "
            f"{first['stats']}; expected {layers} each, all cuda")
    out.update(params=n, prefill_s=first["prefill_s"],
               decode_s=first["decode_s"], issue_s=first["issue_s"])
    log("lm", f"{LM_ARCH} bf16 full width: {n:,} parameters "
        f"(param_count() {cfg.param_count():,} + {(2 * layers + 1)} norms "
        f"of {cfg.d_model}); prefill {LM_BATCH} x {LM_PROMPT} tokens "
        f"{first['prefill_s'] * 1e3:.1f} ms, {LM_GEN} decode steps "
        f"{first['decode_s'] * 1e3:.1f} ms "
        f"({LM_GEN * LM_BATCH / first['decode_s']:.1f} tok/s; "
        f"{first['issue_s'] * 1e3:.1f} ms of it issuing on the host), peak "
        f"{out['serve_peak_bytes'] / 2**30:.2f} GiB; "
        f"{first['per_prefill']} attention launches a prefill, "
        f"{layers} a decode step, all cuda")
    second = lm_serve(model, prompts, LM_GEN, profile_step=LM_GEN - 1)
    differ = [key for key in ("logits", "fed")
              if not same_bits(first[key], second[key])]
    differ += [f"param {i}" for i, (a, b) in enumerate(zip(
        tree_leaves(first["params"]), tree_leaves(second["params"])))
        if not same_bits(a, b)]
    if differ:
        raise AssertionError(f"lm: two serving runs differ in {differ}")
    wall_ms, busy_ms = second["step_profile"]
    out["decode_step_profile"] = {"wall_ms": wall_ms, "device_busy_ms":
                                  busy_ms}
    out["second_run"] = {key: second[key] for key in (
        "prefill_s", "decode_s", "issue_s")}
    log("lm", f"a second run from the same seed: bit for bit (weights, "
        f"{LM_GEN} decode logits, tokens); prefill "
        f"{second['prefill_s'] * 1e3:.1f} ms, {LM_GEN} decode steps "
        f"{second['decode_s'] * 1e3:.1f} ms with one under the profiler: "
        f"its decode step at t = "
        f"{LM_PROMPT + LM_GEN - 1} between two syncs under the profiler: "
        f"{wall_ms:.2f} ms of host wall, device busy "
        f"{'not measured' if busy_ms is None else f'{busy_ms:.3f} ms'} "
        f"(bound {lm_decode_bound_ms(cfg):.3f} ms)")
    del second
    torch.cuda.empty_cache()
    readings = lm_decode_against_full(model, first["params"], prompts, first)
    out["decode_vs_full"] = readings
    log("lm", "decode against one full pass over {p} tokens at positions "
        "{positions}: RMS share {rms_share:.4g} (limit {lim:.4g}), max abs "
        "err {max_abs_err:.4g}, |logit| <= {max_abs_logit:.4g}, argmax "
        "differs at {argmax_differ} of {n} (near ties; {argmax_differ_clear} "
        "clear)".format(p=LM_PROMPT + LM_GEN, lim=LM_RMS_SHARE,
                        n=LM_BATCH * LM_GEN, **readings))
    del first
    torch.cuda.empty_cache()

    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    res = serve_lib.serve(SERVE_DRIVER, on_mesh=False)
    launches = mxq.launch_counts()["flash_attention"]
    if (launches != layers * 32
            or ops.kernel_stats().get("flash_attention") != {"cuda":
                                                              launches}):
        raise AssertionError(f"lm serve driver: {launches} attention "
                             f"launches, {ops.kernel_stats()}; expected "
                             f"{layers * 32}, all cuda")
    out["serve_driver"] = {k: res[k] for k in (
        "prefill_s", "decode_s", "decode_tok_per_s", "peak_bytes")}
    out["serve_driver"]["launches"] = launches
    out["driver_runs"] = {"serve": {"tokens": res["tokens"],
                                    "logits": res["logits"].cpu(),
                                    "launches": launches}}
    log("lm", f"serve driver (fp32, batch 4, prompt 512, 32 tokens): prefill "
        f"{res['prefill_s'] * 1e3:.1f} ms, decode "
        f"{res['decode_tok_per_s']:.1f} tok/s, peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB, {launches} attention "
        "launches, all cuda")
    del res
    torch.cuda.empty_cache()

    ckpt = tempfile.mkdtemp(prefix="lm_ckpt_")
    try:
        mxq.reset_launch_counts()
        ops.reset_kernel_stats()
        res = train_lib.train(TRAIN_DRIVER + ["--checkpoint-dir", ckpt],
                              on_mesh=False)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = mxq.launch_counts()["flash_attention"]
    if (not all(math.isfinite(x) for x in res["loss"])
            or len(res["loss"]) != 3
            or ops.kernel_stats().get("flash_attention") != {"cuda":
                                                              launches}
            or launches != 3 * 2 * layers):
        raise AssertionError(f"lm train driver: losses {res['loss']}, "
                             f"{launches} attention launches, "
                             f"{ops.kernel_stats()}; expected finite, "
                             f"{3 * 2 * layers} all cuda")
    out["train_driver"] = {k: res[k] for k in ("loss", "step_s",
                                               "tok_per_s", "peak_bytes")}
    out["train_driver"]["launches"] = launches
    log("lm", f"train driver (fp32 AdamW, batch 1 x seq 1024): losses "
        f"{[round(x, 4) for x in res['loss']]}, step walls "
        f"{[round(x, 3) for x in res['step_s']]} s, peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB, {launches} attention "
        f"launches (forward and recompute, {layers} each a step), all cuda")
    out["driver_runs"]["train"] = {
        "loss": res["loss"], "launches": launches,
        "params": [p.cpu() for p in tree_leaves(res["params"])]}
    del res
    out["launches_lm"] = {"prefill": layers, "decode_step": layers,
                          "serve_run": layers * (1 + LM_GEN),
                          "full_pass": readings["full_pass_launches"],
                          "serve_driver": out["serve_driver"]["launches"],
                          "train_driver": launches}
    return out


# Phase 14's models: (arch, layers kept, batch, prompt tokens), each served
# at its published widths in its own bf16 from a seeded CUDA generator,
# the depth cut to fit one card: mixtral-8x7b 4 of 32 layers (6.1 B
# parameters), jamba-v0.1-52b one pattern period, 8 of 32 layers (7 Mamba,
# 1 attention; 4 MoE layers of 16 experts; 13.3 B), xlstm-125m whole.
MIXER_MODELS = (("mixtral-8x7b", 4, 4, 4096), ("jamba-v0.1-52b", 8, 2, 4096),
                ("xlstm-125m", 12, 4, 1024))
MIXER_GEN = 32
# Phase 14's limit on decode against one full pass over the same tokens,
# both in the config's bf16: RMS(decode - full) <= MIXER_RMS_SHARE x
# RMS(full) over all generated positions' logits. Set from readings on an
# H100, since LM_RMS_SHARE's rounding estimate (each sublayer moved by
# ~2.6u, u = 2^-9, compounding as sqrt(L)) does not hold for every model
# here: it gives 0.015, 0.021 and 0.017 for mixtral's 8, jamba's 16 and
# xlstm's 12 sublayers, and sound runs read 0.012, 0.018 and 0.040.
# xlstm's excess is rounding, not a fault: in fp32 the same model reads
# 2.5e-5, and each decode fault planted by ``xlstm_decode_bracket`` (a
# stale sLSTM or mLSTM state, a conv row read late) reads 0.64-1.05 in
# bf16 and fp32 alike. The limit sits 1.6x above the largest sound reading
# and 10x below the least fault; the bracket holds both ends every run.
# The MoE models are held at a capacity factor of e / k, where no token
# can drop, and over the tokens that decode and the full pass route to the
# same experts (``mixer_moe_decode_check``).
MIXER_RMS_SHARE = 2.0 ** -4
# Routing is discrete: where a token's k-th and (k+1)-th router
# probabilities nearly tie, the two runs' rounding may send it to other
# experts, and its logits then move by a gate times an expert's output.
# The router reads the normed residual, which the runs carry apart by the
# share above (~2 %), so its fp32 logits (~N(0, 1)) move by ~0.02 and a
# gap between two probabilities (each <= 1/2) by up to ~0.02. A reroute
# is allowed only where the full pass's gap is within ROUTE_TIE, 1.5x
# that; a routing fault reroutes tokens far from any tie.
ROUTE_TIE = 2.0 ** -5
# tests/_torch_lm.py's tolerances, for the reduced models' card run held
# to the CPU port: fp32 summation order (RTOL of each tensor's scale) and
# gradients (GRAD_RTOL of each leaf's scale).
LM_RTOL, LM_GRAD_RTOL = 2e-5, 1e-3
RECURRENCES = (("ssm", "_chunk", "mamba chunks"),
               ("xlstm", "_mlstm_chunk", "mlstm chunks"),
               ("xlstm", "_slstm_step", "slstm steps"))


def layer_scale_(model, params):
    """Rescale ``params`` in place so that each stacked block leaf has its
    own layer's init scale, and return them. ``ParamDef`` (the
    reference's init, which the port keeps) takes the leading dim as the
    fan-in, and for a stacked [n_groups, ...] leaf that is the group count:
    1 in the reduced jamba and xLSTM and in jamba-v0.1-52b cut to one
    period, so their block weights are N(0, 1) and the models chaotic (one
    fp32 rounding of the reduced models' weights moves their gradients by
    up to 4 % of a leaf's scale; full-width jamba's decode and full pass
    part by an RMS share of 0.45). A default-scaled block leaf is
    multiplied by sqrt(n_groups / its layer's own fan-in), the scale its
    layer's def draws alone; leaves with a scale of their own stay. Used
    by phase 14 and by the CPU parity tests."""
    from repro_torch.tree import tree_leaves

    defs = tree_leaves(model.param_defs()["blocks"])
    for d, leaf in zip(defs, tree_leaves(params["blocks"])):
        if d.init == "normal" and d.scale is None:
            leaf.mul_(math.sqrt(d.shape[0] / d.shape[1]))
    return params


@contextlib.contextmanager
def recurrence_spans(spans: dict):
    """Time each call of the eager recurrences (the Mamba scan chunk, the
    mLSTM chunk, the sLSTM step) between two CUDA events, without a sync:
    ``spans[label]`` collects the (start, end) pairs."""
    import importlib

    import torch

    saved = []
    for module, name, label in RECURRENCES:
        mod = importlib.import_module(f"repro_torch.models.{module}")
        orig = getattr(mod, name)

        def timed(*args, _orig=orig, _label=label):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _orig(*args)
            end.record()
            spans.setdefault(_label, []).append((start, end))
            return out
        saved.append((mod, name, orig))
        setattr(mod, name, timed)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


@contextlib.contextmanager
def route_record(records: list):
    """Record each MoE routing call: (expert indices [b, s, k], the top
    k + 1 router probabilities [b, s, k + 1], the keep mask [b, s, k])."""
    import torch

    from repro_torch.models import moe

    orig = moe.route

    def recording(logits, cfg, *, no_drop):
        out = orig(logits, cfg, no_drop=no_drop)
        records.append((out[1], torch.softmax(logits, -1).topk(
            cfg.top_k + 1, -1).values, out[3]))
        return out
    moe.route = recording
    try:
        yield
    finally:
        moe.route = orig


# Decode faults planted in xlstm-125m, each of which phase 14's decode check
# must fail (``xlstm_decode_bracket``): an sLSTM or mLSTM layer whose decode
# never advances its recurrent state past the prefill's, and an mLSTM conv
# that reads its window one row late (rows t-3, t-3, t-2 and t in place of
# t-3, t-2, t-1 and t).
XLSTM_FAULTS = ("sLSTM state stale", "mLSTM state stale",
                "mLSTM conv one row late")
# The limit on the same check in fp32: xlstm-125m's sound fp32 decode
# reads 2.5e-5 on an H100 (far above u = 2^-24: the gated recurrences
# amplify rounding), the planted faults 0.64-1.05; the limit leaves 10x
# above the one and 2600x below the other.
XLSTM_FP32_SHARE = 2.0 ** -12


@contextlib.contextmanager
def planted_fault(fault: str):
    """Plant one of ``XLSTM_FAULTS`` in the xLSTM layers' decode, through
    the model's mixer table (``models/transformer.py::_MIXERS``); prefill
    and the full pass run as they are."""
    import torch

    from repro_torch.configs.base import MIXER_MLSTM, MIXER_SLSTM
    from repro_torch.models import transformer, xlstm

    mixer = MIXER_SLSTM if fault.startswith("sLSTM") else MIXER_MLSTM
    defs, forward, cache_defs = transformer._MIXERS[mixer]
    conv = xlstm.causal_conv

    def stale(params, x, cfg, *, mode, cache=None):
        if mode != "decode":
            return forward(params, x, cfg, mode=mode, cache=cache)
        keep = {key: val.clone() for key, val in cache.items()
                if key != "conv"}
        out = forward(params, x, cfg, mode=mode, cache=cache)
        for key, val in keep.items():
            cache[key].copy_(val)
        return out

    def late(x, w, b, conv_state=None):
        if conv_state is None:
            return conv(x, w, b)
        y, _ = conv(x, w, b, torch.cat([conv_state[:, :1],
                                        conv_state[:, :-1]], 1))
        return y, conv(x, w, b, conv_state)[1]

    if fault.endswith("state stale"):
        transformer._MIXERS[mixer] = (defs, stale, cache_defs)
    else:
        xlstm.causal_conv = late
    try:
        yield
    finally:
        transformer._MIXERS[mixer] = (defs, forward, cache_defs)
        xlstm.causal_conv = conv


def xlstm_decode_bracket(model, params, prompts, fed) -> dict:
    """Where phase 14's decode check of xlstm-125m sits between a sound
    decode and a faulty one. The bf16 model on ``params`` and the same
    model in fp32 (weights from the same seed, ``layer_scale_``d) each
    prefill ``prompts`` once and decode the tokens ``fed`` [B, gen] from
    a copy of that cache, sound and with each of ``XLSTM_FAULTS``
    planted, held to one full pass over the same tokens: sound within the
    limit (``XLSTM_FP32_SHARE`` in fp32, ``MIXER_RMS_SHARE`` in bf16),
    every fault above it. Returns the readings."""
    import dataclasses

    import torch

    from repro_torch.models.registry import make_lm_model
    from repro_torch.tree import tree_map

    model32 = make_lm_model(dataclasses.replace(model.cfg, dtype="float32"),
                            model.device)
    p32 = layer_scale_(model32, model32.init(
        torch.Generator(device=model.device).manual_seed(0)))
    s, gen = prompts.shape[1], fed.shape[1]
    out, shares = {}, {}
    for dtype, m, p, limit in (("float32", model32, p32, XLSTM_FP32_SHARE),
                               ("bfloat16", model, params, MIXER_RMS_SHARE)):
        full, _ = full_pass_logits(m, p, prompts, fed)
        with torch.no_grad():
            _, prefilled = m.prefill(p, prompts, cache_capacity=s + gen)
        out[dtype] = {}
        for fault in (None,) + XLSTM_FAULTS:
            caches, logits = tree_map(torch.clone, prefilled), []
            with (planted_fault(fault) if fault
                  else contextlib.nullcontext()), torch.no_grad():
                for i in range(gen):
                    step, caches = m.decode_step(p, fed[:, i:i + 1], s + i,
                                                 caches)
                    logits.append(step)
            out[dtype][fault or "sound"] = decode_readings(
                torch.stack(logits, 1), full)
        shares[dtype] = {key: r["rms_share"] for key, r in out[dtype].items()}
        shares[dtype]["limit"] = limit
        del full, prefilled, caches
    log("mixers", f"{model.cfg.name}: decode of the same {gen} tokens "
        "against the full pass, sound and with a fault planted (RMS "
        "shares): " + "; ".join(
            f"{dtype} sound {sh['sound']:.4g} (limit {sh['limit']:.4g}), "
            + ", ".join(f"{fault} {sh[fault]:.4g}" for fault in XLSTM_FAULTS)
            for dtype, sh in shares.items()))
    for dtype, sh in shares.items():
        missed = [fault for fault in XLSTM_FAULTS
                  if not sh[fault] > sh["limit"]]
        if not sh["sound"] <= sh["limit"] or missed:
            raise AssertionError(
                f"{model.cfg.name}: {dtype} decode against the full pass: "
                f"{sh} (sound within the limit, every fault above; missed "
                f"{missed})")
    return out


def route_flips(decoded: list, full: list, s: int, gen: int, k: int):
    """Where decode routed a generated token to other experts than the
    full pass did, in any MoE layer: (mask [B, gen], the number of (token,
    layer) flips, the largest of the full pass's gaps p_k - p_(k+1) between
    its k-th and (k+1)-th router probabilities at a flip). ``decoded``
    holds ``route_record``'s calls of a serving run (its one-token decode
    calls, layer after layer, step after step), ``full`` those of one pass
    over all s + gen tokens (one group a row)."""
    import torch

    steps = [r for r in decoded if r[0].shape[1] == 1]
    layers = len(full)
    if len(steps) != gen * layers:
        raise AssertionError(f"{len(steps)} decode routing calls, expected "
                             f"{gen} x {layers}")
    flips, count, gap = None, 0, 0.0
    for layer, (idx, top, _) in enumerate(full):
        want = idx[:, s:s + gen].sort(-1).values
        got = torch.cat([steps[i * layers + layer][0]
                         for i in range(gen)], 1).sort(-1).values
        flip = (want != got).any(-1)
        flips = flip if flips is None else flips | flip
        count += int(flip.sum())
        if bool(flip.any()):
            gaps = top[:, s:s + gen, k - 1] - top[:, s:s + gen, k]
            gap = max(gap, float(gaps[flip].max()))
    return flips, count, gap


def drop_shares(records: list):
    """(share of (token, expert) picks dropped, share of tokens that lost
    a pick) over ``route_record``'s calls."""
    keeps = [keep for *_, keep in records]
    return (float(sum((~k).sum() for k in keeps))
            / sum(k.numel() for k in keeps),
            float(sum((~k).any(-1).sum() for k in keeps))
            / sum(k[..., 0].numel() for k in keeps))


def mixer_serving(cfg, full_layers: int, batch: int, prompt: int) -> dict:
    """Phase 14, one model at full width in its bf16 (depth cut to
    ``cfg.num_layers`` of ``full_layers``), its weights from a seeded CUDA
    generator rescaled to each layer's own init scale (``layer_scale_``):
    two serving runs from the same seed, bit for bit (weights, decode
    logits, tokens), every attention call "cuda" at one launch a layer for
    the prefill and for each decode step; the element count against
    ``param_defs()``; between them a prefill with the eager recurrences
    timed (``recurrence_spans``) and the MoE drops counted
    (``route_record``); one decode step of the second run profiled; decode
    against one full pass (``lm_decode_against_full`` within
    ``MIXER_RMS_SHARE``; ``mixer_moe_decode_check`` for the MoE models;
    ``xlstm_decode_bracket`` for xlstm-125m). Returns the readings."""
    import dataclasses

    import torch

    from repro_torch.configs.base import MIXER_ATTENTION
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed import param_shapes
    from repro_torch.models.registry import make_lm_model
    from repro_torch.tree import tree_leaves

    name, gen = cfg.name, MIXER_GEN
    model = make_lm_model(cfg)
    attn = sum(cfg.mixer_for_layer(i) == MIXER_ATTENTION
               for i in range(cfg.num_layers))
    prompts = torch.from_numpy(TokenPipeline(
        cfg.vocab_size, prompt, batch, seed=0).batch(0)["inputs"]).to(
            model.device)

    def fresh():
        return model.init(torch.Generator(device="cuda").manual_seed(0))

    def timed_prefill(params, spans, routes):
        """Prefill ms with the recurrences timed and the routing recorded."""
        with recurrence_spans(spans), route_record(routes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, prompts, cache_capacity=prompt + gen)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    first = lm_serve(model, prompts, gen,
                     params=layer_scale_(model, fresh()))
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in tree_leaves(first["params"]))
    want = sum(m.numel() for m in tree_leaves(param_shapes(
        model.param_defs())))
    if n != want:
        raise AssertionError(f"{name}: {n} parameters, param_defs() {want}")
    stats = {"cuda": attn * (1 + gen)} if attn else None
    if (first["per_prefill"] != attn or first["per_step"] != [attn] * gen
            or first["stats"] != stats):
        raise AssertionError(
            f"{name}: attention launches {first['per_prefill']} a prefill, "
            f"{first['per_step']} per decode step, kernel_stats "
            f"{first['stats']}; expected {attn} each, all cuda")
    spans, routes = {}, []
    instrumented_ms = timed_prefill(first["params"], spans, routes)
    second = lm_serve(model, prompts, gen, profile_step=gen - 1,
                      params=layer_scale_(model, fresh()))
    differ = [key for key in ("logits", "fed")
              if not same_bits(first[key], second[key])]
    differ += [f"param {i}" for i, (a, b) in enumerate(zip(
        tree_leaves(first["params"]), tree_leaves(second["params"])))
        if not same_bits(a, b)]
    if differ:
        raise AssertionError(f"{name}: two serving runs differ in {differ}")
    recur = {label: sum(a.elapsed_time(b) for a, b in pairs)
             for label, pairs in spans.items()}
    calls = {label: len(pairs) for label, pairs in spans.items()}
    wall_ms, busy_ms = second["step_profile"]
    out = {"layers": cfg.num_layers, "of_layers": full_layers,
           "batch": batch, "prompt": prompt, "params": n,
           "param_count": cfg.param_count(), "peak_bytes": peak,
           "prefill_ms": [first["prefill_s"] * 1e3,
                          second["prefill_s"] * 1e3],
           "instrumented_prefill_ms": instrumented_ms,
           "decode_tok_per_s": [gen * batch / r["decode_s"]
                                for r in (first, second)],
           "issue_share": [r["issue_s"] / r["decode_s"]
                           for r in (first, second)],
           "decode_step_profile": {"wall_ms": wall_ms,
                                   "device_busy_ms": busy_ms},
           "recurrences_ms": recur, "recurrence_calls": calls,
           "recurrence_share": sum(recur.values()) / instrumented_ms,
           "launches": {"prefill": first["per_prefill"],
                        "decode_steps": first["per_step"]}}
    if cfg.num_experts:
        out["dropped_shares"] = drop_shares(routes)
    log("mixers", f"{name} bf16, {cfg.num_layers} of {full_layers} layers: "
        f"{n:,} parameters (= param_defs(); param_count() "
        f"{cfg.param_count():,}); prefill {batch} x {prompt} tokens "
        f"{first['prefill_s'] * 1e3:.1f} ms, {gen} decode steps "
        f"{first['decode_s'] * 1e3:.1f} ms ({out['decode_tok_per_s'][0]:.1f}"
        f" tok/s; {out['issue_share'][0]:.1%} issuing on the host), peak "
        f"{peak / 2**30:.2f} GiB; {attn} attention launches a prefill and a "
        f"decode step, all cuda")
    log("mixers", f"{name}: a second run from the same seed bit for bit "
        f"(weights, {gen} decode logits, tokens); a prefill with the "
        f"recurrences timed between CUDA events {instrumented_ms:.1f} ms: "
        + (", ".join(f"{label} {ms:.1f} ms ({calls[label]} calls)"
                     for label, ms in recur.items()) or "none")
        + f" = {out['recurrence_share']:.1%} of it; decode step at t = "
        f"{prompt + gen - 1} under the profiler {wall_ms:.2f} ms host wall, "
        f"device busy "
        f"{'not measured' if busy_ms is None else f'{busy_ms:.3f} ms'}"
        + (f"; at capacity factor {cfg.capacity_factor} the prefill dropped "
           "{:.2%} of the (token, expert) picks, {:.2%} of the tokens lost a "
           "pick".format(*out["dropped_shares"])
           if cfg.num_experts else ""))
    del second
    torch.cuda.empty_cache()
    if not cfg.num_experts:
        out["decode_vs_full"] = lm_decode_against_full(
            model, first["params"], prompts, first, MIXER_RMS_SHARE)
        log("mixers", "{name}: decode against one full pass over {p} "
            "tokens at positions {positions}: RMS share {rms_share:.4g} "
            "(limit {lim:.4g}), max abs err {max_abs_err:.4g}, argmax "
            "differs at {argmax_differ} of {tokens} (near ties; "
            "{argmax_differ_clear} clear)".format(
                name=name, p=prompt + gen, lim=MIXER_RMS_SHARE,
                **out["decode_vs_full"]))
        if cfg.slstm_at:
            out["decode_bracket"] = xlstm_decode_bracket(
                model, first["params"], prompts, first["fed"])
        return out
    out["decode_vs_full"] = mixer_moe_decode_check(
        cfg, first["params"], prompts, gen)
    return out


def mixer_moe_decode_check(cfg, params, prompts, gen: int) -> dict:
    """Phase 14's decode check of an MoE model: at a capacity factor of
    e / k (no token can drop) a serving run on ``params`` and one full
    pass over its tokens, both with their routing recorded. Where decode
    and the full pass route a token to the same experts in every layer,
    its logits are held within ``MIXER_RMS_SHARE`` (greedy tokens equal but
    near ties); a token that either routed elsewhere must sit where the
    full pass's k-th and (k+1)-th router probabilities are within
    ``ROUTE_TIE`` of each other. Returns the readings."""
    import dataclasses

    from repro_torch.models.registry import make_lm_model

    model = make_lm_model(dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k))
    s = prompts.shape[1]
    decoded, full_routes = [], []
    with route_record(decoded):
        run = lm_serve(model, prompts, gen, params=params)
    with route_record(full_routes):
        full, launches = full_pass_logits(model, params, prompts, run["fed"])
    flips, count, gap = route_flips(decoded, full_routes, s, gen, cfg.top_k)
    held = decode_readings(run["logits"], full, ~flips)
    whole = decode_readings(run["logits"], full)
    out = {**held, "all_tokens": whole, "rerouted_tokens": int(flips.sum()),
           "rerouted_token_layers": count, "largest_gap_at_reroute": gap,
           "full_pass_launches": launches, "positions": [s, s + gen - 1]}
    log("mixers", "{name}: decode against one full pass over {p} tokens at "
        "positions {positions}, capacity factor {cf:g}: {rerouted_tokens} of "
        "{n} tokens routed to other experts ({rerouted_token_layers} (token, "
        "layer) pairs; the full pass's largest gap p_k - p_(k+1) there "
        "{largest_gap_at_reroute:.3g}, limit {tie:.3g}); over the other "
        "{tokens}: RMS share {rms_share:.4g} (limit {lim:.4g}), max abs err "
        "{max_abs_err:.4g}, argmax differs at {argmax_differ} (near ties; "
        "{argmax_differ_clear} clear); over all: RMS share {all_share:.4g}, "
        "argmax differs at {all_differ}".format(
            name=cfg.name, p=s + gen, cf=model.cfg.capacity_factor,
            n=flips.numel(), tie=ROUTE_TIE, lim=MIXER_RMS_SHARE,
            all_share=whole["rms_share"], all_differ=whole["argmax_differ"],
            **out))
    if (not held["rms_share"] <= MIXER_RMS_SHARE
            or held["argmax_differ_clear"] or not whole["finite"]
            or not gap <= ROUTE_TIE):
        raise AssertionError(f"{cfg.name}: decode against the full pass: "
                             f"{out} (limits: RMS share {MIXER_RMS_SHARE} "
                             f"where routed alike, no clear argmax change, "
                             f"reroutes only within {ROUTE_TIE} of a tie)")
    return out


def mixer_gradients() -> dict:
    """Phase 14: the reduced mixtral-8x7b, jamba-v0.1-52b and xlstm-125m
    (fp32, ``layer_scale_``d weights from a CPU generator, one
    ``TokenPipeline`` batch of 2 x 32) once on the card and once on the
    CPU port: the card's loss and metrics within ``LM_RTOL`` and every
    gradient within ``LM_GRAD_RTOL`` of the CPU's (an sLSTM's input-gate
    bias, on which the loss does not depend, against its gate's weight
    gradient, as ``tests/_torch_lm.py::grads_close``). Returns the largest
    shares of the limits."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MIXER_ATTENTION
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.registry import make_lm_model
    from repro_torch.tree import tree_leaves, tree_map

    def value_and_grad(model, params, data):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(live, data)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return ({k: v.detach() for k, v in metrics.items()},
                [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)])

    def paths(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from paths(v, prefix + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from paths(v, prefix + (i,))
        else:
            yield prefix

    def reading(got, want, rtol, scale=None):
        """The largest share of the limit rtol·(scale + |want|), scale
        max|want| by default; 0 where both are exactly 0."""
        want = want.double()
        scale = float(want.abs().max()) if scale is None else scale
        err = (got.double().cpu() - want).abs()
        limit = rtol * (scale + want.abs())
        return float(torch.where(err == 0, torch.zeros_like(err),
                                 err / limit).max())

    out = {}
    for arch in ("mixtral-8x7b", "jamba-v0.1-52b", "xlstm-125m"):
        cfg = get_arch(arch).reduced()
        cpu, card = make_lm_model(cfg, "cpu"), make_lm_model(cfg)
        params = layer_scale_(cpu, cpu.init(
            torch.Generator().manual_seed(0)))
        data = {k: torch.from_numpy(v) for k, v in TokenPipeline(
            cfg.vocab_size, 32, 2, seed=0).batch(0).items()}
        want_m, want_g = value_and_grad(cpu, params, data)
        ops.reset_kernel_stats()
        got_m, got_g = value_and_grad(
            card, tree_map(lambda p: p.cuda(), params),
            {k: v.cuda() for k, v in data.items()})
        stats = ops.kernel_stats().get("flash_attention")
        attn = any(cfg.mixer_for_layer(i) == MIXER_ATTENTION
                   for i in range(cfg.num_layers))
        if (set(stats or ()) != {"cuda"}) if attn else stats is not None:
            raise AssertionError(f"{arch} reduced: attention {stats}, "
                                 "expected the kernel only")
        worst = {key: reading(got_m[key], want_m[key], LM_RTOL)
                 for key in ("loss", "nll", "aux", "accuracy")}
        grads = {p: (g, w) for p, g, w in zip(paths(params), got_g, want_g)}
        shares = []
        for path, (g, w) in grads.items():
            scale = None
            if path[-1] == "b_i" and path[:-1] + ("r_i",) in grads:
                scale = float(grads[path[:-1] + ("w_i",)][1].abs().max())
            shares.append(reading(g, w, LM_GRAD_RTOL, scale))
        worst["grads"] = max(shares)
        out[arch] = worst
        if not all(v <= 1.0 for v in worst.values()):
            raise AssertionError(f"{arch} reduced: the card's loss and "
                                 f"gradients against the CPU port's, shares "
                                 f"of the limits: {worst}")
        log("mixers", f"{arch} reduced, fp32 on the card against the CPU "
            f"port: loss {float(got_m['loss']):.6f} / "
            f"{float(want_m['loss']):.6f}, aux {float(got_m['aux']):.6g}; "
            f"largest shares of the limits (RTOL {LM_RTOL}, gradients "
            f"{LM_GRAD_RTOL} over {len(shares)} leaves): {worst}; attention "
            f"{stats}")
    return out


def mixer_examples() -> dict:
    """Phase 14: ``examples/train_lm_torch.py`` at xlstm-125m's full width
    for 3 steps (fp32 AdamW, the train driver's batch 16 x 256: finite
    losses, each step's wall, peak memory) and
    ``examples/serve_lm_torch.py`` at its defaults (reduced mixtral-8x7b:
    prefill ms, decode tok/s, peak memory, attention launches)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops

    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import serve_lm_torch
    import train_lm_torch

    out = {}
    ckpt = tempfile.mkdtemp(prefix="lm_ckpt_")
    try:
        res = train_lm_torch.run(["--steps", "3", "--log-every", "1",
                                  "--checkpoint-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if len(res["loss"]) != 3 or not all(math.isfinite(x)
                                        for x in res["loss"]):
        raise AssertionError(f"train_lm_torch.py: losses {res['loss']}")
    out["train_example"] = {k: res[k] for k in ("loss", "step_s",
                                                 "tok_per_s", "peak_bytes")}
    log("mixers", f"examples/train_lm_torch.py (xlstm-125m, fp32 AdamW, "
        f"batch 16 x seq 256, 3 steps): losses "
        f"{[round(x, 4) for x in res['loss']]}, step walls "
        f"{[round(x, 3) for x in res['step_s']]} s, "
        f"{res['tok_per_s']:,.0f} tok/s, peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    res = serve_lm_torch.run([])
    launches = mxq.launch_counts()["flash_attention"]
    if (ops.kernel_stats().get("flash_attention") != {"cuda": launches}
            or launches != 2 * 16 or res["tokens"].shape != (4, 16)):
        raise AssertionError(f"serve_lm_torch.py: {launches} attention "
                             f"launches, {ops.kernel_stats()}, tokens "
                             f"{res['tokens'].shape}; expected 32 cuda")
    out["serve_example"] = {k: res[k] for k in (
        "prefill_s", "decode_s", "decode_tok_per_s", "peak_bytes")}
    out["serve_example"]["launches"] = launches
    log("mixers", f"examples/serve_lm_torch.py (reduced mixtral-8x7b, fp32, "
        f"4 x 32 prompt, 16 tokens): prefill {res['prefill_s'] * 1e3:.1f} "
        f"ms, decode {res['decode_tok_per_s']:.1f} tok/s, peak "
        f"{res['peak_bytes'] / 2**30:.3f} GiB, {launches} attention launches"
        ", all cuda")
    return out


def mixer_phase() -> dict:
    """Phase 14: the MoE, Mamba and xLSTM layers on the card
    (``mixer_serving`` for each of ``MIXER_MODELS``, ``mixer_gradients``,
    ``mixer_examples``). Returns the readings."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    out = {}
    for arch, layers, batch, prompt in MIXER_MODELS:
        full = get_arch(arch)
        out[arch] = mixer_serving(dataclasses.replace(full, num_layers=layers),
                                  full.num_layers, batch, prompt)
        torch.cuda.empty_cache()
    out["gradients"] = mixer_gradients()
    out.update(mixer_examples())
    return out


# Phase 15's per-shard runs: R shards of gemma2-2b's attention at full
# width in bf16; decode positions (the last fills every shard; the first
# leaves the last two of four shards with no valid slot).
SHARDS = 4
SHARD_DECODE_T = (8223, 3000)
SHARD_SEQ = 8192


def same_runs(tag: str, first: dict, second: dict, keys) -> None:
    """Raise unless ``second``'s ``keys`` equal ``first``'s bit for bit
    (tensors, lists of tensors, numpy arrays or floats)."""
    import numpy as np

    for key in keys:
        a, b = first[key], second[key]
        if isinstance(a, list) and a and hasattr(a[0], "dtype"):
            same = len(a) == len(b) and all(
                same_bits(x, y) for x, y in zip(a, b))
        elif hasattr(a, "dtype") and not isinstance(a, np.ndarray):
            same = same_bits(a, b)
        else:
            same = np.array_equal(np.asarray(a), np.asarray(b))
        if not same:
            raise AssertionError(f"sharding: the {tag} driver on the host "
                                 f"mesh differs from phase 13's in {key}")


def sharded_drivers(runs: dict) -> dict:
    """Phase 15 (i): the serve and train drivers on
    ``make_host_mesh(1)`` — a one-rank NCCL group, the rules of their
    shapes, the prefill / decode / train bundles — at phase 13's setups,
    against phase 13's runs of the same drivers with no mesh: tokens,
    decode logits, losses and final parameters bit for bit, every
    attention launch "cuda" and as many as phase 13's."""
    import shutil
    import tempfile

    import torch

    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.tree import tree_leaves

    out = {}
    for tag in ("serve", "train"):
        mxq.reset_launch_counts()
        ops.reset_kernel_stats()
        t0 = time.perf_counter()
        if tag == "serve":
            res = serve_lib.serve(SERVE_DRIVER)
            got = {"tokens": res["tokens"], "logits": res["logits"].cpu()}
            keys = ("tokens", "logits")
        else:
            ckpt = tempfile.mkdtemp(prefix="lm_ckpt_")
            try:
                res = train_lib.train(TRAIN_DRIVER + ["--checkpoint-dir",
                                                      ckpt])
            finally:
                shutil.rmtree(ckpt, ignore_errors=True)
            got = {"loss": res["loss"],
                   "params": [p.cpu() for p in tree_leaves(res["params"])]}
            keys = ("loss", "params")
        wall = time.perf_counter() - t0
        del res
        torch.cuda.empty_cache()
        launches = mxq.launch_counts()["flash_attention"]
        if (launches != runs[tag]["launches"] or ops.kernel_stats().get(
                "flash_attention") != {"cuda": launches}):
            raise AssertionError(f"sharding: {tag} driver on the mesh: "
                                 f"{launches} attention launches, "
                                 f"{ops.kernel_stats()}; expected "
                                 f"{runs[tag]['launches']}, all cuda")
        same_runs(tag, runs[tag], got, keys)
        out[tag] = {"launches": launches, "wall_s": wall}
        log("sharding", f"{tag} driver on make_host_mesh(1) (one-rank NCCL "
            f"group, bundles of launch/steps.py): {', '.join(keys)} equal "
            f"phase 13's run with no mesh bit for bit; {launches} attention "
            f"launches, all cuda; {wall:.2f} s")
    return out


def shard_decode(gen, dev) -> dict:
    """Phase 15 (ii): gemma2-2b's decode against its 8224-slot global ring
    in bf16 (batch 4, 8 heads over 4 kv heads, D 256, softcap 50), the
    slots cut into SHARDS ranges: each through ``decode_shard`` (the
    kernel with lse; none for a shard with no valid slot), merged by
    ``merge_decode_shards`` over the stacked results, held to the
    unsharded kernel decode (``flash_decode``) within phase 7's bf16
    limits, at each of SHARD_DECODE_T."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.models import attention as attn

    cfg = get_arch(LM_ARCH)
    ring = LM_PROMPT + LM_GEN
    b, h, kvh, d = LM_BATCH, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    opts = dict(logit_softcap=cfg.attn_softcap, scale=attn._qscale(cfg))
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, kvh, ring, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    per = ring // SHARDS
    rows = []
    for t in SHARD_DECODE_T:
        n_all = min(t + 1, ring)
        counts = [max(0, min(n_all - r * per, per)) for r in range(SHARDS)]

        def shards():
            return [attn.decode_shard(q, k[:, :, r * per:(r + 1) * per],
                                      v[:, :, r * per:(r + 1) * per], n,
                                      **opts)
                    for r, n in enumerate(counts)]

        before = mxq.launch_counts()["flash_attention"]
        parts = shards()
        launches = mxq.launch_counts()["flash_attention"] - before
        merged = attn.merge_decode_shards(
            torch.stack([o for o, _ in parts]),
            torch.stack([lse for _, lse in parts]),
            lambda x: x.amax(0), lambda x: x.sum(0))
        whole = attn.flash_decode(q, k, v, t, **opts)
        torch.cuda.synchronize()
        err, reading, share = attention_within(
            f"sharded decode t={t}", merged, whole, "bfloat16",
            f"the unsharded decode ({SHARDS} shards)")
        if launches != sum(1 for n in counts if n):
            raise AssertionError(f"sharding: decode t={t}: {launches} "
                                 f"launches for valid slots {counts}")
        row = {"t": t, "valid_slots": counts, "launches": launches,
               "max_abs_err": err, "tol_reading": reading,
               "rms_share": share,
               "shard_ms": [time_ms(lambda: attn.decode_shard(
                   q, k[:, :, r * per:(r + 1) * per],
                   v[:, :, r * per:(r + 1) * per], n, **opts))
                   for r, n in enumerate(counts)],
               "shard_bound_ms": [attention_bound_ms(
                   (b, 1, n, h, kvh, d), 2, n)[0] if n else 0.0
                   for n in counts],
               "unsharded_ms": time_ms(lambda: attn.flash_decode(
                   q, k, v, t, **opts))}
        rows.append(row)
        log("sharding", "decode t={t} over {n} shards, valid slots "
            "{valid_slots}: {launches} kernel launches (with lse), merged "
            "vs unsharded max err {max_abs_err:.3g} ({tol_reading:.3g} of "
            "the limit), RMS share {rms_share:.3g}; per-shard kernel ms "
            "{shard_ms} (bounds {shard_bound_ms}) against {unsharded_ms:.4f}"
            " ms unsharded".format(n=SHARDS, **row))
    return {"shape_b_h_kv_ring_d": [b, h, kvh, ring, d], "cases": rows}


def shard_seq(gen, dev) -> dict:
    """Phase 15 (iii): gemma2-2b's global layer and a local layer (window
    4096) at 1 x SHARD_SEQ in bf16, the queries cut into SHARDS slices,
    each through ``seq_shard`` (the kernel with its ``q_offset`` against
    the whole K/V), concatenated and held to the unsharded kernel call
    within phase 7's bf16 limits."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn

    cfg = get_arch(LM_ARCH)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.randn((1, SHARD_SEQ, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((1, SHARD_SEQ, kvh, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    per = SHARD_SEQ // SHARDS
    rows = []
    for label, window in (("global layer", None),
                          ("local layer", cfg.local_window)):
        opts = dict(window=window, logit_softcap=cfg.attn_softcap,
                    scale=attn._qscale(cfg))

        def shard(r):
            return attn.seq_shard(q[:, r * per:(r + 1) * per], k, v,
                                  r * per, **opts)

        before = mxq.launch_counts()["flash_attention"]
        merged = torch.cat([shard(r) for r in range(SHARDS)], 1)
        launches = mxq.launch_counts()["flash_attention"] - before
        whole = ops.flash_attention(q, k, v, causal=True, window=window,
                                    softcap=cfg.attn_softcap,
                                    scale=attn._qscale(cfg))
        torch.cuda.synchronize()
        err, reading, share = attention_within(
            f"sequence-parallel {label}", merged, whole, "bfloat16",
            f"the unsharded call ({SHARDS} query slices)")
        row = {"layer": label, "window": window, "launches": launches,
               "max_abs_err": err, "tol_reading": reading,
               "rms_share": share,
               "shard_ms": [time_ms(lambda: shard(r))
                            for r in range(SHARDS)],
               "shard_bound_ms": [attention_bound_ms(
                   (1, per, SHARD_SEQ, h, kvh, d), 2, attention_pairs(
                       per, SHARD_SEQ, True, window, r * per))[0]
                   for r in range(SHARDS)],
               "unsharded_ms": time_ms(lambda: ops.flash_attention(
                   q, k, v, causal=True, window=window,
                   softcap=cfg.attn_softcap, scale=attn._qscale(cfg)))}
        rows.append(row)
        log("sharding", "sequence-parallel {layer} (window {window}) 1 x "
            "{s} over {n} query slices: {launches} kernel launches, "
            "concatenated vs unsharded max err {max_abs_err:.3g} "
            "({tol_reading:.3g} of the limit), RMS share {rms_share:.3g}; "
            "per-shard kernel ms {shard_ms} (bounds {shard_bound_ms}) "
            "against {unsharded_ms:.4f} ms unsharded".format(
                s=SHARD_SEQ, n=SHARDS, **row))
    return {"shape_b_s_h_kv_d": [1, SHARD_SEQ, h, kvh, d], "cases": rows}


def sharding_phase(runs: dict) -> dict:
    """Phase 15: the mesh half on one card — the drivers on the host mesh
    against phase 13's (``sharded_drivers``), then the per-shard decode
    (``shard_decode``) and sequence-parallel attention (``shard_seq``) at
    full width. It runs last: the drivers start and end a one-rank
    process group. Returns the readings and the attention launches."""
    import torch

    out = {"drivers": sharded_drivers(runs)}
    gen = torch.Generator(device="cuda").manual_seed(15)
    out["decode"] = shard_decode(gen, "cuda")
    torch.cuda.empty_cache()
    out["seq_parallel"] = shard_seq(gen, "cuda")
    out["launches"] = {
        "serve_driver": out["drivers"]["serve"]["launches"],
        "train_driver": out["drivers"]["train"]["launches"],
        "decode_shards": [row["launches"] for row in out["decode"]["cases"]],
        "seq_shards": [row["launches"]
                       for row in out["seq_parallel"]["cases"]]}
    return out


# Phase 16: the MoE, Mamba and xLSTM layers' per-rank bodies, R virtual
# model ranks run one after another on the one card and their terms
# summed as the all-reduce would (``distributed.run_serial``), held to the
# unsharded layer: (arch, layer, ranks R, batch, tokens) at published
# widths in bf16. R = 16 on mixtral's 8 experts is the production mesh's
# expert fission (r = 2: 16 virtual experts of d_ff 7168).
RANK_CASES = (("mixtral-8x7b", "moe", (2, 4, 16), 1, 4096),
              ("jamba-v0.1-52b", "moe", (4,), 1, 4096),
              ("jamba-v0.1-52b", "mamba", (2, 4), 1, 4096),
              ("xlstm-125m", "mlstm", (2,), 4, 1024),
              ("xlstm-125m", "slstm", (2,), 4, 1024))
RANK_DECODE = 32  # decode steps against the rank-split caches
RANK_INIT = 16  # the CUDA generator's seed for phase 16's weights
# The merged ranks against the unsharded layer, both in bf16: RMS(merged -
# whole) <= RANK_RMS_SHARE x RMS(whole), phase 15's limit for its merged
# decode. The ranks sum their terms of each contraction over d_inner (or
# over the experts) in another order and round each term to bf16 before
# the sum, ~1 rounding (2^-9) of the output's scale; the recurrences carry
# it through 32 decode steps.
RANK_RMS_SHARE = 2.0 ** -6
# The serve drivers' runs of the three archs on make_host_mesh(1) and with
# no mesh: examples/serve_lm_torch.py's setup (phase 14), reduced, fp32.
RANK_DRIVER = ["--reduced", "--batch", "4", "--prompt-len", "32", "--gen",
               "16"]


def rank_share(merged, whole) -> dict:
    """{max_abs_err, rms_share}: ``merged`` against ``whole``."""
    err = (merged.float() - whole.float())
    return {"max_abs_err": float(err.abs().max()),
            "rms_share": float(err.square().mean().sqrt()
                               / whole.float().square().mean().sqrt()
                               .clamp_min(1e-30))}


def rank_within(label: str, merged, whole) -> dict:
    """Raise unless ``merged`` has ``whole``'s shape and dtype and lies
    within RANK_RMS_SHARE of it; returns ``rank_share``."""
    got = rank_share(merged, whole)
    if (merged.shape != whole.shape or merged.dtype != whole.dtype
            or not got["rms_share"] <= RANK_RMS_SHARE):
        raise AssertionError(
            f"mixer ranks: {label}: merged ranks vs the unsharded layer: "
            f"{tuple(merged.shape)} {merged.dtype} against "
            f"{tuple(whole.shape)} {whole.dtype}, RMS share "
            f"{got['rms_share']:.3g} (limit {RANK_RMS_SHARE:.3g}), max abs "
            f"err {got['max_abs_err']:.3g}")
    return got


def rank_part(tree: dict, defs: dict, ranks: int, rank: int) -> dict:
    """Rank ``rank``'s part of a layer's ``tree`` (params or a cache) laid
    out by ``defs``: the first dim that ``distributed.MODEL_SPLIT`` names
    cut into ``ranks`` pieces as DTensor cuts it (a view, so a cache
    written by the rank fills the whole), every other leaf a copy of its
    own (a replicated cache is each rank's own)."""
    from repro_torch.distributed import MODEL_SPLIT, chunk_range

    out = {}
    for key, leaf in tree.items():
        dims = [d for d, n in enumerate(defs[key].logical)
                if n in MODEL_SPLIT]
        out[key] = (leaf.narrow(dims[0], *chunk_range(
            leaf.shape[dims[0]], ranks, rank)) if dims else leaf.clone())
    return out


def moe_ranks(arch: str, ranks_list, batch: int, tokens: int,
              dev="cuda") -> list:
    """Phase 16, one MoE FFN at full width in bf16: ``moe_rank`` on R
    virtual model ranks, each running its virtual experts (R above the
    expert count splits them: ``convert.experts_to_virtual``), their
    terms of y summed in fp32 and rounded once, and their router
    statistics summed into ``aux``; held to ``moe_forward`` within
    RANK_RMS_SHARE, every rank's routing (expert indices and keep mask)
    equal to the unsharded layer's. Times the unsharded layer and the R
    bodies' serial run."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.convert import experts_to_virtual
    from repro_torch.distributed import init_params, run_serial
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_arch(arch), dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(RANK_INIT)
    params = init_params(moe.moe_defs(cfg), gen)
    x = torch.randn((batch, tokens, cfg.d_model), generator=gen,
                    device=dev).bfloat16()
    rows = []
    with torch.no_grad():
        want_routes = []
        with route_record(want_routes):
            y0, aux0 = moe.moe_forward(params, x, cfg)
        whole_ms = time_ms(lambda: moe.moe_forward(params, x, cfg), iters=3)
        for ranks in ranks_list:
            r = max(1, ranks // cfg.num_experts)
            virtual = experts_to_virtual(params, r)
            per = cfg.num_experts * r // ranks

            def bodies():
                return [moe.moe_rank(
                    x, virtual["router"],
                    *(virtual[k][m * per:(m + 1) * per]
                      for k in ("w_gate", "w_up", "w_down")), cfg,
                    first=m * per, lead=m == 0) for m in range(ranks)]

            routes = []
            with route_record(routes):
                outs = run_serial(bodies())
            y = torch.stack([o[0] for o in outs]).sum(0).to(x.dtype)
            aux = moe.balance_loss(sum(o[2] for o in outs), cfg)
            torch.cuda.synchronize()
            for m, got in enumerate(routes):
                for i, what in ((0, "expert indices"), (2, "keep mask")):
                    if not torch.equal(got[i], want_routes[0][i]):
                        raise AssertionError(
                            f"mixer ranks: {arch} MoE, rank {m} of {ranks}:"
                            f" its {what} differ from the unsharded "
                            "layer's")
            row = {"arch": arch, "layer": "moe", "ranks": ranks,
                   "virtual_per_expert": r, "experts_per_rank": per,
                   "d_ff_per_expert": cfg.d_ff // r,
                   **rank_within(f"{arch} MoE over {ranks} ranks", y, y0),
                   "aux_err": abs(float(aux) - float(aux0)),
                   "routes_equal": len(routes),
                   "whole_ms": whole_ms,
                   "ranks_ms": time_ms(lambda: run_serial(bodies()),
                                       iters=3)}
            if not row["aux_err"] <= 1e-5 * abs(float(aux0)) + 1e-7:
                raise AssertionError(f"mixer ranks: {arch} MoE over {ranks} "
                                     f"ranks: aux {float(aux)} against "
                                     f"{float(aux0)}")
            rows.append(row)
            log("ranks", "{arch} MoE FFN {b} x {t} bf16 over {ranks} ranks "
                "({experts_per_rank} of {ev} virtual experts a rank, r = "
                "{virtual_per_expert}, d_ff {d_ff_per_expert}): merged vs "
                "unsharded RMS share {rms_share:.3g} (limit {lim:.3g}), max "
                "abs err {max_abs_err:.3g}; routing of all {routes_equal} "
                "rank calls equal to the unsharded layer's; aux err "
                "{aux_err:.3g}; {ranks} bodies in turn {ranks_ms:.3f} ms "
                "against {whole_ms:.3f} ms unsharded".format(
                    b=batch, t=tokens, lim=RANK_RMS_SHARE,
                    ev=cfg.num_experts * r, **row))
    return rows


def mixer_ranks(arch: str, layer: str, ranks_list, batch: int,
                tokens: int, dev="cuda") -> list:
    """Phase 16, one Mamba / mLSTM / sLSTM layer at full width in bf16: a
    prefill of ``tokens`` into a zero cache and RANK_DECODE decode steps,
    unsharded (``*_forward``) and as R virtual ranks' bodies
    (``*_rank``) run in turn (``run_serial``), each rank on its share of
    the channels and of the cache (``rank_part``: views, so the ranks fill
    one cache; a replicated leaf is each rank's own copy, equal across the
    ranks bit for bit); every output and the final cache held within
    RANK_RMS_SHARE of the unsharded layer's."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import (chunk_range, init_params,
                                         is_param_def, run_serial)
    from repro_torch.models import ssm, xlstm
    from repro_torch.tree import tree_map

    defs, fwd, body, cdefs, width = {
        "mamba": (ssm.mamba_defs, ssm.mamba_forward, ssm.mamba_rank,
                  ssm.mamba_cache_defs, None),
        "mlstm": (xlstm.mlstm_defs, xlstm.mlstm_forward, xlstm.mlstm_rank,
                  xlstm.mlstm_cache_defs, "mlstm"),
        "slstm": (xlstm.slstm_defs, xlstm.slstm_forward, xlstm.slstm_rank,
                  xlstm.slstm_cache_defs, "slstm")}[layer]
    cfg = dataclasses.replace(get_arch(arch), dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(RANK_INIT)
    ldefs = defs(cfg)
    params = init_params(ldefs, gen)
    x = torch.randn((batch, tokens + RANK_DECODE, cfg.d_model),
                    generator=gen, device=dev).bfloat16()
    cache_defs = cdefs(cfg, batch)

    def zero_cache():
        return tree_map(lambda d: d.initialize(None, dev), cache_defs,
                        is_leaf=is_param_def)

    def run(step):
        outs = [step(x[:, :tokens], "prefill")]
        for t in range(tokens, tokens + RANK_DECODE):
            outs.append(step(x[:, t:t + 1], "decode"))
        return outs

    rows = []
    with torch.no_grad():
        cache0 = zero_cache()
        t0 = time.perf_counter()
        want = run(lambda xx, mode: fwd(params, xx, cfg, mode=mode,
                                        cache=cache0)[0])
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        for ranks in ranks_list:
            cache = zero_cache()
            caches = [rank_part(cache, cache_defs, ranks, m)
                      for m in range(ranks)]
            parts = [rank_part(params, ldefs, ranks, m)
                     for m in range(ranks)]
            kw = [{} for _ in range(ranks)]
            if width:  # the channel offset of each rank's share
                n = (int(cfg.mlstm_proj_factor * cfg.d_model)
                     if width == "mlstm" else cfg.d_model)
                kw = [{"lo": chunk_range(n, ranks, m)[0]}
                      for m in range(ranks)]

            def step(xx, mode):
                outs = run_serial([body(parts[m], xx, cfg, mode=mode,
                                        cache=caches[m], **kw[m])
                                   for m in range(ranks)])
                return torch.stack([o[0] for o in outs]).sum(0).to(x.dtype)

            t0 = time.perf_counter()
            got = run(step)
            torch.cuda.synchronize()
            ranks_s = time.perf_counter() - t0
            pre = rank_within(f"{arch} {layer} prefill over {ranks} ranks",
                              got[0], want[0])
            dec = rank_within(f"{arch} {layer} {RANK_DECODE} decode steps "
                              f"over {ranks} ranks", torch.cat(got[1:], 1),
                              torch.cat(want[1:], 1))
            state = {}
            for key, leaf in cache.items():
                if key in caches[0] and caches[0][key].shape == leaf.shape:
                    # replicated: each rank's own copy, all equal
                    for m in range(1, ranks):
                        if not same_bits(caches[m][key], caches[0][key]):
                            raise AssertionError(
                                f"mixer ranks: {arch} {layer}: rank {m}'s "
                                f"replicated {key} differs from rank 0's")
                    leaf = caches[0][key]
                state[key] = rank_within(
                    f"{arch} {layer} cache {key} over {ranks} ranks", leaf,
                    cache0[key])["rms_share"]
            row = {"arch": arch, "layer": layer, "ranks": ranks,
                   "prefill": pre, "decode": dec, "cache_rms_share": state,
                   "whole_s": whole_s, "ranks_s": ranks_s}
            rows.append(row)
            log("ranks", f"{arch} {layer} {batch} x {tokens} bf16 over "
                f"{ranks} ranks: prefill RMS share {pre['rms_share']:.3g} "
                f"(max abs err {pre['max_abs_err']:.3g}), {RANK_DECODE} "
                f"decode steps against the rank-split cache "
                f"{dec['rms_share']:.3g} ({dec['max_abs_err']:.3g}), final "
                f"cache {', '.join(f'{k} {v:.3g}' for k, v in state.items())}"
                f" (limit {RANK_RMS_SHARE:.3g}); prefill and decode "
                f"{ranks_s:.2f} s in turn against {whole_s:.2f} s unsharded")
    return rows


def mixer_drivers_on_mesh() -> dict:
    """Phase 16: the serve driver of each MoE / Mamba / xLSTM arch
    (RANK_DRIVER's setup) on ``make_host_mesh(1)`` and with no mesh:
    tokens and decode logits bit for bit, every attention launch "cuda"
    and as many on the mesh as off it."""
    import torch

    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib

    out = {}
    for arch in ("mixtral-8x7b", "jamba-v0.1-52b", "xlstm-125m"):
        runs = {}
        for on_mesh in (False, True):
            mxq.reset_launch_counts()
            ops.reset_kernel_stats()
            t0 = time.perf_counter()
            res = serve_lib.serve(["--arch", arch] + RANK_DRIVER,
                                  on_mesh=on_mesh)
            wall = time.perf_counter() - t0
            launches = mxq.launch_counts()["flash_attention"]
            stats = ops.kernel_stats().get("flash_attention")
            if launches and stats != {"cuda": launches}:
                raise AssertionError(f"mixer ranks: {arch} serve driver: "
                                     f"{launches} attention launches, "
                                     f"kernel_stats {stats}")
            runs[on_mesh] = {"tokens": res["tokens"],
                             "logits": res["logits"].cpu(),
                             "launches": launches, "wall_s": wall}
        same_runs(f"{arch} serve", runs[False], runs[True],
                  ("tokens", "logits"))
        if runs[True]["launches"] != runs[False]["launches"]:
            raise AssertionError(f"mixer ranks: {arch} serve driver: "
                                 f"{runs[True]['launches']} attention "
                                 "launches on the mesh, "
                                 f"{runs[False]['launches']} off it")
        out[arch] = {"launches": runs[True]["launches"],
                     "wall_s": [runs[False]["wall_s"], runs[True]["wall_s"]]}
        log("ranks", f"{arch} serve driver ({' '.join(RANK_DRIVER)}) on "
            f"make_host_mesh(1): tokens and decode logits equal the run "
            f"with no mesh bit for bit; {runs[True]['launches']} attention "
            f"launches each, all cuda; {runs[False]['wall_s']:.2f} s off / "
            f"{runs[True]['wall_s']:.2f} s on the mesh")
        torch.cuda.empty_cache()
    return out


def rank_phase(dev="cuda") -> dict:
    """Phase 16: the MoE, Mamba and xLSTM layers across ranks on one card
    (module docstring): ``mixer_drivers_on_mesh``, then ``moe_ranks`` and
    ``mixer_ranks`` over RANK_CASES. Returns the readings and the
    attention launches."""
    import torch

    out = {"drivers": mixer_drivers_on_mesh(), "layers": []}
    for arch, layer, ranks, batch, tokens in RANK_CASES:
        t0 = time.perf_counter()
        if layer == "moe":
            rows = moe_ranks(arch, ranks, batch, tokens, dev)
        else:
            rows = mixer_ranks(arch, layer, ranks, batch, tokens, dev)
        out["layers"] += rows
        log("ranks", f"{arch} {layer}: {time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()
    out["launches"] = {arch: row["launches"]
                       for arch, row in out["drivers"].items()}
    return out


# Phase 17: the dry run (``launch/dryrun.py``) held against the card. Two
# one-card cells, each traced on a one-rank mesh and then run for real:
# gemma2-2b's bf16 prefill at phase 13's 4 x 8192, and the train driver's
# fp32 step at 1 x 1024 (phases 13 and 15). Then one production cell per
# mixer family on the (16, 16) fake mesh, as report rows.
DRY_CELLS = (("prefill", "bfloat16", 4, LM_PROMPT),
             ("train", "float32", 1, 1024))
DRY_RUNS = 5  # timed real steps; the share is over their median
DRY_PEAK = (0.8, 1.25)  # measured peak / predicted peak must lie within
DRY_PRODUCTION = (("yi-6b", "train_4k"), ("mixtral-8x7b", "prefill_32k"),
                  ("jamba-v0.1-52b", "prefill_32k"),
                  ("xlstm-125m", "prefill_32k"))


def dry_bundle(kind: str, dtype: str, batch: int, seq: int, mesh, dev):
    """The bundle of one one-card cell (``DRY_CELLS``) on ``mesh``: the
    prefill step, or the train driver's (AdamW at its learning rate, one
    microbatch)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.sharding import make_rules
    from repro_torch.launch.steps import build_bundle
    from repro_torch.training.optimizer import OptimizerConfig

    arch = dataclasses.replace(configs.get_arch(LM_ARCH), dtype=dtype)
    shape = ShapeConfig(f"dry_{kind}", seq, batch, kind)
    rules = make_rules(arch, shape, mesh)
    kw = {}
    if kind == "train":  # launch/train.py's step
        kw = dict(opt_cfg=OptimizerConfig(name="adamw", lr=1e-3,
                                          warmup_steps=20, total_steps=3),
                  num_microbatches=1)
    return build_bundle(arch, shape, mesh, rules, device=dev, **kw), rules


def dry_predict(kind: str, dtype: str, batch: int, seq: int):
    """The dry run's counts and roofline of a one-card cell, traced on a
    one-rank mesh over a fake process group (nothing on the card)."""
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.steps import trace_bundle

    with dryrun.fake_world(1):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        bundle, rules = dry_bundle(kind, dtype, batch, seq, mesh, "cpu")
        counts = trace_bundle(bundle, mesh, rules, t=seq - 1)
    return counts, roofline.analyze(counts, 1)


def dry_measure(kind: str, dtype: str, batch: int, seq: int,
                dev="cuda") -> dict:
    """The same step on the card from ``repro_torch.launch``, on the
    one-rank host mesh, random weights from a seed: its arguments' bytes,
    its FLOPs counted as the dry run counts them (one run, the backward
    on the calling thread), its peak (``max_memory_allocated`` after a
    warm-up and ``reset_peak_memory_stats``) and the median of DRY_RUNS
    timed steps."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.launch.counting import Counter, tensor_bytes
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.steps import arg_leaves, bundle_args

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    vocab = configs.get_arch(LM_ARCH).vocab_size

    def make(meta):
        if meta.dtype.is_floating_point:
            return (0.02 * torch.randn(meta.shape, generator=gen,
                                       device=dev)).to(meta.dtype)
        return torch.randint(0, vocab, meta.shape, generator=gen,
                             device=dev, dtype=meta.dtype)

    torch.cuda.empty_cache()
    with host_mesh(1, dev) as mesh:
        bundle, _ = dry_bundle(kind, dtype, batch, seq, mesh, dev)
        args = bundle_args(bundle, make, seq - 1)
        arg_bytes = sum(tensor_bytes(x) for x in arg_leaves(args))

        def step():
            out = bundle.fn(*args)
            torch.cuda.synchronize()
            return out

        step()  # warm-up: cuBLAS workspaces, the kernels' first call
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step()
        peak = torch.cuda.max_memory_allocated()
        times = []
        mxq.reset_launch_counts()
        for _ in range(DRY_RUNS):
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        launches = mxq.launch_counts().get("flash_attention", 0)
        counter = Counter()
        with torch.autograd.set_multithreading_enabled(False), counter:
            out = bundle.fn(*args)
        del out
        torch.cuda.synchronize()
    del args
    torch.cuda.empty_cache()
    return {"arg_bytes": arg_bytes, "flops": counter.counts.flops,
            "kernel_flops": counter.counts.kernel_flops,
            "peak_bytes": peak, "resident_bytes": base,
            "median_s": sorted(times)[len(times) // 2], "times_s": times,
            "launches": launches}


def dryrun_phase(dev="cuda") -> dict:
    """Phase 17: predicted against measured for DRY_CELLS (FLOPs and
    argument bytes equal, the peak within DRY_PEAK, the step's share of
    its roofline), then DRY_PRODUCTION on the (16, 16) fake mesh as
    ``report.render`` rows. A cell that fails to trace fails the phase."""
    from repro_torch.launch import dryrun, report

    out = {"cells": [], "launches": {}}
    for kind, dtype, batch, seq in DRY_CELLS:
        label = f"{LM_ARCH} {kind} {batch}x{seq} {dtype}"
        t0 = time.perf_counter()
        counts, rf = dry_predict(kind, dtype, batch, seq)
        trace_s = time.perf_counter() - t0
        got = dry_measure(kind, dtype, batch, seq, dev)
        row = {"cell": label, "trace_s": trace_s,
               "predicted": {"flops": counts.flops,
                             "arg_bytes": counts.arg_bytes,
                             "peak_bytes": counts.peak_bytes,
                             "temp_bytes": counts.temp_bytes,
                             "hbm_bytes": counts.hbm_bytes,
                             "hbm_bytes_unfused": counts.hbm_bytes_unfused,
                             "t_total_s": rf.t_total,
                             "bottleneck": rf.bottleneck},
               "measured": got,
               "peak_ratio": got["peak_bytes"] / counts.peak_bytes,
               "roofline_share": rf.t_total / got["median_s"]}
        out["cells"].append(row)
        out["launches"][kind] = got["launches"]
        log("dryrun", f"{label}: FLOPs predicted {counts.flops:.6e} "
            f"measured {got['flops']:.6e}; argument bytes predicted "
            f"{counts.arg_bytes} measured {got['arg_bytes']}; peak bytes "
            f"predicted {counts.peak_bytes} measured {got['peak_bytes']} "
            f"(x{row['peak_ratio']:.4f}); HBM bytes {counts.hbm_bytes:.6e} "
            f"fused ({counts.hbm_bytes_unfused:.6e} unfused); roofline "
            f"t_total {rf.t_total * 1e3:.3f} ms ({rf.bottleneck}; compute "
            f"{rf.t_compute * 1e3:.3f}, memory {rf.t_memory * 1e3:.3f}) "
            f"against a median "
            f"step of {got['median_s'] * 1e3:.3f} ms over {DRY_RUNS}: share "
            f"{row['roofline_share']:.4f}; trace {trace_s:.1f} s; "
            f"{got['launches']} attention launches in the timed steps")
        if got["flops"] != counts.flops:
            raise AssertionError(f"{label}: measured FLOPs {got['flops']} "
                                 f"!= predicted {counts.flops}")
        if got["arg_bytes"] != counts.arg_bytes:
            raise AssertionError(f"{label}: argument bytes {got['arg_bytes']}"
                                 f" != predicted {counts.arg_bytes}")
        lo, hi = DRY_PEAK
        if not lo <= row["peak_ratio"] <= hi:
            raise AssertionError(f"{label}: measured peak {got['peak_bytes']}"
                                 f" outside {DRY_PEAK} x the predicted "
                                 f"{counts.peak_bytes}")
        if got["launches"] < 1:
            raise AssertionError(f"{label}: the real steps launched no "
                                 "attention kernel")
    results = []
    t0 = time.perf_counter()
    with dryrun.fake_world(256):
        for arch, shape in DRY_PRODUCTION:
            row = dryrun.run_cell(arch, shape, False, verbose=False)
            if row["status"] != "ok":
                raise AssertionError(f"dry run {arch} x {shape}: "
                                     f"{row.get('error')}")
            results.append(row)
    out["production_s"] = time.perf_counter() - t0
    out["production"] = results
    for line in report.render(results, "pod").splitlines():
        log("dryrun", line)
    log("dryrun", f"{len(results)} production cells on the (16, 16) fake "
        f"mesh in {out['production_s']:.1f} s")
    return out


# Phase 18: the paper's figure experiments and the quickstart. Table III's
# models that no other phase runs take one MX6 fill and one forward of
# EXP_BATCH frames at their published width.
EXP_BATCH = 8
EXP_FIRST_RUN = ("resnet34", "wideresnet101")
# The first EXP_CPU_FRAMES frames of each first-run forward are held to the
# same forward on the CPU from the same serving tree: both fp32 (TF32 off),
# so they differ only by summation order, RMS(card - cpu) <=
# EXP_FORWARD_RMS_SHARE x RMS(cpu), as for the fp32 attention.
EXP_CPU_FRAMES = 2
EXP_FORWARD_RMS_SHARE = 2.0 ** -12
EXP_KERNELS = ("mx_quantize", "mx_dequantize", "mx_matmul",
               "flash_attention")  # each launched, all "cuda", in phase 18


def exp_counted(part: str, fn, out: dict):
    """Run ``fn`` with the launch counts and kernel_stats set to 0 just
    before it, and keep its launches, kernel_stats and wall in ``out``
    under ``part``; a call on the plain path fails the phase. Returns what
    ``fn`` returns."""
    import torch

    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    mxq.reset_launch_counts()
    ops.reset_kernel_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {op: n for op, n in mxq.launch_counts().items() if n}
    stats = ops.kernel_stats()
    plain = {op: paths for op, paths in stats.items() if paths.get("plain")}
    if plain:
        raise AssertionError(f"experiments {part}: calls on the plain path: "
                             f"{plain}")
    out["launches"][part] = launches
    out["kernel_stats"][part] = stats
    out["wall_s"][part] = wall
    log("experiments", f"{part}: {wall:.2f} s, launches {launches}")
    return res


def exp_rows(rows) -> None:
    for name, us, derived in rows:
        log("experiments", f"{name},{us:.3f},{derived}")


def table3_first_run(built, dev) -> dict:
    """ResNet34 and WideResNet101 (``EXP_FIRST_RUN``), built at published
    width by Table III: one MX6 fill each through its kernel's serving
    cache (one quantize and one dequantize launch, every quantized leaf
    bitwise the plain version's) and one forward of ``EXP_BATCH`` frames
    at 224 px (finite logits of the full class count, the first
    ``EXP_CPU_FRAMES`` within ``EXP_FORWARD_RMS_SHARE`` of the same
    forward on the CPU)."""
    import numpy as np
    import torch

    from repro_torch.core.estimator import DaCapoEstimator
    from repro_torch.core.kernel import InferenceKernel, LabelingKernel
    from repro_torch.core.mx import _quantizable
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.kernels import ops, ref
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_leaves, tree_map

    x = torch.from_numpy(np.random.default_rng(18).normal(
        size=(EXP_BATCH, 224, 224, 3)).astype(np.float32)).to(dev)
    out = {}
    for name, cls in zip(EXP_FIRST_RUN, (InferenceKernel, LabelingKernel)):
        model, params, _ = built[name]
        cfg = model.cfg
        kern = cls(model, cfg, DaCapoEstimator(), apply_mx=True, device=dev)
        before = mxq.launch_counts()
        serving = kern.serving_cache.get(params, "mx6")
        torch.cuda.synchronize()
        after = mxq.launch_counts()
        fill = {op: after[op] - before[op] for op in after
                if after[op] != before[op]}
        if fill != {"mx_quantize": 1, "mx_dequantize": 1}:
            raise AssertionError(f"{name}: an MX6 fill launched {fill}")
        plain = tree_map(
            lambda p: ref.mx_quant_dequant_ref(
                ops._pad_last(p.reshape(-1, p.shape[-1]), 16)[0],
                "mx6")[:, : p.shape[-1]].reshape(p.shape)
            if _quantizable(p, 1024) else p, params)
        for p, s, want in zip(tree_leaves(params), tree_leaves(serving),
                              tree_leaves(plain)):
            if _quantizable(p, 1024) and not bitwise(s, want):
                raise AssertionError(f"{name}: kernel-filled serving leaf "
                                     "!= plain")
        del plain
        with torch.no_grad():
            logits = kern._run_apply(serving, x)
            on_cpu = make_vision_model(cfg, "cpu").apply(
                tree_map(lambda p: p.cpu(), serving),
                x[:EXP_CPU_FRAMES].cpu())
        if logits.shape != (EXP_BATCH, cfg.num_classes) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: bad logits {logits.shape}")
        share = float((logits[:EXP_CPU_FRAMES].cpu() - on_cpu).square()
                      .mean().sqrt() / on_cpu.square().mean().sqrt())
        if not share <= EXP_FORWARD_RMS_SHARE:
            raise AssertionError(
                f"{name}: card forward vs the CPU's: RMS share {share:.3g} "
                f"> {EXP_FORWARD_RMS_SHARE:.3g}")
        n = sum(p.numel() for p in tree_leaves(params))
        out[name] = {"params": n, "fill_launches": fill,
                     "logits_abs_max": float(logits.abs().max()),
                     "cpu_rms_share": share}
        log("experiments", f"{name} ({n / 1e6:.1f} M params, 224 px): one "
            f"MX6 fill {fill}, bitwise the plain version; forward of "
            f"{EXP_BATCH} frames: finite logits, |max| "
            f"{out[name]['logits_abs_max']:.3f}; the first "
            f"{EXP_CPU_FRAMES} vs the CPU's forward: RMS share {share:.3g} "
            f"(limit {EXP_FORWARD_RMS_SHARE:.3g})")
        del serving, kern
    return out


def quickstart_mx_check(mx: dict) -> dict:
    """The quickstart's MX demo (``mx_quantize`` and ``mx_gemm_mx`` at
    x [64, 256] @ w [256, 64]) held, at each precision, to the plain
    ``mx_matmul_ref`` of the same operands quantized by the plain
    quantize, elementwise within phase 6's two limits
    (``ref.gemm_error_limits``). Returns each precision's max |err|."""
    import torch

    from repro_torch.kernels import ref

    x, w = mx["x"], mx["w"].T.contiguous()
    max_err = {}
    for prec, out in mx["out"].items():
        plain = ref.mx_matmul_ref(ref.mx_quantize_ref(x, prec),
                                  ref.mx_quantize_ref(w, prec))
        worst, typical = ref.gemm_error_limits(
            ref.mx_quant_dequant_ref(x, prec),
            ref.mx_quant_dequant_ref(w, prec))
        err = (out - plain).abs()
        tiny = torch.finfo(torch.float32).tiny
        r_worst = float((err / worst.clamp_min(tiny)).max())
        r_typical = float((err / typical.clamp_min(tiny)).max())
        if (out.shape != plain.shape or not bool(torch.isfinite(out).all())
                or not r_worst <= 1 or not r_typical <= 1):
            raise AssertionError(
                f"quickstart mx_matmul {prec}: kernel vs plain outside the "
                f"limits (max err {float(err.max())}, {r_worst:.3g} x the "
                f"worst and {r_typical:.3g} x the typical limit)")
        max_err[prec] = float(err.max())
        log("experiments", f"quickstart mx_matmul {prec} vs plain: max "
            f"|err| {max_err[prec]:.3g}, {r_worst:.3g} x the worst and "
            f"{r_typical:.3g} x the typical limit")
    return max_err


def fig9_differences(first, second) -> list:
    """What differs between two Fig. 9 runs (empty when they agree bit for
    bit): each system's phase log, drift events, accuracy timeline and
    average accuracy."""
    diffs = []
    for key, (a, _) in first.items():
        b = second[key][0]
        for field in ("phase_log", "drift_events", "accuracy_timeline",
                      "avg_accuracy"):
            if getattr(a, field) != getattr(b, field):
                diffs.append(f"{key}: {field} differs")
    return diffs


def experiments_phase(dev="cuda") -> dict:
    """Phase 18: the paper's figure experiments (``repro_torch.experiments``)
    and the quickstart (``examples/quickstart_torch.py``) on the card:
    Table III's six models at published widths (``table3_first_run`` for
    the two no other phase runs), Fig. 3, Fig. 9 on S1 at the fast sizes
    twice (each from a fresh pretraining; the two runs bit for bit), Figs.
    11 and 12 at the fast sizes, and the quickstart's three demos. Each
    part's launches are counted from 0; every kernel call must be on the
    "cuda" path and each of ``EXP_KERNELS`` launched. Returns the
    readings."""
    import math

    import torch

    from repro_torch.experiments import (common, fig3_flops, fig9_accuracy,
                                         fig11_temporal, fig12_extreme,
                                         table3_models)

    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import quickstart_torch

    out = {"launches": {}, "kernel_stats": {}, "wall_s": {}}
    built = exp_counted("table3_build", lambda: table3_models.build(dev),
                        out)
    out["table3"] = table3_models.rows_of(built)
    exp_rows(out["table3"])
    out["first_run"] = exp_counted(
        "table3_first_run", lambda: table3_first_run(built, dev), out)
    del built
    torch.cuda.empty_cache()
    out["fig3"] = fig3_flops.run()
    exp_rows(out["fig3"])

    runs = []
    for i in range(2):
        common.forget_pretrained()
        runs.append(exp_counted(
            f"fig9_run{i + 1}",
            lambda: fig9_accuracy.sessions(True, dev, ("S1",)), out))
    diffs = fig9_differences(*runs)
    if out["launches"]["fig9_run1"] != out["launches"]["fig9_run2"]:
        diffs.append(f"launches {out['launches']['fig9_run1']} != "
                     f"{out['launches']['fig9_run2']}")
    if diffs:
        raise AssertionError(f"Fig. 9 does not repeat: {diffs}")
    out["fig9"] = fig9_accuracy.rows_of(runs[0], ("S1",))
    exp_rows(out["fig9"])
    log("experiments", f"Fig. 9 on S1, two runs from fresh pretraining: "
        f"bit for bit (phase logs, drift events, timelines, accuracies)")
    out["fig11"] = exp_counted(
        "fig11", lambda: fig11_temporal.run(True, dev), out)
    exp_rows(out["fig11"])
    out["fig12"] = exp_counted(
        "fig12", lambda: fig12_extreme.run(True, dev), out)
    exp_rows(out["fig12"])
    for rows in (out["fig9"], out["fig11"], out["fig12"]):
        for name, _, derived in rows:
            if "nan" in derived:
                raise AssertionError(f"{name}: {derived}")

    quick = exp_counted("quickstart", lambda: quickstart_torch.run(dev), out)
    mx_vs_plain = quickstart_mx_check(quick["mx"])
    errors = quick["mx"]["rel_err"]
    if not (all(math.isfinite(e) for e in errors.values())
            and errors["mx4"] > errors["mx6"] > errors["mx9"]):
        raise AssertionError(f"quickstart MX errors {errors}")
    logits = quick["lm"]["logits"]
    if not (math.isfinite(quick["lm"]["loss"])
            and bool(torch.isfinite(logits).all())
            and tuple(logits.shape) == (2, logits.shape[-1])):
        raise AssertionError(f"quickstart LM: loss {quick['lm']['loss']}, "
                             f"logits {tuple(logits.shape)}")
    cl = quick["cl"]
    if not cl.phase_log or not math.isfinite(cl.avg_accuracy):
        raise AssertionError(f"quickstart session: {len(cl.phase_log)} "
                             f"phases, accuracy {cl.avg_accuracy}")
    out["quickstart"] = {"mx_rel_err": errors,
                         "mx_max_abs_err_vs_plain": mx_vs_plain,
                         "lm_loss": quick["lm"]["loss"],
                         "cl_avg_accuracy": cl.avg_accuracy,
                         "cl_drift_events": cl.drift_events,
                         "cl_phases": len(cl.phase_log)}
    total = {}
    for part in out["launches"].values():
        for op, n in part.items():
            total[op] = total.get(op, 0) + n
    missing = [op for op in EXP_KERNELS if not total.get(op)]
    if missing:
        raise AssertionError(f"experiments: {missing} never launched "
                             f"({total})")
    out["launches_total"] = total
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

    # ------------------------------------------------------------ 11 fleet
    t0 = time.perf_counter()
    fleet, fleet_firsts = fleet_phase(est)
    fleet_launches = fleet["launches"]
    log("fleet", f"phase done in {time.perf_counter() - t0:.2f} s")

    # ---------------------------------------------------------- 12 manager
    t0 = time.perf_counter()
    manager_launches = manager_phase(fleet_firsts["sequential"])["launches"]
    del fleet_firsts
    log("manager", f"phase done in {time.perf_counter() - t0:.2f} s")

    # --------------------------------------------------------------- 13 lm
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lm = lm_phase()
    log("lm", f"phase done in {time.perf_counter() - t0:.2f} s")

    # ----------------------------------------------------------- 14 mixers
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mixers = mixer_phase()
    log("mixers", f"phase done in {time.perf_counter() - t0:.2f} s")
    print("[mixers] summary " + json.dumps(mixers, default=float),
          flush=True)

    # --------------------------------------------------------- 15 sharding
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    sharding = sharding_phase(lm.pop("driver_runs"))
    log("sharding", f"phase done in {time.perf_counter() - t0:.2f} s")

    # ------------------------------------------------------- 16 mixer ranks
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ranks = rank_phase()
    log("ranks", f"phase done in {time.perf_counter() - t0:.2f} s")
    print("[ranks] summary " + json.dumps(ranks, default=float), flush=True)

    # ----------------------------------------------------------- 17 dryrun
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    dry = dryrun_phase()
    log("dryrun", f"phase done in {time.perf_counter() - t0:.2f} s")
    print("[dryrun] summary " + json.dumps(
        {"cells": dry["cells"], "launches": dry["launches"]}, default=float),
        flush=True)

    # ------------------------------------------------------ 18 experiments
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    exp = experiments_phase()
    log("experiments", f"phase done in {time.perf_counter() - t0:.2f} s")
    print("[experiments] summary " + json.dumps(
        {key: exp[key] for key in ("launches", "wall_s", "first_run",
                                   "quickstart")}, default=float),
        flush=True)

    def launches_experiments(op: str) -> dict:
        return {part: counts.get(op, 0)
                for part, counts in exp["launches"].items()}

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
            "launches_fleet": {part: counts[name]
                               for part, counts in fleet_launches.items()},
            "launches_manager": {part: counts[name] for part, counts in
                                 manager_launches.items()},
            "launches_experiments": launches_experiments(name),
            "trees": [{key: row[key] for key in (
                "tree", "leaves", "elements", "launches", "bound_ms",
                "q_ms" if name == "mx_quantize" else "dq_ms") if key in row}
                for row in tree_rows]})
    for row in gemm_rows:
        if row["name"] == "mx_matmul":
            row["launches_experiments"] = launches_experiments("mx_matmul")
            row["max_abs_err_quickstart"] = exp["quickstart"][
                "mx_max_abs_err_vs_plain"]
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
        "launches_fleet": {
            "vit_fleet_batched": fleet_launches["vit_fleet_batched"][
                "flash_attention"],
            "vit_vmapped": fleet["vit_vmapped"]["cuda"],
            "full_width": fleet_launches["full_width"]["flash_attention"]},
        "launches_lm": lm["launches_lm"],
        "launches_mixers": {
            **{arch: mixers[arch]["launches"]
               for arch, *_ in MIXER_MODELS},
            "serve_example": mixers["serve_example"]["launches"]},
        "launches_sharding": sharding["launches"],
        "launches_mixer_ranks": ranks["launches"],
        "launches_dryrun": dry["launches"],
        "launches_experiments": launches_experiments("flash_attention"),
        "lse_max_abs_err": max(row["lse_max_abs_err"] for row in
                               attention_rows
                               if row["lse_max_abs_err"] is not None),
        "lse_cases": list(LSE_CASES),
        "sharding": {key: sharding[key] for key in ("decode",
                                                    "seq_parallel")},
        "cases": attention_rows})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
