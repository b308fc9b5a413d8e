#!/usr/bin/env python3
"""Serving-copy fills and the main path's session on one card, measured
through APIs that every tree of the port has had since its MX kernels
landed, so that the same script runs in an unpacked older checkout and in
the current one (run the two in one call, old / new / new / old):

    python3 fill_profile.py [--tag NAME] [--out-dir fill_profile_out]

1. fills — an MX6 ``ServingParamsCache`` fill of full-width ResNet18,
   WideResNet50, ViT-B/32 and ViT-B/16 (random weights from a seed): host
   wall (ending in a synchronize) and its host part (issuing the fill),
   medians of 15 fills, device time (CUDA events behind a spin kernel long
   enough to cover the host part, L2 flushed first; median of 15), the MX
   launches of one fill, and
   the bound: the bytes that quantizing and dequantizing the tree's
   quantized leaves must move (5.125 bytes an element each way, K padded to
   16) over 3.35 TB/s.
2. leaf — ``mx_quantize_cuda`` / ``mx_dequantize_cuda`` alone at
   [9216, 1024] mx6, WideResNet50's largest leaf (median of 15, L2 flushed).
3. profile — the session of ``chip_smoke.py`` phase 4 (ResNet18 /
   WideResNet50, DC-ST, S1, 45 s virtual, MX6 serving) once without and once
   under ``torch.profiler``: session wall, the device's busy time (the union
   of its kernels' and copies' intervals) and its share of the wall, the
   top device kernels, and the share of the wall that fills take, by host
   time (``quantize_tree_mx`` + ``dequantize_tree_mx``) and by the MX
   kernels' device time. The profiler's Chrome trace goes gzipped to
   ``<out-dir>/profile_<tag>.json.gz``.

Prints one line per reading, the card's ``nvidia-smi`` line, and last one
JSON object, also written to ``<out-dir>/fill_profile_<tag>.json``. Needs a
CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import gzip
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
FILL_SPIN = 40_000_000  # cycles, ~20 ms: longer than the host takes a fill


def device_ms(fn, spin: int, iters: int = 15) -> float:
    """Median device time of ``fn``: L2 flushed, a spin kernel of ``spin``
    cycles queued so that the host has issued all of ``fn`` before the
    device reaches it, then ``fn`` between two events."""
    import numpy as np
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def fill_bytes(params) -> int:
    """Bytes one fill must move: each quantized leaf's M·K fp32 values,
    M·Kp mantissas and 2·M·Kp/16 exponent and bits bytes, once each way."""
    from repro_torch.core.mx import _quantizable
    from repro_torch.tree import tree_leaves

    total = 0
    for p in tree_leaves(params):
        if _quantizable(p, 1024):
            m, k = math.prod(p.shape[:-1]), int(p.shape[-1])
            kp = -(-k // 16) * 16
            total += 2 * (4 * m * k + m * kp + 2 * (m * kp // 16))
    return total


def fills() -> list:
    import numpy as np
    import torch

    from repro_torch.configs.dacapo_pairs import (RESNET18, VIT_B16, VIT_B32,
                                                  WIDERESNET50)
    from repro_torch.core.kernel import ServingParamsCache
    from repro_torch.core.mx import _quantizable
    from repro_torch.kernels import mx_quantize as mxq
    from repro_torch.models.registry import make_vision_model
    from repro_torch.tree import tree_leaves

    gen = torch.Generator().manual_seed(0)
    rows = []
    for cfg in (RESNET18, WIDERESNET50, VIT_B32, VIT_B16):
        params = make_vision_model(cfg, "cuda").init(gen)
        cache = ServingParamsCache()
        cache.get(params, "mx6")  # warm the allocator and the library
        walls, hosts = [], []
        for _ in range(15):
            cache.invalidate()
            torch.cuda.synchronize()
            before = mxq.launch_counts()
            t0 = time.perf_counter()
            cache.get(params, "mx6")
            hosts.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            after = mxq.launch_counts()

        def fill():
            cache.invalidate()
            cache.get(params, "mx6")

        row = {"model": cfg.name,
               "quantized_leaves": sum(_quantizable(p, 1024)
                                       for p in tree_leaves(params)),
               "fill_wall_ms": float(np.median(walls)),
               "fill_walls_ms": walls,
               "fill_host_ms": float(np.median(hosts)),
               "fill_device_ms": device_ms(fill, FILL_SPIN),
               "launches_per_fill": {op: after[op] - before[op]
                                     for op in ("mx_quantize",
                                                "mx_dequantize")},
               "bound_ms": fill_bytes(params) / HBM_BYTES_PER_S * 1e3}
        rows.append(row)
        print("[fill] {model}: {quantized_leaves} quantized leaves; wall "
              "{fill_wall_ms:.4f} ms (host part {fill_host_ms:.4f} ms), "
              "device {fill_device_ms:.4f} ms, bound {bound_ms:.4f} ms, "
              "launches per fill {launches_per_fill}; walls "
              "{fill_walls_ms}".format(**row), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    return rows


def leaf() -> dict:
    import torch

    from repro_torch.kernels import mx_quantize as mxq

    x = torch.randn((9216, 1024), generator=torch.Generator().manual_seed(1)
                    ).to("cuda")
    q = mxq.mx_quantize_cuda(x, "mx6")
    n = x.numel()
    row = {"shape": [9216, 1024],
           "q_ms": device_ms(lambda: mxq.mx_quantize_cuda(x, "mx6"),
                             1_000_000),
           "dq_ms": device_ms(lambda: mxq.mx_dequantize_cuda(q), 1_000_000),
           "bound_ms": (4 * n + n + 2 * (n // 16)) / HBM_BYTES_PER_S * 1e3}
    print("[leaf] mx6 {shape}: quantize {q_ms:.4f} ms, dequantize "
          "{dq_ms:.4f} ms, bound {bound_ms:.4f} ms".format(**row),
          flush=True)
    return row


def session_once(profiler=None):
    """One run of phase 4's session; returns (wall s, fill host s, fill
    calls, the run's MX launches)."""
    import numpy as np
    import torch

    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core import mx as mx_lib
    from repro_torch.core.session import CLSystemSpec, pretrain_model
    from repro_torch.data.stream import DriftStream, scenario
    from repro_torch.kernels import mx_quantize as mxq

    stream = DriftStream(scenario("S1", 3), seed=5, img=24)
    session = CLSystemSpec(student=RESNET18, teacher=WIDERESNET50,
                           allocator="dacapo-spatiotemporal", apply_mx=True,
                           device="cuda").build()
    rng = np.random.default_rng(0)
    tp = pretrain_model(session.teacher, stream, 25, 32, rng)
    sp = pretrain_model(session.student, stream, 15, 32, rng,
                        segments=stream.segments[:1], seed=8)
    session.set_pretrained(tp, sp)
    torch.cuda.synchronize()
    spent = {"s": 0.0, "calls": 0}
    originals = {name: getattr(mx_lib, name)
                 for name in ("quantize_tree_mx", "dequantize_tree_mx")}

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent["s"] += time.perf_counter() - t0
                spent["calls"] += 1
        return call

    for name, fn in originals.items():
        setattr(mx_lib, name, timed(fn))
    mxq.reset_launch_counts()
    try:
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        session.run(stream, duration=45.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if profiler is not None:
            profiler.stop()
    finally:
        for name, fn in originals.items():
            setattr(mx_lib, name, fn)
    launches = {op: n for op, n in mxq.launch_counts().items() if n}
    return wall, spent["s"], spent["calls"], launches


def device_events(prof) -> list:
    """(name, start µs, end µs) of every device-side event of a trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def profile(out_dir: Path, tag: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    wall_plain, fill_plain_s, fill_calls, launches = session_once()
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    wall, fill_s, _, _ = session_once(prof)
    events = device_events(prof)
    busy = busy_us([(s, e) for _, s, e in events]) / 1e3
    by_name = {}
    for name, s, e in events:
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + (e - s) / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    mx_ms = sum(ms for name, (ms, _) in by_name.items()
                if "mx_quantize" in name or "mx_dequantize" in name)
    row = {"session_wall_s": wall_plain, "fill_host_s": fill_plain_s,
           "fill_calls": fill_calls, "launches": launches,
           "profiled_wall_s": wall, "profiled_fill_host_s": fill_s,
           "device_events": len(events), "device_busy_ms": busy,
           "device_busy_share": busy / (wall * 1e3),
           "mx_kernels_device_ms": mx_ms,
           "fill_host_share": fill_plain_s / wall_plain,
           "top_kernels": [{"name": name[:120], "ms": ms, "count": n}
                           for name, (ms, n) in top]}
    print("[profile] session wall {session_wall_s:.4f} s unprofiled, "
          "{profiled_wall_s:.4f} s profiled; fills {fill_calls} tree calls "
          "taking {fill_host_s:.4f} s of host time ({fill_host_share:.4f} of "
          "the wall); MX launches {launches}; device busy "
          "{device_busy_ms:.3f} ms over {device_events} device events "
          "({device_busy_share:.4f} of the profiled wall), of which the MX "
          "kernels {mx_kernels_device_ms:.3f} ms".format(**row), flush=True)
    for item in row["top_kernels"]:
        print("[profile]   {ms:9.3f} ms  x{count:<6d} {name}".format(**item),
              flush=True)
    trace = out_dir / f"profile_{tag}.json"
    prof.export_chrome_trace(str(trace))
    with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    trace.unlink()
    return row


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", default="tree")
    parser.add_argument("--out-dir", default="fill_profile_out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fill_profile: needs a CUDA card")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"tag": args.tag, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "fills": fills(), "leaf": leaf(),
              "profile": profile(out_dir, args.tag)}
    (out_dir / f"fill_profile_{args.tag}.json").write_text(
        json.dumps(result, indent=1))
    print(smi, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
