#!/usr/bin/env python3
"""The MX backward pair's device time at each GEMM of ResNet18, on one GPU.

    python3 pair_per_gemm.py

Times ``mx_fused.mx_matmul_bwd_pair_cuda`` (mx9) at full-width ResNet18's
GEMMs at batch 32 (``core.estimator.vision_gemms``, each (M, N, K) once
with its count), on N(0, 1) operands from a fixed seed, with
``chip_smoke.time_ms`` (the median of 15 launches, the L2 flushed before
each). It uses only what every checkout of the port since the pair's
split (its ``chip_smoke.py`` and ``mx_fused`` wrapper) has, so the same
file, copied to an older checkout's root and run there, times that
checkout's pair on the same inputs. Prints the card's ``nvidia-smi``
line, one JSON line per GEMM and one with the sum over the 21 launches,
and exits 0. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import json
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pair_per_gemm: torch.cuda.is_available() is False "
                         "— this measurement needs a CUDA card")
    from chip_smoke import nvidia_smi_line, time_ms
    from repro_torch.configs.dacapo_pairs import RESNET18
    from repro_torch.core.estimator import vision_gemms
    from repro_torch.kernels import mx_fused as mxf

    print(nvidia_smi_line(), flush=True)
    counts = Counter(vision_gemms(RESNET18, batch=32))
    gen = torch.Generator(device="cuda").manual_seed(7)
    total = 0.0
    for (m, n, k), count in sorted(counts.items()):
        g = torch.randn((m, n), generator=gen, device="cuda")
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        ms = time_ms(lambda: mxf.mx_matmul_bwd_pair_cuda(g, x, w, "mx9"))
        total += ms * count
        print(json.dumps({"shape_mnk": [m, n, k], "count": count,
                          "pair_ms": ms}), flush=True)
        del g, x, w
    print(json.dumps({"launches": sum(counts.values()),
                      "sum_pair_ms": total}), flush=True)


if __name__ == "__main__":
    main()
