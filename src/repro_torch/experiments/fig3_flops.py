"""Fig. 3: MAC/FLOP breakdown of the three CL kernels over a 120 s run (the
JAX package's ``benchmarks/bench_fig3_flops.py``).

The paper shows retraining's share rising from 26% to 82% of total FLOPs as
the labeling sampling rate and retraining epochs increase, with inference
falling 57.8% -> 9.1% and labeling 27.1% -> 7.0%. The sweep is analytic,
from the full-width models' FLOP counts; nothing runs on a device.
"""
from __future__ import annotations

import time

from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
from repro_torch.models.registry import make_vision_model

WINDOW_S = 120.0
FPS = 30.0
SWEEP = [(0.5, 1), (1.0, 3), (2.0, 5), (4.0, 10), (6.0, 15)]


def kernel_flops(sample_rate_hz: float, epochs: int):
    student = make_vision_model(RESNET18, "meta")
    teacher = make_vision_model(WIDERESNET50, "meta")
    n_frames = WINDOW_S * FPS
    n_samples = WINDOW_S * sample_rate_hz
    infer = n_frames * student.flops()
    label = n_samples * teacher.flops()
    retrain = n_samples * epochs * 3 * student.flops()
    total = infer + label + retrain
    return infer / total, retrain / total, label / total, total


def run():
    rows = []
    t0 = time.time()
    # sweep: (sampling rate, epochs) from light to heavy retraining configs
    for rate, epochs in SWEEP:
        fi, fr, fl, total = kernel_flops(rate, epochs)
        rows.append((
            f"fig3/rate{rate}_ep{epochs}", (time.time() - t0) * 1e6,
            f"inference={fi*100:.1f}% retraining={fr*100:.1f}% "
            f"labeling={fl*100:.1f}% total_tflops={total/1e12:.1f}"))
    # the paper's qualitative claim
    fi0, fr0, _, _ = kernel_flops(0.5, 1)
    fi1, fr1, _, _ = kernel_flops(6.0, 15)
    ok = fr1 > fr0 and fi1 < fi0 and fr1 > 0.7 and fr0 < 0.4
    rows.append(("fig3/trend_check", 0.0,
                 f"retrain_share {fr0*100:.1f}%->{fr1*100:.1f}% "
                 f"(paper 26%->82%) PASS={ok}"))
    return rows
