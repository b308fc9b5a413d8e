"""Fig. 11: temporal resource-allocation decisions — retraining vs labeling
time breakdown for DC-S vs DC-ST, plus the accuracy delta (the JAX
package's ``benchmarks/bench_fig11_temporal.py``).

Paper: on drift, DC-ST allocates ~12.7% more time to labeling and gains
~5.9% accuracy over the spatial-only baseline.

Per-phase metrics come through the CLSession observer hook (structured
``PhaseRecord``s). The second pair is ViT-B/32 / ViT-B/16, whose attention
runs through ``ops.flash_attention``.
"""
from __future__ import annotations

import time

from repro_torch.configs.dacapo_pairs import PAIRS
from repro_torch.device import DeviceLike
from repro_torch.experiments.common import run_system


def run(fast: bool = False, device: DeviceLike = None):
    rows = []
    for student, teacher in PAIRS[:2]:
        t0 = time.time()
        st_records = []
        st = run_system("DaCapo-Spatiotemporal", student, teacher, "S1",
                        observers=(st_records.append,), fast=fast,
                        device=device)
        sp = run_system("DaCapo-Spatial", student, teacher, "S1", fast=fast,
                        device=device)
        us = (time.time() - t0) * 1e6

        def frac(res):
            tot = res.retrain_time + res.label_time
            return res.label_time / max(tot, 1e-9)

        # Observer-fed decision audit: how many phases ran with the boosted
        # N_ldd labeling budget (Alg. 1 line 13)?
        boosted = sum(1 for r in st_records
                      if r.decision.extra_label_samples > 0)
        rows.append((
            f"fig11/{student.name}+{teacher.name}", us,
            f"DC-ST label_frac={frac(st)*100:.1f}% "
            f"DC-S label_frac={frac(sp)*100:.1f}% "
            f"delta={100*(frac(st)-frac(sp)):+.1f}pp (paper +12.7pp) "
            f"acc_delta={(st.avg_accuracy-sp.avg_accuracy)*100:+.1f}pp "
            f"(paper +5.9pp) drifts={st.drift_events} "
            f"boosted_phases={boosted}/{len(st_records)}"))
    return rows
