"""Fig. 12: extreme data-drift scenarios (ES1/ES2, all four drift axes; the
JAX package's ``benchmarks/bench_fig12_extreme.py``).

Paper: Ekya degrades most (-12.9% vs regular), EOMU tolerates better
(+7.8% over Ekya), DaCapo-ST best (+4.4% over EOMU, +13.0% over Ekya).
"""
from __future__ import annotations

import time

from repro_torch.configs.dacapo_pairs import PAIRS
from repro_torch.device import DeviceLike
from repro_torch.experiments.common import run_system

SYSTEMS_12 = ("OrinHigh-Ekya", "OrinHigh-EOMU", "DaCapo-Spatiotemporal")
SCENARIOS = ("ES1", "ES2")


def run(fast: bool = False, device: DeviceLike = None):
    rows = []
    accs = {}
    for scen in SCENARIOS:
        for name in SYSTEMS_12:
            t0 = time.time()
            res = run_system(name, PAIRS[0][0], PAIRS[0][1], scen,
                             fast=fast, device=device)
            accs[(scen, name)] = res.avg_accuracy
            rows.append((
                f"fig12/{scen}/{name}", (time.time() - t0) * 1e6,
                f"avg_acc={res.avg_accuracy*100:.1f}% "
                f"drifts={res.drift_events}"))
    for scen in SCENARIOS:
        dc = accs[(scen, "DaCapo-Spatiotemporal")]
        ek = accs[(scen, "OrinHigh-Ekya")]
        eo = accs[(scen, "OrinHigh-EOMU")]
        rows.append((
            f"fig12/{scen}/ordering", 0.0,
            f"DaCapo-vs-Ekya={100*(dc-ek):+.1f}pp (paper +13.0) "
            f"DaCapo-vs-EOMU={100*(dc-eo):+.1f}pp (paper +4.4) "
            f"PASS={dc >= max(ek, eo) - 0.02}"))
    return rows
