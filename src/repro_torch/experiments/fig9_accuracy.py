"""Fig. 9: end-to-end averaged accuracy of the continuously-learning system
variants on drift scenarios (the JAX package's
``benchmarks/bench_fig9_accuracy.py``).

Validates the paper's ordering claims on the synthetic BDD100K stand-in:
  (1) DaCapo-Spatiotemporal is the best system overall;
  (2) DC-ST > DC-S (temporal reallocation helps);
  (3) OrinLow is the weakest configuration;
plus the 127x / 254x power advantage (Table IV) as energy-per-run.
"""
from __future__ import annotations

import time

from repro_torch.configs.dacapo_pairs import PAIRS
from repro_torch.device import DeviceLike
from repro_torch.experiments.common import POWER_W, SYSTEMS, run_system

SCENARIOS = ("S1", "S3")
PAIR = PAIRS[0]  # (ResNet18, WideResNet50)


def sessions(fast: bool, device: DeviceLike = None, scenarios=SCENARIOS):
    """Every system on each scenario: ``{(scen, name): (CLResult, µs)}``."""
    results = {}
    for scen in scenarios:
        for name in SYSTEMS:
            t0 = time.time()
            res = run_system(name, PAIR[0], PAIR[1], scen, fast=fast,
                             device=device)
            results[(scen, name)] = (res, (time.time() - t0) * 1e6)
    return results


def rows_of(results, scenarios=SCENARIOS):
    rows = []
    for (scen, name), (res, us) in results.items():
        energy = POWER_W[name] * 180.0
        rows.append((
            f"fig9/{scen}/{name}", us,
            f"avg_acc={res.avg_accuracy*100:.1f}% "
            f"drifts={res.drift_events} energy_J={energy:.0f}"))
    # ordering checks per scenario
    for scen in scenarios:
        get = lambda n: results[(scen, n)][0].avg_accuracy  # noqa: E731
        dcst = get("DaCapo-Spatiotemporal")
        checks = {
            "dcst_beats_dcs": dcst >= get("DaCapo-Spatial") - 0.01,
            "dcst_beats_orin_ekya": dcst > get("OrinHigh-Ekya") - 0.01,
            "orinlow_weakest": get("OrinLow-Ekya") <= max(
                get(n) for n in SYSTEMS) + 1e-9,
        }
        rows.append((f"fig9/{scen}/ordering", 0.0,
                     " ".join(f"{k}={v}" for k, v in checks.items())))
    ratio = POWER_W["OrinHigh-Ekya"] / POWER_W["DaCapo-Spatiotemporal"]
    rows.append(("fig9/power_ratio", 0.0,
                 f"OrinHigh/DaCapo={ratio:.0f}x (paper 254x)"))
    return rows


def run(fast: bool = False, device: DeviceLike = None):
    return rows_of(sessions(fast, device))
