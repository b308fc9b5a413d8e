"""Runner of the figure experiments (the JAX package's
``benchmarks/run.py``, its figure modules): prints ``name,us_per_call,
derived`` CSV rows and exits 1 if any figure raised.

Run:  PYTHONPATH=src python -m repro_torch.experiments [--fast]
          [--only table3,fig3,fig9,fig11,fig12] [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise; without a card it
raises rather than run on the CPU. ``--fast`` takes the quick sizes (the
reference's ``REPRO_BENCH_FAST=1``).
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

FIGURES = ("table3", "fig3", "fig9", "fig11", "fig12")


def figures(fast: bool, device):
    """Each figure's name and the call that makes its rows."""
    from repro_torch.experiments import (fig3_flops, fig9_accuracy,
                                         fig11_temporal, fig12_extreme,
                                         table3_models)

    return {
        "table3": lambda: table3_models.run(device),
        "fig3": fig3_flops.run,
        "fig9": lambda: fig9_accuracy.run(fast, device),
        "fig11": lambda: fig11_temporal.run(fast, device),
        "fig12": lambda: fig12_extreme.run(fast, device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments")
    ap.add_argument("--fast", action="store_true",
                    help="quick sizes: 3 segments, 90 virtual s a session")
    ap.add_argument("--only", default=",".join(FIGURES),
                    help="comma-separated figures to run, of "
                    + ",".join(FIGURES))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    only = [name for name in args.only.split(",") if name]
    unknown = sorted(set(only) - set(FIGURES))
    if unknown:
        ap.error(f"unknown figures {unknown}; choose from {FIGURES}")

    from repro_torch.device import resolve_device
    from repro_torch.experiments.common import emit

    device = resolve_device(args.device)
    calls = figures(args.fast, device)
    print("name,us_per_call,derived")
    failures = 0
    for name in FIGURES:
        if name not in only:
            continue
        t0 = time.time()
        try:
            emit(calls[name]())
            print(f"# {name} done in {time.time()-t0:.1f}s", flush=True)
        except Exception:  # noqa: BLE001
            failures += 1
            traceback.print_exc()
            print(f"# {name} FAILED", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
