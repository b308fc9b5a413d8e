"""Render the port's dry-run results (``launch/dryrun.py --out``) into
the roofline table (the JAX package's ``launch/report.py``)."""
from __future__ import annotations

import argparse
import json


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def render(results, mesh="pod"):
    rows = []
    header = ("| arch | shape | status | mem/dev GiB | t_comp ms | t_mem ms "
              "| t_coll ms | bottleneck | useful |")
    sep = "|" + "---|" * 9
    rows.append(header)
    rows.append(sep)
    for r in results:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP (full attn) "
                        "| - | - | - | - | - | - |")
            continue
        if r["status"] == "fail":
            rows.append(f"| {r['arch']} | {r['shape']} | FAIL | - | - | - "
                        f"| - | - | - |")
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {fmt_bytes(r['bytes_per_device'])} "
            f"| {rf['t_compute']*1e3:.1f} | {rf['t_memory']*1e3:.1f} "
            f"| {rf['t_collective']*1e3:.1f} | {rf['bottleneck']} "
            f"| {r['useful_flops_ratio']:.2f} |")
    return "\n".join(rows)


def summarize(results):
    ok = [r for r in results if r["status"] == "ok"]
    fail = [r for r in results if r["status"] == "fail"]
    skip = [r for r in results if r["status"] == "skipped"]
    lines = [f"{len(ok)} ok / {len(skip)} skipped / {len(fail)} failed"]
    for r in fail:
        lines.append(f"  FAIL {r['arch']} x {r['shape']} x {r['mesh']}: "
                     f"{r.get('error', '')[:200]}")
    return "\n".join(lines)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("results")
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args()
    with open(args.results) as f:
        results = json.load(f)
    print(summarize(results))
    print()
    print(render(results, args.mesh))
