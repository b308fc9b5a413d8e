"""Host cost of the host mesh on one card: the serve driver
(``repro_torch.launch.serve``) at ``chip_smoke.py`` phase 13's setup
(gemma2-2b in fp32, batch 4, prompt 512, 32 tokens) in three variants, in
turns:

* ``no mesh`` — ``serve(argv, on_mesh=False)``: no process group, no rules;
* ``mesh`` — ``serve(argv)``: ``make_host_mesh(1)`` on a one-rank NCCL
  group, the decode shape's rules, the bundles;
* ``group, no mesh`` — ``serve(argv, on_mesh=False)`` while a one-rank
  NCCL group is alive (``launch/mesh.py::host_mesh``): the group's own
  cost without the rules.

  python3 mesh_overhead.py [--reps 3]

Prints each run's decode and prefill wall, then the card's ``nvidia-smi``
line and, as its last line, a JSON object of every run. Needs one CUDA
card and ``nvcc``; the kernels build at first use.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

ARGV = ["--arch", "gemma2-2b", "--batch", "4", "--prompt-len", "512",
        "--gen", "32"]
VARIANTS = ("no mesh", "mesh", "group, no mesh")


def run(variant: str) -> dict:
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import host_mesh

    quiet = contextlib.redirect_stdout(io.StringIO())
    if variant == "mesh":
        with quiet:
            return serve.serve(ARGV)
    group = (host_mesh(1, "cuda") if variant == "group, no mesh"
             else contextlib.nullcontext())
    with group, quiet:
        return serve.serve(ARGV, on_mesh=False)


def main() -> None:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mesh_overhead: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    for rep in range(args.reps):
        order = VARIANTS if rep % 2 == 0 else VARIANTS[::-1]
        for variant in order:
            res = run(variant)
            row = {"rep": rep, "variant": variant,
                   "decode_ms": res["decode_s"] * 1e3,
                   "prefill_ms": res["prefill_s"] * 1e3,
                   "tokens": res["tokens"].tolist()}
            runs.append(row)
            print(f"[mesh_overhead] rep {rep} {variant}: decode "
                  f"{row['decode_ms']:.1f} ms (31 steps), prefill "
                  f"{row['prefill_ms']:.1f} ms", flush=True)
            del res
            torch.cuda.empty_cache()
    first = runs[0]["tokens"]
    if any(r["tokens"] != first for r in runs):
        raise SystemExit("mesh_overhead: the variants' tokens differ")
    for variant in VARIANTS:
        walls = sorted(r["decode_ms"] for r in runs
                       if r["variant"] == variant)
        print(f"[mesh_overhead] {variant}: decode ms {walls}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"gpu": smi, "runs": [
        {k: v for k, v in r.items() if k != "tokens"} for r in runs]}),
        flush=True)


if __name__ == "__main__":
    main()
