#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s phase-7 attention check on one GPU.

    python3 attention_mutants.py

For each mutant of the kv split's ``combine_kernel``
(``src/repro_torch/kernels/csrc/flash_attention.cu``) — the partials
merged without their e^(m_s - m) rescale, and piece 0 left out — copies
the checkout's ``src/`` and ``chip_smoke.py`` into a temporary directory,
plants the mutant in the copy, builds it and, in a child process, drives
phase 7's cases that the plan splits (the same inputs) through
``chip_smoke.attention_within``. Prints one JSON line per mutant and case
(max error, share of the elementwise limit, RMS share and its limit,
whether the check rejected it) and exits 1 if any mutant passes. Needs
one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
MUTANTS = {
    "no rescale": (
        "const float w = expf(p.part_ml[2 * (s * rows + prow)] - mx);",
        "const float w = 1.f;"),
    "piece 0 dropped": (
        "for (int s = 0; s < p.splits; ++s) {\n      const float w",
        "for (int s = 1; s < p.splits; ++s) {\n      const float w"),
}


def drive(mutant: str) -> None:
    """In a mutated copy: phase 7's split cases, one JSON line each."""
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    if not Path(fa.__file__).resolve().is_relative_to(ROOT):
        raise SystemExit(f"attention_mutants: imported {fa.__file__}, not "
                         f"the copy under {ROOT}")
    gen = torch.Generator(device="cuda").manual_seed(7)  # as phase 7
    for label, shape, dtype, opts in chip_smoke.ATTENTION_CASES:
        q, k, v = chip_smoke.attention_inputs(gen, shape, dtype, "cuda")
        b, sq, skv, h = shape[:4]
        plan = fa.attention_plan(b, h, sq, skv, causal=opts["causal"],
                                 window=opts.get("window"),
                                 q_offset=opts.get("q_offset", 0))
        if plan.splits == 1:
            continue
        out = fa.flash_attention_cuda(q, k, v, **opts)
        plain = ref.flash_attention_ref(q, k, v, **opts)
        err, reading, share = chip_smoke.attention_readings(out, plain, dtype)
        try:
            chip_smoke.attention_within(label, out, plain, dtype, "plain")
            rejected = False
        except AssertionError:
            rejected = True
        print(json.dumps({
            "mutant": mutant, "case": label, "dtype": dtype,
            "kv_splits": plan.splits, "max_abs_err": err,
            "tol_reading": reading, "rms_share": share,
            "rms_limit": chip_smoke.ATTENTION_RMS_SHARE[dtype],
            "rejected": rejected}), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_mutants: torch.cuda.is_available() is "
                         "False — this check needs a CUDA card")
    source = (ROOT / SOURCE).read_text()
    passed = []
    for mutant, (old, new) in MUTANTS.items():
        if source.count(old) != 1:
            raise SystemExit(f"attention_mutants: the {mutant!r} site is "
                             f"not once in {SOURCE}")
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src", ignore=shutil
                            .ignore_patterns("_build", "__pycache__"))
            for name in ("chip_smoke.py", "attention_mutants.py"):
                shutil.copy2(ROOT / name, copy / name)
            (copy / SOURCE).write_text(source.replace(old, new))
            run = subprocess.run(
                [sys.executable, str(copy / "attention_mutants.py"),
                 "--drive", mutant], capture_output=True, text=True,
                timeout=900)
        print(run.stdout, end="", flush=True)
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith("{")]
        if run.returncode or not rows:
            raise SystemExit(f"attention_mutants: {mutant!r} did not run "
                             f"(exit {run.returncode}):\n{run.stderr[-4000:]}")
        passed += [row for row in rows if not row["rejected"]]
    if passed:
        raise SystemExit(f"attention_mutants: phase 7's check passed "
                         f"{len(passed)} mutant case(s)")
    print(f"phase 7's check rejected every mutant ({', '.join(MUTANTS)}) "
          "at every split case", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--drive"]:
        drive(sys.argv[2])
    else:
        main()
