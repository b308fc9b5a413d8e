"""Table III: parameter counts and GFLOPs of the six evaluated models (the
JAX package's ``benchmarks/bench_table3_models.py``).

Validates the implementations against the paper's reported numbers
(paper GFLOPs are MACs; ours count 2*MACs, so we compare flops/2). Each
model is built at its published width on ``device`` (``cuda`` unless
asked otherwise); on ``meta`` only the shapes are made.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.configs.dacapo_pairs import TABLE_III, VISION_MODELS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import make_vision_model


def build(device: DeviceLike = None):
    """Each model at published width, its weights drawn from seed 0 and its
    build's wall in µs: ``{name: (model, params, us)}``."""
    device = resolve_device(device)
    built = {}
    for name, cfg in VISION_MODELS.items():
        m = make_vision_model(cfg, device)
        t0 = time.time()
        # On meta the CPU generator's draws are made on meta too (nothing
        # is drawn); elsewhere they are drawn on the CPU and moved.
        with (torch.device(device) if device.type == "meta"
              else contextlib.nullcontext()):
            params = m.init(torch.Generator().manual_seed(0))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        built[name] = (m, params, (time.time() - t0) * 1e6)
    return built


def rows_of(built):
    rows = []
    for name, (m, params, us) in built.items():
        n = m.param_count(params)
        gmacs = m.flops() / 2 / 1e9
        ref_n, ref_g = TABLE_III[name]
        derived = (f"params={n/1e6:.1f}M(paper {ref_n/1e6:.1f}M) "
                   f"gmacs={gmacs:.2f}(paper {ref_g:.2f}) "
                   f"param_err={abs(n-ref_n)/ref_n*100:.1f}%")
        rows.append((f"table3/{name}", us, derived))
    return rows


def run(device: DeviceLike = None):
    return rows_of(build(device))
