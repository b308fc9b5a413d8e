"""Serving driver: prefill + batched autoregressive greedy decode on the
host mesh (the JAX package's ``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \
      --batch 4 --prompt-len 64 --gen 32 [--device cpu]

The reference's flags, plus ``--device`` (default ``cuda``; the run raises
without a card unless it asks for the CPU). As in the reference the model
runs in fp32 (``dtype="float32"`` over the config's own), from seed 0, on
``make_host_mesh(--model-parallel)`` under the decode shape's sharding
rules: the params are placed by ``param_shardings`` and the prefill and
decode are ``launch/steps.py``'s bundles. On one rank every tensor stays
plain and the run is the single-card one bit for bit. Across ranks
(``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu
--model-parallel 2 ...``) every arch runs sharded: the dense layers
through DTensor's ops and the sequence-sharded attention, the MoE experts
over "model" (split into virtual experts where the axis does not divide
their count: ``steps.place_params``), the Mamba and xLSTM mixers
tensor-parallel through their per-rank bodies.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import full_tensor, mesh_size
from repro_torch.launch.mesh import describe, run_mesh
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.steps import (
    build_decode_bundle,
    build_prefill_bundle,
    place_params,
)
from repro_torch.models.registry import make_lm_model


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="yi-6b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(argv=None, *, on_mesh: bool = True) -> dict:
    """Run the driver; returns its numbers (prefill s, decode s and tok/s,
    the generated tokens [B, gen], the decode logits [B, gen - 1, V],
    peak device bytes on a card). ``on_mesh=False`` runs the same steps
    with no mesh and no rules."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    with run_mesh(args.model_parallel, dev, on_mesh) as mesh:
        return _serve(args, dev, mesh)


def _serve(args, dev: torch.device, mesh) -> dict:
    arch = configs.get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    arch = dataclasses.replace(arch, dtype="float32")
    capacity = args.prompt_len + args.gen
    shape = ShapeConfig("serve", capacity, args.batch, "decode")
    rules = make_rules(arch, shape, mesh)
    prefill = build_prefill_bundle(
        arch, dataclasses.replace(shape, kind="prefill"), mesh, rules,
        device=dev)
    decode = build_decode_bundle(arch, shape, mesh, rules, device=dev)
    model = make_lm_model(arch, dev)
    if mesh_size(mesh) > 1 and dist.get_rank() == 0:
        print(f"{describe(mesh)} ({mesh_size(mesh)} ranks)")

    rng = np.random.default_rng(0)
    if arch.input_mode == "embeddings":
        prompts = rng.normal(size=(args.batch, args.prompt_len,
                                   arch.d_model)).astype(np.float32)
    else:
        prompts = rng.integers(0, arch.vocab_size,
                               size=(args.batch, args.prompt_len))
        prompts = prompts.astype(np.int32)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        if mesh is not None:
            params = place_params(arch, params, prefill.in_shardings[0],
                                  mesh, rules)
        prompts = torch.from_numpy(prompts).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill.fn(params, {"inputs": prompts})
        logits = full_tensor(logits)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        if logits.ndim == 3:  # multi-head outputs: take head 0
            logits = logits[:, 0]
        toks = logits.argmax(-1)
        generated, step_logits = [toks.cpu().numpy()], []
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            t = args.prompt_len + i
            if arch.input_mode == "embeddings":
                step_in = torch.from_numpy(rng.normal(size=(
                    args.batch, 1, arch.d_model)).astype(np.float32)).to(dev)
            else:
                step_in = toks.reshape(args.batch, 1)
            logits, caches = decode.fn(params, caches,
                                       {"inputs": step_in, "t": t})
            logits = full_tensor(logits)
            if logits.ndim == 3:
                logits = logits[:, 0]
            step_logits.append(logits)
            toks = logits.argmax(-1)
            generated.append(toks.cpu().numpy())
        _sync(dev)
        t_decode = time.perf_counter() - t0
    gen = np.stack(generated, 1)
    steps = args.gen - 1
    out = {"prefill_s": t_prefill, "decode_s": t_decode,
           "decode_tok_per_s": steps * args.batch / max(t_decode, 1e-9),
           "tokens": gen, "device": str(dev),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None),
           "logits": (torch.stack(step_logits, 1) if step_logits
                      else None)}
    if mesh is not None and dist.get_rank() != 0:
        return out
    print(f"prefill: {args.batch}x{args.prompt_len} in "
          f"{t_prefill * 1e3:.1f} ms")
    print(f"decode:  {steps} steps x {args.batch} seqs in "
          f"{t_decode * 1e3:.1f} ms ({out['decode_tok_per_s']:,.0f} tok/s)")
    print("sample tokens:", gen[0, :16].tolist())
    if out["peak_bytes"] is not None:
        print(f"peak device memory: {out['peak_bytes'] / 2**30:.2f} GiB "
              f"({torch.cuda.get_device_name(dev)})")
    return out


def main(argv=None) -> int:
    serve(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
