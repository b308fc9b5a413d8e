"""End-to-end LM training driver on the host mesh (the JAX package's
``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --reduced --steps 200 --batch 32 --seq 256 [--device cpu]

The reference's flags, plus ``--device`` (default ``cuda``; the run raises
without a card unless it asks for the CPU). As in the reference the model
trains in fp32 (``dtype="float32"`` over the config's own) with AdamW, one
microbatch, the token pipeline, checkpoints every ``--checkpoint-every``
steps, a heartbeat and a straggler detector, on
``make_host_mesh(--model-parallel)`` under the train shape's sharding
rules: the params are placed by ``param_shardings`` and each step is
``launch/steps.py::build_train_bundle``'s ``fn`` (``microbatched_grads``
then ``apply_updates``, in place, as the reference donates its state). On
one rank every tensor stays plain and the run is the single-card one bit
for bit. Across ranks (``torchrun``) every arch trains sharded (the MoE,
Mamba and xLSTM layers through their per-rank bodies, autograd crossing
their collectives), and a checkpoint gathers the full tensors and is
written by rank 0. The default
``--checkpoint-dir`` lies under the temporary directory (``TMPDIR``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import full_tensor, mesh_size
from repro_torch.launch.mesh import describe, run_mesh
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.steps import build_train_bundle, place_params
from repro_torch.launch.steps import train_step  # noqa: F401 (re-exported)
from repro_torch.models.registry import make_lm_model
from repro_torch.runtime.fault import Heartbeat, StragglerDetector
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_state import TrainState
from repro_torch.tree import tree_map


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="xlstm-125m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkpoint-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def train(argv=None, *, on_mesh: bool = True) -> dict:
    """Run the driver; returns its numbers (per-step loss, accuracy and
    host wall, tok/s, stragglers, peak device bytes on a card) and the
    final ``params`` (DTensors across ranks). ``on_mesh=False`` runs the
    same step with no mesh and no rules."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    with run_mesh(args.model_parallel, dev, on_mesh) as mesh:
        return _train(args, dev, mesh)


def _train(args, dev: torch.device, mesh) -> dict:
    arch = configs.get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    arch = dataclasses.replace(arch, dtype="float32")
    shape = ShapeConfig("custom_train", args.seq, args.batch, "train")
    rules = make_rules(arch, shape, mesh)
    opt_cfg = OptimizerConfig(name="adamw", lr=args.lr, warmup_steps=20,
                              total_steps=args.steps)
    bundle = build_train_bundle(arch, shape, mesh, rules, opt_cfg=opt_cfg,
                                num_microbatches=1, device=dev)
    model = make_lm_model(arch, dev)
    pipe = TokenPipeline(arch.vocab_size, args.seq, args.batch, seed=0)
    lead = mesh is None or dist.get_rank() == 0
    if mesh_size(mesh) > 1 and lead:
        print(f"{describe(mesh)} ({mesh_size(mesh)} ranks)")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    if mesh is not None:
        params = place_params(arch, params, bundle.in_shardings[0].params,
                              mesh, rules)
    state = TrainState.create(params, opt_cfg)
    del params
    hb, sd = Heartbeat(), StragglerDetector()
    log = {"loss": [], "accuracy": [], "step_s": []}
    with CheckpointManager(args.checkpoint_dir, max_to_keep=2) as ckpt:
        hb.beat()
        t0 = time.time()
        for step in range(args.steps):
            batch = pipe.batch(step)
            if arch.input_mode == "embeddings":
                rng = np.random.default_rng(step)
                batch["inputs"] = rng.normal(size=(
                    args.batch, args.seq, arch.d_model)).astype(np.float32)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            state, metrics = bundle.fn(state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                metrics = {k: full_tensor(v) for k, v in metrics.items()}
                loss = float(metrics["loss"])  # waits for the step
                acc = float(metrics["accuracy"])
                dur = hb.beat()
                log["loss"].append(loss)
                log["accuracy"].append(acc)
                log["step_s"].append(dur)
                if lead:
                    print(f"step {step:5d} loss {loss:7.4f} acc {acc:5.3f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"({dur * 1e3:6.1f} ms/step)", flush=True)
            else:
                dur = hb.beat()
            sd.observe(step, dur, hb.median())
            if (step + 1) % args.checkpoint_every == 0:
                tree = tree_map(full_tensor, state.as_tree())
                if lead:
                    ckpt.save(step + 1, tree, blocking=False)
                del tree
        ckpt.wait()
        elapsed = time.time() - t0
    toks = args.steps * args.batch * args.seq
    out = {**log, "tok_per_s": toks / elapsed, "stragglers": len(sd.events),
           "device": str(dev), "params": state.params,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)}
    if lead:
        print(f"done: {out['tok_per_s']:,.0f} tok/s, stragglers: "
              f"{out['stragglers']}")
        if out["peak_bytes"] is not None:
            print(f"peak device memory: {out['peak_bytes'] / 2**30:.2f} GiB "
                  f"({torch.cuda.get_device_name(dev)})")
    return out


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
