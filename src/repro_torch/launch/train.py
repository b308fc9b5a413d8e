"""End-to-end LM training driver on one card (the JAX package's
``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --reduced --steps 200 --batch 32 --seq 256 [--device cpu]

The reference's flags, plus ``--device`` (default ``cuda``; the run raises
without a card unless it asks for the CPU). As in the reference the model
trains in fp32 (``dtype="float32"`` over the config's own) with AdamW, one
microbatch, the token pipeline, checkpoints every ``--checkpoint-every``
steps, a heartbeat and a straggler detector. Each step is the body of the
reference's ``launch/steps.py::build_train_bundle`` train step:
``microbatched_grads`` then ``apply_updates`` (in place, as the reference
donates its state). A ``--model-parallel`` above 1 needs a mesh: ROADMAP
item 10c. The default ``--checkpoint-dir`` lies under the temporary
directory (``TMPDIR``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.registry import make_lm_model
from repro_torch.runtime.fault import Heartbeat, StragglerDetector
from repro_torch.training.grad import microbatched_grads
from repro_torch.training.optimizer import OptimizerConfig, apply_updates
from repro_torch.training.train_state import TrainState


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


def train_step(model, state: TrainState, batch, opt_cfg: OptimizerConfig,
               num_microbatches: int = 1):
    """One step: ``microbatched_grads`` of ``model.loss``, then
    ``apply_updates`` (params and moments updated in place)."""
    loss, metrics, grads = microbatched_grads(
        lambda p, b: model.loss(p, b), state.params, batch,
        num_microbatches)
    params, opt, om = apply_updates(state.params, grads, state.opt_state,
                                    state.step, opt_cfg)
    del grads
    return TrainState(params, opt, state.step + 1), {**metrics, **om}


def train(argv=None) -> dict:
    """Run the driver; returns its numbers (per-step loss, accuracy and
    host wall, tok/s, stragglers, peak device bytes on a card)."""
    args = parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs a mesh and sharding rules: ROADMAP "
            "item 10c")
    arch = configs.get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    arch = dataclasses.replace(arch, dtype="float32")
    dev = resolve_device(args.device)
    opt_cfg = OptimizerConfig(name="adamw", lr=args.lr, warmup_steps=20,
                              total_steps=args.steps)
    model = make_lm_model(arch, dev)
    pipe = TokenPipeline(arch.vocab_size, args.seq, args.batch, seed=0)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
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
            state, metrics = train_step(model, state, batch, opt_cfg)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])  # waits for the step
                acc = float(metrics["accuracy"])
                dur = hb.beat()
                log["loss"].append(loss)
                log["accuracy"].append(acc)
                log["step_s"].append(dur)
                print(f"step {step:5d} loss {loss:7.4f} acc {acc:5.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"({dur * 1e3:6.1f} ms/step)", flush=True)
            else:
                dur = hb.beat()
            sd.observe(step, dur, hb.median())
            if (step + 1) % args.checkpoint_every == 0:
                ckpt.save(step + 1, state.as_tree(), blocking=False)
        ckpt.wait()
        elapsed = time.time() - t0
    toks = args.steps * args.batch * args.seq
    out = {**log, "tok_per_s": toks / elapsed, "stragglers": len(sd.events),
           "device": str(dev),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)}
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
