"""Quickstart of the PyTorch port (``examples/quickstart.py`` on
``repro_torch``): the three public layers of the framework in one script.

1. MX precision — quantize tensors / run an MX matmul (the paper's DPE).
2. Continuous learning — Algorithm 1 on a drifting stream (60 virtual s).
3. LM zoo — the train loss, a prefill and a decode step of an assigned
   architecture.

On the card the MX matmul runs the quantize kernel and the unfused MX
GEMM, and the LM's attention the flash-attention kernel; ``--device cpu``
runs their plain versions.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys


def demo_mx(device) -> dict:
    """The MX matmul x [64, 256] @ w [256, 64] at each precision; returns
    the operands, each precision's output and its relative error against
    fp32."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 256, generator=gen).to(device)
    w = torch.randn(256, 64, generator=gen).to(device)
    exact = x @ w
    outs, errors = {}, {}
    for prec in ("mx4", "mx6", "mx9"):
        outs[prec] = ops.mx_matmul(x, w, prec, prec)
        errors[prec] = float(torch.linalg.norm(outs[prec] - exact)
                             / torch.linalg.norm(exact))
        print(f"  {prec}: matmul relative error {errors[prec]:.4f}")
    return {"x": x, "w": w, "out": outs, "rel_err": errors}


def demo_continuous_learning(device):
    """A DC-ST session over 60 virtual s of S1; returns its ``CLResult``."""
    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core import CLHyperParams, CLSystemSpec
    from repro_torch.data.stream import DriftStream, scenario

    stream = DriftStream(scenario("S1", 3), seed=0, img=24)
    hp = CLHyperParams(n_t=48, n_l=24, c_b=192)
    # Declarative front door: describe the system, then build the session.
    session = CLSystemSpec(student=RESNET18, teacher=WIDERESNET50, hp=hp,
                           allocator="dacapo-spatiotemporal",
                           apply_mx=False, eval_fps=0.5,
                           device=device).build()
    print(f"  spatial allocation: T-SA={session.r_tsa} rows, "
          f"B-SA={session.r_bsa} rows (30 FPS inference)")
    session.pretrain(stream, teacher_steps=30, student_steps=20, batch=32)
    result = session.run(stream, duration=60.0)
    print(f"  60s of S1: avg accuracy {result.avg_accuracy*100:.1f}%, "
          f"{result.drift_events} drift events, "
          f"retrain/label = {result.retrain_time:.1f}s/"
          f"{result.label_time:.1f}s")
    return result


def demo_lm(device) -> dict:
    """Reduced gemma2-2b: the loss of a batch, a 16-token prefill and one
    decode step; returns the loss and the decode step's logits."""
    import torch

    from repro_torch import configs
    from repro_torch.models.transformer import make_model

    cfg = configs.get_arch("gemma2-2b").reduced()
    model = make_model(cfg, device)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    with torch.no_grad():
        loss, _ = model.loss(params, {"inputs": toks[:, :-1],
                                      "labels": toks[:, 1:]})
        print(f"  {cfg.name}: train loss {float(loss):.2f}")
        _, caches = model.prefill(params, toks[:, :16], cache_capacity=33)
        logits, _ = model.decode_step(params, toks[:, 16:17], 16, caches)
    print(f"  prefill(16) + decode(1): logits {tuple(logits.shape)}")
    return {"loss": float(loss), "logits": logits}


def run(device=None) -> dict:
    """The three demos on ``device`` (``cuda`` unless asked otherwise), in
    the reference's order; returns what each computed."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    print("== MX block-floating-point (paper §V-B) ==")
    mx = demo_mx(device)
    print("== LM architecture zoo (assigned archs) ==")
    lm = demo_lm(device)
    print("== Continuous learning (Algorithm 1) ==")
    cl = demo_continuous_learning(device)
    print("done.")
    return {"mx": mx, "lm": lm, "cl": cl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
