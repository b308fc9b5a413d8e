"""End-to-end driver of the PyTorch port: DaCapo continuous learning on a
drifting drive (``examples/continuous_learning_drive.py`` on
``repro_torch``, on the card: :func:`drive` takes ``device="cpu"``).

Runs the full Algorithm 1 system against an extreme scenario (ES1 — all
four drift axes) and compares against the Ekya-like fixed-window baseline
on identical pretrained weights, printing the accuracy timeline.

``--dispatch concurrent`` executes through the async dispatch layer
(core/dispatch.py): a forced 2-row mesh is fissioned into T-SA/B-SA
sub-meshes, score windows are fused into batched inference, each phase
charges max(t_TSA, t_BSA) instead of the serial chain, and frame windows
flow through the speculative FramePipeline (data/pipeline.py), whose
reconcile hit rate is reported per system.

``--online`` swaps DaCapo-ST for DaCapo-ST-Online, the drift-reactive
spatial re-allocator.

``--trace PATH`` turns on the trace spine (core/trace.py) for the DaCapo
system, dumps the per-program execution trace as JSON to PATH for offline
analysis (:meth:`~repro_torch.core.trace.SessionTrace.load` /
:class:`~repro_torch.core.replay.TraceReplayer`), and prints the top-5
device programs by measured host wall time and by virtual-clock cost,
each with the kernel path that served it.

Run:  PYTHONPATH=src python examples/continuous_learning_drive_torch.py
          [--fast] [--scenario ES1] [--dispatch sequential|concurrent]
          [--online] [--trace PATH]
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np


def drive(scenario_name: str = "ES1", n_seg: int = 5,
          duration: float = 240.0, n_t: int = 96, n_l: int = 48,
          c_b: int = 256, steps: Tuple[int, int] = (100, 40),
          batch: int = 48, dispatch: str = "sequential",
          online: bool = False, trace: Optional[str] = None,
          device=None):
    """DaCapo (DC-ST, or DC-ST-Online with ``online``) against Ekya on one
    drifting stream from one shared pretraining, printing per-phase lines,
    the accuracy timeline and each system's summary; with ``trace`` the
    DaCapo run's trace is saved there and its top programs printed.
    Returns ``(results, trace)``: the results by allocator name and the
    recorded :class:`~repro_torch.core.trace.SessionTrace` (or None)."""
    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core import CLHyperParams, CLSystemSpec, pretrain_model
    from repro_torch.core.partition import forced_row_mesh
    from repro_torch.data.stream import DriftStream, scenario
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import make_vision_model

    device = resolve_device(device)
    mesh = None
    if dispatch == "concurrent":
        # Force a 2-row mesh so T-SA and B-SA are disjoint sub-meshes.
        mesh = forced_row_mesh(2, device)

    stream = DriftStream(scenario(scenario_name, n_seg), seed=11, img=24)
    hp = CLHyperParams(n_t=n_t, n_l=n_l, c_b=c_b)

    # One shared pretraining for fairness.
    rng = np.random.default_rng(0)
    tp = pretrain_model(make_vision_model(WIDERESNET50.reduced(), device),
                        stream, steps[0], batch, rng)
    sp = pretrain_model(make_vision_model(RESNET18.reduced(), device),
                        stream, steps[1], batch, rng,
                        segments=stream.segments[:1], seed=8)

    dacapo = ("dacapo-spatiotemporal-online" if online
              else "dacapo-spatiotemporal")
    results = {}
    trace_rec = None
    for allocator in (dacapo, "ekya"):
        session = CLSystemSpec(
            student=RESNET18, teacher=WIDERESNET50, hp=hp,
            allocator=allocator, apply_mx=False, eval_fps=0.5,
            mesh=mesh, dispatch=dispatch,
            trace=bool(trace) and allocator == dacapo,
            device=device).build()
        if allocator == dacapo:
            trace_rec = session.dispatcher.recorder
        session.set_pretrained(tp, sp)
        # Observer hook: structured per-phase metrics as they happen.
        session.add_observer(lambda rec, name=allocator: print(
            f"  [{name}] phase {rec.index:2d} t={rec.t:6.1f}s "
            f"acc_v={rec.acc_valid:.2f} acc_l={rec.acc_label:.2f}"
            f" tsa/bsa={rec.t_tsa:.2f}/{rec.t_bsa:.2f}s"
            f" rows={rec.decision.rows_tsa}/{rec.decision.rows_bsa}"
            f"{' DRIFT' if rec.drift else ''}"))
        results[allocator] = session.run(stream, duration=duration)

    print(f"\nscenario {scenario_name}, {duration:.0f} virtual seconds, "
          f"device {device}")
    print(f"{'time':>6} | {'DaCapo':>10} | {'Ekya':>10}")
    dc = dict(results[dacapo].accuracy_timeline)
    ek = dict(results["ekya"].accuracy_timeline)
    for t in sorted(set(list(dc) + list(ek))):
        a = f"{dc[t]*100:9.1f}%" if t in dc else "         -"
        b = f"{ek[t]*100:9.1f}%" if t in ek else "         -"
        print(f"{t:6.0f} | {a} | {b}")
    for name, res in results.items():
        hits = sum(r.spec_hits for r in res.records)
        misses = sum(r.spec_misses for r in res.records)
        spec = (f" spec-hit-rate={hits / (hits + misses):.0%}"
                if hits + misses else "")
        print(f"{name}: avg={res.avg_accuracy*100:.1f}% "
              f"drifts={res.drift_events} "
              f"label/retrain={res.label_time:.0f}/{res.retrain_time:.0f}s"
              f"{spec}")

    if not (trace and trace_rec is not None):
        return results, None
    recorded = trace_rec.trace
    recorded.save(trace)
    programs = [(ph.index, e) for ph in recorded.phases
                for e in ph.events if e.kind == "program"]
    n_events = sum(len(ph.events) for ph in recorded.phases)
    print(f"\ntrace: {len(recorded.phases)} phases, {n_events} events "
          f"({len(programs)} programs) -> {trace}")
    for title, key in (("host wall time", lambda pe: pe[1].wall_s),
                       ("virtual cost", lambda pe: pe[1].cost_s)):
        print(f"top-5 programs by {title}:")
        for idx, e in sorted(programs, key=key, reverse=True)[:5]:
            path = f" path={e.path}" if e.path else ""
            print(f"  phase {idx:2d} {e.label:>9} [{e.role}] "
                  f"cost={e.cost_s:8.4f}s wall={e.wall_s:8.4f}s "
                  f"units={e.units:g}{path}")
    return results, recorded


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--scenario", default="ES1")
    ap.add_argument("--dispatch", default="sequential",
                    choices=("sequential", "concurrent"))
    ap.add_argument("--online", action="store_true",
                    help="use the drift-reactive online spatial "
                         "re-allocator (DC-ST-Online) instead of DC-ST")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the DaCapo run's execution trace and "
                         "dump it as JSON to PATH")
    args = ap.parse_args()
    drive(args.scenario,
          n_seg=3 if args.fast else 5,
          duration=90.0 if args.fast else 240.0,
          n_t=64 if args.fast else 96,
          n_l=32 if args.fast else 48,
          steps=(30, 20) if args.fast else (100, 40),
          dispatch=args.dispatch, online=args.online, trace=args.trace)


if __name__ == "__main__":
    main()
