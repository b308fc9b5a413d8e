"""Multi-camera fleet driver of the PyTorch port: N streams, one accelerator,
shared T-SA (``examples/fleet_drive.py`` on ``repro_torch``, on the card:
:func:`drive` takes ``device="cpu"``, the command line ``--device cpu``).

Builds a small heterogeneous fleet — one camera drifting through a paper
scenario, the rest parked in stable contexts — and runs it through
:class:`~repro_torch.core.fleet.FleetSession`: every camera serves its own
inference timeline on the B-SA while a single shared T-SA labels and
retrains for the whole fleet, with the
:class:`~repro_torch.core.allocation.FleetAllocator` proportioning the
per-phase budget across cameras (``--mode drift-weighted|uniform|
round-robin|isolated``) and a pluggable
:class:`~repro_torch.core.decision.FleetRowPolicy` resolving the fleet's
ONE spatial plane per phase (``--row-policy resolve-max|drift-surge|
weighted-vote``). The per-phase log shows each stream's lane (``s0``,
``s1``, ...) and where the budget went; the summary compares per-stream
accuracy and prints the fleet T-SA rows over time.

With ``--shards N`` (N > 1) the same fleet runs under the sharded
:class:`~repro_torch.core.manager.FleetManager` tier instead — N
independent FleetSessions with headroom placement, live lane migration and
per-lane checkpointing — and ``--fail-at PHASE`` injects an accelerator
loss on the last shard at that phase: the driver prints the manager's
re-homing/recovery timeline (admissions, migrations, the failure, each
lane's checkpoint restore) and the conserved manager/shard virtual-clock
ledgers.

``--parallel N`` steps the manager's shards on an N-worker pool each
round (overlapped stepping) — the printed results are bit-identical to
the serial run; only host scheduling changes.

Run:  PYTHONPATH=src python examples/fleet_drive_torch.py [--fast]
          [--streams 3] [--mode drift-weighted] [--row-policy resolve-max]
          [--dispatch sequential|concurrent]
          [--shards 2] [--fail-at 4] [--parallel 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional, Tuple

import numpy as np


def drive(streams: int = 3, scenario_name: str = "S3",
          mode: str = "drift-weighted", row_policy: str = "resolve-max",
          dispatch: str = "sequential", shards: int = 1,
          fail_at: Optional[int] = None, parallel: int = 0,
          seg_s: float = 45.0, n_seg: int = 5, duration: float = 180.0,
          n_t: int = 64, n_l: int = 32, c_b: int = 192,
          steps: Tuple[int, int] = (60, 30), batch: int = 48, device=None):
    """The fleet (``shards == 1``) or the manager tier over it, printing
    per-phase lines (fleet) or the re-homing timeline (manager) and a
    summary. ``parallel > 1`` or ``fail_at`` imply at least 2 shards.
    Returns the :class:`~repro_torch.core.fleet.FleetResult` or the
    :class:`~repro_torch.core.manager.ManagerResult`."""
    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core import CLHyperParams, FleetSpec, pretrain_model
    from repro_torch.core.mx import PrecisionPolicy
    from repro_torch.data.stream import DriftStream, Segment, scenario
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import make_vision_model

    device = resolve_device(device)
    if parallel > 1 and shards < 2:
        shards = 2  # overlap needs more than one shard to step
    if fail_at is not None and shards < 2:
        shards = 2  # a failure needs a survivor to recover onto

    drifting = [dataclasses.replace(s, duration_s=seg_s)
                for s in scenario(scenario_name, n_seg)]
    cams = [DriftStream(drifting, seed=11, img=24)]
    for i in range(streams - 1):
        cams.append(DriftStream([Segment(duration_s=seg_s)] * n_seg,
                                seed=21 + i, img=24))
    # MX9 serving -> balanced (8, 8) split; v_thr widened for the scaled
    # per-lane label counts.
    hp = CLHyperParams(n_t=n_t, n_l=n_l, c_b=c_b, v_thr=-0.2)

    rng = np.random.default_rng(0)
    tp = pretrain_model(make_vision_model(WIDERESNET50.reduced(), device),
                        cams[0], steps[0], batch, rng)
    sp = pretrain_model(make_vision_model(RESNET18.reduced(), device),
                        cams[0], steps[1], batch, rng,
                        segments=cams[0].segments[:1], seed=8)

    spec = FleetSpec(student=RESNET18, teacher=WIDERESNET50, hp=hp,
                     fleet_mode=mode, row_policy=row_policy,
                     apply_mx=False, eval_fps=0.5,
                     policy=PrecisionPolicy(inference="mx9"),
                     dispatch=dispatch, device=device)
    if shards > 1:
        return run_manager(spec, cams, tp, sp, duration, shards=shards,
                           fail_at=fail_at, parallel=parallel, mode=mode)
    fleet = spec.build()
    fleet.set_pretrained(tp, sp)
    fleet.add_observer(lambda rec: print(
        f"  [s{rec.stream}] phase {rec.index:2d} t={rec.t:6.1f}s "
        f"acc_v={rec.acc_valid:.2f} acc_l={rec.acc_label:.2f} "
        f"budget={rec.decision.retrain_samples:3d}r/"
        f"{rec.decision.total_label_samples:3d}l "
        f"tsa={rec.t_tsa:5.2f}s"
        f"{' DRIFT' if rec.drift else ''}"))
    fres = fleet.run(cams, duration=duration)

    print(f"\nfleet mode={mode} row-policy={row_policy} streams={streams} "
          f"{duration:.0f} virtual seconds ({len(fres.fleet_phase_log)} "
          f"fleet phases), device {device}")
    for i, lane in enumerate(fres.streams):
        kind = "drifting" if i == 0 else "stable"
        print(f"  s{i} ({kind:8s}): avg={lane.avg_accuracy * 100:5.1f}%  "
              f"drifts={lane.drift_events}  "
              f"label/retrain={lane.label_time:.0f}/"
              f"{lane.retrain_time:.0f}s")
    print(f"fleet mean accuracy: {fres.fleet_avg_accuracy * 100:.1f}%")
    if fres.fleet_phase_log:
        mean_tsa = float(np.mean([e["t_tsa"]
                                  for e in fres.fleet_phase_log]))
        print(f"shared T-SA per phase: {mean_tsa:.2f}s "
              f"(sum of per-stream shares — one array, not N)")
        rows = [(e["t"], e["rows_tsa"], e["rows_bsa"])
                for e in fres.fleet_phase_log]
        print("fleet rows over time (t: T-SA/B-SA):")
        print("  " + "  ".join(f"{t:5.0f}s:{rt}/{rb}"
                               for t, rt, rb in rows))
        moves = sum(1 for a, b in zip(rows, rows[1:]) if a[1] != b[1])
        print(f"spatial re-allocations: {moves} (row policy: {row_policy})")
    return fres


def run_manager(spec, cams, tp, sp, duration: float, shards: int,
                fail_at: Optional[int], parallel: int, mode: str):
    """The sharded tier: ``shards`` FleetSessions under one FleetManager,
    with headroom placement, live migration, per-lane checkpoints and
    (with ``fail_at``) an injected accelerator loss and its recovery."""
    from repro_torch.core.manager import FleetManager
    from repro_torch.runtime.fault import FailureInjector

    victim = shards - 1
    injector = None
    if fail_at is not None:
        injector = FailureInjector(fail_at_steps=[(fail_at, victim)])
    with tempfile.TemporaryDirectory(prefix="fleet_drive_ckpt_") as ckpt:
        mgr = FleetManager(spec, n_shards=shards, placement="headroom",
                           placement_kwargs={"min_gap": 1},
                           checkpoint_dir=ckpt, checkpoint_every=2,
                           migration=True, migration_cooldown=2,
                           failure_injector=injector, recovery_cost_s=2.0,
                           parallel_shards=parallel)
        mgr.set_pretrained(tp, sp)
        res = mgr.run(cams, duration=duration)

    stepping = (f"overlapped x{parallel} "
                f"({res.parallel_rounds}/{res.rounds} pooled rounds)"
                if parallel > 1 else "serial")
    print(f"\nmanager: {shards} shards, mode={mode}, {duration:.0f} virtual "
          f"seconds, {res.rounds} rounds, stepping {stepping}, device "
          f"{spec.device}"
          + (f", shard {victim} killed at phase {fail_at}"
             if fail_at is not None else ""))
    print("re-homing / recovery timeline:")
    shown = 0
    for e in res.events:
        if e.kind == "checkpoint":
            continue
        shown += 1
        where = (f"shard {e.shard}" if e.to_shard is None
                 else f"shard {e.shard} -> {e.to_shard}")
        lane = f" lane {e.key}" if e.key is not None else ""
        print(f"  t={e.t:6.1f}s round {e.round:2d} {e.kind:8s} "
              f"{where}{lane}  {e.detail}")
    if not shown:
        print("  (no admissions, migrations or failures)")
    ckpts = sum(1 for e in res.events if e.kind == "checkpoint")
    print(f"checkpoint sweeps: {ckpts} (every 2 rounds, per-lane)")
    print("per-lane results:")
    for key in sorted(res.lane_results, key=str):
        lane = res.lane_results[key]
        print(f"  {key}: avg={lane.avg_accuracy * 100:5.1f}%  "
              f"phases={len(lane.records)}  drifts={lane.drift_events}")
    print(f"fleet mean accuracy: {res.fleet_avg_accuracy * 100:.1f}%")
    dead = [i for i, r in enumerate(res.shard_results) if r is None]
    for i, led in enumerate(res.shard_ledgers):
        state = "DEAD" if i in dead else "alive"
        print(f"  shard {i} ({state}): t_tsa={led['t_tsa']:7.2f}s "
              f"t_bsa={led['t_bsa']:7.2f}s")
    print(f"manager ledger: t_tsa={res.ledger['t_tsa']:.2f}s "
          f"+ recovery={res.ledger['recovery_cost']:.2f}s "
          f"+ migration={res.ledger['migration_cost']:.2f}s "
          f"(conservation gap {res.conservation_gap():.2e})")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--scenario", default="S3",
                    help="scenario of the drifting camera")
    ap.add_argument("--mode", default="drift-weighted",
                    choices=("drift-weighted", "uniform", "round-robin",
                             "isolated"))
    ap.add_argument("--row-policy", default="resolve-max",
                    choices=("resolve-max", "drift-surge", "weighted-vote"),
                    help="fleet spatial-plane policy (FleetRowPolicy)")
    ap.add_argument("--dispatch", default="sequential",
                    choices=("sequential", "concurrent"))
    ap.add_argument("--shards", type=int, default=1,
                    help="run under the FleetManager tier with N shards")
    ap.add_argument("--fail-at", type=int, default=None, metavar="PHASE",
                    help="kill the last shard's accelerator at this fleet "
                         "phase (implies the manager tier)")
    ap.add_argument("--parallel", type=int, default=0, metavar="N",
                    help="overlapped shard stepping: N pool workers step "
                         "the shards concurrently each round (0 = serial; "
                         "the ManagerResult is bit-identical either way)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "CPU path)")
    args = ap.parse_args()
    drive(streams=args.streams, scenario_name=args.scenario,
          mode=args.mode, row_policy=args.row_policy,
          dispatch=args.dispatch, shards=args.shards, fail_at=args.fail_at,
          parallel=args.parallel,
          seg_s=20.0 if args.fast else 45.0,
          n_seg=4 if args.fast else 5,
          duration=60.0 if args.fast else 180.0,
          n_t=48 if args.fast else 64,
          n_l=24 if args.fast else 32,
          steps=(20, 12) if args.fast else (60, 30),
          device=args.device)


if __name__ == "__main__":
    main()
