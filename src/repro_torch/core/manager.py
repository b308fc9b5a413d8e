"""FleetManager — the sharded, elastic, fault-tolerant fleet-of-fleets tier
(the JAX package's ``core/manager.py``).

Architecture:

* a **shard** is one :class:`~repro_torch.core.fleet.FleetSession` (its own
  kernels, allocator, RNGs and serving caches; every shard on the fleet
  spec's device), opened phase-steppable as a
  :class:`~repro_torch.core.fleet.FleetRun` — the manager never reaches
  inside a shard's phase; it acts only at phase boundaries, where no
  :class:`~repro_torch.core.dispatch.PhasePlan` is in flight;
* the **manager loop** is round-based: each round, every live shard
  executes one fleet phase; between rounds the manager checkpoints lanes
  (per-lane :class:`~repro_torch.checkpoint.CheckpointManager`
  directories), admits due cameras, and migrates lanes per its placement
  policy;
* **overlapped rounds** — with ``parallel_shards > 1`` the live shards'
  phases run concurrently on a ``ThreadPoolExecutor`` and meet at a
  phase-boundary **barrier**, where all bookkeeping — ledger charges,
  checkpointing, admission, migration, failure recovery — happens in
  shard-index order. The overlapped loop is **bit-identical to serial
  stepping**: shard phases touch only shard-private state (the
  process-wide launch counters, kernel stats and serving caches are
  locked), the failure injector is probed with deterministic
  ``(round, shard)`` keys, and the barrier fixes the order of every
  charge, event and :class:`PlacementAction` whatever order the workers
  finish in. The reference's ``shard_pace`` (a sleep standing in for a
  device wait on a CPU host) has no counterpart: the card's wait is real.
  On one card every worker issues onto the current stream of
  ``cuda:0``; torch's grad mode, stream and device are per thread, and a
  shard's phase sets what it needs itself (the kernels enter
  ``torch.no_grad()``, the SGD step ``torch.enable_grad()``);
* **lane admission** — a camera joining mid-run is placed on the shard
  the :class:`PlacementPolicy` picks; a policy may instead *reject* the
  camera when every shard is oversubscribed (``PlacementAction(kind=
  "reject")``);
* **estimator-driven placement** — the ``estimator`` policy scores moves
  with :class:`~repro_torch.core.estimator.PlacementCostModel`: a
  migration fires only when the T-SA seconds it shaves off the per-round
  load maximum, amortized over a horizon, exceed the explicit
  ``migration_cost_s`` the manager charges its ledger per move;
* **live lane migration** — a lane is frozen into a
  :class:`~repro_torch.core.fleet.LaneSnapshot` and re-homed with its
  pipeline, resuming bit for bit;
* **fault tolerance** — a simulated accelerator loss
  (:class:`~repro_torch.runtime.fault.FailureInjector`, probed per round
  with ``key=shard_index``) kills a shard: its lanes restore from their
  last durable per-lane checkpoint (host arrays landed on the surviving
  shard's device by :func:`~repro_torch.runtime.elastic.rehome_tree`) and
  re-home across survivors, with ``recovery_cost_s`` per lane charged to
  the manager ledger. Only an
  :class:`~repro_torch.runtime.fault.InjectedFailure` is a shard loss: any
  other exception of a shard's step (a CUDA fault, a failed launch)
  propagates out of :meth:`FleetManager.run`, never recovered;
* the **virtual-clock ledger is conserved**: every phase's T-SA/B-SA
  seconds are charged once to the owning shard and once to the manager,
  so ``manager.t_tsa == Σ shard.t_tsa`` (to float re-association) and the
  only extra manager-level charges are the explicit recovery and
  migration costs;
* each round is recorded as a
  :class:`~repro_torch.core.decision.ManagerDecision`.

A lane checkpoint holds the lane's arrays as npz leaves and everything
else in one pickled ``aux`` blob of port objects (policy, RNG states,
records, decision), so a lane checkpoint belongs to the package that wrote
it; the cross-package promise is the plain array layout of
:class:`~repro_torch.checkpoint.CheckpointManager`. ``aux`` holds no
tensor (:func:`snapshot_to_state` refuses one), so it unpickles without a
card.

Degeneracy contract: a **1-shard FleetManager is bit-identical to a bare
FleetSession** (same records, timelines, ledger) — the manager opens the
shard's run through the same :meth:`~repro_torch.core.fleet.FleetSession
.open_run` path ``run()`` uses, and checkpointing is side-effect free on
live lanes.
"""
from __future__ import annotations

import dataclasses
import io
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.decision import ManagerDecision, PlacementAction
from repro_torch.core.estimator import PlacementCostModel
from repro_torch.core.fleet import (
    FleetResult,
    FleetRun,
    FleetSession,
    FleetSpec,
    LaneSnapshot,
)
from repro_torch.core.session import CLResult
from repro_torch.core.trace import PhaseTrace, SessionTrace
from repro_torch.data.pipeline import FramePipeline
from repro_torch.runtime.fault import FailureInjector, InjectedFailure


# --------------------------------------------------------------- shard views
@dataclasses.dataclass(frozen=True)
class ShardView:
    """Frozen per-shard stats a placement policy conditions on."""

    index: int
    alive: bool
    done: bool
    n_lanes: int
    clock: float
    t_tsa: float  # accumulated T-SA seconds on this shard
    recent_t_tsa: float  # last phase's T-SA seconds (headroom proxy)
    drifted_lanes: int  # lanes whose latest phase fired drift
    recent_phase_s: float = 0.0  # last phase's wall (t - phase_start)

    @property
    def placeable(self) -> bool:
        return self.alive and not self.done


@dataclasses.dataclass(frozen=True)
class LaneView:
    """Frozen per-lane stats for migration decisions."""

    shard: int
    index: int
    key: object
    drifted: bool  # latest phase fired drift
    drift_events: int
    recent_t_tsa: float = 0.0  # last phase's T-SA seconds for this lane


# --------------------------------------------------------- placement policies
class PlacementPolicy:
    """Pluggable lane-placement policy: where admitted/re-homed lanes land
    and which lanes migrate, mirroring the
    :class:`~repro_torch.core.decision.FleetRowPolicy` registry pattern —
    ``PlacementPolicy("headroom", **kwargs)`` dispatches through
    :data:`PLACEMENT_POLICIES` (subclasses construct directly), unknown
    kwargs are rejected, :meth:`reset` is called once per manager run.
    """

    name = "base"

    def __new__(cls, spec: Optional[str] = None, **kwargs):
        if cls is PlacementPolicy:
            key = spec or "headroom"
            try:
                sub = PLACEMENT_POLICIES[key]
            except KeyError:
                raise KeyError(
                    f"unknown placement policy {key!r}; "
                    f"known: {sorted(PLACEMENT_POLICIES)}") from None
            return super().__new__(sub)
        return super().__new__(cls)

    def __init__(self, spec: Optional[str] = None, **kwargs):
        # ``spec`` is the registry key consumed by __new__; unknown kwargs
        # are rejected, not swallowed — a typo'd knob must not silently
        # measure default behavior.
        del spec
        if kwargs:
            raise TypeError(
                f"{type(self).__name__} got unexpected keyword "
                f"arguments: {sorted(kwargs)}")

    def reset(self, n_shards: int) -> None:
        """Fresh per-run state (cursors etc.)."""

    def place(self, views: Sequence[ShardView]) -> int:
        """Shard index for a new or re-homed lane. At least one view is
        guaranteed placeable."""
        raise NotImplementedError

    def admit(self, views: Sequence[ShardView]) -> Optional[int]:
        """Shard index for a *mid-run* admission, or ``None`` to reject
        the camera (every shard oversubscribed — surfaced by the manager
        as ``PlacementAction(kind="reject")``). Default: admission is
        just placement, never rejected. Initial placement and fault
        recovery go through :meth:`place` and cannot reject."""
        return self.place(views)

    def migrate(self, views: Sequence[ShardView],
                lanes: Sequence[LaneView]
                ) -> Optional[Tuple[LaneView, int]]:
        """Propose at most one migration: (lane, target shard index), or
        None. Default: placement-only policies never migrate."""
        return None


class StaticPlacementPolicy(PlacementPolicy):
    """Round-robin admission over placeable shards, never migrates — the
    no-elasticity baseline."""

    name = "static"

    def __init__(self, spec: Optional[str] = None):
        super().__init__(spec)
        self._cursor = 0

    def reset(self, n_shards: int) -> None:
        self._cursor = 0

    def place(self, views: Sequence[ShardView]) -> int:
        order = [v for v in views if v.placeable]
        pick = order[self._cursor % len(order)]
        self._cursor += 1
        return pick.index


class HeadroomPlacementPolicy(PlacementPolicy):
    """Admit onto the shard with the most T-SA headroom (fewest lanes,
    then least recent T-SA time); migrate a drifted lane off an
    oversubscribed shard when a strictly less-loaded shard exists.

    The migration trigger is the DaCapo contention story one tier up: a
    drifting lane means an N_ldd labeling burst plus buffer-refill
    retraining on its shard's single T-SA — if another shard's T-SA is
    sitting idle, moving the hot lane buys recovery time on the target
    *and* serving time back on the source. ``min_gap`` is the load gap
    (in lanes) required before a move fires (hysteresis against
    ping-ponging)."""

    name = "headroom"

    def __init__(self, spec: Optional[str] = None, *, min_gap: int = 2):
        super().__init__(spec)
        self.min_gap = min_gap

    def place(self, views: Sequence[ShardView]) -> int:
        order = sorted((v for v in views if v.placeable),
                       key=lambda v: (v.n_lanes, v.recent_t_tsa, v.index))
        return order[0].index

    def migrate(self, views, lanes):
        placeable = [v for v in views if v.placeable]
        if len(placeable) < 2:
            return None
        # Busiest shard that has a drifted lane and >= 2 lanes.
        sources = sorted(
            (v for v in placeable
             if v.n_lanes >= 2 and v.drifted_lanes > 0),
            key=lambda v: (-v.recent_t_tsa, -v.n_lanes, v.index))
        for src in sources:
            targets = sorted(
                (v for v in placeable if v.index != src.index),
                key=lambda v: (v.n_lanes, v.recent_t_tsa, v.index))
            tgt = targets[0]
            if src.n_lanes - tgt.n_lanes < self.min_gap:
                continue  # not oversubscribed enough to pay a move
            for lane in lanes:
                if lane.shard == src.index and lane.drifted:
                    return lane, tgt.index
        return None


class DriftPackPlacementPolicy(PlacementPolicy):
    """Consolidate drifting lanes onto one shard: admissions land on the
    *quietest* shard (fewest drifted lanes), and a drifted lane migrates
    onto the shard already owning the most drifted lanes — packing the
    retraining-heavy lanes so their N_ldd bursts share one T-SA while the
    other shards' B-SAs serve healthy lanes undisturbed."""

    name = "drift-pack"

    def place(self, views: Sequence[ShardView]) -> int:
        order = sorted((v for v in views if v.placeable),
                       key=lambda v: (v.drifted_lanes, v.n_lanes, v.index))
        return order[0].index

    def migrate(self, views, lanes):
        placeable = [v for v in views if v.placeable]
        if len(placeable) < 2:
            return None
        hot = sorted(placeable,
                     key=lambda v: (-v.drifted_lanes, v.n_lanes, v.index))[0]
        if hot.drifted_lanes == 0:
            return None  # nothing drifting anywhere
        for lane in lanes:
            if lane.drifted and lane.shard != hot.index:
                src = next(v for v in placeable if v.index == lane.shard)
                if src.n_lanes >= 2:
                    return lane, hot.index
        return None


class EstimatorPlacementPolicy(PlacementPolicy):
    """Placement scored by :class:`~repro_torch.core.estimator
    .PlacementCostModel` instead of lane counts.

    Under overlapped rounds the manager's wall per round is the *maximum*
    of the per-shard T-SA loads, so this policy reasons in seconds on
    that maximum (the Ekya-style microprofiled-placement idea one tier
    up): admissions land on the shard with the least recent T-SA load;
    a lane migrates only when the load-max seconds it saves, amortized
    over ``horizon_rounds``, exceed ``migration_cost_s`` — the same
    figure the manager charges its ledger per move, so a migration that
    fires has, by construction, already paid for itself in the model;
    and a mid-run admission is **rejected** when every warm shard's
    predicted T-SA utilization (T-SA seconds per phase over the phase
    wall) would exceed ``oversub_limit`` with one more lane aboard.
    """

    name = "estimator"

    def __init__(self, spec: Optional[str] = None, *,
                 migration_cost_s: float = 2.0,
                 horizon_rounds: int = 4,
                 oversub_limit: float = 1.5):
        super().__init__(spec)
        self.model = PlacementCostModel(
            migration_cost_s=migration_cost_s,
            horizon_rounds=horizon_rounds,
            oversub_limit=oversub_limit)

    def place(self, views: Sequence[ShardView]) -> int:
        order = sorted((v for v in views if v.placeable),
                       key=lambda v: (v.recent_t_tsa, v.n_lanes, v.index))
        return order[0].index

    def admit(self, views: Sequence[ShardView]) -> Optional[int]:
        placeable = [v for v in views if v.placeable]
        warm = [v for v in placeable if v.recent_phase_s > 0]
        if not warm:
            return self.place(views)  # no utilization signal yet
        lanes = sum(v.n_lanes for v in placeable)
        # The incoming camera's cost is unknown until it runs; predict it
        # as the fleet-mean per-lane T-SA load.
        lane_cost = (sum(v.recent_t_tsa for v in placeable) / lanes
                     if lanes else 0.0)
        fits = [v for v in warm
                if self.model.admits(v.recent_t_tsa, v.recent_phase_s,
                                     lane_cost)]
        # An idle shard (no phase yet) always has room.
        fits += [v for v in placeable if v.recent_phase_s <= 0]
        if not fits:
            return None
        order = sorted(fits,
                       key=lambda v: (v.recent_t_tsa, v.n_lanes, v.index))
        return order[0].index

    def migrate(self, views, lanes):
        placeable = sorted((v for v in views if v.placeable),
                           key=lambda v: v.index)
        if len(placeable) < 2:
            return None
        pos = {v.index: i for i, v in enumerate(placeable)}
        loads = [v.recent_t_tsa for v in placeable]
        lanes_per = {v.index: v.n_lanes for v in placeable}
        best = None  # (gain, lane, target shard index)
        for lane in sorted(lanes, key=lambda l: (l.shard, l.index)):
            if lane.shard not in pos or lane.recent_t_tsa <= 0:
                continue
            if lanes_per[lane.shard] < 2:
                continue  # never drain a shard's last lane
            for tgt in placeable:
                if tgt.index == lane.shard:
                    continue
                gain = self.model.migration_gain_s(
                    loads, pos[lane.shard], pos[tgt.index],
                    lane.recent_t_tsa)
                # Strictly-greater keeps the first (lowest shard/lane
                # index) candidate on ties — deterministic proposals.
                if best is None or gain > best[0]:
                    best = (gain, lane, tgt.index)
        if best is None or best[0] <= self.model.migration_cost_s:
            return None
        return best[1], best[2]


PLACEMENT_POLICIES: Dict[str, Type[PlacementPolicy]] = {
    "static": StaticPlacementPolicy,
    "headroom": HeadroomPlacementPolicy,
    "drift-pack": DriftPackPlacementPolicy,
    "estimator": EstimatorPlacementPolicy,
}


def make_placement_policy(policy, **kwargs) -> PlacementPolicy:
    """Resolve a placement policy from a registry name, class, or ready
    instance."""
    if isinstance(policy, PlacementPolicy):
        return policy
    if isinstance(policy, str):
        return PlacementPolicy(policy, **kwargs)
    return policy(**kwargs)


# ------------------------------------------------------ durable lane snapshot
class _NoTensorPickler(pickle.Pickler):
    """Refuses tensors: the ``aux`` blob must unpickle without a card."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError("a lane snapshot's aux blob must hold no tensor "
                            f"(found one of shape {tuple(obj.shape)})")
        return NotImplemented


def snapshot_to_state(snap: LaneSnapshot) -> Dict[str, object]:
    """Encode a :class:`LaneSnapshot` as the flat array tree
    :class:`~repro_torch.checkpoint.CheckpointManager` persists: the large
    arrays (params / opt / buffer samples) as npz leaves, everything else
    — RNG states, the pickled lane policy, records, timeline — as one
    opaque ``aux`` uint8 blob, so the checkpoint round-trips bit-exactly
    without ``allow_pickle`` on the array file. ``aux`` pickles port
    objects and no tensor (a tensor raises ``TypeError``)."""
    bx, by = snap.buffer["x"], snap.buffer["y"]
    aux = {
        "key": snap.key,
        "rng_state": snap.rng_state,
        "policy": snap.policy,
        "lane_state": snap.lane_state,
        "decision": snap.decision,
        "eval_cursor": snap.eval_cursor,
        "retrain_time": snap.retrain_time,
        "label_time": snap.label_time,
        "drift_events": snap.drift_events,
        "records": snap.records,
        "timeline": snap.timeline,
        "clock": snap.clock,
        "buffer_meta": {"capacity": snap.buffer["capacity"],
                        "rng_state": snap.buffer["rng_state"]},
    }
    buf = io.BytesIO()
    _NoTensorPickler(buf).dump(aux)
    blob = np.frombuffer(buf.getvalue(), dtype=np.uint8).copy()
    return {
        "params": snap.params,
        "opt": snap.opt,
        "buffer_x": bx if bx is not None else np.zeros((0,), np.float32),
        "buffer_y": by if by is not None else np.zeros((0,), np.int64),
        "aux": blob,
    }


def state_to_snapshot(state: Dict[str, object]) -> LaneSnapshot:
    """Decode :func:`snapshot_to_state` (the exact inverse)."""
    aux = pickle.loads(np.asarray(state["aux"]).tobytes())
    bx = np.asarray(state["buffer_x"])
    by = np.asarray(state["buffer_y"])
    meta = aux["buffer_meta"]
    return LaneSnapshot(
        key=aux["key"],
        params=state["params"],
        opt=state["opt"],
        buffer={"x": None if bx.size == 0 else bx,
                "y": None if by.size == 0 else by,
                "capacity": meta["capacity"],
                "rng_state": meta["rng_state"]},
        rng_state=aux["rng_state"],
        policy=aux["policy"],
        lane_state=aux["lane_state"],
        decision=aux["decision"],
        eval_cursor=aux["eval_cursor"],
        retrain_time=aux["retrain_time"],
        label_time=aux["label_time"],
        drift_events=aux["drift_events"],
        records=aux["records"],
        timeline=aux["timeline"],
        clock=aux["clock"],
    )


# ---------------------------------------------------------------- the manager
@dataclasses.dataclass
class ManagerEvent:
    """One entry of the manager's re-homing/recovery timeline."""

    round: int
    t: float  # manager virtual clock (fleet frontier) at the event
    kind: str  # "admit"|"reject"|"migrate"|"fail"|"recover"|"checkpoint"
    shard: int
    key: object = None
    to_shard: Optional[int] = None
    detail: str = ""


@dataclasses.dataclass
class _Shard:
    index: int
    session: FleetSession
    run: Optional[FleetRun] = None
    alive: bool = True
    t_tsa: float = 0.0
    t_bsa: float = 0.0
    recent_t_tsa: float = 0.0
    recent_phase_s: float = 0.0
    phases: int = 0
    trace_seen: int = 0  # cursor into the shard recorder's phase list


@dataclasses.dataclass
class ManagerResult:
    """One manager run: per-shard fleet results, flat per-lane lanes, the
    conserved two-level ledger, and the event/decision timelines."""

    name: str
    shard_results: List[Optional[FleetResult]]  # None for dead shards
    lane_results: Dict[object, CLResult]  # key -> final lane result
    fleet_avg_accuracy: float  # mean over all surviving lanes
    ledger: Dict[str, float]  # manager level: t_tsa/t_bsa/recovery_cost
    shard_ledgers: List[Dict[str, float]]
    events: List[ManagerEvent]
    decisions: List[ManagerDecision]
    rounds: int
    parallel_rounds: int = 0  # rounds stepped on the worker pool

    @property
    def n_shards(self) -> int:
        return len(self.shard_results)

    def conservation_gap(self) -> float:
        """|manager T-SA ledger − Σ shard T-SA ledgers| — zero modulo
        float re-association; recovery and migration costs are charged
        only at manager level, on top (``ledger['total']``)."""
        return abs(self.ledger["t_tsa"]
                   - sum(s["t_tsa"] for s in self.shard_ledgers))


class FleetManager:
    """Owns N shards and runs the fleet-of-fleets phase loop above them.

    ``spec`` is the :class:`~repro_torch.core.fleet.FleetSpec` every shard is
    built from (one independent :class:`FleetSession` per shard, on the
    spec's device: ``cuda`` unless it says ``device="cpu"``). The manager
    acts only at phase boundaries: admission, migration, per-lane
    checkpointing, and fault recovery all happen between
    :meth:`FleetRun.step` calls.

    ``checkpoint_dir=None`` disables durable checkpoints (recovery then
    restarts lost lanes fresh from the pretrained student);
    ``failure_injector`` is probed once per shard per round with
    ``key=shard_index``; ``recovery_cost_s`` is the explicit manager-level
    charge per re-homed lane (checkpoint read + re-home + serving-copy
    fill, in virtual seconds), and ``migration_cost_s`` the analogous
    charge per policy migration (``ledger['migration_cost']``, included in
    ``ledger['total']`` — a move is never free; the ``estimator`` policy
    additionally *decides* with the same figure, so set both from one
    number).

    ``parallel_shards > 1`` steps the live shards' phases concurrently on
    a ``ThreadPoolExecutor`` of that many workers; ``0``/``1`` (default)
    keeps the serial loop. Either way every round ends at a barrier that
    charges ledgers, recovers failures, checkpoints, admits and migrates
    in shard-index order, so the overlapped loop is **bit-identical** to
    serial stepping: same records, same ``ManagerDecision`` stream, same
    two-level ledger (shard phases touch only shard-private state; the
    process-wide launch counters, kernel stats and serving caches are
    locked; the failure injector is probed with deterministic
    ``(round, shard)`` keys).
    """

    def __init__(self, spec: FleetSpec, n_shards: int = 2,
                 placement="headroom",
                 placement_kwargs: Optional[dict] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 migration: bool = True,
                 migration_cooldown: int = 2,
                 migration_cost_s: float = 0.0,
                 failure_injector: Optional[FailureInjector] = None,
                 recovery_cost_s: float = 0.0,
                 parallel_shards: int = 0):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.spec = spec
        self.placement = make_placement_policy(placement,
                                               **(placement_kwargs or {}))
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, checkpoint_every)
        self.migration = migration
        self.migration_cooldown = max(0, migration_cooldown)
        self.migration_cost_s = migration_cost_s
        self.failure_injector = failure_injector
        self.recovery_cost_s = recovery_cost_s
        self.parallel_shards = max(0, parallel_shards)
        self.shards: List[_Shard] = [
            _Shard(index=i, session=spec.build()) for i in range(n_shards)]
        self.name = f"manager-{self.placement.name}x{n_shards}"
        self.events: List[ManagerEvent] = []
        self.decisions: List[ManagerDecision] = []
        self.ledger: Dict[str, float] = {
            "t_tsa": 0.0, "t_bsa": 0.0, "recovery_cost": 0.0,
            "migration_cost": 0.0}
        self.parallel_rounds = 0
        # Merged trace spine: when the fleet spec carries ``trace``, every
        # shard session records its own phases (each ``spec.build()`` gets
        # its own recorder) and the manager merges them at the round
        # barrier, in shard-index order — deterministic whatever order the
        # overlapped workers finish in. ``self.trace`` is the merged view.
        self.trace_phases: List[PhaseTrace] = []
        self._streams: Dict[object, object] = {}  # key -> source stream
        self._ckpts: Dict[object, CheckpointManager] = {}
        self._round = 0
        self._last_migration = -(10 ** 9)

    # ----------------------------------------------------------- pretrained
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def set_pretrained(self, teacher_params, student_params) -> None:
        """Install the shared pretrained teacher/student on every shard."""
        for shard in self.shards:
            shard.session.set_pretrained(teacher_params, student_params)

    # -------------------------------------------------------------- views
    def _views(self) -> List[ShardView]:
        views = []
        for shard in self.shards:
            run = shard.run
            drifted = 0
            if run is not None:
                drifted = sum(1 for lane in run.lanes
                              if lane.records and lane.records[-1].drift)
            views.append(ShardView(
                index=shard.index, alive=shard.alive,
                done=(run.done if run is not None else True),
                n_lanes=(len(run.lanes) if run is not None else 0),
                clock=(run.clock if run is not None else 0.0),
                t_tsa=shard.t_tsa, recent_t_tsa=shard.recent_t_tsa,
                drifted_lanes=drifted,
                recent_phase_s=shard.recent_phase_s))
        return views

    def _lane_views(self) -> List[LaneView]:
        lanes = []
        for shard in self.shards:
            if not shard.alive or shard.run is None:
                continue
            for lane in shard.run.lanes:
                lanes.append(LaneView(
                    shard=shard.index, index=lane.index, key=lane.key,
                    drifted=bool(lane.records and lane.records[-1].drift),
                    drift_events=lane.drift_events,
                    recent_t_tsa=(lane.records[-1].t_tsa
                                  if lane.records else 0.0)))
        return lanes

    def _frontier(self) -> float:
        live = [s.run.clock for s in self.shards
                if s.alive and s.run is not None and not s.run.done
                and s.run.lanes]
        if live:
            return min(live)
        any_run = [s.run.clock for s in self.shards if s.run is not None]
        return max(any_run) if any_run else 0.0

    # ------------------------------------------------------------- ledger
    def _charge(self, shard: _Shard) -> None:
        """Charge any newly-logged phases to both ledgers — once to the
        shard, once to the manager, same numbers: conservation by
        construction."""
        log = shard.run.fleet_phase_log
        for entry in log[shard.phases:]:
            shard.t_tsa += entry["t_tsa"]
            shard.t_bsa += entry["t_bsa"]
            shard.recent_t_tsa = entry["t_tsa"]
            shard.recent_phase_s = entry["t"] - entry["phase_start"]
            self.ledger["t_tsa"] += entry["t_tsa"]
            self.ledger["t_bsa"] += entry["t_bsa"]
        shard.phases = len(log)
        self._drain_trace(shard)

    # -------------------------------------------------------------- trace
    def _drain_trace(self, shard: _Shard) -> None:
        """Pull the shard recorder's newly-completed phases into the
        manager's merged trace, stamping their shard index. Called only at
        the round barrier, in shard-index order, so the merged event
        stream is identical for serial and overlapped stepping."""
        recorder = shard.session.dispatcher.recorder
        if recorder is None:
            return
        for phase in recorder.drain_since(shard.trace_seen):
            phase.shard = shard.index
            self.trace_phases.append(phase)
        shard.trace_seen = len(recorder.phases)

    @property
    def trace(self) -> SessionTrace:
        """The barrier-merged manager trace (empty when tracing is off)."""
        return SessionTrace(phases=self.trace_phases,
                            meta={"tier": "manager", "name": self.name})

    # -------------------------------------------------------- checkpoints
    def _ckpt_for(self, key: object) -> Optional[CheckpointManager]:
        if self.checkpoint_dir is None:
            return None
        if key not in self._ckpts:
            self._ckpts[key] = CheckpointManager(
                os.path.join(self.checkpoint_dir, f"lane_{key}"),
                max_to_keep=2)
        return self._ckpts[key]

    def _checkpoint_lanes(self) -> None:
        for shard in self.shards:
            if not shard.alive or shard.run is None or shard.run.done:
                continue
            for i, lane in enumerate(shard.run.lanes):
                mgr = self._ckpt_for(lane.key)
                if mgr is None:
                    continue
                snap = shard.run.snapshot_lane(i)
                mgr.save(self._round, snapshot_to_state(snap),
                         metadata={"key": str(lane.key),
                                   "shard": shard.index,
                                   "clock": snap.clock})
        if self.checkpoint_dir is not None:
            self.events.append(ManagerEvent(
                round=self._round, t=self._frontier(), kind="checkpoint",
                shard=-1, detail=f"round {self._round}"))

    def _restore_snapshot(self, key: object) -> Optional[LaneSnapshot]:
        mgr = self._ckpt_for(key)
        if mgr is None:
            return None
        mgr.wait()  # join any in-flight async save before reading
        step = mgr.latest_step()
        if step is None:
            return None
        shard = next(s for s in self.shards if s.alive)
        like = snapshot_to_state(_template_snapshot(shard.session))
        state, _ = mgr.restore(step, like)
        return state_to_snapshot(state)

    # ----------------------------------------------------------- recovery
    def _fail_shard(self, shard: _Shard, reason: str,
                    placements: List[PlacementAction]) -> None:
        """Accelerator loss on ``shard``: mark it dead (its accumulated
        ledger stays — that work happened), restore every lane from its
        last durable checkpoint (fresh from the pretrained student if it
        never checkpointed), and re-home across survivors; each re-homed
        lane costs ``recovery_cost_s`` on the manager ledger."""
        shard.alive = False
        self._drain_trace(shard)  # keep any completed phases of the dead
        t = self._frontier()
        self.events.append(ManagerEvent(
            round=self._round, t=t, kind="fail", shard=shard.index,
            detail=reason))
        lost = [(lane.key, lane.index) for lane in shard.run.lanes]
        shard.run.close()
        shard.run = None
        survivors = [s for s in self.shards
                     if s.alive and s.run is not None and not s.run.done]
        if not survivors:
            raise RuntimeError(
                f"shard {shard.index} failed with no surviving shards")
        for key, _ in lost:
            snap = self._restore_snapshot(key)
            views = self._views()
            target = next(s for s in self.shards
                          if s.index == self.placement.place(views))
            # A recovered lane gets a FRESH pipeline over the source
            # stream — the dead shard's speculation state died with it.
            pipe = FramePipeline(
                self._streams[key],
                speculative=target.session.speculative_frames)
            target.run.attach_lane(pipe, key=key, snapshot=snap, own=True)
            self.ledger["recovery_cost"] += self.recovery_cost_s
            detail = ("restored from checkpoint" if snap is not None
                      else "no checkpoint; restarted fresh")
            placements.append(PlacementAction(
                kind="recover", key=key, to_shard=target.index,
                from_shard=shard.index, reason=detail))
            self.events.append(ManagerEvent(
                round=self._round, t=t, kind="recover", shard=shard.index,
                key=key, to_shard=target.index, detail=detail))

    # ---------------------------------------------------------- migration
    def _maybe_migrate(self, placements: List[PlacementAction]) -> None:
        if not self.migration:
            return
        if self._round - self._last_migration < self.migration_cooldown:
            return
        proposal = self.placement.migrate(self._views(), self._lane_views())
        if proposal is None:
            return
        lane_view, target_idx = proposal
        src = self.shards[lane_view.shard]
        tgt = self.shards[target_idx]
        snap, pipe = src.run.detach_lane(lane_view.index)
        tgt.run.attach_lane(pipe, snapshot=snap, own=True)
        self._last_migration = self._round
        self.ledger["migration_cost"] += self.migration_cost_s
        placements.append(PlacementAction(
            kind="migrate", key=lane_view.key, to_shard=target_idx,
            from_shard=src.index, reason="placement-policy migration"))
        self.events.append(ManagerEvent(
            round=self._round, t=self._frontier(), kind="migrate",
            shard=src.index, key=lane_view.key, to_shard=target_idx,
            detail=f"lane {lane_view.key}: shard {src.index} -> "
                   f"{target_idx}"))

    # --------------------------------------------------------- round step
    def _step_shard(self, shard: _Shard) -> None:
        """One round's unit of work for one shard — the piece the worker
        pool overlaps. Probes the failure injector (keyed by
        ``(round, shard)``, so the outcome is deterministic whichever
        thread runs it) and executes one fleet phase. Touches only shard-private state: ledger charges and
        membership changes happen at the barrier, in shard-index order.
        The injector is probed before the phase starts, so a failed shard
        has no program in flight when the barrier closes its run."""
        if self.failure_injector is not None:
            self.failure_injector.maybe_fail(self._round, key=shard.index)
        shard.run.step()

    # ---------------------------------------------------------------- run
    def run(self, streams: Union[Sequence, Dict[object, object]],
            duration: Optional[float] = None,
            admissions: Sequence[Tuple[float, object, object]] = (),
            observers: Sequence = ()) -> ManagerResult:
        """Run the fleet-of-fleets to ``duration``.

        ``streams``: the initial cameras — a sequence of streams/pipelines
        (keys auto-assigned ``cam0..``) or a dict ``key -> stream``.
        Initial placement groups them shard-by-shard via the placement
        policy, then opens each shard's run through
        :meth:`FleetSession.open_run` — a 1-shard manager therefore takes
        the exact code path of :meth:`FleetSession.run` (the degeneracy
        contract). ``admissions`` is a sequence of ``(t, key, stream)``:
        each camera joins at the first phase boundary where the fleet
        frontier has reached ``t``.
        """
        if isinstance(streams, dict):
            items = list(streams.items())
        else:
            items = [(f"cam{i}", s) for i, s in enumerate(streams)]
        self.placement.reset(len(self.shards))
        self.events, self.decisions = [], []
        self.ledger = {"t_tsa": 0.0, "t_bsa": 0.0, "recovery_cost": 0.0,
                       "migration_cost": 0.0}
        self.parallel_rounds = 0
        self._round = 0
        self._last_migration = -(10 ** 9)

        # Initial placement: policy-placed, then one open_run per shard so
        # the per-shard loop is the exact FleetSession.run code path.
        groups: List[List[Tuple[object, object]]] = [
            [] for _ in self.shards]
        for key, stream in items:
            views = [ShardView(index=i, alive=True, done=False,
                               n_lanes=len(groups[i]), clock=0.0,
                               t_tsa=0.0, recent_t_tsa=0.0,
                               drifted_lanes=0)
                     for i in range(len(self.shards))]
            groups[self.placement.place(views)].append((key, stream))
            self._streams[key] = stream
        for shard, group in zip(self.shards, groups):
            shard.run = shard.session.open_run(
                [s for _, s in group], duration=duration,
                observers=observers)
            for lane, (key, _) in zip(shard.run.lanes, group):
                lane.key = key
        pending = sorted(admissions, key=lambda a: a[0])
        pending = list(pending)

        # ------------------------------------------------ the round loop
        pool: Optional[ThreadPoolExecutor] = None
        if self.parallel_shards > 1 and len(self.shards) > 1:
            pool = ThreadPoolExecutor(
                max_workers=min(self.parallel_shards, len(self.shards)),
                thread_name_prefix="shard-step")
        try:
            self._round_loop(pool, pending)
        except BaseException:
            # Anything but an injected failure ends the run: drain the
            # pool, so no shard has a phase in flight, then close every
            # shard's pipelines before the error propagates.
            if pool is not None:
                pool.shutdown(wait=True)
            for shard in self.shards:
                if shard.run is not None:
                    shard.run.close()
            raise
        if pool is not None:
            pool.shutdown(wait=True)

        # ------------------------------------------------------ finalize
        for mgr in self._ckpts.values():
            mgr.close()  # flush any in-flight async saves
        shard_results: List[Optional[FleetResult]] = []
        lane_results: Dict[object, CLResult] = {}
        for shard in self.shards:
            if not shard.alive:
                shard_results.append(None)
                continue
            result = shard.run.finalize()
            shard_results.append(result)
            for lane, lane_result in zip(shard.run.lanes, result.streams):
                lane_results[lane.key] = lane_result
            shard.run.close()
        accs = [r.avg_accuracy for r in lane_results.values()]
        return ManagerResult(
            name=self.name,
            shard_results=shard_results,
            lane_results=lane_results,
            fleet_avg_accuracy=float(np.mean(accs)) if accs else 0.0,
            ledger={**self.ledger,
                    "total": self.ledger["t_tsa"]
                    + self.ledger["recovery_cost"]
                    + self.ledger["migration_cost"]},
            shard_ledgers=[{"t_tsa": s.t_tsa, "t_bsa": s.t_bsa}
                           for s in self.shards],
            events=self.events,
            decisions=self.decisions,
            rounds=self._round,
            parallel_rounds=self.parallel_rounds,
        )

    def _round_loop(self, pool: Optional[ThreadPoolExecutor],
                    pending: List[Tuple[float, object, object]]) -> None:
        """Rounds until every shard drains. Each round has two halves:
        the **step phase** — every live shard's :meth:`_step_shard`, on
        the pool when one is given (overlapped) or inline (serial) — and
        the **barrier**, which replays outcomes in shard-index order:
        charges for survivors, recovery for failures, then checkpointing,
        admission and migration. Joining futures in shard-index order and
        doing ALL bookkeeping at the barrier is what makes the overlapped
        loop bit-identical to the serial one whatever order workers
        finish in. Only :class:`InjectedFailure` is a shard loss; any
        other exception propagates."""
        while any(s.alive and s.run is not None and not s.run.done
                  and s.run.lanes for s in self.shards):
            placements: List[PlacementAction] = []
            stepping = [s for s in self.shards
                        if s.alive and s.run is not None
                        and not s.run.done and s.run.lanes]
            failures: Dict[int, str] = {}
            if pool is not None and len(stepping) > 1:
                self.parallel_rounds += 1
                futures = {s.index: pool.submit(self._step_shard, s)
                           for s in stepping}
                for shard in stepping:
                    try:
                        futures[shard.index].result()
                    except InjectedFailure as e:
                        failures[shard.index] = str(e)
            else:
                for shard in stepping:
                    try:
                        self._step_shard(shard)
                    except InjectedFailure as e:
                        failures[shard.index] = str(e)
            for shard in stepping:
                if shard.index in failures:
                    self._fail_shard(shard, failures[shard.index],
                                     placements)
                else:
                    self._charge(shard)
            live = [s for s in self.shards
                    if s.alive and s.run is not None and not s.run.done]
            # An idle (empty) shard's virtual clock tracks the fleet
            # frontier — it sits ready; time passes. A lane attached to
            # it later starts scoring from the join point, not t=0.
            frontier = self._frontier()
            for shard in live:
                if not shard.run.lanes:
                    shard.run.clock = max(shard.run.clock, frontier)
            if live:
                # Per-lane checkpoints every checkpoint_every rounds
                # (side-effect free on the live lanes).
                if (self._round + 1) % self.checkpoint_every == 0:
                    self._checkpoint_lanes()
                # Due admissions: cameras whose join time the fleet
                # frontier has passed.
                frontier = self._frontier()
                while pending and pending[0][0] <= frontier:
                    t_at, key, stream = pending.pop(0)
                    views = self._views()
                    target_idx = self.placement.admit(views)
                    if target_idx is None:
                        # Every shard oversubscribed: the camera is turned
                        # away — explicit degraded service, recorded in
                        # the decision stream, never a silent drop.
                        placements.append(PlacementAction(
                            kind="reject", key=key, to_shard=None,
                            reason=f"admission due at t={t_at:g}: "
                                   f"fleet oversubscribed"))
                        self.events.append(ManagerEvent(
                            round=self._round, t=frontier, kind="reject",
                            shard=-1, key=key,
                            detail=f"due t={t_at:g}: oversubscribed"))
                        continue
                    self._streams[key] = stream
                    target = next(s for s in self.shards
                                  if s.index == target_idx)
                    target.run.attach_lane(stream, key=key)
                    placements.append(PlacementAction(
                        kind="admit", key=key, to_shard=target.index,
                        reason=f"admission due at t={t_at:g}"))
                    self.events.append(ManagerEvent(
                        round=self._round, t=frontier, kind="admit",
                        shard=target.index, key=key,
                        detail=f"due t={t_at:g}"))
                self._maybe_migrate(placements)
            self.decisions.append(ManagerDecision(
                shards=tuple(
                    (s.run.fleet_dec
                     if s.alive and s.run is not None and not s.run.done
                     else None)
                    for s in self.shards),
                placements=tuple(placements)))
            self._round += 1


def _template_snapshot(session: FleetSession) -> LaneSnapshot:
    """A structure-only :class:`LaneSnapshot` used as the ``like`` tree
    for :meth:`CheckpointManager.restore` — array *structures* must match
    the saved state (shapes are immaterial to npz restore; the aux blob
    and buffer arrays are single leaves)."""
    params = session.student_params
    return LaneSnapshot(
        key=None, params=params,
        opt=session.retrain.init_state(params),
        buffer={"x": np.zeros((0,), np.float32),
                "y": np.zeros((0,), np.int64),
                "capacity": session.hp.c_b, "rng_state": {}},
        rng_state={}, policy=None, lane_state=(), decision=None,
        eval_cursor=0.0, retrain_time=0.0, label_time=0.0,
        drift_events=0, records=[], timeline=[], clock=0.0)


@dataclasses.dataclass
class ManagerSpec:
    """Declarative front door for the manager tier, mirroring
    :class:`~repro_torch.core.fleet.FleetSpec`: one fleet spec for every shard
    plus the manager surface (shard count, placement policy and knobs,
    checkpointing, migration and its ledger cost, failure injection,
    recovery cost, and the overlapped-stepping knob ``parallel_shards``
    — worker-pool size, 0/1 = serial, bit-identical either way; see
    :class:`FleetManager`)."""

    fleet: FleetSpec
    n_shards: int = 2
    placement: object = "headroom"  # name, class, or ready instance
    placement_kwargs: Optional[dict] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    migration: bool = True
    migration_cooldown: int = 2
    migration_cost_s: float = 0.0
    failure_injector: Optional[FailureInjector] = None
    recovery_cost_s: float = 0.0
    parallel_shards: int = 0
    # Trace spine: ``True`` gives EVERY shard its own fresh recorder (one
    # per ``fleet.build()``), merged at the manager's round barrier into
    # ``FleetManager.trace``. Prefer True over a shared recorder instance
    # here — shards step concurrently under ``parallel_shards``.
    trace: object = None

    def build(self) -> FleetManager:
        fleet = self.fleet
        if self.trace is not None:
            fleet = dataclasses.replace(fleet, trace=self.trace)
        return FleetManager(
            fleet, n_shards=self.n_shards, placement=self.placement,
            placement_kwargs=self.placement_kwargs,
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_every=self.checkpoint_every,
            migration=self.migration,
            migration_cooldown=self.migration_cooldown,
            migration_cost_s=self.migration_cost_s,
            failure_injector=self.failure_injector,
            recovery_cost_s=self.recovery_cost_s,
            parallel_shards=self.parallel_shards)
