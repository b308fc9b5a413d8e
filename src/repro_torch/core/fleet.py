"""FleetSession — multi-camera fleet sessions on one spatially-shared array
(the JAX package's ``core/fleet.py`` ported).

DaCapo's deployment story (paper §2, §5) is an autonomous system serving
*several* camera feeds from one accelerator: every feed needs its own
inference timeline on the B-SA while labeling and retraining for all feeds
compete for the single T-SA. This module is the engine that turns N
independent :class:`~repro_torch.data.stream.DriftStream`s into one fleet
session:

* each stream gets its own **data-plane lane** — a
  :class:`~repro_torch.data.pipeline.FramePipeline` with per-stream
  speculation state, a per-stream score sink (its B-SA serving/accuracy
  timeline), a per-stream
  :class:`~repro_torch.core.sample_buffer.SampleBuffer`, student weights
  and optimizer state, and a per-stream
  :class:`~repro_torch.core.session.PhaseRecord` lane (``record.stream``
  carries the lane id);
* one **shared plan** per fleet phase: the
  :class:`~repro_torch.core.dispatch.KernelDispatcher` binds all N
  pipelines to a single :class:`~repro_torch.core.dispatch.PhasePlan`
  whose T-SA ledger is charged once for the fleet while each charge is
  also attributed to its lane (``plan.lane_time``);
* labeling bursts are **batched across streams** on the shared T-SA
  (:meth:`~repro_torch.core.kernel.LabelingKernel.label_fleet_async` via
  ``plan.dispatch_multi``): one microbatched pass labels the whole fleet's
  burst, and per-lane label handles split back out device-side;
* each phase executes ONE :class:`~repro_torch.core.decision.FleetDecision`:
  a :class:`~repro_torch.core.allocation.FleetAllocator` proportions the
  fleet's temporal budget across streams (uniform / round-robin /
  drift-weighted / isolated), while a pluggable
  :class:`~repro_torch.core.decision.FleetRowPolicy` resolves the N
  per-lane spatial requests into the ONE fleet-wide spatial plane the
  engine executes. Each lane keeps an ordinary per-stream
  :class:`~repro_torch.core.allocation.AllocationPolicy` underneath.

Degeneracy contract: a **1-stream fleet is bit-identical to**
:class:`~repro_torch.core.session.CLSession` — same records (including
per-phase ``t_tsa``/``t_bsa`` and speculation counters), same accuracy
timeline, same virtual clock: the fleet loop is the session loop
generalized over lanes, and every float accumulation it performs at N=1
replays the single-stream sequence.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.core.allocation import (
    AllocationDecision,
    CLHyperParams,
    FleetAllocator,
    PhaseFeedback,
)
from repro_torch.core.decision import FleetDecision
from repro_torch.core.sample_buffer import SampleBuffer
from repro_torch.core.session import (
    CLResult,
    CLSession,
    CLSystemSpec,
    PhaseObserver,
    PhaseRecord,
    _ScoreSink,
    flush_sinks_batched,
)
from repro_torch.data.pipeline import FramePipeline
from repro_torch.data.stream import DriftStream
from repro_torch.runtime.elastic import rehome_tree
from repro_torch.tree import tree_map


@dataclasses.dataclass
class _StreamLane:
    """Per-stream engine state: one camera's data plane + learning state."""

    index: int
    pipe: FramePipeline  # ownership is tracked by FleetSession.run
    buffer: SampleBuffer
    sink: _ScoreSink
    rng: np.random.Generator
    params: object  # this stream's student weights (master, fp32)
    opt: object
    serving: object  # quantized serving copy of ``params``
    decision: AllocationDecision
    keep_frac: float = 1.0
    eval_cursor: float = 0.0
    retrain_time: float = 0.0
    label_time: float = 0.0
    drift_events: int = 0
    records: List[PhaseRecord] = dataclasses.field(default_factory=list)
    # per-phase scratch
    spec_seen: Tuple[int, int] = (0, 0)
    acc_v: float = 1.0
    valid_h: object = None
    yv: object = None
    label_h: object = None
    pred_l_h: object = None
    x_l: object = None
    # manager-tier identity + migration carry-over
    key: object = None  # stable camera id across shards (None: anonymous)
    timeline_prefix: List = dataclasses.field(default_factory=list)
    # accuracy timeline accrued on previous shards, prepended at finalize


@dataclasses.dataclass
class LaneSnapshot:
    """A lane frozen at a phase boundary — the unit of migration and
    per-lane checkpointing in the manager tier.

    Everything a lane needs to resume *bit-identically* on another
    :class:`FleetSession` (same model/kernel configs): host (numpy) copies
    of the student weights and optimizer state, the :class:`SampleBuffer`
    state dict (samples + draw-RNG bit-generator state), the lane RNG's
    bit-generator state, a deep copy of the lane's live
    :class:`~repro_torch.core.allocation.AllocationPolicy` (its drift
    detector and online row state), the fleet-side lane state
    (:meth:`~repro_torch.core.allocation.FleetAllocator.lane_policy_state`),
    and the accounting carried into the next shard's records (cursor,
    times, records, accuracy timeline, the virtual clock at capture).
    """

    key: object
    params: object  # host (numpy) student tree
    opt: object  # host optimizer tree
    buffer: dict  # SampleBuffer.state_dict()
    rng_state: dict  # np bit-generator state
    policy: object  # deep-copied lane AllocationPolicy
    lane_state: tuple  # FleetAllocator.lane_policy_state(i)
    decision: object  # the lane's current AllocationDecision
    eval_cursor: float
    retrain_time: float
    label_time: float
    drift_events: int
    records: List[PhaseRecord]
    timeline: List  # accuracy timeline accrued so far
    clock: float  # virtual clock at capture (phase boundary)


@dataclasses.dataclass
class FleetResult:
    """One fleet run: per-stream :class:`CLResult` lanes + fleet ledger."""

    name: str
    streams: List[CLResult]
    fleet_avg_accuracy: float  # mean of the per-stream averages
    fleet_phase_log: List[dict]  # per-phase shared-T-SA/B-SA ledger
    drift_events: int  # total across streams

    @property
    def n_streams(self) -> int:
        return len(self.streams)


class FleetSession(CLSession):
    """Executes fleet allocation decisions phase-by-phase for N streams.

    Construction mirrors :class:`CLSession` (``device`` included: ``cuda``
    unless the caller asks for the CPU); ``allocator`` is either a ready
    :class:`FleetAllocator` or a per-stream policy (registry name / class /
    instance) that gets wrapped in one, with ``fleet_mode`` /
    ``fleet_budget_streams`` / ``fleet_kwargs`` configuring the wrapper.
    All streams share the student/teacher model pair and kernels but keep
    independent weights, buffers and drift state per lane.
    """

    def __init__(self, student_cfg: VisionConfig, teacher_cfg: VisionConfig,
                 hp: Optional[CLHyperParams] = None, estimator=None,
                 allocator="dacapo-spatiotemporal",
                 fleet_mode: str = "drift-weighted",
                 fleet_budget_streams: float = 1.0,
                 fleet_row_policy="resolve-max",
                 fleet_kwargs: Optional[dict] = None,
                 fleet_serve_batched: bool = False, **kwargs):
        hp = hp or CLHyperParams()
        if not isinstance(allocator, FleetAllocator):
            allocator = FleetAllocator(
                hp, policy=allocator, mode=fleet_mode,
                budget_streams=fleet_budget_streams,
                row_policy=fleet_row_policy, **(fleet_kwargs or {}))
        super().__init__(student_cfg, teacher_cfg, hp=hp,
                         estimator=estimator, allocator=allocator, **kwargs)
        self.fleet_allocator: FleetAllocator = self.allocator
        # Opt-in: serve every lane's queued score windows through ONE
        # vmapped B-SA program per phase (InferenceKernel.
        # predict_fleet_async) instead of one fused predict per lane.
        # Default OFF: the vmapped apply can differ from per-lane applies
        # in float ulps, and the degeneracy contract is per-lane numerics.
        self.fleet_serve_batched = fleet_serve_batched

    # ------------------------------------------------------------ fleet run
    def run(self, streams: Union[DriftStream, FramePipeline,
                                 Sequence[Union[DriftStream, FramePipeline]]],
            duration: Optional[float] = None,
            observers: Sequence[PhaseObserver] = ()) -> FleetResult:
        """Execute the fleet loop over ``streams`` — raw
        :class:`DriftStream`s (each wrapped in its own lane pipeline) or
        ready :class:`FramePipeline` handles, freely mixed. A single stream
        is a 1-lane fleet (bit-identical to :class:`CLSession`)."""
        run = self.open_run(streams, duration, observers)
        try:
            while run.step():
                pass
            return run.finalize()
        finally:
            run.close()

    def open_run(self, streams: Union[DriftStream, FramePipeline,
                                      Sequence[Union[DriftStream,
                                                     FramePipeline]], None]
                 = None,
                 duration: Optional[float] = None,
                 observers: Sequence[PhaseObserver] = (),
                 clock: float = 0.0) -> "FleetRun":
        """Open the fleet loop as a phase-steppable :class:`FleetRun` —
        the handle the manager tier drives: ``step()`` one phase at a
        time, with lane admission/migration/checkpointing between steps.
        ``streams`` may be ``None``/empty (an empty shard populated by
        ``attach_lane``, e.g. the fault-recovery restore path; requires an
        explicit ``duration``). ``run()`` is exactly open → step* →
        finalize → close."""
        streams = [] if streams is None else streams
        if isinstance(streams, (DriftStream, FramePipeline)):
            streams = [streams]
        pipes: List[FramePipeline] = []
        owned: List[FramePipeline] = []
        for s in streams:
            if isinstance(s, FramePipeline):
                pipes.append(s)
            else:
                pipe = FramePipeline(s, speculative=self.speculative_frames)
                pipes.append(pipe)
                owned.append(pipe)
        try:
            run = FleetRun(self, pipes, duration, observers, clock=clock)
        except Exception:
            for pipe in owned:
                pipe.close()
            raise
        run._owned = owned
        return run


class FleetRun:
    """One live fleet phase loop, opened phase-steppable.

    This is the engine loop of :meth:`FleetSession.run` hoisted into an
    object so the manager tier can interleave *membership changes* with
    phases: :meth:`step` executes exactly one fleet phase (one shared
    :class:`~repro_torch.core.dispatch.PhasePlan`), and between steps — at
    phase boundaries, the only points where no plan is in flight — lanes
    can be snapshotted (:meth:`snapshot_lane`), detached
    (:meth:`detach_lane`) and attached (:meth:`attach_lane`: fresh camera
    or :class:`LaneSnapshot` restore). A run executed as pure
    step-until-done is :meth:`FleetSession.run`.

    :meth:`step` reads and writes only this run's state — its session
    (own kernels, allocator, RNGs), its lanes, its pipelines — and, of
    process-wide state, only the locked kernel-stat counters and serving
    caches. Membership mutations (attach/detach/snapshot) happen between
    steps, single-threaded.
    """

    def __init__(self, session: FleetSession, pipes: List[FramePipeline],
                 duration: Optional[float] = None,
                 observers: Sequence[PhaseObserver] = (),
                 clock: float = 0.0):
        self.session = session
        hp = session.hp
        n = len(pipes)
        if duration is None:
            if not pipes:
                raise ValueError(
                    "an empty FleetRun needs an explicit duration")
            duration = min(p.duration for p in pipes)
        self.duration = duration
        self.observers = session._observers + list(observers)
        self.clock = clock
        self.done = False
        self.fleet_phase_log: List[dict] = []
        self._owned: List[FramePipeline] = []
        self._lane_seq = n  # monotonic rng-seed cursor across admissions
        if n == 0:
            session.fleet_allocator.begin_empty()
            self.fleet_dec: Optional[FleetDecision] = None
            self.decisions: List[AllocationDecision] = []
            self.lanes: List[_StreamLane] = []
            self._spatial = None
            return
        # One FleetDecision per phase: N per-lane temporal planes + ONE
        # fleet spatial plane (rows already resolved by the row policy).
        self.fleet_dec = session.fleet_allocator.initial_fleet_decision(n)
        self.decisions = list(self.fleet_dec.lane_decisions)
        self.lanes = [
            _StreamLane(
                index=i, pipe=pipe,
                buffer=SampleBuffer(hp.c_b, seed=3),
                sink=_ScoreSink(session.inference,
                                fuse=session.dispatcher.concurrent),
                rng=np.random.default_rng(session.seed + i),
                params=tree_map(torch.clone, session.student_params),
                opt=None, serving=None, decision=self.decisions[i])
            for i, pipe in enumerate(pipes)
        ]
        spatial = self.fleet_dec.spatial
        self._spatial = spatial
        for lane in self.lanes:
            lane.opt = session.retrain.init_state(lane.params)
            # The B-SA serves all N streams: per-stream sustainable frame
            # fraction divides its throughput by the fleet's aggregate fps.
            lane.keep_frac = session.inference.plan_keep_frac(spatial,
                                                              hp.fps * n)
            lane.serving = session.inference.serving_params(
                lane.params, spatial.precisions.inference)

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    def close(self) -> None:
        """Close the pipelines this run owns (wrapped from raw streams)."""
        for pipe in self._owned:
            pipe.close()
        self._owned = []

    # ------------------------------------------------------------- scoring
    def _score_lane_until(self, lane: _StreamLane, t_end: float, serving,
                          plan) -> None:
        """Queue lane-``i`` student-accuracy scoring on
        [lane.eval_cursor, t_end): that stream's B-SA serving program.
        The generalization of the session's ``score_until`` — same
        guard, same subsampling, same charge, per lane."""
        session = self.session
        if t_end <= lane.eval_cursor + 1e-9:
            return
        n_eval = max(1, int((t_end - lane.eval_cursor) * session.eval_fps))
        if plan is not None:
            x, y = plan.fetch(lane.eval_cursor, t_end,
                              max_frames=n_eval, lane=lane.index)
            plan.charge(
                "b_sa",
                len(x) * session.inference.plan_time_per_sample(
                    self._spatial),
                lane=lane.index, label="score", units=len(x))
        else:
            x, y = lane.pipe.frames(lane.eval_cursor, t_end,
                                    max_frames=n_eval)
        lane.sink.add(t_end, x, y, lane.keep_frac, serving)
        lane.eval_cursor = t_end

    # -------------------------------------------------------------- phases
    def step(self) -> bool:
        """Execute ONE fleet phase. Returns False (and marks the run done)
        when the virtual clock has reached the duration — including the
        mid-phase exit, where the phase's plan is finished early — or when
        the run has no lanes."""
        if self.done:
            return False
        if not self.lanes or self.clock >= self.duration:
            self.done = True
            return False
        session = self.session
        hp = session.hp
        duration = self.duration
        lanes = self.lanes
        n = len(lanes)
        pipes = [lane.pipe for lane in lanes]
        fleet_dec = self.fleet_dec
        decisions = self.decisions
        clock = self.clock

        phase_start = clock
        spatial = fleet_dec.spatial
        self._spatial = spatial
        temporal = fleet_dec.temporal
        r_tsa, r_bsa = spatial.rows_tsa, spatial.rows_bsa
        if spatial.refission:  # the fleet plane's re-fission intent
            session._repartition(r_bsa)
        for lane in lanes:
            lane.decision = decisions[lane.index]
            lane.keep_frac = session.inference.plan_keep_frac(
                spatial, hp.fps * n)
        # ---- Plan: one shared ledger for the fleet phase; the plan
        # consumes the fleet decision's per-lane views — rotating every
        # lane's speculation, pre-sized with its temporal budget. ----
        plan = session.dispatcher.begin_phase(
            clock, pipes, decisions=fleet_dec.per_lane(),
            fps=hp.fps if session.decision_aware_spec else None)
        for lane in lanes:
            lane.spec_seen = (lane.pipe.hits, lane.pipe.misses)
            lane.valid_h = lane.yv = None
            lane.acc_v = 1.0
            if temporal[lane.index].profile_cost_s:
                plan.charge("t_sa", temporal[lane.index].profile_cost_s,
                            lane=lane.index, label="profile")
        # -------- Retraining (Alg. 1 lines 4-7), lane by lane on the
        # shared T-SA chain --------
        for lane in lanes:
            t_lane = temporal[lane.index]
            if (len(lane.buffer) >= hp.sgd_batch
                    and t_lane.retrain_samples > 0):
                xt, yt, xv, yv = lane.buffer.get_data(
                    t_lane.retrain_samples, t_lane.valid_samples)
                fit_t0 = time.perf_counter() if plan.traced else 0.0
                lane.params, lane.opt, n_batches = session.retrain.fit(
                    lane.params, lane.opt, xt, yt, lane.rng,
                    epochs=t_lane.retrain_epochs)
                t_phase = n_batches * session.retrain.plan_time_per_batch(
                    spatial)
                plan.charge(
                    "t_sa", t_phase, lane=lane.index, label="retrain",
                    units=n_batches,
                    wall_s=(time.perf_counter() - fit_t0 if plan.traced
                            else 0.0))
                lane.retrain_time += t_phase
                lane.serving = session.inference.serving_params(
                    lane.params, spatial.precisions.inference)
                lane.yv = yv
                v_role = ("b_sa" if session.dispatcher.concurrent
                          else "t_sa")
                lane.valid_h = plan.dispatch(
                    v_role, "valid",
                    lambda s=lane.serving, v=xv:
                    session.inference.predict_async(s, v),
                    cost_s=len(xv) * session.inference.plan_time_per_sample(
                        spatial, role=v_role),
                    lane=lane.index, units=len(xv))
        for lane in lanes:
            self._score_lane_until(lane, min(plan.now(), duration),
                                   lane.serving, plan)
        if plan.now() >= duration:
            self.clock = plan.finish()
            self.done = True
            return False

        # -------- Labeling (lines 8-10): bursts fetched per lane, then
        # batched across the fleet on the shared T-SA --------
        for lane in lanes:
            if temporal[lane.index].reset_buffer:
                lane.buffer.reset()  # line 12
                lane.drift_events += 1
        t_lab0 = plan.now()
        for lane in lanes:
            n_label = temporal[lane.index].total_label_samples
            lane.x_l, _ = plan.fetch(t_lab0, t_lab0 + n_label / hp.fps,
                                     max_frames=n_label,
                                     lane=lane.index, tag="label")
        # ONE batched device program labels the whole fleet's burst at
        # the fleet spatial plane's labeling precision (cross-stream
        # microbatches on the shared T-SA).
        costs = [
            temporal[lane.index].total_label_samples
            * session.labeling.plan_time_per_sample(spatial)
            for lane in lanes]
        t_run = plan.now()
        handles = plan.dispatch_multi(
            "t_sa", "label",
            lambda: session.labeling.label_fleet_async(
                session.teacher_params, [ln.x_l for ln in lanes],
                spatial.precisions.labeling,
                microbatch=session._label_microbatch),
            costs=costs, lanes=[lane.index for lane in lanes],
            units=[float(temporal[lane.index].total_label_samples)
                   for lane in lanes])
        for lane, handle, cost in zip(lanes, handles, costs):
            # Replay the plan's serial accumulation so each lane's
            # label_time reproduces the single-stream float pattern
            # ((t + c) - t): the 1-stream degeneracy contract.
            t_next = t_run + cost
            lane.label_time += t_next - t_run
            t_run = t_next
            lane.label_h = handle
        for lane in lanes:
            lane.pred_l_h = plan.dispatch(
                "b_sa", "acc_label",
                lambda s=lane.serving, x=lane.x_l:
                session.inference.predict_async(s, x),
                cost_s=len(lane.x_l)
                * session.inference.plan_time_per_sample(spatial),
                lane=lane.index, units=len(lane.x_l))
        for lane in lanes:
            self._score_lane_until(lane, min(plan.now(), duration),
                                   lane.serving, plan)

        # Fixed-window pacing, per lane temporal plane (the pacing
        # floor is the max boundary any paced lane declares).
        for lane in lanes:
            if temporal[lane.index].pace_window_s:
                w = temporal[lane.index].pace_window_s
                next_boundary = (int(phase_start / w) + 1) * w
                if plan.now() < next_boundary:
                    self._score_lane_until(
                        lane, min(next_boundary, duration),
                        lane.serving, plan)
                    plan.pad_to(next_boundary)

        # ---- Collect: the fleet phase-end barrier. ----
        clock = plan.finish()
        self.clock = clock
        serve_batched = session.fleet_serve_batched
        for lane in lanes:
            self._score_lane_until(lane, min(clock, duration),
                                   lane.serving, None)
            if lane.valid_h is not None:
                lane.acc_v = float(
                    (lane.valid_h.collect() == lane.yv).mean())
            y_l = lane.label_h.collect()
            lane.acc_l = float(
                (lane.pred_l_h.collect() == y_l).mean())
            lane.buffer.update(lane.x_l, y_l)  # line 14
            if not serve_batched:
                lane.sink.flush()
        if serve_batched:
            # One vmapped B-SA program serves every lane's queued
            # score windows (ledger already charged per window).
            flush_sinks_batched(session.inference,
                                [ln.sink for ln in lanes])

        # -------- Next decisions (lines 11-13), fleet-proportioned ----
        # Per-lane engine-side drift verdicts: computed once here (by
        # each lane policy's detector) and handed down on the feedback
        # — the deduped source the lane policies, the drift-weighted
        # split AND the fleet row policy all read.
        feedbacks = [
            PhaseFeedback(acc_valid=lane.acc_v, acc_label=lane.acc_l,
                          t=clock, phase_start=phase_start,
                          retrain_time=lane.retrain_time,
                          label_time=lane.label_time,
                          drifted=session.fleet_allocator.policies[
                              lane.index].observe_drift(
                                  lane.acc_l, lane.acc_v, clock))
            for lane in lanes]
        next_fleet = session.fleet_allocator.next_fleet_decision(feedbacks)
        next_decisions = list(next_fleet.lane_decisions)
        self.fleet_phase_log.append({
            "t": clock, "phase_start": phase_start,
            "t_tsa": plan.t_tsa, "t_bsa": plan.t_bsa,
            "rows_tsa": r_tsa, "rows_bsa": r_bsa,
            "per_stream_t_tsa": [plan.lane_time("t_sa", lane.index)
                                 for lane in lanes],
            "per_stream_t_bsa": [plan.lane_time("b_sa", lane.index)
                                 for lane in lanes],
        })
        for lane in lanes:
            record = PhaseRecord(
                index=len(lane.records), t=clock, acc_valid=lane.acc_v,
                acc_label=lane.acc_l,
                drift=next_decisions[lane.index].reset_buffer,
                retrain_time=lane.retrain_time,
                label_time=lane.label_time,
                decision=lane.decision,
                next_decision=next_decisions[lane.index],
                phase_start=phase_start,
                t_tsa=plan.lane_time("t_sa", lane.index),
                t_bsa=plan.lane_time("b_sa", lane.index),
                spec_hits=lane.pipe.hits - lane.spec_seen[0],
                spec_misses=lane.pipe.misses - lane.spec_seen[1],
                stream=lane.index)
            lane.records.append(record)
            for obs in self.observers:
                obs(record)
        self.fleet_dec = next_fleet
        self.decisions = next_decisions
        return True

    def finalize(self) -> FleetResult:
        """Score every lane to the duration and assemble the
        :class:`FleetResult` — the tail of :meth:`FleetSession.run`.
        Migrated lanes prepend the accuracy timeline they accrued on
        previous shards."""
        session = self.session
        results = []
        for lane in self.lanes:
            self._score_lane_until(lane, self.duration, lane.serving, None)
        if session.fleet_serve_batched:
            flush_sinks_batched(session.inference,
                                [ln.sink for ln in self.lanes])
        for lane in self.lanes:
            acc_timeline = lane.timeline_prefix + lane.sink.timeline()
            accs = [a for _, a in acc_timeline]
            results.append(CLResult(
                name=f"{session.fleet_allocator.name}[{lane.index}]",
                accuracy_timeline=acc_timeline,
                phase_log=[r.as_log_entry() for r in lane.records],
                avg_accuracy=float(np.mean(accs)) if accs else 0.0,
                retrain_time=lane.retrain_time,
                label_time=lane.label_time,
                drift_events=lane.drift_events,
                records=lane.records,
            ))
        return FleetResult(
            name=session.fleet_allocator.name,
            streams=results,
            fleet_avg_accuracy=(float(
                np.mean([r.avg_accuracy for r in results]))
                if results else 0.0),
            fleet_phase_log=self.fleet_phase_log,
            drift_events=sum(r.drift_events for r in results),
        )

    # -------------------------------------------- membership (manager tier)
    # All membership operations happen BETWEEN steps — at phase boundaries,
    # where no PhasePlan is in flight and every lane's device work has been
    # collected — so a snapshot is a consistent cut of the lane.

    def snapshot_lane(self, index: int) -> LaneSnapshot:
        """Freeze lane ``index`` at the current phase boundary. Side-effect
        free on the live lane: params/opt are host-copied, RNG/buffer
        states and the lane policy deep-copied — continuing the run does
        not mutate the snapshot, which is what makes periodic per-lane
        checkpointing safe."""
        lane = self.lanes[index]
        alloc = self.session.fleet_allocator

        def host(tree):
            return tree_map(lambda x: x.detach().cpu().numpy().copy(), tree)

        return LaneSnapshot(
            key=lane.key,
            params=host(lane.params),
            opt=host(lane.opt),
            buffer=lane.buffer.state_dict(),
            rng_state=copy.deepcopy(lane.rng.bit_generator.state),
            policy=copy.deepcopy(alloc.policies[index]),
            lane_state=copy.deepcopy(alloc.lane_policy_state(index)),
            decision=lane.decision,
            eval_cursor=lane.eval_cursor,
            retrain_time=lane.retrain_time,
            label_time=lane.label_time,
            drift_events=lane.drift_events,
            records=list(lane.records),
            timeline=lane.timeline_prefix + lane.sink.timeline(),
            clock=self.clock,
        )

    def attach_lane(self, source: Union[DriftStream, FramePipeline],
                    key: object = None,
                    snapshot: Optional[LaneSnapshot] = None,
                    own: Optional[bool] = None) -> _StreamLane:
        """Admit a lane at the current phase boundary — a fresh camera
        (``snapshot=None``: new lane from the session's pretrained
        student, scoring from the current clock) or a
        :class:`LaneSnapshot` restore (migration / fault recovery: the
        lane resumes with the snapshot's weights, buffer, RNG and policy
        state). Raw streams are wrapped in an owned pipeline; pass
        ``own=True`` to hand over an existing pipeline's ownership too."""
        session = self.session
        hp = session.hp
        alloc = session.fleet_allocator
        if isinstance(source, FramePipeline):
            pipe = source
            if own:
                self._owned.append(pipe)
        else:
            pipe = FramePipeline(source,
                                 speculative=session.speculative_frames)
            self._owned.append(pipe)
        index = len(self.lanes)
        sink = _ScoreSink(session.inference,
                          fuse=session.dispatcher.concurrent)
        if snapshot is None:
            alloc.admit_lane()
            lane = _StreamLane(
                index=index, pipe=pipe,
                buffer=SampleBuffer(hp.c_b, seed=3), sink=sink,
                rng=np.random.default_rng(session.seed + self._lane_seq),
                params=tree_map(torch.clone, session.student_params),
                opt=None, serving=None, decision=None, key=key)
            lane.opt = session.retrain.init_state(lane.params)
            lane.eval_cursor = self.clock  # score from the join point
        else:
            alloc.admit_lane(policy=copy.deepcopy(snapshot.policy),
                             lane_state=copy.deepcopy(snapshot.lane_state))
            buffer = SampleBuffer(hp.c_b, seed=3)
            buffer.load_state_dict(snapshot.buffer)
            rng = np.random.default_rng(0)
            rng.bit_generator.state = copy.deepcopy(snapshot.rng_state)
            lane = _StreamLane(
                index=index, pipe=pipe, buffer=buffer, sink=sink, rng=rng,
                params=rehome_tree(snapshot.params, device=session.device),
                opt=rehome_tree(snapshot.opt, device=session.device),
                serving=None, decision=snapshot.decision,
                key=snapshot.key if key is None else key)
            lane.eval_cursor = snapshot.eval_cursor
            lane.retrain_time = snapshot.retrain_time
            lane.label_time = snapshot.label_time
            lane.drift_events = snapshot.drift_events
            lane.records = list(snapshot.records)
            lane.timeline_prefix = list(snapshot.timeline)
        self._lane_seq += 1
        self.lanes.append(lane)
        self._refresh_decisions()
        spatial = self.fleet_dec.spatial
        if self._spatial is None:
            self._spatial = spatial
        lane.keep_frac = session.inference.plan_keep_frac(
            spatial, hp.fps * len(self.lanes))
        lane.serving = session.inference.serving_params(
            lane.params, spatial.precisions.inference)
        if lane.decision is None:
            lane.decision = self.decisions[lane.index]
        if self.done and self.clock < self.duration:
            self.done = False  # an emptied run can be repopulated
        return lane

    def detach_lane(self, index: int) -> Tuple[LaneSnapshot, FramePipeline]:
        """Remove lane ``index`` at the current phase boundary, returning
        its :class:`LaneSnapshot` and its pipeline (which keeps the lane's
        speculation state — hand both to ``attach_lane`` on the target
        shard for a bit-identical resume). Surviving lanes are re-indexed
        compactly; ownership of the pipe transfers to the caller."""
        snap = self.snapshot_lane(index)
        lane = self.lanes.pop(index)
        self.session.fleet_allocator.remove_lane(index)
        if lane.pipe in self._owned:
            self._owned.remove(lane.pipe)
        for j, ln in enumerate(self.lanes):
            ln.index = j
        if self.lanes:
            self._refresh_decisions()
        else:
            self.fleet_dec = None
            self.decisions = []
        return snap, lane.pipe

    def _refresh_decisions(self) -> None:
        """Re-emit the fleet decision for the current membership (see
        :meth:`~repro_torch.core.allocation.FleetAllocator
        .rebuild_fleet_decision`)."""
        self.fleet_dec = \
            self.session.fleet_allocator.rebuild_fleet_decision()
        self.decisions = list(self.fleet_dec.lane_decisions)
        for lane, d in zip(self.lanes, self.decisions):
            lane.decision = d


@dataclasses.dataclass
class FleetSpec(CLSystemSpec):
    """Declarative front door for fleet sessions: every
    :class:`~repro_torch.core.session.CLSystemSpec` knob (inherited, through
    ``_session_kwargs``; ``device`` defaults to ``cuda``) plus the fleet
    surface: the per-stream ``allocator`` is wrapped in a
    :class:`FleetAllocator` with ``fleet_mode`` / ``budget_streams`` /
    ``row_policy`` (the :class:`~repro_torch.core.decision.FleetRowPolicy`
    resolving the fleet's per-phase spatial plane) / ``fleet_kwargs``.

        fleet = FleetSpec(student=RESNET18, teacher=WIDERESNET50,
                          row_policy="drift-surge").build()
        result = fleet.run([stream_a, stream_b, stream_c])"""

    fleet_mode: str = "drift-weighted"
    budget_streams: float = 1.0
    row_policy: object = "resolve-max"  # name, class, or ready instance
    fleet_kwargs: Optional[dict] = None
    serve_batched: bool = False  # one vmapped B-SA program per phase

    def build(self) -> FleetSession:
        return FleetSession(
            fleet_mode=self.fleet_mode,
            fleet_budget_streams=self.budget_streams,
            fleet_row_policy=self.row_policy,
            fleet_kwargs=self.fleet_kwargs,
            fleet_serve_batched=self.serve_batched,
            **self._session_kwargs(),
        )
