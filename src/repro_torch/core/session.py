"""CLSession — the continuous-learning engine (paper Fig. 4 + Algorithm 1),
ported from the JAX package's ``core/session.py``.

As in the reference, the *virtual clock* advances by phase durations the
performance estimator computes on the FULL model configs (Table III /
Table IV hardware), while the *learning dynamics* (inference, labeling,
retraining, accuracy) run on reduced same-family twins over the synthetic
drift stream — here in PyTorch, on the card unless the caller passes
``device="cpu"``.

The engine is policy-free: it executes the two-plane
:class:`~repro_torch.core.decision.Decision` the bound
:class:`~repro_torch.core.allocation.AllocationPolicy` emits, through the
dispatch layer (core/dispatch.py: programs issued asynchronously, host
values collected at the phase-end barrier) and the data plane
(data/pipeline.py), and reports ``PhaseFeedback`` back. When constructed
with a ``mesh`` (a :class:`~repro_torch.core.partition.RowMesh`), the
engine fissions it into T-SA / B-SA sub-meshes with
:func:`~repro_torch.core.partition.partition_mesh` and binds each kernel
to its sub-accelerator, re-partitioning online when a decision changes the
split; on a single device the partition degenerates to time-sharing.
With ``trace=`` the dispatch layer records every program and charge
(core/trace.py), for replay and calibration (core/replay.py).

Not ported yet: the fleet's score sinks (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.core import mx as mx_lib
from repro_torch.core.allocation import (
    AllocationDecision,
    AllocationPolicy,
    CLHyperParams,
    PhaseFeedback,
    make_allocator,
)
from repro_torch.core.decision import SpatialPlan, as_decision
from repro_torch.core.dispatch import KernelDispatcher, PhasePlan, to_host
from repro_torch.core.estimator import DaCapoEstimator
from repro_torch.core.kernel import (
    InferenceKernel,
    LabelingKernel,
    RetrainKernel,
    sgd_momentum_step,
)
from repro_torch.core.partition import (
    SpatialPartition,
    partition_mesh,
    single_device_partition,
)
from repro_torch.core.sample_buffer import SampleBuffer
from repro_torch.core.trace import TraceRecorder
from repro_torch.data.pipeline import FramePipeline
from repro_torch.data.stream import DriftStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import make_vision_model
from repro_torch.tree import tree_map


@dataclasses.dataclass
class CLResult:
    name: str
    accuracy_timeline: List[Tuple[float, float]]  # (t, acc on [t-dt, t))
    phase_log: List[dict]
    avg_accuracy: float
    retrain_time: float
    label_time: float
    drift_events: int
    records: List["PhaseRecord"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class PhaseRecord:
    """Structured per-phase metrics delivered to observers."""

    index: int
    t: float  # virtual clock at phase end
    acc_valid: float
    acc_label: float
    drift: bool  # drift detected at this phase boundary
    retrain_time: float  # cumulative
    label_time: float  # cumulative
    decision: AllocationDecision  # the decision this phase executed
    next_decision: AllocationDecision  # what the policy chose for the next
    phase_start: float = 0.0  # virtual clock at phase start
    t_tsa: float = 0.0  # T-SA kernel time this phase (retrain+valid+label)
    t_bsa: float = 0.0  # B-SA kernel time this phase (serving-side programs)
    spec_hits: int = 0  # frame windows served from speculative prefetch
    spec_misses: int = 0  # frame windows synthesized inline (reconcile miss)

    def as_log_entry(self) -> dict:
        """``phase_log`` dict layout."""
        return {"t": self.t, "acc_valid": self.acc_valid,
                "acc_label": self.acc_label, "drift": self.drift,
                "retrain_time": self.retrain_time,
                "label_time": self.label_time,
                "phase_start": self.phase_start,
                "t_tsa": self.t_tsa, "t_bsa": self.t_bsa,
                "spec_hits": self.spec_hits,
                "spec_misses": self.spec_misses}


PhaseObserver = Callable[[PhaseRecord], None]


class _ScoreSink:
    """Deferred accuracy timeline: the B-SA serving-side scoring stream.
    Without fusion each window is dispatched at once as its own async
    predict; with ``fuse`` (concurrent dispatch) windows accumulate and
    ``flush`` issues ONE batched predict. ``timeline`` is the only point
    that copies predictions to the host."""

    def __init__(self, kernel: InferenceKernel, fuse: bool):
        self.kernel = kernel
        self.fuse = fuse
        self._pending: List[tuple] = []  # (t_end, x, y, keep_frac)
        self._params = None  # serving params of the pending windows
        self._entries: List[tuple] = []  # (t_end, pred_dev, y, keep_frac)

    def add(self, t_end: float, x, y, keep_frac: float, params) -> None:
        if not self.fuse:
            pred = self.kernel.predict_async(params, x)
            self._entries.append((t_end, pred, y, keep_frac))
            return
        if self._pending and self._params is not params:
            self.flush()  # serving params changed mid-queue
        self._params = params
        self._pending.append((t_end, x, y, keep_frac))

    def flush(self) -> None:
        """Dispatch queued windows (one fused forward) — still async."""
        if not self._pending:
            return
        preds = self.kernel.predict_batched(
            self._params, [x for _, x, _, _ in self._pending])
        for (t_end, _x, y, kf), pred in zip(self._pending, preds):
            self._entries.append((t_end, pred, y, kf))
        self._pending.clear()

    def timeline(self) -> List[Tuple[float, float]]:
        """Collect: materialize every queued prediction into (t, acc)."""
        self.flush()
        return [(t_end, float((to_host(pred) == y).mean()) * kf)
                for t_end, pred, y, kf in self._entries]


class CLSession:
    """Executes allocation decisions phase-by-phase against the kernels."""

    def __init__(
        self,
        student_cfg: VisionConfig,
        teacher_cfg: VisionConfig,
        hp: Optional[CLHyperParams] = None,
        estimator=None,
        allocator: Union[str, AllocationPolicy] = "dacapo-spatiotemporal",
        precision_policy: mx_lib.PrecisionPolicy = mx_lib.DEFAULT_POLICY,
        apply_mx_numerics: bool = True,
        seed: int = 0,
        eval_fps: float = 2.0,
        mesh=None,
        observers: Sequence[PhaseObserver] = (),
        dispatch: str = "sequential",
        label_microbatch: Optional[int] = None,
        speculative_frames: Optional[bool] = None,
        decision_aware_spec: bool = True,
        trace: Union[None, bool, TraceRecorder] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.hp = hp or CLHyperParams()
        self.estimator = estimator or DaCapoEstimator()
        self.policy = precision_policy
        self.apply_mx = apply_mx_numerics
        self.eval_fps = eval_fps  # accuracy-scoring subsample rate
        self.allocator = make_allocator(allocator, self.hp, precision_policy)
        # Trace spine (core/trace.py): ``trace=None`` keeps recording off
        # unless the bound policy declares ``needs_trace`` (dacapo-replay);
        # ``True`` makes a fresh recorder; a ready TraceRecorder is shared
        # as it is. An empty recorder has len() 0, so test against None.
        if trace is None and getattr(self.allocator, "needs_trace", False):
            trace = True
        if trace is True:
            trace = TraceRecorder()
        elif trace is False:
            trace = None
        self.dispatcher = KernelDispatcher(dispatch, recorder=trace)
        if trace is not None:
            self.allocator.attach_trace(trace)
        # Speculative frame prefetch follows the dispatch mode by default.
        if speculative_frames is None:
            speculative_frames = self.dispatcher.concurrent
        self.speculative_frames = speculative_frames
        self.decision_aware_spec = decision_aware_spec
        # Microbatched labeling: one call by default; concurrent mode
        # chunks big bursts unless overridden (0 disables it in either).
        if label_microbatch is None:
            self._label_microbatch = (64 if self.dispatcher.concurrent
                                      else None)
        else:
            self._label_microbatch = label_microbatch or None
        self.full_student, self.full_teacher = student_cfg, teacher_cfg
        self.student_cfg = student_cfg.reduced()
        self.teacher_cfg = teacher_cfg.reduced()
        self.student = make_vision_model(self.student_cfg, self.device)
        self.teacher = make_vision_model(self.teacher_cfg, self.device)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._observers: List[PhaseObserver] = list(observers)

        # The session's precision policy is authoritative, also for ready
        # policy instances.
        self.allocator.precision = precision_policy
        self.allocator.bind(self.estimator, self.full_student)

        # Offline spatial allocation (Alg. 1 lines 1-2).
        self.r_tsa, self.r_bsa = self.allocator.rows

        # The three kernels (Fig. 4), each owning its forward and cost.
        self.inference = InferenceKernel(
            self.student, self.full_student, self.estimator, self.apply_mx,
            self.device)
        self.labeling = LabelingKernel(
            self.teacher, self.full_teacher, self.estimator, self.apply_mx,
            self.device)
        self.retrain = RetrainKernel(
            self.student, self.full_student, self.estimator, self.hp,
            self.device)
        self.kernels = (self.inference, self.labeling, self.retrain)
        # Retraining supersedes the student tree: drop its serving copy
        # from the inference kernel's cache (the teacher never changes).
        self.retrain.invalidates = (self.inference.serving_cache,)

        # Spatial partition: fission the mesh if one is given.
        self.mesh = mesh
        self._mesh_rows_bsa: Optional[int] = None
        self.partition: SpatialPartition = single_device_partition()
        self._repartition(self.r_bsa)

    # --------------------------------------------------------------- mesh
    def _mesh_split(self, rows_bsa: int) -> int:
        """Map the estimator's row split onto the mesh's leading axis. A
        single-row mesh cannot be fissioned: 0, so that `_repartition`
        time-shares (the paper's R=0 fallback)."""
        n_rows = self.mesh.devices.shape[0]
        if n_rows < 2:
            return 0
        frac = rows_bsa / max(1, self.estimator.total_rows)
        return max(1, min(n_rows - 1, round(n_rows * frac)))

    def _repartition(self, rows_bsa: int) -> None:
        """(Re)fission the mesh for a row split and bind the kernels to the
        sub-meshes. Without a mesh the partition stays time-shared; an
        unchanged split leaves the current partition untouched."""
        if self.mesh is None:
            for k in self.kernels:
                k.bind_partition(self.partition)
            return
        want = self._mesh_split(rows_bsa)
        if want == self._mesh_rows_bsa:
            return
        self._mesh_rows_bsa = want
        self.partition = (single_device_partition() if want == 0
                          else partition_mesh(self.mesh, want))
        for k in self.kernels:
            k.bind_partition(self.partition)

    # ---------------------------------------------------------- observers
    def add_observer(self, observer: PhaseObserver) -> None:
        self._observers.append(observer)

    # --------------------------------------------------------- pretraining
    def pretrain(self, stream: DriftStream, teacher_steps: int = 300,
                 student_steps: int = 80, batch: int = 64):
        """Teacher: pretrained across the whole attribute space (general).
        Student: narrow slice only (first segment's context) -> must adapt."""
        t_params = pretrain_model(self.teacher, stream, teacher_steps, batch,
                                  rng=self.rng)
        s_params = pretrain_model(self.student, stream, student_steps, batch,
                                  rng=self.rng, segments=stream.segments[:1],
                                  seed=8)
        self.set_pretrained(t_params, s_params)

    def set_pretrained(self, teacher_params, student_params):
        """Install (shared) pretrained weights on the session's device; the
        student tree is copied, since retraining replaces it."""
        self.teacher_params = tree_map(lambda p: p.to(self.device),
                                       teacher_params)
        self.student_params = tree_map(lambda p: p.to(self.device).clone(),
                                       student_params)
        self._opt = self.retrain.init_state(self.student_params)

    # ------------------------------------------------------------ main loop
    def _resolve_spatial(self, decision) -> SpatialPlan:
        """The decision's spatial plane with concrete rows."""
        return as_decision(decision).spatial.resolve(
            self.r_tsa, self.r_bsa, self.estimator.total_rows)

    def run(self, stream: Union[DriftStream, FramePipeline],
            duration: Optional[float] = None,
            observers: Sequence[PhaseObserver] = ()) -> CLResult:
        """Execute the continuous-learning loop over ``stream`` — a raw
        :class:`DriftStream` (wrapped in the session's own
        :class:`FramePipeline`) or a ready pipeline handle."""
        if isinstance(stream, FramePipeline):
            pipe, own_pipe = stream, False
        else:
            pipe = FramePipeline(stream, speculative=self.speculative_frames)
            own_pipe = True
        try:
            return self._run(pipe, duration, observers)
        finally:
            if own_pipe:
                pipe.close()

    def _run(self, pipe: FramePipeline, duration: Optional[float],
             observers: Sequence[PhaseObserver]) -> CLResult:
        hp = self.hp
        duration = duration or pipe.duration
        buffer = SampleBuffer(hp.c_b, seed=3)
        observers = self._observers + list(observers)
        raw = self.allocator.initial_decision()
        dec = as_decision(raw)

        spatial = self._resolve_spatial(dec)
        keep_frac = self.inference.plan_keep_frac(spatial, hp.fps)
        serving = self.inference.serving_params(
            self.student_params, spatial.precisions.inference)
        clock = 0.0
        eval_cursor = 0.0
        sink = _ScoreSink(self.inference, fuse=self.dispatcher.concurrent)
        records: List[PhaseRecord] = []
        retrain_time = label_time = 0.0
        drift_events = 0

        def score_until(t_end: float, serving_params,
                        plan: Optional[PhasePlan]):
            """Queue student-accuracy scoring on [eval_cursor, t_end): the
            B-SA serving-side program of the phase."""
            nonlocal eval_cursor
            if t_end <= eval_cursor + 1e-9:
                return
            n_eval = max(1, int((t_end - eval_cursor) * self.eval_fps))
            x, y = (plan.fetch(eval_cursor, t_end, max_frames=n_eval)
                    if plan is not None
                    else pipe.frames(eval_cursor, t_end, max_frames=n_eval))
            if plan is not None:
                plan.charge("b_sa", len(x)
                            * self.inference.plan_time_per_sample(spatial),
                            label="score", units=len(x))
            sink.add(t_end, x, y, keep_frac, serving_params)
            eval_cursor = t_end

        while clock < duration:
            phase_start = clock
            spatial = self._resolve_spatial(dec)
            temporal = dec.temporal
            prec = spatial.precisions
            if spatial.refission:  # the plane's mesh re-fission intent
                self._repartition(spatial.rows_bsa)
            keep_frac = self.inference.plan_keep_frac(spatial, hp.fps)
            plan = self.dispatcher.begin_phase(
                clock, pipe, decision=dec,
                fps=hp.fps if self.decision_aware_spec else None)
            spec_seen = (pipe.hits, pipe.misses)
            valid_h = xv = yv = None
            if temporal.profile_cost_s:
                plan.charge("t_sa", temporal.profile_cost_s, label="profile")
            # ---------------- Retraining (Alg. 1 lines 4-7) ----------------
            acc_v = 1.0
            if len(buffer) >= hp.sgd_batch and temporal.retrain_samples > 0:
                xt, yt, xv, yv = buffer.get_data(temporal.retrain_samples,
                                                 temporal.valid_samples)
                fit_t0 = time.perf_counter() if plan.traced else 0.0
                self.student_params, self._opt, n_batches = self.retrain.fit(
                    self.student_params, self._opt, xt, yt, self.rng,
                    epochs=temporal.retrain_epochs)
                t_phase = n_batches * self.retrain.plan_time_per_batch(
                    spatial)
                plan.charge(
                    "t_sa", t_phase, label="retrain", units=n_batches,
                    wall_s=(time.perf_counter() - fit_t0 if plan.traced
                            else 0.0))
                retrain_time += t_phase
                # UpdateWeight + Valid (lines 6-7), dispatched async;
                # sequential charges validation on the T-SA chain,
                # concurrent on the B-SA where the inference kernel lives.
                serving = self.inference.serving_params(self.student_params,
                                                        prec.inference)
                v_role = ("b_sa" if self.dispatcher.concurrent else "t_sa")
                valid_h = plan.dispatch(
                    v_role, "valid",
                    lambda s=serving, v=xv: self.inference.predict_async(s, v),
                    cost_s=len(xv) * self.inference.plan_time_per_sample(
                        spatial, role=v_role),
                    units=len(xv))
            score_until(min(plan.now(), duration), serving, plan)
            if plan.now() >= duration:
                clock = plan.finish()
                break

            # ---------------- Labeling (lines 8-10) ------------------------
            n_label = temporal.total_label_samples
            if temporal.reset_buffer:
                buffer.reset()  # line 12
                drift_events += 1
            t_lab0 = plan.now()
            x_l, _y_true = plan.fetch(t_lab0, t_lab0 + n_label / hp.fps,
                                      max_frames=n_label, tag="label")
            label_h = plan.dispatch(
                "t_sa", "label",
                lambda: self.labeling.label_async(
                    self.teacher_params, x_l, prec.labeling,
                    microbatch=self._label_microbatch),
                cost_s=n_label * self.labeling.plan_time_per_sample(spatial),
                units=n_label)
            label_time += plan.now() - t_lab0
            pred_l_h = plan.dispatch(
                "b_sa", "acc_label",
                lambda: self.inference.predict_async(serving, x_l),
                cost_s=len(x_l) * self.inference.plan_time_per_sample(
                    spatial),
                units=len(x_l))
            score_until(min(plan.now(), duration), serving, plan)

            # Fixed-window pacing, declared by the temporal plane.
            if temporal.pace_window_s:
                w = temporal.pace_window_s
                next_boundary = (int(phase_start / w) + 1) * w
                if plan.now() < next_boundary:
                    score_until(min(next_boundary, duration), serving, plan)
                    plan.pad_to(next_boundary)

            # ---- Collect: the phase-end barrier — the only host sync. ----
            clock = plan.finish()
            # Concurrent mode: score the B-SA tail past the T-SA clock under
            # THIS phase's serving params (sequential: a no-op).
            score_until(min(clock, duration), serving, None)
            if valid_h is not None:
                acc_v = float((valid_h.collect() == yv).mean())
            y_l = label_h.collect()
            acc_l = float((pred_l_h.collect() == y_l).mean())
            buffer.update(x_l, y_l)  # line 14
            sink.flush()  # issue fused scoring before serving params change

            # ---------------- Next decision (lines 11-13) ------------------
            drifted = self.allocator.observe_drift(acc_l, acc_v, clock)
            feedback = PhaseFeedback(
                acc_valid=acc_v, acc_label=acc_l, t=clock,
                phase_start=phase_start, retrain_time=retrain_time,
                label_time=label_time, drifted=drifted)
            next_raw = self.allocator.next_decision(feedback)
            next_dec = as_decision(next_raw)
            record = PhaseRecord(
                index=len(records), t=clock, acc_valid=acc_v,
                acc_label=acc_l, drift=next_dec.temporal.reset_buffer,
                retrain_time=retrain_time, label_time=label_time,
                decision=raw, next_decision=next_raw,
                phase_start=phase_start, t_tsa=plan.t_tsa, t_bsa=plan.t_bsa,
                spec_hits=pipe.hits - spec_seen[0],
                spec_misses=pipe.misses - spec_seen[1])
            records.append(record)
            for obs in observers:
                obs(record)
            raw, dec = next_raw, next_dec

        score_until(duration, serving, None)
        acc_timeline = sink.timeline()
        accs = [a for _, a in acc_timeline]
        return CLResult(
            name=self.allocator.name,
            accuracy_timeline=acc_timeline,
            phase_log=[r.as_log_entry() for r in records],
            avg_accuracy=float(np.mean(accs)) if accs else 0.0,
            retrain_time=retrain_time,
            label_time=label_time,
            drift_events=drift_events,
            records=records,
        )


@dataclasses.dataclass
class CLSystemSpec:
    """Declarative front door: describe a CL system, then ``build()`` it.

    ``student``/``teacher`` are the FULL paper configs (Table III); the
    session derives the reduced twins itself. ``device`` defaults to
    ``cuda`` (building raises without a card); tests pass ``"cpu"``.

        session = CLSystemSpec(student=RESNET18, teacher=WIDERESNET50,
                               allocator="dacapo-spatiotemporal").build()
    """

    student: Optional[VisionConfig] = None
    teacher: Optional[VisionConfig] = None
    allocator: Union[str, AllocationPolicy] = "dacapo-spatiotemporal"
    estimator: object = None  # instance or zero-arg factory
    policy: mx_lib.PrecisionPolicy = mx_lib.DEFAULT_POLICY
    hp: Optional[CLHyperParams] = None
    apply_mx: bool = True
    seed: int = 0
    eval_fps: float = 2.0
    mesh: object = None  # a RowMesh to fission into T-SA / B-SA
    dispatch: str = "sequential"  # see core/dispatch.py for the semantics
    label_microbatch: Optional[int] = None
    # Speculative frame prefetch; None = follow the dispatch mode.
    speculative_frames: Optional[bool] = None
    # Pre-size speculated labeling bursts with the next decision's budget.
    decision_aware_spec: bool = True
    # Trace spine: None = off (bit-identical), True = fresh TraceRecorder,
    # or a ready TraceRecorder instance to share. See core/trace.py.
    trace: Union[None, bool, TraceRecorder] = None
    device: DeviceLike = None  # None = cuda

    def build(self) -> CLSession:
        if self.student is None or self.teacher is None:
            raise ValueError(
                f"{type(self).__name__} needs student and teacher configs")
        est = self.estimator
        if est is not None and (isinstance(est, type)
                                or not hasattr(est, "total_rows")):
            est = est()  # class or zero-arg factory -> instance
        return CLSession(
            student_cfg=self.student,
            teacher_cfg=self.teacher,
            hp=self.hp,
            estimator=est,
            allocator=self.allocator,
            precision_policy=self.policy,
            apply_mx_numerics=self.apply_mx,
            seed=self.seed,
            eval_fps=self.eval_fps,
            mesh=self.mesh,
            dispatch=self.dispatch,
            label_microbatch=self.label_microbatch,
            speculative_frames=self.speculative_frames,
            decision_aware_spec=self.decision_aware_spec,
            trace=self.trace,
            device=self.device,
        )


# ------------------------------------------------------------------ helpers
def pretrain_model(model, stream: DriftStream, steps: int, batch: int,
                   rng: np.random.Generator, segments=None, seed: int = 7,
                   lr: float = 3e-3):
    """SGD-momentum pretraining over IID stream samples; weights start from
    a CPU ``torch.Generator`` seeded with ``seed``."""
    params = model.init(torch.Generator().manual_seed(seed))
    opt = tree_map(torch.zeros_like, params)
    for _ in range(steps):
        x, y = stream.sample_dataset(batch, rng, segments=segments)
        params, opt, _ = sgd_momentum_step(
            model, params, opt,
            torch.as_tensor(x, device=model.device),
            torch.as_tensor(y, dtype=torch.long, device=model.device), lr)
    return params
