"""Async kernel dispatch: the plan → dispatch → collect execution layer
(the JAX package's ``core/dispatch.py`` ported).

The session builds a per-phase :class:`PhasePlan` and *dispatches* device
programs through it — PyTorch launches CUDA work asynchronously, so a
program's thunk returns device tensors at once — and *collects* host
values only at the phase-end barrier where the policy's feedback needs
them (:meth:`ProgramHandle.collect`, the one host sync).

Virtual-clock semantics (``dispatch=`` on ``CLSystemSpec`` / ``CLSession``):

``"sequential"`` (default)
    Everything time-shares one serial chain: the phase clock advances by
    the **sum** of the charged program costs in issue order — retraining
    batches, validation inference (charged at the T-SA rows), labeling.
    The B-SA-side measurement programs (accuracy scoring, labeled-frame
    predictions) are tracked in the phase ledger but never gate the chain.

``"concurrent"``
    T-SA and B-SA programs execute in parallel on their disjoint
    sub-accelerators: the phase advances by ``max(t_TSA, t_BSA)``. The
    inference kernel's programs are B-SA work charged at the B-SA's own
    throughput. Fixed-window pacing still floors the phase end.

Both modes issue every program eagerly; the difference is purely in clock
accounting, which is the reference's float arithmetic, add for add.

Fleet sessions (core/fleet.py) bind N pipelines to one plan — one
data-plane lane per camera stream — and attribute every charge to a lane
ledger next to the fleet ledger, so the shared T-SA is charged once for the
fleet while per-stream shares stay auditable (``lane_time``).
``dispatch_multi`` issues one device program on behalf of several lanes
(cross-stream batched labeling) and fans its per-lane results out into
individual handles.

Trace spine (core/trace.py): with a
:class:`~repro_torch.core.trace.TraceRecorder` attached to the dispatcher
(``CLSystemSpec(trace=...)``), every ``dispatch`` / ``dispatch_multi``
issue is recorded as a ``"program"``
:class:`~repro_torch.core.trace.TraceEvent` — role, label, lane, virtual
cost, host wall time of the issue, the kernel path that served it and the
unit count the cost scales with — and every bare ``charge`` as a
``"charge"`` event, in issue order. Recording touches no numeric plan
state, so traced runs are bit-identical to untraced ones; with no recorder
(the default) the traced overrides reduce to one ``is None`` check and the
untraced code path. :class:`~repro_torch.core.replay.TraceReplayer`
replays the recorded per-role float-add sequence to reconstruct, and
predict, phase times.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.trace import TraceEvent, TraceRecorder

SEQUENTIAL = "sequential"
CONCURRENT = "concurrent"
DISPATCH_MODES = (SEQUENTIAL, CONCURRENT)

ROLES = ("t_sa", "b_sa")


def _as_pipelines(pipeline) -> Tuple:
    """Normalize ``begin_phase``'s pipeline argument: None, a single
    FramePipeline, or a sequence of them (one lane per fleet stream)."""
    if pipeline is None:
        return ()
    if isinstance(pipeline, (list, tuple)):
        return tuple(pipeline)
    return (pipeline,)


def to_host(value: Any) -> np.ndarray:
    """A device tensor (or array-like) as a host numpy array — a sync."""
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


class ProgramHandle:
    """Deferred result of an issued device program. ``collect()`` is the
    only point that blocks (copies to host numpy); it is idempotent."""

    __slots__ = ("_value", "_host", "_collected")

    def __init__(self, value: Any):
        self._value = value
        self._host: Any = None
        self._collected = False

    @property
    def issued(self) -> Any:
        """The raw (device-side) value, without forcing a sync."""
        return self._value

    def collect(self) -> np.ndarray:
        if not self._collected:
            self._host = to_host(self._value)
            self._value = None  # drop the device reference
            self._collected = True
        return self._host


@dataclasses.dataclass(frozen=True)
class DeviceProgram:
    """One dispatched unit of device work, with its virtual-clock cost."""

    role: str  # "t_sa" | "b_sa"
    label: str  # e.g. "valid", "label", "score", "acc_label"
    cost_s: float
    handle: Optional[ProgramHandle]
    lane: Optional[int] = None  # fleet stream lane this program serves


class PhasePlan:
    """Clock + program ledger for one phase, built as the session executes.

    The running T-SA clock (``now()``) is a single ``+=`` per T-SA charge on
    one accumulator, so phase boundaries are the reference's floats.
    """

    def __init__(self, mode: str, start: float, pipeline=None):
        self.mode = mode
        self.start = start
        # One FramePipeline per stream lane; a single pipeline (the
        # CLSession case) is lane 0 of a one-lane plan.
        self.pipelines: Tuple = _as_pipelines(pipeline)
        # The two-plane Decision(s) this phase executes, one per lane.
        self.decisions: Tuple = ()
        self.programs: List[DeviceProgram] = []
        self.totals: Dict[str, float] = {role: 0.0 for role in ROLES}
        # Per-lane ledgers: plain sums from 0.0 of the addends that feed
        # ``totals``, so a one-lane plan's lane ledger is the fleet ledger.
        self.lane_totals: Dict[int, Dict[str, float]] = {}
        self._now = start  # T-SA running clock
        self._floor = start  # pacing floor on the phase end

    @property
    def pipeline(self):
        """Lane 0's pipeline (the single-stream handle)."""
        return self.pipelines[0] if self.pipelines else None

    @property
    def traced(self) -> bool:
        """Is a TraceRecorder observing this plan? (The engine uses this to
        gate wall-time measurement of host-side work like retraining SGD,
        keeping the untraced path free of even a ``perf_counter`` call.)"""
        return False

    # ----------------------------------------------------------- dispatch
    def dispatch(self, role: str, label: str, issue: Callable[[], Any],
                 cost_s: float = 0.0, lane: Optional[int] = None,
                 units: float = 0.0) -> ProgramHandle:
        """Issue a device program *now* (async — the thunk must not block)
        and charge its cost (to ``lane``'s ledger too, with a lane);
        returns a handle to ``collect()`` later. ``units`` is the
        trace-facing quantity the cost was computed from (frames scored,
        samples labeled) — ignored untraced."""
        del units
        handle = ProgramHandle(issue())
        self.programs.append(DeviceProgram(role, label, cost_s, handle, lane))
        self.charge(role, cost_s, lane=lane)
        return handle

    def dispatch_multi(self, role: str, label: str,
                       issue: Callable[[], Sequence[Any]],
                       costs: Sequence[float],
                       lanes: Sequence[int],
                       units: Optional[Sequence[float]] = None
                       ) -> List[ProgramHandle]:
        """Issue ONE device program serving several stream lanes (e.g. a
        labeling burst batched across the fleet on the shared T-SA) and
        split its per-lane results into individual handles. The thunk must
        return one device value per lane; each lane's cost is charged to
        both the fleet ledger and that lane's ledger, in lane order — for a
        one-lane plan this is exactly a single ``dispatch``."""
        del units
        values = issue()
        if len(values) != len(lanes) or len(costs) != len(lanes):
            raise ValueError(
                f"dispatch_multi: {len(values)} values / {len(costs)} costs "
                f"for {len(lanes)} lanes")
        handles = []
        for value, cost_s, lane in zip(values, costs, lanes):
            handle = ProgramHandle(value)
            self.programs.append(
                DeviceProgram(role, label, cost_s, handle, lane))
            self.charge(role, cost_s, lane=lane)
            handles.append(handle)
        return handles

    def fetch(self, t0: float, t1: float, max_frames: int = 0,
              lane: int = 0, tag: Optional[str] = None):
        """Pull a frame window for this phase's programs through lane
        ``lane``'s bound FramePipeline (speculative prefetch; results are
        bit-identical either way). ``tag`` marks the window's role."""
        if not self.pipelines:
            raise ValueError(
                "no FramePipeline bound to this plan; pass one to "
                "KernelDispatcher.begin_phase")
        return self.pipelines[lane].frames(t0, t1, max_frames=max_frames,
                                           tag=tag)

    def charge(self, role: str, seconds: float,
               lane: Optional[int] = None, label: Optional[str] = None,
               units: float = 0.0, wall_s: float = 0.0) -> None:
        """Charge virtual time without an attached program (e.g. retraining
        SGD, whose cost is known only after the batch count is). With a
        ``lane``, the charge is also attributed to that stream's ledger.
        ``label``/``units``/``wall_s`` annotate the charge for the trace
        spine (kernel name, quantity the cost scales with, measured host
        wall) — ignored untraced."""
        del label, units, wall_s
        self.totals[role] += seconds
        if lane is not None:
            lane_led = self.lane_totals.setdefault(
                lane, {r: 0.0 for r in ROLES})
            lane_led[role] += seconds
        if role == "t_sa":
            self._now += seconds

    def lane_time(self, role: str, lane: int) -> float:
        """This phase's virtual seconds charged to ``lane`` on ``role``."""
        return self.lane_totals.get(lane, {}).get(role, 0.0)

    def pad_to(self, t: float) -> None:
        """Floor the phase end on a pacing-grid boundary (pace_window_s)."""
        if t > self._floor:
            self._floor = t

    # -------------------------------------------------------------- clock
    def now(self) -> float:
        """Running clock while the phase is being built: the T-SA chain
        drives phase structure in both modes."""
        return self._now

    @property
    def t_tsa(self) -> float:
        return self.totals["t_sa"]

    @property
    def t_bsa(self) -> float:
        return self.totals["b_sa"]

    def finish(self) -> float:
        """Phase-end clock. Sequential: the T-SA sum; concurrent:
        start + max(t_TSA, t_BSA). Both respect the pacing floor."""
        end = self._now
        if self.mode == CONCURRENT:
            end = max(end, self.start + self.totals["b_sa"])
        return max(end, self._floor)

    def collect_all(self) -> None:
        """Barrier: materialize every outstanding program of this phase."""
        for prog in self.programs:
            if prog.handle is not None:
                prog.handle.collect()


class KernelDispatcher:
    """Factory + bookkeeping for per-phase plans: its mode decides the
    clock semantics of every :class:`PhasePlan` it opens. The counters
    (``phases_dispatched``, ``programs_dispatched``, ``windows_fetched``,
    ``programs_by_label``) are cumulative, for benchmarks and tests.

    ``recorder`` (a :class:`~repro_torch.core.trace.TraceRecorder`, default
    None) turns on the trace spine: each ``begin_phase`` opens a
    :class:`~repro_torch.core.trace.PhaseTrace` and the plan's traced
    overrides record every program issue and ledger charge."""

    def __init__(self, mode: str = SEQUENTIAL,
                 recorder: Optional[TraceRecorder] = None):
        if mode not in DISPATCH_MODES:
            raise ValueError(
                f"unknown dispatch mode {mode!r}; known: {DISPATCH_MODES}")
        self.mode = mode
        self.recorder = recorder
        self.phases_dispatched = 0
        self.programs_dispatched = 0
        self.windows_fetched = 0
        self.programs_by_label: Dict[str, int] = {}

    @property
    def concurrent(self) -> bool:
        return self.mode == CONCURRENT

    def begin_phase(self, start: float, pipeline=None,
                    label_hints: Optional[Sequence] = None,
                    decisions: Optional[Sequence] = None,
                    fps: Optional[float] = None) -> PhasePlan:
        """Open a phase plan. ``pipeline`` is a FramePipeline or a sequence
        of them (one lane per fleet stream); opening the plan rotates each
        pipeline's speculation onto this phase start. ``decisions`` (one
        two-plane Decision per lane) is the phase's intent: with a stream
        ``fps``, each lane's label hint — the decision-aware speculation
        signal — derives from its temporal plane's labeling budget.
        ``label_hints`` (one ``(n_samples, fps)`` per lane, or None
        entries) is the pre-plane spelling of the same signal; when given
        it wins over the hints ``decisions`` would give."""
        pipelines = _as_pipelines(pipeline)
        decisions = tuple(decisions) if decisions is not None else ()
        if label_hints is None:
            label_hints = [
                (None if d is None or fps is None
                 else (d.temporal.total_label_samples, fps))
                for d in decisions]
        for i, pipe in enumerate(pipelines):
            hint = label_hints[i] if i < len(label_hints) else None
            pipe.begin_phase(start, label_hint=hint)
        plan = _TrackedPlan(self, self.mode, start, pipelines)
        plan.decisions = decisions
        if self.recorder is not None:
            plan._trace = self.recorder.begin_phase(
                start, self.mode, decisions=plan.decisions)
        self.phases_dispatched += 1
        return plan


class _TrackedPlan(PhasePlan):
    """PhasePlan that feeds the dispatcher's cumulative counters — and,
    when the dispatcher carries a
    :class:`~repro_torch.core.trace.TraceRecorder`, records the phase's
    program/charge stream as :class:`~repro_torch.core.trace.TraceEvent`s.
    Recording never touches the numeric plan state (ledgers, clock,
    floor); with ``_trace is None`` every override falls straight through
    to the untraced code path."""

    def __init__(self, dispatcher: KernelDispatcher, mode: str, start: float,
                 pipeline=None):
        super().__init__(mode, start, pipeline)
        self._dispatcher = dispatcher
        self._trace = None  # open PhaseTrace when the dispatcher records
        self._in_program = False  # suppress charge events inside dispatch

    @property
    def traced(self) -> bool:
        return self._trace is not None

    def dispatch(self, role: str, label: str, issue: Callable[[], Any],
                 cost_s: float = 0.0, lane: Optional[int] = None,
                 units: float = 0.0) -> ProgramHandle:
        self._dispatcher.programs_dispatched += 1
        by_label = self._dispatcher.programs_by_label
        by_label[label] = by_label.get(label, 0) + 1
        tr = self._trace
        if tr is None:
            return super().dispatch(role, label, issue, cost_s, lane=lane)
        recorder = self._dispatcher.recorder
        before = recorder.paths_before()
        t0 = time.perf_counter()
        self._in_program = True
        try:
            handle = super().dispatch(role, label, issue, cost_s, lane=lane)
        finally:
            self._in_program = False
        wall = time.perf_counter() - t0
        tr.events.append(TraceEvent(
            kind="program", role=role, label=label, cost_s=cost_s,
            lane=lane, wall_s=wall, path=recorder.dominant_path(before),
            units=units))
        return handle

    def dispatch_multi(self, role: str, label: str,
                       issue: Callable[[], Sequence[Any]],
                       costs: Sequence[float],
                       lanes: Sequence[int],
                       units: Optional[Sequence[float]] = None
                       ) -> List[ProgramHandle]:
        self._dispatcher.programs_dispatched += 1
        by_label = self._dispatcher.programs_by_label
        by_label[label] = by_label.get(label, 0) + 1
        tr = self._trace
        if tr is None:
            return super().dispatch_multi(role, label, issue, costs, lanes)
        recorder = self._dispatcher.recorder
        before = recorder.paths_before()
        t0 = time.perf_counter()
        self._in_program = True
        try:
            handles = super().dispatch_multi(role, label, issue, costs,
                                             lanes)
        finally:
            self._in_program = False
        # One device program fanned across the lanes: the measured wall is
        # split evenly over the per-lane events (``fan`` marks the group).
        wall = (time.perf_counter() - t0) / max(1, len(lanes))
        path = recorder.dominant_path(before)
        for i, (cost_s, lane) in enumerate(zip(costs, lanes)):
            tr.events.append(TraceEvent(
                kind="program", role=role, label=label, cost_s=cost_s,
                lane=lane, wall_s=wall, path=path,
                units=(units[i] if units is not None else 0.0),
                fan=len(lanes)))
        return handles

    def charge(self, role: str, seconds: float,
               lane: Optional[int] = None, label: Optional[str] = None,
               units: float = 0.0, wall_s: float = 0.0) -> None:
        super().charge(role, seconds, lane=lane)
        tr = self._trace
        if tr is not None and not self._in_program:
            tr.events.append(TraceEvent(
                kind="charge", role=role, label=label or "charge",
                cost_s=seconds, lane=lane, wall_s=wall_s, units=units))

    def finish(self) -> float:
        end = super().finish()
        tr = self._trace
        if tr is not None:
            tr.end = end
            tr.floor = self._floor
        return end

    def fetch(self, t0: float, t1: float, max_frames: int = 0,
              lane: int = 0, tag: Optional[str] = None):
        self._dispatcher.windows_fetched += 1
        return super().fetch(t0, t1, max_frames, lane=lane, tag=tag)
