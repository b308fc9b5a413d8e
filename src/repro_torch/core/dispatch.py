"""Async kernel dispatch: the plan → dispatch → collect execution layer
(the single-stream part of the JAX package's ``core/dispatch.py``).

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

Trace spine (core/trace.py): with a
:class:`~repro_torch.core.trace.TraceRecorder` attached to the dispatcher
(``CLSystemSpec(trace=...)``), every ``dispatch`` is recorded as a
``"program"`` :class:`~repro_torch.core.trace.TraceEvent` — role, label,
virtual cost, host wall time of the issue, the kernel path that served it
and the unit count the cost scales with — and every bare ``charge`` as a
``"charge"`` event, in issue order. Recording touches no numeric plan
state, so traced runs are bit-identical to untraced ones; with no recorder
(the default) the traced overrides reduce to one ``is None`` check and the
untraced code path. :class:`~repro_torch.core.replay.TraceReplayer`
replays the recorded per-role float-add sequence to reconstruct, and
predict, phase times.

Not ported yet: the fleet's lanes (``lane=`` on ``charge``,
``dispatch_multi``, ``lane_totals``; ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.trace import TraceEvent, TraceRecorder

SEQUENTIAL = "sequential"
CONCURRENT = "concurrent"
DISPATCH_MODES = (SEQUENTIAL, CONCURRENT)

ROLES = ("t_sa", "b_sa")


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


class PhasePlan:
    """Clock + program ledger for one phase, built as the session executes.

    The running T-SA clock (``now()``) is a single ``+=`` per T-SA charge on
    one accumulator, so phase boundaries are the reference's floats.
    """

    def __init__(self, mode: str, start: float, pipeline=None):
        self.mode = mode
        self.start = start
        self.pipeline = pipeline  # the phase's FramePipeline
        self.programs: List[DeviceProgram] = []
        self.totals: Dict[str, float] = {role: 0.0 for role in ROLES}
        self._now = start  # T-SA running clock
        self._floor = start  # pacing floor on the phase end

    @property
    def traced(self) -> bool:
        """Is a TraceRecorder observing this plan? (The engine uses this to
        gate wall-time measurement of host-side work like retraining SGD,
        keeping the untraced path free of even a ``perf_counter`` call.)"""
        return False

    # ----------------------------------------------------------- dispatch
    def dispatch(self, role: str, label: str, issue: Callable[[], Any],
                 cost_s: float = 0.0, units: float = 0.0) -> ProgramHandle:
        """Issue a device program *now* (async — the thunk must not block)
        and charge its cost; returns a handle to ``collect()`` later.
        ``units`` is the trace-facing quantity the cost was computed from
        (frames scored, samples labeled) — ignored untraced."""
        del units
        handle = ProgramHandle(issue())
        self.programs.append(DeviceProgram(role, label, cost_s, handle))
        self.charge(role, cost_s)
        return handle

    def fetch(self, t0: float, t1: float, max_frames: int = 0,
              tag: Optional[str] = None):
        """Pull a frame window for this phase's programs through the bound
        FramePipeline (speculative prefetch; results are bit-identical
        either way). ``tag`` marks the window's role."""
        if self.pipeline is None:
            raise ValueError(
                "no FramePipeline bound to this plan; pass one to "
                "KernelDispatcher.begin_phase")
        return self.pipeline.frames(t0, t1, max_frames=max_frames, tag=tag)

    def charge(self, role: str, seconds: float, label: Optional[str] = None,
               units: float = 0.0, wall_s: float = 0.0) -> None:
        """Charge virtual time without an attached program (e.g. retraining
        SGD, whose cost is known only after the batch count is).
        ``label``/``units``/``wall_s`` annotate the charge for the trace
        spine (kernel name, quantity the cost scales with, measured host
        wall) — ignored untraced."""
        del label, units, wall_s
        self.totals[role] += seconds
        if role == "t_sa":
            self._now += seconds

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

    def begin_phase(self, start: float, pipeline=None, decision=None,
                    fps: Optional[float] = None) -> PhasePlan:
        """Open a phase plan. Opening it rotates the pipeline's speculation
        onto this phase start; with a stream ``fps``, the label hint (the
        decision-aware speculation signal) derives from the decision's
        labeling budget."""
        if pipeline is not None:
            hint = (None if decision is None or fps is None
                    else (decision.temporal.total_label_samples, fps))
            pipeline.begin_phase(start, label_hint=hint)
        plan = _TrackedPlan(self, self.mode, start, pipeline)
        if self.recorder is not None:
            plan._trace = self.recorder.begin_phase(
                start, self.mode,
                decisions=() if decision is None else (decision,))
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
                 cost_s: float = 0.0, units: float = 0.0) -> ProgramHandle:
        self._dispatcher.programs_dispatched += 1
        by_label = self._dispatcher.programs_by_label
        by_label[label] = by_label.get(label, 0) + 1
        tr = self._trace
        if tr is None:
            return super().dispatch(role, label, issue, cost_s)
        recorder = self._dispatcher.recorder
        before = recorder.paths_before()
        t0 = time.perf_counter()
        self._in_program = True
        try:
            handle = super().dispatch(role, label, issue, cost_s)
        finally:
            self._in_program = False
        wall = time.perf_counter() - t0
        tr.events.append(TraceEvent(
            kind="program", role=role, label=label, cost_s=cost_s,
            wall_s=wall, path=recorder.dominant_path(before), units=units))
        return handle

    def charge(self, role: str, seconds: float, label: Optional[str] = None,
               units: float = 0.0, wall_s: float = 0.0) -> None:
        super().charge(role, seconds)
        tr = self._trace
        if tr is not None and not self._in_program:
            tr.events.append(TraceEvent(
                kind="charge", role=role, label=label or "charge",
                cost_s=seconds, wall_s=wall_s, units=units))

    def finish(self) -> float:
        end = super().finish()
        tr = self._trace
        if tr is not None:
            tr.end = end
            tr.floor = self._floor
        return end

    def fetch(self, t0: float, t1: float, max_frames: int = 0,
              tag: Optional[str] = None):
        self._dispatcher.windows_fetched += 1
        return super().fetch(t0, t1, max_frames, tag=tag)
