"""Async kernel dispatch: the plan → dispatch → collect execution layer
(the JAX package's ``core/dispatch.py`` without the trace recorder).

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

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

    # ----------------------------------------------------------- dispatch
    def dispatch(self, role: str, label: str, issue: Callable[[], Any],
                 cost_s: float = 0.0) -> ProgramHandle:
        """Issue a device program *now* (async — the thunk must not block)
        and charge its cost; returns a handle to ``collect()`` later."""
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

    def charge(self, role: str, seconds: float) -> None:
        """Charge virtual time without an attached program (e.g. retraining
        SGD, whose cost is known only after the batch count is)."""
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
    ``programs_by_label``) are cumulative, for benchmarks and tests."""

    def __init__(self, mode: str = SEQUENTIAL):
        if mode not in DISPATCH_MODES:
            raise ValueError(
                f"unknown dispatch mode {mode!r}; known: {DISPATCH_MODES}")
        self.mode = mode
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
        self.phases_dispatched += 1
        return plan


class _TrackedPlan(PhasePlan):
    """PhasePlan that feeds the dispatcher's cumulative counters."""

    def __init__(self, dispatcher: KernelDispatcher, mode: str, start: float,
                 pipeline=None):
        super().__init__(mode, start, pipeline)
        self._dispatcher = dispatcher

    def dispatch(self, role: str, label: str, issue: Callable[[], Any],
                 cost_s: float = 0.0) -> ProgramHandle:
        self._dispatcher.programs_dispatched += 1
        by_label = self._dispatcher.programs_by_label
        by_label[label] = by_label.get(label, 0) + 1
        return super().dispatch(role, label, issue, cost_s)

    def fetch(self, t0: float, t1: float, max_frames: int = 0,
              tag: Optional[str] = None):
        self._dispatcher.windows_fetched += 1
        return super().fetch(t0, t1, max_frames, tag=tag)
